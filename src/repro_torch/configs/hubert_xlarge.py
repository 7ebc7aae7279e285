"""hubert-xlarge — encoder-only audio transformer (wav2vec2-style backbone);
conv frame frontend is a stub per the assignment (input_specs() provides
precomputed frame embeddings); masked-prediction head over 504 clusters.
[arXiv:2106.07447; unverified]"""
from repro_torch.config.model import ModelConfig
from repro_torch.config.registry import register_arch


@register_arch("hubert-xlarge")
def config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge",
        family="encoder",
        n_layers=48,
        d_model=1280,
        n_heads=16,
        n_kv_heads=16,
        d_ff=5120,
        vocab_size=504,
        head_dim=80,
        causal=False,
        source="arXiv:2106.07447; unverified",
    )
