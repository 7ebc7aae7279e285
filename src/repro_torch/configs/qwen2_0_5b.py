"""qwen2-0.5b — dense, GQA kv=2, QKV bias, tied embeddings. [arXiv:2407.10671; hf]"""
from repro_torch.config.model import ModelConfig
from repro_torch.config.registry import register_arch


@register_arch("qwen2-0.5b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-0.5b",
        family="dense",
        n_layers=24,
        d_model=896,
        n_heads=14,
        n_kv_heads=2,
        d_ff=4864,
        vocab_size=151936,
        head_dim=64,
        qkv_bias=True,
        rope_theta=1e6,
        tie_embeddings=True,
        source="arXiv:2407.10671; hf",
    )
