"""llava-next-34b — VLM: dense GQA decoder backbone (Yi-34B-class) consuming
anyres patch embeddings; modality frontend is a stub per the assignment
(input_specs() provides precomputed patch embeddings).
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""
from repro_torch.config.model import ModelConfig
from repro_torch.config.registry import register_arch


@register_arch("llava-next-34b")
def config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-34b",
        family="vlm",
        n_layers=60,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=20480,
        vocab_size=64000,
        head_dim=128,
        rope_theta=5e6,
        source="hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified",
    )
