"""mixtral-8x22b — MoE 8 experts top-2, GQA kv=8, SWA. [arXiv:2401.04088; hf]"""
from repro_torch.config.model import ModelConfig
from repro_torch.config.registry import register_arch


@register_arch("mixtral-8x22b")
def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b",
        family="moe",
        n_layers=56,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=16384,
        vocab_size=32768,
        head_dim=128,
        sliding_window=4096,
        n_experts=8,
        experts_per_token=2,
        rope_theta=1e6,
        source="arXiv:2401.04088; hf",
    )
