"""olmoe-1b-7b — MoE 64 experts top-8, fine-grained (d_ff=1024/expert).
[arXiv:2409.02060; hf]"""
from repro_torch.config.model import ModelConfig
from repro_torch.config.registry import register_arch


@register_arch("olmoe-1b-7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b",
        family="moe",
        n_layers=16,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,  # MHA
        d_ff=1024,
        vocab_size=50304,
        head_dim=128,
        n_experts=64,
        experts_per_token=8,
        rope_theta=1e4,
        source="arXiv:2409.02060; hf",
    )
