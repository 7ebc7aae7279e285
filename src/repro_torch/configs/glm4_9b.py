"""glm4-9b — dense, RoPE, GQA kv=2. [hf:THUDM/glm-4-9b; hf]"""
from repro_torch.config.model import ModelConfig
from repro_torch.config.registry import register_arch


@register_arch("glm4-9b")
def config() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b",
        family="dense",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=2,
        d_ff=13696,
        vocab_size=151552,
        head_dim=128,
        rope_theta=1e4,
        source="hf:THUDM/glm-4-9b; hf",
    )
