"""zamba2-2.7b — hybrid: Mamba2 backbone + shared attention block (weights
reused, applied every 6th layer, concat-skip from embeddings).
[arXiv:2411.15242; hf]"""
from repro_torch.config.model import ModelConfig
from repro_torch.config.registry import register_arch


@register_arch("zamba2-2.7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b",
        family="hybrid",
        n_layers=54,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,  # MHA in the shared block
        d_ff=10240,     # shared block MLP
        vocab_size=32000,
        head_dim=80,
        ssm_state=64,
        ssm_version=2,  # Mamba2 / SSD
        ssm_expand=2,
        ssm_head_dim=64,
        attn_every=6,
        rope_theta=1e4,
        source="arXiv:2411.15242; hf",
    )
