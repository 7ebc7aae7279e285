"""falcon-mamba-7b — attention-free Mamba-1 SSM. [arXiv:2410.05355; unverified]"""
from repro_torch.config.model import ModelConfig
from repro_torch.config.registry import register_arch


@register_arch("falcon-mamba-7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b",
        family="ssm",
        n_layers=64,
        d_model=4096,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab_size=65024,
        ssm_state=16,
        ssm_version=1,  # mamba1 arch
        ssm_expand=2,
        ssm_conv=4,
        tie_embeddings=True,
        source="arXiv:2410.05355; unverified",
    )
