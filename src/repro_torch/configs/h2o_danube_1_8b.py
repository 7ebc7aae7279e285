"""h2o-danube-1.8b — dense llama+mistral mix, GQA kv=8, sliding-window attention.
[arXiv:2401.16818; hf]"""
from repro_torch.config.model import ModelConfig
from repro_torch.config.registry import register_arch


@register_arch("h2o-danube-1.8b")
def config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-1.8b",
        family="dense",
        n_layers=24,
        d_model=2560,
        n_heads=32,
        n_kv_heads=8,
        d_ff=6912,
        vocab_size=32000,
        head_dim=80,
        sliding_window=4096,  # mistral-style SWA
        rope_theta=1e4,
        source="arXiv:2401.16818; hf",
    )
