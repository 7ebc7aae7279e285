"""What the LM drivers share: the model configuration from its file, the
program's model with the benchmark's weights in it, and the reference's
view of the same weights."""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

# configuration file keys (the published config.json's) -> the port's
# ModelConfig fields
FIELDS = {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
          "num_attention_heads": "n_heads", "num_key_value_heads": "n_kv_heads",
          "intermediate_size": "d_ff", "vocab_size": "vocab_size", "rope_theta": "rope_theta",
          "rms_norm_eps": "norm_eps", "tie_word_embeddings": "tie_embeddings"}


def model_config(config: dict):
    """The port's ModelConfig for the configuration file, with the file's
    ``program`` settings (the port's own knobs) applied."""
    from repro_torch.config.model import ModelConfig

    kw = {field: config[key] for key, field in FIELDS.items()}
    kw.update(head_dim=config["hidden_size"] // config["num_attention_heads"],
              qkv_bias=bool(config["qkv_bias"]), dtype=config["torch_dtype"])
    cfg = ModelConfig(name=config["name"], family="dense", **kw)
    return dataclasses.replace(cfg, **config.get("program", {}))


def reference_config(config: dict) -> dict:
    return {"layers": config["num_hidden_layers"], "heads": config["num_attention_heads"],
            "kv_heads": config["num_key_value_heads"],
            "head_dim": config["hidden_size"] // config["num_attention_heads"],
            "rms_norm_eps": config["rms_norm_eps"], "rope_theta": config["rope_theta"]}


def flat(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A nested dict of tensors as {dotted name: tensor}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def build(cell):
    """The program's config and model on the cell's device, holding the
    benchmark's weights (drawn from the seed on the device)."""
    from portbench import inputs
    from repro_torch.models import build_model

    cfg = model_config(cell.config)
    model = build_model(cfg, cell.device)
    params = flat(model.params())
    weights = inputs.lm_weights({n: tuple(p.shape) for n, p in params.items()}, cell.seed,
                                cell.device, dtype=params["embed.tok"].dtype)
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(weights[n])
    return cfg, model


def reference_weights(cell) -> Dict[str, torch.Tensor]:
    """The same weights again, drawn from the seed in the type the program
    holds them in, as float32 for the reference (the program's copies are
    not read)."""
    from portbench import inputs
    from repro_torch.models.model import param_specs

    specs = flat(param_specs(model_config(cell.config)))
    shapes = {n: tuple(s.shape) for n, s in specs.items()}
    w = inputs.lm_weights(shapes, cell.seed, cell.device, dtype=specs["embed.tok"].dtype)
    return {n: t.float() for n, t in w.items()}
