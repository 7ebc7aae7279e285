"""Unified model/shape configuration for every assigned architecture family.

One frozen dataclass covers dense / MoE / SSM / hybrid / encoder / VLM; family
selects the block stack, the rest are dimension knobs. `reduced()` produces
the family-preserving smoke-test config (small dims, same structure) required
by deliverable (f). `LayeredConfig` adds the fields of a stack whose mixer
kind is given layer by layer (family ``"layered"``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encoder", "vlm", "layered")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 1e4
    sliding_window: int = 0      # 0 = full attention
    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # SSM (mamba)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_version: int = 0         # 1 = mamba1 (falcon-mamba), 2 = mamba2/SSD (zamba2)
    ssm_head_dim: int = 64       # mamba2 P
    ssm_dt_rank: int = 0         # mamba1; 0 -> ceil(d_model/16)
    ssm_chunk: int = 128         # chunked-scan length (TPU adaptation knob)
    # hybrid (zamba2)
    attn_every: int = 0          # shared attn block after every k-th ssm layer
    # structure
    causal: bool = True
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # attention compute (TPU adaptation knobs, see DESIGN.md / §Perf)
    attn_chunk: int = 1024       # KV-chunked (flash-style) attention block
    loss_chunk: int = 512        # sequence chunking for the vocab head + CE
    remat: str = "full"          # "none" | "dots" | "full" per-layer remat policy
                                 # (full = save only scan carries; "dots" is a
                                 # §Perf knob for models with HBM headroom)
    scan_unroll: bool = False    # unroll every lax.scan (dry-run cost variants
                                 # only: XLA cost_analysis counts a scan body
                                 # once regardless of trip count)
    attn_p_bf16: bool = True     # store post-softmax probabilities in bf16 for
                                 # the PV matmul (halves prefill HBM traffic;
                                 # §Perf iteration 2); f32 when dtype=float32
    attn_grouped: bool = True    # grouped-GQA einsums (no KV repeat); False =
                                 # naive repeat_kv baseline (§Perf iteration 1 A/B)
    source: str = ""             # provenance tag from the assignment table

    # ------------------------------------------------------------- derived
    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def softmax_scale(self) -> float:
        """Attention's softmax scale: 1/sqrt(hd)."""
        return 1.0 / (self.hd ** 0.5)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or -(-self.d_model // 16)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def has_decode(self) -> bool:
        return self.family != "encoder"

    @property
    def subquadratic(self) -> bool:
        """Eligible for long_500k (spec: SSM / hybrid / linear-attn only)."""
        return self.family in ("ssm", "hybrid")

    def n_shared_attn(self) -> int:
        """Hybrid: number of shared-attention applications."""
        if self.family != "hybrid" or not self.attn_every:
            return 0
        return self.n_layers // self.attn_every

    # ------------------------------------------------------------ counting
    def param_count(self) -> int:
        """Analytic parameter count (cross-checked against the real pytree)."""
        d, f, V, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        n = V * d  # embedding
        if not self.tie_embeddings and self.family != "encoder":
            n += V * d  # lm head
        if self.family == "encoder":
            n += V * d  # classifier head
        hd, H, KV = self.hd, self.n_heads, self.n_kv_heads

        def attn_params() -> int:
            a = d * H * hd + 2 * d * KV * hd + H * hd * d
            if self.qkv_bias:
                a += H * hd + 2 * KV * hd
            return a

        def mlp_params(ff: int) -> int:
            return 3 * d * ff  # gate, up, down

        if self.family in ("dense", "vlm"):
            per = attn_params() + mlp_params(f) + 2 * d
            n += L * per
        elif self.family == "encoder":
            per = attn_params() + mlp_params(f) + 2 * d
            n += L * per
        elif self.family == "moe":
            per = attn_params() + self.n_experts * mlp_params(f) + d * self.n_experts + 2 * d
            n += L * per
        elif self.family == "ssm":
            n += L * (self._mamba1_params() + d)
        elif self.family == "hybrid":
            n += L * (self._mamba2_params() + d)
            if self.n_shared_attn():
                # shared block params counted once (weights reused)
                n += 2 * d * self.n_heads * self.hd + 2 * 2 * d * self.n_kv_heads * self.hd \
                     + self.n_heads * self.hd * d + 2 * d + mlp_params(self.d_ff) if self.d_ff else 0
        n += d  # final norm
        return n

    def _mamba1_params(self) -> int:
        d, di, N, R = self.d_model, self.d_inner, self.ssm_state, self.dt_rank
        return (
            d * 2 * di            # in_proj
            + self.ssm_conv * di  # depthwise conv
            + di * (R + 2 * N)    # x_proj
            + R * di + di         # dt_proj
            + di * N + di         # A_log, D
            + di * d              # out_proj
        )

    def _mamba2_params(self) -> int:
        d, di, N = self.d_model, self.d_inner, self.ssm_state
        H = self.ssm_nheads
        return (
            d * (2 * di + 2 * N + H)  # in_proj -> z, x, B, C, dt
            + self.ssm_conv * (di + 2 * N)
            + 3 * H                   # A_log, D, dt_bias
            + di                      # norm
            + di * d                  # out_proj
        )

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k experts only)."""
        if self.family != "moe":
            return self.param_count()
        d, f = self.d_model, self.d_ff
        inactive = (self.n_experts - self.experts_per_token) * 3 * d * f * self.n_layers
        return self.param_count() - inactive

    # ------------------------------------------------------------- reduced
    def reduced(self) -> "ModelConfig":
        """Family-preserving tiny config for CPU smoke tests."""
        changes: Dict = dict(
            n_layers=min(self.n_layers, 4 if self.family != "hybrid" else 2 * max(self.attn_every, 1)),
            d_model=128,
            n_heads=min(self.n_heads, 4) or 0,
            n_kv_heads=min(self.n_kv_heads, 2) or 0,
            d_ff=256 if self.d_ff else 0,
            vocab_size=512,
            head_dim=32 if self.n_heads else 0,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            attn_chunk=64,
            loss_chunk=64,
            ssm_chunk=32,
            ssm_head_dim=32 if self.ssm_version == 2 else self.ssm_head_dim,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            name=f"{self.name}-reduced",
            dtype="float32",
        )
        if self.family == "moe":
            changes["n_experts"] = min(self.n_experts, 8)
            changes["experts_per_token"] = min(self.experts_per_token, 2)
        if self.family == "hybrid":
            changes["attn_every"] = min(self.attn_every or 2, 2)
        return dataclasses.replace(self, **changes)


@dataclass(frozen=True)
class LayeredConfig(ModelConfig):
    """A stack whose mixer kind is given per layer (granitemoehybrid): layer
    ``i`` runs a Mamba-2 mixer where ``layer_types[i]`` is ``"mamba"`` and
    GQA attention where it is ``"attention"``, and every layer then runs
    routed experts (``n_experts`` of width ``d_ff``, top ``experts_per_token``,
    no capacity) beside one shared gated-SiLU expert of width
    ``shared_d_ff``:

        h  = x + residual_multiplier * mixer(rms_norm(x))
        x' = h + residual_multiplier * (moe(rms_norm(h)) + shared(rms_norm(h)))

    The embedding is multiplied by ``embedding_multiplier`` and the logits
    divided by ``logits_scaling``; attention's softmax scale is
    ``attn_scale`` (0: 1/sqrt(hd)), and ``rope_theta`` 0 gives attention no
    positional encoding. A subclass, so that ``ModelConfig``'s own fields
    stay the JAX package's."""

    layer_types: Tuple[str, ...] = ()
    shared_d_ff: int = 0
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    attn_scale: float = 0.0
    logits_scaling: float = 1.0

    KINDS = ("mamba", "attention")

    def __post_init__(self):
        assert self.family == "layered", self.family
        assert len(self.layer_types) == self.n_layers, (len(self.layer_types), self.n_layers)
        assert set(self.layer_types) <= set(self.KINDS), self.layer_types

    @property
    def n_mamba(self) -> int:
        return self.layer_types.count("mamba")

    @property
    def n_attn(self) -> int:
        return self.layer_types.count("attention")

    @property
    def softmax_scale(self) -> float:
        return self.attn_scale or 1.0 / (self.hd ** 0.5)

    def mixer_index(self, i: int) -> int:
        """Layer ``i``'s index in the stack of its own mixer kind."""
        return self.layer_types[:i].count(self.layer_types[i])

    def _attn_params(self) -> int:
        d, H, KV, hd = self.d_model, self.n_heads, self.n_kv_heads, self.hd
        return d * H * hd + 2 * d * KV * hd + H * hd * d + (H * hd + 2 * KV * hd if self.qkv_bias else 0)

    def _ffn_params(self, experts: int) -> int:
        """Two norms, the router, ``experts`` routed experts and the shared one."""
        d = self.d_model
        return 2 * d + d * self.n_experts + experts * 3 * d * self.d_ff + 3 * d * self.shared_d_ff

    def param_count(self) -> int:
        d, V = self.d_model, self.vocab_size
        conv_bias = self.d_inner + 2 * self.ssm_state
        n = V * d * (1 if self.tie_embeddings else 2) + d
        n += self.n_layers * self._ffn_params(self.n_experts)
        n += self.n_mamba * (self._mamba2_params() + conv_bias) + self.n_attn * self._attn_params()
        return n

    def active_param_count(self) -> int:
        return self.param_count() - self.n_layers * (self.n_experts - self.experts_per_token) * 3 \
            * self.d_model * self.d_ff

    def reduced(self) -> "LayeredConfig":
        """Tiny widths, 8 experts with top 2, and four layers: one attention
        layer second among three mamba ones where the stack has both kinds."""
        kinds = [k for k in self.KINDS if k in self.layer_types]
        types = ("mamba", "attention", "mamba", "mamba") if len(kinds) == 2 else (kinds[0],) * 4
        return dataclasses.replace(
            self, name=f"{self.name}-reduced", n_layers=4, layer_types=types, d_model=128,
            n_heads=min(self.n_heads, 4), n_kv_heads=min(self.n_kv_heads, 2), head_dim=32,
            d_ff=64, shared_d_ff=96, vocab_size=512, n_experts=min(self.n_experts, 8),
            experts_per_token=min(self.experts_per_token, 2), ssm_state=16, ssm_head_dim=32,
            ssm_chunk=32, attn_chunk=64, loss_chunk=64, dtype="float32")


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def cell_runnable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Spec'd skip rules (DESIGN.md §4): returns (runnable, reason_if_not)."""
    if shape.kind == "decode" and not cfg.has_decode:
        return False, "encoder-only architecture has no autoregressive decode step"
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "long_500k requires sub-quadratic attention (spec: run for SSM/hybrid only)"
    return True, ""
