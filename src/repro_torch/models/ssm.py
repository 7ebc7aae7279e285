"""State-space blocks: Mamba-1 (falcon-mamba) and Mamba-2/SSD (zamba2).

Both run a chunked scan: a loop over sequence chunks carrying the recurrent
state. Inside a chunk, Mamba-1 runs its linear recurrence step by step over
the chunk's Q positions (the reference's ``associative_scan`` has no torch
counterpart), so one chunk of (B, Q, d_inner, N) is the most it holds;
Mamba-2 evaluates the SSD quadratic form with einsums over the chunk.
The depthwise causal conv is ``F.conv1d`` with ``groups=C``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.config.model import ModelConfig
from repro_torch.launch.act_sharding import ModelAxis, constrain
from repro_torch.models.layers import matmul
from repro_torch.models.spec import TensorSpec


# =============================================================== mamba-1
def mamba1_specs(cfg: ModelConfig) -> dict:
    d, di, N, R, K = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank, cfg.ssm_conv
    return {
        "in_proj": TensorSpec((d, 2 * di), ("embed", "ssm_inner")),
        "conv_w": TensorSpec((K, di), (None, "ssm_inner")),
        "conv_b": TensorSpec((di,), ("ssm_inner",), init="zeros"),
        "x_proj": TensorSpec((di, R + 2 * N), ("ssm_inner", None)),
        "dt_w": TensorSpec((R, di), (None, "ssm_inner")),
        "dt_b": TensorSpec((di,), ("ssm_inner",), init="ssm_dt", dtype=torch.float32),
        "A_log": TensorSpec((di, N), ("ssm_inner", None), init="ssm_a", dtype=torch.float32),
        "D": TensorSpec((di,), ("ssm_inner",), init="ones", dtype=torch.float32),
        "out_proj": TensorSpec((di, d), ("ssm_inner", "embed")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along S. x: (B, S, C); w: (K, C)."""
    K, C = w.shape
    xp = F.pad(x.float().transpose(1, 2), (K - 1, 0))           # (B, C, S+K-1)
    out = F.conv1d(xp, w.float().t().unsqueeze(1), groups=C)    # weight (C, 1, K)
    return (out.transpose(1, 2) + b.float()).to(x.dtype)


def _conv_step(window: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The conv at one position. window: (B, K, C) -> (B, C) f32."""
    return torch.einsum("bkc,kc->bc", window.float(), w.float()) + b.float()


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


def _psum_split(tp: ModelAxis):
    """``tp.psum`` of a product each rank then uses on its own channels."""
    return lambda t: tp.psum(t, partial_grad=True)


def _mamba1_local(p: dict, tp: ModelAxis) -> dict:
    """This rank's slice of a mamba-1 layer's parameters: the d_inner
    channels [c0, c1) over ``model``; ``c0``/``c1`` under those keys."""
    out = {}
    for name, dim in (("conv_w", 1), ("conv_b", 0), ("x_proj", 0), ("dt_w", 1), ("dt_b", 0),
                      ("A_log", 0), ("D", 0), ("out_proj", 0)):
        out[name], out["c0"], out["c1"] = tp.param(p[name], dim)
    return out


def _mamba1_inputs(p: dict, cfg: ModelConfig, xz: torch.Tensor):
    """(p, tp, x, z) of a mamba-1 block from its in_proj output. On a
    DTensor the output is gathered over ``model`` and x and z are cut to
    this rank's d_inner channels, with p cut alike (``tp``; None on plain
    tensors)."""
    if not isinstance(xz, DTensor):
        x, z = xz.chunk(2, dim=-1)
        return p, None, x, z
    tp = ModelAxis(xz)
    p = _mamba1_local(p, tp)
    xz, c0, c1, di = tp.whole_rows(xz, partial_grad=True), p["c0"], p["c1"], cfg.d_inner
    return p, tp, xz[..., c0:c1], xz[..., di + c0:di + c1]


def _mamba1_core(p: dict, cfg: ModelConfig, x: torch.Tensor, h0: torch.Tensor, reduce=_same):
    """Chunked selective scan. x: (B, S, di) post-conv post-silu activations.
    h0: (B, di, N) carried state. Returns (y, h_last). On a slice of the
    channels, ``reduce`` sums the x_proj partial products over the slices."""
    B, S, di = x.shape
    N, R, Q = cfg.ssm_state, cfg.dt_rank, min(cfg.ssm_chunk, S)
    assert S % Q == 0, (S, Q)

    proj = reduce(matmul(x, p["x_proj"]).float())  # (B, S, R+2N)
    dt_r, Bm, Cm = proj[..., :R], proj[..., R: R + N], proj[..., R + N:]
    dt = F.softplus(dt_r @ p["dt_w"].float() + p["dt_b"])  # (B, S, di)
    A = -torch.exp(p["A_log"])  # (di, N)
    xf = x.float()

    h, ys = h0, []
    for c0 in range(0, S, Q):
        dt_c, B_c, C_c, x_c = (t[:, c0:c0 + Q] for t in (dt, Bm, Cm, xf))
        dA = torch.exp(dt_c[..., None] * A)                   # (B,Q,di,N)
        dBx = (dt_c * x_c)[..., None] * B_c[:, :, None, :]    # (B,Q,di,N)
        # intra-chunk linear recurrence h_t = dA_t h_{t-1} + dBx_t (a list
        # and one stack: autograd keeps no per-step copy of a buffer)
        steps = []
        for t in range(Q):
            h = dA[:, t] * h + dBx[:, t]
            steps.append(h)
        ys.append(torch.einsum("bqn,bqdn->bqd", C_c, torch.stack(steps, dim=1)))
    y = torch.cat(ys, dim=1) + xf * p["D"]
    return y, h


def mamba1_forward(p: dict, cfg: ModelConfig, u: torch.Tensor, h0=None):
    """Full block. u: (B, S, d_model) -> ((B, S, d_model), h_last).

    On DTensors each rank runs the conv and the scan on its own d_inner
    channels (``ModelAxis``): the in_proj output is gathered over
    ``model``, x_proj's partial products are all-reduced, and the output
    is left pending its sum over ``model`` (h_last sharded on d_inner)."""
    xz = constrain(matmul(u, p["in_proj"]), "inner")  # SP -> TP: d_inner sharded
    p, tp, x, z = _mamba1_inputs(p, cfg, xz)
    x = F.silu(_causal_conv(x, p["conv_w"], p["conv_b"]))
    if h0 is None:
        h0 = torch.zeros((x.shape[0], x.shape[-1], cfg.ssm_state), dtype=torch.float32, device=x.device)
    y, h_last = _mamba1_core(p, cfg, x, h0, _same if tp is None else _psum_split(tp))
    y = (y * F.silu(z.float())).to(u.dtype)
    out = matmul(y, p["out_proj"])
    if tp is None:
        return out, h_last
    return tp.wrap(out, partial=True), tp.wrap(h_last, 1, cfg.d_inner)


def mamba1_decode(p: dict, cfg: ModelConfig, u: torch.Tensor, h: torch.Tensor, conv_buf: torch.Tensor):
    """Single-token step. u: (B, d); h: (B, di, N); conv_buf: (B, K-1, di).
    Returns (y (B, d), h_new, conv_buf_new)."""
    N, R = cfg.ssm_state, cfg.dt_rank
    p, tp, x, z = _mamba1_inputs(p, cfg, matmul(u, p["in_proj"]))  # (B, di)
    reduce = _same
    if tp is not None:  # as in mamba1_forward, on this rank's channels
        h, conv_buf, reduce = tp.local(h, 1), tp.local(conv_buf, 2), _psum_split(tp)
    window = torch.cat([conv_buf, x[:, None]], dim=1)  # (B, K, di)
    x = F.silu(_conv_step(window, p["conv_w"], p["conv_b"])).to(u.dtype)

    proj = reduce(matmul(x, p["x_proj"]).float())
    dt_r, Bm, Cm = proj[..., :R], proj[..., R: R + N], proj[..., R + N:]
    dt = F.softplus(dt_r @ p["dt_w"].float() + p["dt_b"])  # (B, di)
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt[..., None] * A)                     # (B, di, N)
    dBx = (dt * x.float())[..., None] * Bm[:, None, :]
    h_new = dA * h + dBx
    y = torch.einsum("bn,bdn->bd", Cm, h_new) + x.float() * p["D"]
    y = (y * F.silu(z.float())).to(u.dtype)
    out = matmul(y, p["out_proj"])
    if tp is None:
        return out, h_new, window[:, 1:]
    return (tp.wrap(out, partial=True), tp.wrap(h_new, 1, cfg.d_inner),
            tp.wrap(window[:, 1:], 2, cfg.d_inner))


# =============================================================== mamba-2
def mamba2_specs(cfg: ModelConfig) -> dict:
    d, di, N, K = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    H = cfg.ssm_nheads
    return {
        "in_proj": TensorSpec((d, 2 * di + 2 * N + H), ("embed", "ssm_inner")),
        "conv_w": TensorSpec((K, di + 2 * N), (None, "ssm_inner")),
        "conv_b": TensorSpec((di + 2 * N,), ("ssm_inner",), init="zeros"),
        "A_log": TensorSpec((H,), ("ssm_heads",), init="ssm_a", dtype=torch.float32),
        "dt_b": TensorSpec((H,), ("ssm_heads",), init="ssm_dt", dtype=torch.float32),
        "D": TensorSpec((H,), ("ssm_heads",), init="ones", dtype=torch.float32),
        "norm": TensorSpec((di,), ("ssm_inner",), init="ones"),
        "out_proj": TensorSpec((di, d), ("ssm_inner", "embed")),
    }


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., Q) decay logs -> (..., Q, Q) lower-triangular pairwise sums:
    out[i, j] = sum_{j < t <= i} a_t  (i >= j), -inf above diagonal."""
    Q = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]  # sum_(j,i] when i>=j
    i = torch.arange(Q, device=a.device)
    keep = i[:, None] >= i[None, :]
    return torch.where(keep, diff, float("-inf"))


def _mamba2_core(cfg, dt, A, Bm, Cm, X, h):
    """Chunked SSD. dt: (B,S,H); Bm/Cm: (B,S,N); X: (B,S,H,P); h: (B,H,P,N)."""
    S = dt.shape[1]
    Q = min(cfg.ssm_chunk, S)
    assert S % Q == 0
    ys = []
    for c0 in range(0, S, Q):
        dt_c, B_c, C_c, x_c = (t[:, c0:c0 + Q] for t in (dt, Bm, Cm, X))
        a = (dt_c * A).transpose(1, 2)                           # (B,H,Q) decay logs
        L = torch.exp(_segsum(a))                                # (B,H,Q,Q)
        xdt = x_c * dt_c[..., None]                              # (B,Q,H,P)
        # intra-chunk (diagonal blocks)
        y_diag = torch.einsum("bqn,bkn,bhqk,bkhp->bqhp", C_c, B_c, L, xdt)
        # inter-chunk: contribution of carried state
        cum = torch.cumsum(a, dim=-1)                            # (B,H,Q)
        y_inter = torch.einsum("bqn,bhq,bhpn->bqhp", C_c, torch.exp(cum), h)
        # state update
        decay_to_end = torch.exp(cum[..., -1:] - cum)            # (B,H,Q)
        new_contrib = torch.einsum("bkn,bhk,bkhp->bhpn", B_c, decay_to_end, xdt)
        h = torch.exp(cum[..., -1])[..., None, None] * h + new_contrib
        ys.append(y_diag + y_inter)
    return torch.cat(ys, dim=1), h


def _rms(x, scale, eps, tp: Optional[ModelAxis] = None, width: int = 0):
    """RMSNorm over the last dim; on a slice of it (``tp``) the sum of
    squares is all-reduced over ``model`` and divided by the full ``width``."""
    xf = x.float()
    if tp is None:
        ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    else:
        ms = tp.psum(torch.sum(xf * xf, dim=-1, keepdim=True), partial_grad=True) / width
    return xf * torch.rsqrt(ms + eps) * scale.float()


def _mamba2_local(p: dict, cfg: ModelConfig, tp: ModelAxis) -> dict:
    """This rank's slice of a mamba-2 layer's parameters: heads [h0, h1)
    and their d_inner channels [c0, c1) over ``model``, and the slice
    [a0, a1) of the conv's x|B|C channels. Refuses a head split that the
    channel split does not follow."""
    P = cfg.ssm_head_dim
    out = {}
    out["conv_w"], out["a0"], out["a1"] = tp.param(p["conv_w"], 1)
    out["conv_b"] = tp.param(p["conv_b"], 0)[0]
    for name in ("A_log", "dt_b", "D"):
        out[name], out["h0"], out["h1"] = tp.param(p[name], 0)
    out["norm"], c0, c1 = tp.param(p["norm"], 0)
    out["out_proj"] = tp.param(p["out_proj"], 0)[0]
    if (c0, c1) != (out["h0"] * P, out["h1"] * P):
        raise ValueError(f"d_inner slice [{c0}, {c1}) does not follow the head slice "
                         f"[{out['h0']}, {out['h1']}) x {P}")
    return out


def _mamba2_inputs(p: dict, cfg: ModelConfig, zxbcdt: torch.Tensor, conv):
    """(p, tp, z, x, Bm, Cm, dt) of a mamba-2 block from its in_proj output,
    after ``conv`` (the causal conv + silu of the x|B|C channels). On a
    DTensor the in_proj output is gathered over ``model``, the conv runs on
    this rank's slice of its channels and is gathered back, and z, x and dt
    are cut to this rank's heads (``tp``; None on plain tensors)."""
    di, N = cfg.d_inner, cfg.ssm_state
    if not isinstance(zxbcdt, DTensor):
        z, xbc, dt = _split_zxbcdt(cfg, zxbcdt)
        x, Bm, Cm = torch.tensor_split(conv(xbc, p), [di, di + N], dim=-1)
        return p, None, z, x, Bm, Cm, dt
    tp = ModelAxis(zxbcdt)
    p = _mamba2_local(p, cfg, tp)
    z, xbc, dt = _split_zxbcdt(cfg, tp.whole_rows(zxbcdt, partial_grad=True))
    xbc = tp.gather(conv(xbc[..., p["a0"]:p["a1"]], p), xbc.ndim - 1, di + 2 * N, partial_grad=True)
    x, Bm, Cm = torch.tensor_split(xbc, [di, di + N], dim=-1)
    c0, c1 = p["h0"] * cfg.ssm_head_dim, p["h1"] * cfg.ssm_head_dim
    return p, tp, z[..., c0:c1], x[..., c0:c1], Bm, Cm, dt[..., p["h0"]:p["h1"]]


def _split_zxbcdt(cfg: ModelConfig, zxbcdt: torch.Tensor):
    di, N = cfg.d_inner, cfg.ssm_state
    return torch.tensor_split(zxbcdt, [di, 2 * di + 2 * N], dim=-1)


def mamba2_forward(p: dict, cfg: ModelConfig, u: torch.Tensor, h0=None):
    """Full SSD block. u: (B, S, d) -> ((B, S, d), h_last)."""
    di, N, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    zxbcdt = constrain(matmul(u, p["in_proj"]), "inner")  # SP -> TP: d_inner sharded
    conv = lambda xbc, p: F.silu(_causal_conv(xbc, p["conv_w"], p["conv_b"]))
    p, tp, z, x, Bm, Cm, dt = _mamba2_inputs(p, cfg, zxbcdt, conv)
    B, S, H = dt.shape
    X = x.reshape(B, S, H, P).float()
    dtf = F.softplus(dt.float() + p["dt_b"])                     # (B,S,H)
    A = -torch.exp(p["A_log"])                                   # (H,)
    if h0 is None:
        h0 = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    Y, h_last = _mamba2_core(cfg, dtf, A, Bm.float(), Cm.float(), X, h0)
    Y = Y + X * p["D"][None, None, :, None]
    y = Y.reshape(B, S, H * P) * F.silu(z.float())
    y = _rms(y, p["norm"], cfg.norm_eps, tp, di).to(u.dtype)
    out = matmul(y, p["out_proj"])
    if tp is None:
        return out, h_last
    return tp.wrap(out, partial=True), tp.wrap(h_last, 1, cfg.ssm_nheads)


def mamba2_decode(p: dict, cfg: ModelConfig, u: torch.Tensor, h: torch.Tensor, conv_buf: torch.Tensor):
    """Single-token SSD step. u: (B, d); h: (B, H, P, N); conv_buf: (B, K-1, di+2N)."""
    di, N, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    zxbcdt = matmul(u, p["in_proj"])
    if isinstance(zxbcdt, DTensor):
        tp = ModelAxis(zxbcdt)
        h, conv_buf = tp.local(h, 1), tp.local(conv_buf, 2)
    windows = []

    def conv(xbc, p):
        windows.append(torch.cat([conv_buf, xbc[:, None]], dim=1))
        return F.silu(_conv_step(windows[0], p["conv_w"], p["conv_b"]))

    p, tp, z, x, Bm, Cm, dt = _mamba2_inputs(p, cfg, zxbcdt, conv)
    H = dt.shape[-1]
    X = x.reshape(-1, H, P)
    dtf = F.softplus(dt.float() + p["dt_b"])                     # (B,H)
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dtf * A)                                      # (B,H)
    h_new = dA[..., None, None] * h + torch.einsum("bn,bh,bhp->bhpn", Bm, dtf, X)
    y = torch.einsum("bn,bhpn->bhp", Cm, h_new) + X * p["D"][None, :, None]
    y = y.reshape(-1, H * P) * F.silu(z.float())
    y = _rms(y, p["norm"], cfg.norm_eps, tp, di).to(u.dtype)
    out = matmul(y, p["out_proj"])
    if tp is None:
        return out, h_new, windows[0][:, 1:]
    return (tp.wrap(out, partial=True), tp.wrap(h_new, 1, cfg.ssm_nheads),
            tp.wrap(windows[0][:, 1:], 2, di + 2 * N))
