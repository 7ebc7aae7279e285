"""JPEG-Lossless-style codec (DICOM transfer syntax 1.2.840.10008.1.2.4.70).

The paper's scrub stage recompresses blanked images with the JPEG Lossless
syntax. Real JPEG-Lossless = per-pixel predictor (selection values 1-7) +
Huffman entropy coding. We implement the same two-phase structure:

* **prediction** — vectorizable; the numpy implementation here doubles as the
  oracle for the CUDA ``kernels/fused`` residual kernel (prediction is pointwise on
  shifted planes, a perfect VPU workload);
* **entropy coding** — Golomb-Rice with per-image parameter + escape codes.
  The coder is split into two phases (DESIGN.md §12): a **plan** phase
  (:func:`rice_plan`) that derives the zigzag magnitudes, the Rice parameter
  ``k``, per-symbol code lengths, and their prefix-sum bit offsets — all
  vectorizable, and computable on the accelerator by the ``kernels/jls``
  entropy pre-pass — and a **pack** phase (:func:`rice_pack`) that splices
  the variable-length codes into the final bitstream with word-level
  scatter-OR writes. Only the pack splice is inherently host work.

Round-trips are exact (lossless) — asserted by unit + property tests.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

MAGIC = b"RJLS"
_QMAX = 23  # unary quotient cap; larger quotients use a 32-bit escape


# --------------------------------------------------------------- prediction
def predict(img: np.ndarray, sv: int = 1) -> np.ndarray:
    """Predicted plane for selection value ``sv`` (JPEG lossless T.81 Annex H).

    Border convention: (0,0) predicted by 2^(P-1); row 0 by Ra (left);
    column 0 by Rb (above). Works on any unsigned integer dtype.
    """
    if img.ndim != 2:
        raise ValueError("predict expects a 2D plane")
    bits = img.dtype.itemsize * 8
    x = img.astype(np.int64)
    ra = np.empty_like(x)  # left
    rb = np.empty_like(x)  # above
    rc = np.empty_like(x)  # above-left
    ra[:, 1:], ra[:, 0] = x[:, :-1], 0
    rb[1:, :], rb[0, :] = x[:-1, :], 0
    rc[1:, 1:], rc[0, :], rc[1:, 0] = x[:-1, :-1], 0, 0

    if sv == 1:
        pred = ra
    elif sv == 2:
        pred = rb
    elif sv == 3:
        pred = rc
    elif sv == 4:
        pred = ra + rb - rc
    elif sv == 5:
        pred = ra + ((rb - rc) >> 1)
    elif sv == 6:
        pred = rb + ((ra - rc) >> 1)
    elif sv == 7:
        pred = (ra + rb) >> 1
    else:
        raise ValueError(f"selection value must be 1..7, got {sv}")

    # border overrides (same for every sv)
    pred[0, 1:] = ra[0, 1:]
    pred[1:, 0] = rb[1:, 0]
    pred[0, 0] = 1 << (bits - 1)
    return pred


def residuals(img: np.ndarray, sv: int = 1) -> np.ndarray:
    """Signed modulo-2^P residuals, centered in [-2^(P-1), 2^(P-1))."""
    bits = img.dtype.itemsize * 8
    mask = (1 << bits) - 1
    r = (img.astype(np.int64) - predict(img, sv)) & mask
    r = np.where(r >= (1 << (bits - 1)), r - (1 << bits), r)
    return r.astype(np.int32)


def residuals_batch(imgs: np.ndarray, sv: int = 1) -> np.ndarray:
    """Batched :func:`residuals` over a uniform (N, H, W) stack.

    Bit-identical to calling :func:`residuals` per plane (property-tested) —
    the predictor is pointwise over shifted planes, so batching just moves
    the shifts one axis over. Used by the batched executor's host path so a
    chunk pays one vectorized pass instead of N small ones.
    """
    if imgs.ndim != 3:
        raise ValueError("residuals_batch expects an (N, H, W) stack")
    bits = imgs.dtype.itemsize * 8
    x = imgs.astype(np.int64)
    N, H, W = x.shape
    zc = np.zeros((N, H, 1), np.int64)
    zr = np.zeros((N, 1, W), np.int64)
    ra = np.concatenate([zc, x[:, :, :-1]], axis=2)   # left
    rb = np.concatenate([zr, x[:, :-1, :]], axis=1)   # above
    rc = np.concatenate([zr, ra[:, :-1, :]], axis=1)  # above-left

    if sv == 1:
        pred = ra
    elif sv == 2:
        pred = rb
    elif sv == 3:
        pred = rc
    elif sv == 4:
        pred = ra + rb - rc
    elif sv == 5:
        pred = ra + ((rb - rc) >> 1)
    elif sv == 6:
        pred = rb + ((ra - rc) >> 1)
    elif sv == 7:
        pred = (ra + rb) >> 1
    else:
        raise ValueError(f"selection value must be 1..7, got {sv}")

    pred[:, 0, 1:] = ra[:, 0, 1:]
    pred[:, 1:, 0] = rb[:, 1:, 0]
    pred[:, 0, 0] = 1 << (bits - 1)

    mask = (1 << bits) - 1
    r = (x - pred) & mask
    r = np.where(r >= (1 << (bits - 1)), r - (1 << bits), r)
    return r.astype(np.int32)


def reconstruct(res: np.ndarray, sv: int, bits: int) -> np.ndarray:
    """Invert :func:`residuals`. sv 1/2 use vectorized cumsum; others loop."""
    mask = (1 << bits) - 1
    r = res.astype(np.int64)
    H, W = r.shape
    if sv == 1:
        # column 0 reconstructs downward, rows reconstruct left->right
        col0 = np.cumsum(r[:, 0], axis=0) + (1 << (bits - 1))
        rows = r.copy()
        rows[:, 0] = col0
        out = np.cumsum(rows, axis=1)
        return (out & mask).astype(np.uint16 if bits > 8 else np.uint8)
    if sv == 2:
        row0 = np.cumsum(r[0, :], axis=0) + (1 << (bits - 1))
        cols = r.copy()
        cols[0, :] = row0
        out = np.cumsum(cols, axis=0)
        return (out & mask).astype(np.uint16 if bits > 8 else np.uint8)
    # general (sequential) path — used only for small images in tests
    out = np.zeros((H, W), np.int64)
    for i in range(H):
        for j in range(W):
            if i == 0 and j == 0:
                pred = 1 << (bits - 1)
            elif i == 0:
                pred = out[0, j - 1]
            elif j == 0:
                pred = out[i - 1, 0]
            else:
                ra, rb, rc = out[i, j - 1], out[i - 1, j], out[i - 1, j - 1]
                pred = {3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
                        6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[sv]
            out[i, j] = (pred + r[i, j]) & mask
    return out.astype(np.uint16 if bits > 8 else np.uint8)


# --------------------------------------------------------------- rice coding
def _zigzag(r: np.ndarray) -> np.ndarray:
    return ((r.astype(np.int64) << 1) ^ (r.astype(np.int64) >> 63)).astype(np.uint64)


def _unzigzag(u: np.ndarray) -> np.ndarray:
    u = u.astype(np.int64)
    return (u >> 1) ^ -(u & 1)


def _rice_k_from_sum(total: int, size: int) -> int:
    """Rice parameter from the exact integer sum of the zigzag magnitudes.

    The exact-sum form lets the device entropy pre-pass hand back per-row
    integer sums and still land on the same ``k`` as the host (bit-identity
    across the two plan paths is what keeps batched == serial).
    """
    mean = total / size if size else 0.0
    k = 0
    while (1 << k) < mean + 1 and k < 30:
        k += 1
    return k


def _rice_k(u: np.ndarray) -> int:
    return _rice_k_from_sum(int(u.sum(dtype=np.uint64)), u.size)


@dataclass
class RicePlan:
    """Phase-1 output of the Golomb-Rice coder: everything except the splice.

    ``u`` are the zigzag magnitudes, ``lens`` the per-symbol code lengths,
    ``offs`` their exclusive prefix-sum bit offsets (len n+1). ``rem`` is the
    optional pre-extracted k-bit remainder word per symbol — the device
    entropy pre-pass hands it back so the host pack never touches ``u`` for
    non-escape symbols.
    """

    k: int
    u: np.ndarray
    q: np.ndarray
    esc: np.ndarray
    lens: np.ndarray
    offs: np.ndarray
    rem: Optional[np.ndarray] = None

    @property
    def total_bits(self) -> int:
        return int(self.offs[-1])


def rice_plan(res: np.ndarray) -> RicePlan:
    """Host plan phase: zigzag, k, quotients, code lengths, bit offsets."""
    u = _zigzag(res.ravel())
    k = _rice_k(u)
    return _plan_from_u(u, k)


def _plan_from_u(u: np.ndarray, k: int) -> RicePlan:
    q = (u >> np.uint64(k)).astype(np.int64)
    esc = q > _QMAX
    # bit lengths: unary(q)+stop + k remainder; escape: QMAX+1 ones + stop + 64 raw
    lens = np.where(esc, _QMAX + 2 + 64, q + 1 + k)
    offs = np.empty(lens.size + 1, np.int64)
    offs[0] = 0
    np.cumsum(lens, out=offs[1:])
    return RicePlan(k=k, u=u, q=q, esc=esc, lens=lens, offs=offs)


def rice_plan_from_prepass(
    u: np.ndarray, k: int, lens: np.ndarray, rem: Optional[np.ndarray] = None
) -> RicePlan:
    """Plan from the device entropy pre-pass (``kernels/jls`` length kernel):
    the device already computed zigzag magnitudes, per-symbol code lengths,
    and remainder words; the host only prefix-sums the lengths. Bit-identical
    to :func:`rice_plan` on the same residuals (parity-tested)."""
    u = u.ravel().astype(np.uint64)
    q = (u >> np.uint64(k)).astype(np.int64)
    esc = q > _QMAX
    lens = lens.ravel().astype(np.int64)
    offs = np.empty(lens.size + 1, np.int64)
    offs[0] = 0
    np.cumsum(lens, out=offs[1:])
    return RicePlan(
        k=k, u=u, q=q, esc=esc, lens=lens, offs=offs,
        rem=None if rem is None else rem.ravel().astype(np.uint64),
    )


def _scatter_field(
    words: np.ndarray, pos: np.ndarray, val: np.ndarray, nbits: np.ndarray
) -> None:
    """OR variable-width bit fields into an MSB-first uint64 word stream.

    ``val`` (uint64) is written so its bit ``nbits-1`` lands at stream bit
    position ``pos``. Fields are <= 64 bits, so each spans at most two words;
    fields never overlap, so scatter-add == scatter-or (``np.add.at`` takes
    the fast unbuffered path).
    """
    idx = (pos >> 6).astype(np.int64)
    sh = 64 - (pos & 63) - nbits  # left shift into the first word (may be <0)
    lo = sh < 0
    first = np.where(
        lo,
        val >> (-sh).clip(min=0).astype(np.uint64),
        val << sh.clip(min=0).astype(np.uint64),
    )
    np.add.at(words, idx, first)
    if lo.any():
        # low -sh bits spill left-aligned into the next word; the uint64
        # left shift drops the already-written high bits for free
        np.add.at(words, idx[lo] + 1, val[lo] << (64 + sh[lo]).astype(np.uint64))


def rice_pack(plan: RicePlan) -> bytes:
    """Pack phase: splice the planned codes into the final byte stream.

    Word-level construction — two vectorized scatter passes (one per field
    kind) over uint64 words instead of materializing one byte per *bit* —
    byte-identical to the legacy bit-array packer (property-tested).
    """
    total = plan.total_bits
    words = np.zeros((total + 63) // 64 + 1, np.uint64)
    offs = plan.offs[:-1]
    k = plan.k
    ne = ~plan.esc
    if ne.any():
        # non-escape: unary(q) ones + stop + k remainder is one contiguous
        # field of q+1+k <= QMAX+1+k bits: ((2^q - 1) << (k+1)) | rem
        q = plan.q[ne].astype(np.uint64)
        rem = (
            plan.rem[ne]
            if plan.rem is not None
            else plan.u[ne] & np.uint64((1 << k) - 1)
        )
        val = (((np.uint64(1) << q) - np.uint64(1)) << np.uint64(k + 1)) | rem
        _scatter_field(words, offs[ne], val, plan.lens[ne])
    if plan.esc.any():
        eoffs = offs[plan.esc]
        ones = np.full(eoffs.size, ((1 << (_QMAX + 1)) - 1) << 1, np.uint64)
        _scatter_field(
            words, eoffs, ones, np.full(eoffs.size, _QMAX + 2, np.int64)
        )
        _scatter_field(
            words,
            eoffs + _QMAX + 2,
            plan.u[plan.esc],
            np.full(eoffs.size, 64, np.int64),
        )
    return words.astype(">u8").tobytes()[: (total + 7) // 8]


def rice_encode(res: np.ndarray) -> Tuple[bytes, int]:
    """Golomb-Rice encoder (plan + pack). Returns (payload, k)."""
    plan = rice_plan(res)
    return rice_pack(plan), plan.k


def rice_decode(payload: bytes, k: int, n: int) -> np.ndarray:
    """Vectorized Golomb-Rice decoder.

    Fast path assumes no escape codes: with a fixed k-bit field after every
    unary terminator, "index of the next terminator zero" is a function of
    the current one alone (``nxt``), so the parse is a pointer chase with an
    O(1) body plus fully vectorized remainder extraction. The first escape
    symbol always surfaces as a decoded quotient of QMAX+1 (the parse is
    exact up to that point), which falls back to the sequential decoder.
    """
    bits = np.unpackbits(np.frombuffer(payload, np.uint8))
    if n == 0:
        return np.empty(0, np.int64)
    zeros = np.flatnonzero(bits == 0)
    Z = zeros.size
    # successor map in terminator-index space: given terminator z, the next
    # terminator is the first zero at/after zeros[z]+1+k; Z is a sticky
    # "ran off the stream" sentinel so gathers never go out of bounds
    nxt = np.empty(Z + 1, np.int64)
    np.searchsorted(zeros, zeros + (1 + k), side="left", sorter=None).astype(
        np.int64
    ).clip(max=Z, out=nxt[:Z])
    nxt[Z] = Z
    t = _chase(nxt, Z, n)
    if t is None or t[-1] >= Z:
        return _rice_decode_sequential(bits, zeros, k, n)
    zpos = zeros[t]
    starts = np.empty(n, np.int64)
    starts[0] = 0
    starts[1:] = zpos[:-1] + 1 + k
    q = zpos - starts
    if (q > _QMAX).any() or (q < 0).any():  # first escape decodes as QMAX+1
        return _rice_decode_sequential(bits, zeros, k, n)
    rem = np.zeros(n, np.uint64)
    for j in range(k):  # k vectorized passes, not n*k scalar reads
        rem = (rem << np.uint64(1)) | bits[zpos + 1 + j].astype(np.uint64)
    return _unzigzag((q.astype(np.uint64) << np.uint64(k)) | rem)


_CHASE_STRIDE = 8


def _chase(nxt: np.ndarray, Z: int, n: int) -> Optional[np.ndarray]:
    """First n elements of the orbit 0, nxt[0], nxt[nxt[0]], ...

    The orbit is inherently sequential, but composing the successor map with
    itself (``g8 = nxt^8``) cuts the Python-level chase to n/8 iterations;
    the skipped intermediates are recovered with 7 vectorized gathers.
    Returns None when the orbit hits the sentinel Z early (invalid parse).
    """
    if n < 4 * _CHASE_STRIDE:
        out = np.empty(n, np.int64)
        cur = 0
        for i in range(n):
            out[i] = cur
            cur = nxt[cur]
        return None if out[-1] >= Z else out
    g2 = nxt[nxt]
    g4 = g2[g2]
    g8 = g4[g4]
    heads = np.empty(n // _CHASE_STRIDE, np.int64)
    cur = 0
    for i in range(heads.size):
        heads[i] = cur
        cur = g8[cur]
    if heads[-1] >= Z:
        return None
    t = np.empty((heads.size + 1) * _CHASE_STRIDE, np.int64)
    cols = t[: heads.size * _CHASE_STRIDE].reshape(heads.size, _CHASE_STRIDE)
    cols[:, 0] = heads
    for j in range(1, _CHASE_STRIDE):
        cols[:, j] = nxt[cols[:, j - 1]]
    for i in range(heads.size * _CHASE_STRIDE, n):  # tail, < STRIDE steps
        t[i] = cur
        cur = nxt[cur]
    return t[:n]


def _rice_decode_sequential(
    bits: np.ndarray, zeros: np.ndarray, k: int, n: int
) -> np.ndarray:
    """Escape-capable sequential parse (list-backed bit reads, O(log Z)
    terminator lookups) — only streams containing escape codes land here."""
    out = np.empty(n, np.uint64)
    bl = bits.tolist()
    p = 0
    for i in range(n):
        zpos = int(zeros[np.searchsorted(zeros, p)])  # the unary terminator
        q = zpos - p
        p = zpos + 1
        if q == _QMAX + 1:  # escape: raw 64-bit
            val = 0
            for j in range(64):
                val = (val << 1) | bl[p + j]
            p += 64
            out[i] = val
        else:
            rem = 0
            for j in range(k):
                rem = (rem << 1) | bl[p + j]
            p += k
            out[i] = (q << k) | rem
    return _unzigzag(out)


# --------------------------------------------------------------- container
def pack_header(h: int, w: int, bits: int, sv: int, k: int, nbytes: int) -> bytes:
    """Plane header: magic, dims, bits, sv, rice k, payload length.

    Single source of truth for the RJLS plane header layout — used by the
    pure-host :func:`encode`, the kernel-assisted ``kernels/jls`` encode path,
    and the fused batch executor, so the three streams stay byte-identical.
    """
    return MAGIC + b"P" + struct.pack("<IIBBBI", h, w, bits, sv, k, nbytes)


def encode(img: np.ndarray, sv: int = 1) -> bytes:
    """Encode a 2D unsigned-int plane. Header: magic, dims, bits, sv, k, nbytes."""
    if img.ndim == 3:  # multi-sample: encode planes back to back
        planes = [encode(img[..., c], sv) for c in range(img.shape[-1])]
        return MAGIC + b"M" + struct.pack("<H", len(planes)) + b"".join(
            struct.pack("<I", len(p)) + p for p in planes
        )
    bits = img.dtype.itemsize * 8
    res = residuals(img, sv)
    payload, k = rice_encode(res)
    return pack_header(img.shape[0], img.shape[1], bits, sv, k, len(payload)) + payload


def decode(buf: bytes) -> np.ndarray:
    if buf[:4] != MAGIC:
        raise ValueError("not an RJLS stream")
    kind = buf[4:5]
    if kind == b"M":
        (nplanes,) = struct.unpack("<H", buf[5:7])
        off = 7
        planes = []
        for _ in range(nplanes):
            (ln,) = struct.unpack("<I", buf[off : off + 4])
            off += 4
            planes.append(decode(buf[off : off + ln]))
            off += ln
        return np.stack(planes, axis=-1)
    H, W, bits, sv, k, nbytes = struct.unpack("<IIBBBI", buf[5:20])
    payload = buf[20 : 20 + nbytes]
    res = rice_decode(payload, k, H * W).reshape(H, W).astype(np.int32)
    return reconstruct(res, sv, bits)


def compression_ratio(img: np.ndarray, sv: int = 1) -> float:
    return img.nbytes / max(1, len(encode(img, sv)))
