"""Bit-reproducible float32 exp and division for heatmap rasterization.

PyTorch counterpart of ``accvlab_tpu/heatmap/repro_exp.py``: the same
pinned algorithm, so the plain PyTorch version, the CUDA kernel
(``csrc/draw_heatmap.cu``, built with ``-fmad=false`` and explicit
round-to-nearest intrinsics) and the numpy twins below give identical bits.

``exp_f32``: Cody-Waite two-constant reduction + degree-6 Taylor evaluated in
compensated (double-single) Horner form, built only from Dekker exact
products, 2Sum additions and exponent bitcasts. Each PyTorch op is its own
kernel, so no multiply can be contracted into an FMA with the add after it;
the algorithm is contraction-immune besides (see the JAX module's docstring).

``div_f32``: IEEE float32 division of two tensors of the same shape is
correctly rounded on the CPU and on CUDA (PyTorch builds without fast math),
so it needs no correction step here. Call it with tensor divisors: a Python
scalar divisor may be turned into a multiplication by its reciprocal.
"""

from __future__ import annotations

import numpy as np
import torch

_F32 = np.float32
LOG2E = _F32(1.4426950408889634)
# musl expf split: ln2_hi has zeroed low bits so k*ln2_hi is exact for |k|<2^9
LN2_HI = _F32(0.693145751953125)  # 0x1.62e400p-1
LN2_LO = _F32(1.428606765330187e-06)  # 0x1.7f7d1cp-20
# Taylor exp(t) = sum t^n / n!
_COEFFS = tuple(
    _F32(v) for v in (1.0, 1.0, 0.5, 1.0 / 6, 1.0 / 24, 1.0 / 120, 1.0 / 720)
)
_MIN_X = _F32(-87.0)  # exp(-87) ~ 1.6e-38, just above f32 min normal
_SPLIT = _F32(4097.0)  # Veltkamp split constant, 2^12 + 1


# ---------------------------------------------------------------------- #
# torch implementation (plain version of the CUDA kernel's exp)          #
# ---------------------------------------------------------------------- #


def _dekker_mul(x, y):
    """Rounded product + exact error: x*y == p + err."""
    p = x * y
    c = float(_SPLIT) * x
    xh = c - (c - x)
    xl = x - xh
    d = float(_SPLIT) * y
    yh = d - (d - y)
    yl = y - yh
    err = ((xh * yh - p) + xh * yl + xl * yh) + xl * yl
    return p, err


def _two_sum(a, b):
    """Rounded sum + exact error (Knuth 2Sum; additions only)."""
    s = a + b
    z = s - a
    e = (a - (s - z)) + (b - z)
    return s, e


def exp_f32(x: torch.Tensor) -> torch.Tensor:
    """Pinned bit-reproducible f32 exp (torch; see module docstring)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    k = torch.round(x * float(LOG2E)).to(torch.int32)  # round half to even = rint
    kf = k.to(torch.float32)
    s = x - kf * float(LN2_HI)  # Sterbenz-exact (k*ln2_hi is an exact product)
    b, _berr = _dekker_mul(kf, torch.full_like(kf, float(LN2_LO)))
    t = s - b  # _berr (~2^-40 relative) is dropped in every twin alike
    hi = torch.full_like(t, float(_COEFFS[6]))
    lo = torch.zeros_like(t)
    for c in _COEFFS[5::-1]:
        qh, qe = _dekker_mul(hi, t)
        lh, le = _dekker_mul(lo, t)
        rh, re = _two_sum(qh, torch.full_like(qh, float(c)))
        hi = rh
        lo = (qe + lh) + (re + le)
    kk = torch.clamp(k, -126, 126)
    scale = ((kk + 127) << 23).view(torch.float32)
    r = hi + lo
    return torch.where(x < float(_MIN_X), torch.zeros_like(r), r * scale)


def div_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Correctly-rounded f32 division (IEEE tensor / tensor)."""
    a = torch.as_tensor(a, dtype=torch.float32)
    b = torch.as_tensor(b, dtype=torch.float32, device=a.device)
    a, b = torch.broadcast_tensors(a, b)
    return a / b.contiguous()


# ---------------------------------------------------------------------- #
# numpy twins (golden oracle; numpy f32 ops are plain IEEE)              #
# ---------------------------------------------------------------------- #


def _dekker_mul_np(x, y):
    p = (x * y).astype(np.float32)
    c = (_SPLIT * x).astype(np.float32)
    xh = (c - (c - x).astype(np.float32)).astype(np.float32)
    xl = (x - xh).astype(np.float32)
    d = (_SPLIT * y).astype(np.float32)
    yh = (d - (d - y).astype(np.float32)).astype(np.float32)
    yl = (y - yh).astype(np.float32)
    err = (
        ((xh * yh).astype(np.float32) - p).astype(np.float32)
        + (xh * yl).astype(np.float32)
    ).astype(np.float32)
    err = (err + (xl * yh).astype(np.float32)).astype(np.float32)
    err = (err + (xl * yl).astype(np.float32)).astype(np.float32)
    return p, err


def _two_sum_np(a, b):
    s = (a + b).astype(np.float32)
    z = (s - a).astype(np.float32)
    e = (
        (a - (s - z).astype(np.float32)).astype(np.float32)
        + (b - z).astype(np.float32)
    ).astype(np.float32)
    return s, e


def exp_f32_np(x):
    """numpy twin of :func:`exp_f32` — identical bits by construction."""
    x = np.asarray(x, np.float32)
    k = np.rint(x * LOG2E).astype(np.int32)
    kf = k.astype(np.float32)
    s = (x - (kf * LN2_HI).astype(np.float32)).astype(np.float32)
    b, _berr = _dekker_mul_np(kf, np.full_like(kf, LN2_LO))
    t = (s - b).astype(np.float32)
    hi = np.full_like(t, _COEFFS[6])
    lo = np.zeros_like(t)
    for c in _COEFFS[5::-1]:
        qh, qe = _dekker_mul_np(hi, t)
        lh, le = _dekker_mul_np(lo, t)
        rh, re = _two_sum_np(qh, np.full_like(qh, c))
        hi = rh
        lo = (
            (qe + lh).astype(np.float32) + (re + le).astype(np.float32)
        ).astype(np.float32)
    kk = np.clip(k, -126, 126)
    scale = ((kk.astype(np.int32) + 127) << 23).view(np.float32)
    r = (hi + lo).astype(np.float32)
    return np.where(x < _MIN_X, np.float32(0.0), (r * scale).astype(np.float32))


def div_f32_np(a, b):
    """numpy twin of :func:`div_f32` — numpy's f32 division is IEEE
    correctly rounded."""
    return (np.asarray(a, np.float32) / np.asarray(b, np.float32)).astype(np.float32)
