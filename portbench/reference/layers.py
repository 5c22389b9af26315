"""Plain layers of the reference network, on a flat dict of leaves.

``conv_dtype`` is the precision the configuration states for the
convolutions' operands (``"bfloat16"``); ``"fp8"`` is the control, one step
below it: the operands rounded to float8 e4m3 with a per-tensor scale
(straight through in the backward pass), then computed as bfloat16. A
convolution's result is rounded to bfloat16 and carried on in float32;
everything else is float32.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

Leaves = Dict[str, torch.Tensor]
FP8_MAX = 448.0


def lowered(x: torch.Tensor, conv_dtype: str) -> torch.Tensor:
    """``x`` as the products' operand: bfloat16, or fp8 values held in
    bfloat16 for the control."""
    if conv_dtype == "bfloat16":
        return x.to(torch.bfloat16)
    if conv_dtype != "fp8":
        raise ValueError(f"conv_dtype must be 'bfloat16' or 'fp8', got {conv_dtype!r}")
    xf = x.float()
    scale = xf.detach().abs().amax().clamp(min=1e-12) / FP8_MAX
    q = (xf / scale).to(torch.float8_e4m3fn).float() * scale
    return (xf + (q - xf).detach()).to(torch.bfloat16)


def conv(x: torch.Tensor, w: torch.Tensor, conv_dtype: str, stride: int = 1, padding: int = 0,
         bias: torch.Tensor = None, transposed: bool = False) -> torch.Tensor:
    """A convolution (``transposed``: its adjoint, ``w`` as ``(cin, cout, k,
    k)``) of ``conv_dtype`` operands with a bfloat16 result, in float32, plus
    a float32 bias."""
    xl, wl = lowered(x, conv_dtype), lowered(w, conv_dtype)
    if transposed:
        y = F.conv_transpose2d(xl, wl, stride=stride, padding=padding)
    else:
        y = F.conv2d(xl, wl, stride=stride, padding=padding)
    y = y.float()
    return y if bias is None else y + bias[:, None, None]


def batch_norm(x: torch.Tensor, p: Leaves, prefix: str, eps: float) -> torch.Tensor:
    """Training-mode batch norm of NCHW ``x`` in float32: the batch's mean
    and biased variance per channel, then ``weight`` and ``bias``."""
    return F.batch_norm(x, None, None, p[prefix + ".weight"], p[prefix + ".bias"], training=True,
                        eps=eps)


LECUN_TRUNCATION = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


def make_leaves(specs: List[tuple], generator: torch.Generator, device) -> Leaves:
    """Leaves from ``(name, shape, init)`` specs, drawn in one call on
    ``device``: ``("lecun", fan_in)`` a unit normal clipped to +-2 scaled to
    variance 1/fan_in, ``("const", value)``."""
    drawn = [s for s in specs if s[2][0] == "lecun"]
    total = sum(math.prod(s[1]) for s in drawn)
    z = torch.randn(total, generator=generator, device=device)
    out, at = {}, 0
    for name, shape, init in specs:
        if init[0] == "lecun":
            n = math.prod(shape)
            std = math.sqrt(1.0 / init[1]) / LECUN_TRUNCATION
            out[name] = (z[at:at + n].clamp(-2.0, 2.0) * std).reshape(shape)
            at += n
        else:
            out[name] = torch.full(shape, float(init[1]), device=device)
    return out


class Adam:
    """Adam with bias correction on a dict of leaves, in float32."""

    def __init__(self, lr: float, b1: float, b2: float, eps: float):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m: Leaves = {}
        self.v: Leaves = {}
        self.t = 0

    def step(self, params: Leaves, grads: Leaves) -> Leaves:
        self.t += 1
        out = {}
        for k, p in params.items():
            g = grads[k]
            m = self.m.get(k, torch.zeros_like(p)) * self.b1 + (1 - self.b1) * g
            v = self.v.get(k, torch.zeros_like(p)) * self.b2 + (1 - self.b2) * g * g
            self.m[k], self.v[k] = m, v
            mhat = m / (1 - self.b1 ** self.t)
            vhat = v / (1 - self.b2 ** self.t)
            out[k] = p - self.lr * mhat / (vhat.sqrt() + self.eps)
        return out
