"""Weight-only int8/int4 quantization for serving artifacts.

PyTorch port of ``accvlab_tpu/models/quantize.py``. Small-batch serving
streams every weight from memory per call while the activations stay small;
per-output-channel symmetric int8 cuts that stream, the artifact and the
checkpoint about 4x against float32, nibble-packed int4 with grouped scales
about 8x. Activations stay float; :func:`freeze_params_quantized` puts the
dequantization inside the served function, so an exported program holds the
int8/uint8 tensors and dequantizes them per call.

**The storage is the JAX package's, number for number.** A port parameter
is quantized in its flax layout (:mod:`.params`): a conv kernel OIHW here is
HWIO in flax, whose last axis is the output channel and whose flattened
reduction rows run (H, W, I). ``q`` and ``scale`` are those of
``accvlab_tpu.models.quantize`` on the same weights, and
:meth:`QuantizedTensor.dequantize` returns the port's layout again. Layouts
known here: ``"conv"`` (OIHW <-> HWIO), ``"dense"`` (``Linear`` weight <->
flax kernel) and ``"same"``; a tensor of any other parameter (a plain dict,
PETR's attention projections) is quantized as it lies, its last axis the
channel.

Typical flow::

    qp = quantize_params(model)                         # dict name -> tensor | QuantizedTensor
    fn = freeze_params_quantized(model, qp)             # dequant inside the call
    art = export_inference(fn, (example,), ...)         # int8 constants baked
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch
import torch.utils._pytree as pytree
from torch import nn

#: tensors smaller than this many elements stay unquantized (biases, norm
#: scales: negligible bytes, disproportionate accuracy cost)
_DEFAULT_MIN_SIZE = 1024

#: port layout -> flax layout, and back, per layout name
_LAYOUTS: Dict[str, tuple] = {
    "same": (lambda w: w, lambda w: w),
    "conv": (lambda w: w.permute(2, 3, 1, 0), lambda w: w.permute(3, 2, 0, 1)),
    "dense": (lambda w: w.t(), lambda w: w.t()),
}


class QuantizedTensor:
    """A quantized weight, ``values ~= q * scale`` in flax's layout.

    * ``bits=8``: int8 ``q`` in the flax shape, per-last-axis (output
      channel) float32 scales ``(1, ..., 1, C)``.
    * ``bits=4``: two's-complement nibbles packed two per uint8 over the
      flattened reduction rows (``q`` is ``(rows_padded / 2, C)``), with
      per-``group_size``-rows x per-channel scales ``(G, 1, C)``.

    ``shape`` is the port parameter's shape (what :meth:`dequantize`
    returns); ``layout`` names the port <-> flax layout. A registered pytree
    node whose children are ``(q, scale)``.
    """

    def __init__(self, q, scale, orig_dtype="float32", *, bits=8, logical_shape=None,
                 group_size=None, layout="same"):
        self.q = q
        self.scale = scale
        self.orig_dtype = str(orig_dtype).replace("torch.", "")
        self.bits = int(bits)
        self._logical_shape = tuple(logical_shape) if logical_shape is not None else None
        self.group_size = group_size
        if layout not in _LAYOUTS:
            raise ValueError(f"layout must be one of {tuple(_LAYOUTS)}, got {layout!r}")
        self.layout = layout

    @property
    def flax_shape(self):
        """The weight's shape in flax's layout."""
        return self._logical_shape or tuple(self.q.shape)

    @property
    def shape(self):
        return tuple(_LAYOUTS[self.layout][1](torch.empty(self.flax_shape, device="meta")).shape)

    def dequantize(self, dtype=None) -> torch.Tensor:
        dt = getattr(torch, dtype or self.orig_dtype) if not isinstance(dtype, torch.dtype) \
            else dtype
        to_port = _LAYOUTS[self.layout][1]
        if self.bits == 8:
            return to_port((self.q.to(torch.float32) * self.scale).to(dt))
        # int4: unpack nibble pairs -> rows, broadcast group scales, slice
        shape = self._logical_shape
        c = shape[-1]
        rows = math.prod(shape[:-1]) if len(shape) > 1 else 1
        lo = self.q & 0x0F
        hi = self.q >> 4

        def dec(n):  # two's-complement nibble: [0..15] -> [-8..7]
            return (n.to(torch.int8) ^ 8) - 8

        q_rows = torch.stack([dec(lo), dec(hi)], dim=1).reshape(-1, c)
        g = self.scale.shape[0]
        per_group = q_rows.shape[0] // g
        scale_rows = self.scale.expand(g, per_group, c).reshape(-1, c)
        w = (q_rows.to(torch.float32) * scale_rows)[:rows]
        return to_port(w.reshape(shape).to(dt))

    def __repr__(self):
        return (f"QuantizedTensor(shape={tuple(self.shape)}, bits={self.bits}, "
                f"orig_dtype={self.orig_dtype}, layout={self.layout})")


pytree.register_pytree_node(
    QuantizedTensor,
    lambda qt: ([qt.q, qt.scale],
                (qt.orig_dtype, qt.bits, qt._logical_shape, qt.group_size, qt.layout)),
    lambda children, aux: QuantizedTensor(children[0], children[1], aux[0], bits=aux[1],
                                          logical_shape=aux[2], group_size=aux[3],
                                          layout=aux[4]),
    serialized_type_name="accvlab_tpu_torch.models.quantize.QuantizedTensor",
    to_dumpable_context=list,
    from_dumpable_context=lambda c: (c[0], c[1], None if c[2] is None else tuple(c[2]),
                                     c[3], c[4]),
)


def _quantize_leaf(w: torch.Tensor, layout: str = "same") -> QuantizedTensor:
    """Per-output-channel (last axis of the flax layout) symmetric int8:
    ``scale = amax / 127``."""
    w32 = _LAYOUTS[layout][0](w.detach()).to(torch.float32)
    amax = torch.amax(torch.abs(w32), dim=tuple(range(w32.ndim - 1)), keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return QuantizedTensor(q, scale, w.dtype, layout=layout)


def _quantize_leaf_int4(w: torch.Tensor, group_size: Optional[int],
                        layout: str = "same") -> QuantizedTensor:
    """Grouped symmetric int4: the flattened reduction rows (of the flax
    layout) split into ``group_size``-row groups, each with its own
    per-channel scale (``amax / 7``); nibbles pack two rows per uint8."""
    wf = _LAYOUTS[layout][0](w.detach())
    shape = tuple(wf.shape)
    w32 = wf.to(torch.float32).reshape(-1, shape[-1])
    rows, c = w32.shape
    gs = rows if group_size is None else int(group_size)
    if gs < 1:
        raise ValueError(f"group_size={group_size} must be >= 1")
    n_groups = -(-rows // gs)
    if (n_groups * gs) % 2:
        # nibble pairs need an even row count: one extra all-padding group
        # (its amax is 0 -> scale 1, its nibbles decode to 0)
        n_groups += 1
    rows_p = n_groups * gs
    w_pad = torch.nn.functional.pad(w32, (0, 0, 0, rows_p - rows))
    wg = w_pad.reshape(n_groups, gs, c)
    amax = torch.amax(torch.abs(wg), dim=1, keepdim=True)  # (G, 1, C)
    scale = torch.where(amax > 0, amax / 7.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(wg / scale), -7, 7).to(torch.int8)
    nib = q.reshape(rows_p, c).to(torch.uint8) & 0x0F
    packed = nib[0::2] | (nib[1::2] << 4)  # (rows_p / 2, C)
    return QuantizedTensor(packed, scale, w.dtype, bits=4, logical_shape=shape,
                           group_size=gs, layout=layout)


def param_layouts(model: nn.Module) -> Dict[str, str]:
    """Parameter name -> layout name of a model :mod:`.params` knows
    (``"same"`` for a parameter with another layout)."""
    from . import params as P

    names = {id(p): n for n, p in model.named_parameters()}
    kinds = {id(P.CONV): "conv", id(P.DENSE): "dense"}
    try:
        leaves = P._leaves(model)
    except TypeError:
        return {n: "same" for n in names.values()}
    out = {n: "same" for n in names.values()}
    for param, layout in leaves.values():
        out[names[id(param)]] = kinds.get(id(layout), "same")
    return out


def quantize_params(
    params: Union[nn.Module, Dict[str, torch.Tensor]],
    *,
    min_size: int = _DEFAULT_MIN_SIZE,
    predicate: Optional[Callable[[torch.Tensor], bool]] = None,
    bits: int = 8,
    group_size: Optional[int] = None,
) -> Dict[str, Union[torch.Tensor, QuantizedTensor]]:
    """Quantize every float tensor with ``ndim >= 2`` and ``numel >=
    min_size``; the others stay as they are.

    ``params``: a module (its parameters by name, each quantized in its flax
    layout, :func:`param_layouts`) or a dict of name -> tensor or numpy array
    (quantized as they lie); a dict may already hold :class:`QuantizedTensor`s, which are
    kept (idempotent). ``predicate(tensor) -> bool`` overrides the default
    rule. ``bits``: 8 or 4; ``group_size``: int4 rows per scale group
    (``None``: one group). Returns name -> tensor or QuantizedTensor.
    """
    if bits not in (8, 4):
        raise ValueError(f"bits={bits} must be 8 or 4")
    if bits == 8 and group_size is not None:
        raise ValueError("group_size applies to bits=4 only")
    if isinstance(params, nn.Module):
        layouts = param_layouts(params)
        params = {n: p.detach() for n, p in params.named_parameters()}
    else:
        layouts = {}
        params = {n: torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray)
                  else v for n, v in params.items()}

    def should(leaf) -> bool:
        if isinstance(leaf, QuantizedTensor):
            return False  # never re-quantize (nor its scales)
        if predicate is not None:
            return bool(predicate(leaf))
        return (isinstance(leaf, torch.Tensor) and leaf.ndim >= 2
                and leaf.dtype.is_floating_point and leaf.numel() >= min_size)

    def quant(name, w):
        layout = layouts.get(name, "same")
        if bits == 8:
            return _quantize_leaf(w, layout)
        return _quantize_leaf_int4(w, group_size, layout)

    return {n: quant(n, w) if should(w) else w for n, w in params.items()}


def dequantize_params(qparams: Dict, dtype=None) -> Dict[str, torch.Tensor]:
    """The float tensors again (traceable: use it inside the served function
    so that the quantized tensors are what an export holds)."""
    return {n: v.dequantize(dtype) if isinstance(v, QuantizedTensor) else v
            for n, v in qparams.items()}


def freeze_params_quantized(model: nn.Module, qparams: Dict, dtype=None) -> Callable:
    """``fn(*args)``: ``model`` called with the dequantized ``qparams``
    (``torch.func.functional_call``), the quantized counterpart of
    :func:`.serving.freeze_params`."""

    def frozen(*args):
        return torch.func.functional_call(model, dequantize_params(qparams, dtype), args)

    return frozen


def params_nbytes(params) -> int:
    """Total bytes (a QuantizedTensor counts ``q`` plus its float32 scales),
    for reporting the quantization win. ``params``: a module, a dict or any
    pytree of tensors."""
    if isinstance(params, nn.Module):
        params = dict(params.named_parameters())
    total = 0
    for leaf in pytree.tree_leaves(params, is_leaf=lambda x: isinstance(x, QuantizedTensor)):
        if isinstance(leaf, QuantizedTensor):
            total += leaf.q.numel() * leaf.q.element_size() + leaf.scale.numel() * 4
        elif isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
    return total
