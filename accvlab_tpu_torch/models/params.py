"""Parameters of the JAX package's flax models in the port's modules.

``load_jax_params`` fills a :class:`~.centernet.CenterNetDetector` or a
:class:`~.petr.PETRDetector` from the flax variables of the JAX package's
model of the same name, given as nested dicts of numpy arrays::

    {"params": {"ConvBlock_0": {"Conv_0": {"kernel": (3, 3, 3, 64)},
                                "GroupNorm_0": {"scale": (64,), "bias": (64,)}},
                ...,
                "head_heatmap": {"kernel": (1, 1, 128, 10), "bias": (10,)}, ...}}

It also fills the port's
:class:`~accvlab_tpu_torch.lane_regression_training.LaneRegressor` from the
``init_params`` of ``examples/lane_regression_training.py``, a plain dict
``{"w1": (1024, 128), "b1": (128,), .., "w3": (128, 16), "b3": (16,)}``
with no ``"params"`` level.

Layouts: conv kernels are HWIO there and OIHW here; ``Dense`` kernels
``(in, out)`` there and ``Linear`` weights ``(out, in)`` here; the attention's
``DenseGeneral`` kernels ``(dim, heads, head_dim)`` (query, key, value) and
``(heads, head_dim, dim)`` (out) with biases ``(heads, head_dim)`` are
``Linear`` weights over ``heads * head_dim`` features here.
A :class:`~.moe.MoEClassifier` takes the flax tree ``Dense_0``,
``SwitchFFN_0/{router, w_in, w_out}``, ``LayerNorm_0`` and ``Dense_1`` (the
expert weights ``(E, dim, hidden)`` and ``(E, hidden, dim)`` in the same
layout on both sides; a classifier built without ``in_dim`` takes it from
``Dense_0``'s kernel), and a lone :class:`~.moe.SwitchFFN` its
``router``, ``w_in`` and ``w_out``.

``jax_params_of`` is the inverse. No JAX is imported: the caller converts its
arrays with numpy.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple, Union

import numpy as np
import torch
from torch import nn

from .centernet import CenterNetDetector
from .moe import MoEClassifier, SwitchFFN
from .petr import PETRDetector

HWIO_TO_OIHW = (3, 2, 0, 1)
OIHW_TO_HWIO = (2, 3, 1, 0)

Model = Union[CenterNetDetector, PETRDetector, MoEClassifier, SwitchFFN]
#: (to the port's layout, to flax's layout), both on numpy arrays
Layout = Tuple[Callable[[np.ndarray], np.ndarray], Callable[[np.ndarray], np.ndarray]]

SAME: Layout = (lambda a: a, lambda a: a)
CONV: Layout = (lambda a: a.transpose(HWIO_TO_OIHW), lambda a: a.transpose(OIHW_TO_HWIO))
DENSE: Layout = (lambda a: a.T, lambda a: a.T)


def _heads_layouts(heads: int) -> Dict[str, Layout]:
    """DenseGeneral layouts of one attention with ``heads`` heads."""
    def split(a):  # (.., heads * d) -> (.., heads, d)
        return a.reshape(*a.shape[:-1], heads, a.shape[-1] // heads)

    return {
        "qkv_kernel": (lambda a: a.reshape(a.shape[0], -1).T, lambda a: split(a.T)),
        "qkv_bias": (lambda a: a.reshape(-1), split),
        "out_kernel": (lambda a: a.reshape(-1, a.shape[-1]).T,
                       lambda a: a.T.reshape(heads, -1, a.shape[0])),
    }


def _linear(out: dict, path: Tuple[str, ...], layer: nn.Linear) -> None:
    out[path + ("kernel",)] = (layer.weight, DENSE)
    out[path + ("bias",)] = (layer.bias, SAME)


def _norm(out: dict, path: Tuple[str, ...], norm: nn.Module) -> None:
    out[path + ("scale",)] = (norm.weight, SAME)
    out[path + ("bias",)] = (norm.bias, SAME)


def _centernet_leaves(model: CenterNetDetector) -> dict:
    out = {}
    for i, block in enumerate(model.blocks):
        out[(f"ConvBlock_{i}", "Conv_0", "kernel")] = (block.conv.weight, CONV)
        _norm(out, (f"ConvBlock_{i}", "GroupNorm_0"), block.norm)
    for name, head in model.heads().items():
        out[(f"head_{name}", "kernel")] = (head.weight, CONV)
        out[(f"head_{name}", "bias")] = (head.bias, SAME)
    return out


def _petr_leaves(model: PETRDetector) -> dict:
    out = {}
    for i, block in enumerate(model.backbone.blocks):
        out[("CameraBackbone_0", f"Conv_{i}", "kernel")] = (block.conv.weight, CONV)
        _norm(out, ("CameraBackbone_0", f"GroupNorm_{i}"), block.norm)
    _linear(out, ("Dense_0",), model.token_proj)
    out[("queries",)] = (model.queries, SAME)
    if model.motion_aware:
        out[("ref_anchors",)] = (model.ref_anchors, SAME)
        _linear(out, ("position_encoder_hidden",), model.position_encoder_hidden)
        _linear(out, ("position_encoder_out",), model.position_encoder_out)
    if model.num_memory:
        _linear(out, ("memory_proj",), model.memory_proj)
    for i, layer in enumerate(model.layers):
        p = (f"DecoderLayer_{i}",)
        _norm(out, p + ("LayerNorm_0",), layer.norm0)
        _norm(out, p + ("LayerNorm_1",), layer.norm1)
        _linear(out, p + ("Dense_0",), layer.mlp0)
        _linear(out, p + ("Dense_1",), layer.mlp1)
        lay = _heads_layouts(layer.attn.heads)
        attn = p + ("MultiHeadDotProductAttention_0",)
        for name in ("query", "key", "value"):
            lin = getattr(layer.attn, name)
            out[attn + (name, "kernel")] = (lin.weight, lay["qkv_kernel"])
            out[attn + (name, "bias")] = (lin.bias, lay["qkv_bias"])
        out[attn + ("out", "kernel")] = (layer.attn.out.weight, lay["out_kernel"])
        out[attn + ("out", "bias")] = (layer.attn.out.bias, SAME)
    for name in ("boxes", "classes", "existence"):
        _linear(out, (f"head_{name}",), getattr(model, f"head_{name}"))
    return out


def _switch_leaves(switch: SwitchFFN, prefix: Tuple[str, ...] = ()) -> dict:
    out = {}
    _linear(out, prefix + ("router",), switch.router)
    out[prefix + ("w_in",)] = (switch.w_in, SAME)
    out[prefix + ("w_out",)] = (switch.w_out, SAME)
    return out


def _moe_leaves(model: MoEClassifier) -> dict:
    out = {}
    _linear(out, ("Dense_0",), model.dense_0)
    out.update(_switch_leaves(model.switch, ("SwitchFFN_0",)))
    _norm(out, ("LayerNorm_0",), model.norm)
    _linear(out, ("Dense_1",), model.dense_1)
    return out


def _lane_leaves(model) -> dict:
    out = {}
    for i, layer in enumerate((model.fc1, model.fc2, model.fc3), start=1):
        out[(f"w{i}",)] = (layer.weight, DENSE)
        out[(f"b{i}",)] = (layer.bias, SAME)
    return out


def _is_lane(model) -> bool:
    from ..lane_regression_training import LaneRegressor

    return isinstance(model, LaneRegressor)


def _leaves(model: Model) -> Dict[Tuple[str, ...], Tuple[torch.Tensor, Layout]]:
    """flax path -> (port parameter, its layout)."""
    if _is_lane(model):
        return _lane_leaves(model)
    if isinstance(model, PETRDetector):
        return _petr_leaves(model)
    if isinstance(model, CenterNetDetector):
        return _centernet_leaves(model)
    if isinstance(model, MoEClassifier):
        return _moe_leaves(model)
    if isinstance(model, SwitchFFN):
        return _switch_leaves(model)
    raise TypeError(f"no flax layout for {type(model).__name__}")


def _flatten(tree, prefix=()) -> Dict[Tuple[str, ...], np.ndarray]:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (str(k),)))
        return out
    return {prefix: np.asarray(tree)}


def _numpy(param: torch.Tensor) -> np.ndarray:
    return param.detach().cpu().numpy()


def load_jax_params(module: Model, params: dict) -> Model:
    """Copy flax variables ``{"params": {...}}`` into ``module`` (in place;
    returns it). Raises ``ValueError`` on a missing, extra or mis-shaped
    leaf, before anything is copied. A ``LaneRegressor`` takes the example's
    plain dict, without the ``"params"`` level."""
    if _is_lane(module):
        given = _flatten(params)
    elif set(params) != {"params"}:
        raise ValueError(f"expected the flax variables {{'params': ...}}, got keys {sorted(params)}")
    else:
        given = _flatten(params["params"])
    if isinstance(module, MoEClassifier) and module.dense_0 is None \
            and ("Dense_0", "kernel") in given:
        module.build(int(given[("Dense_0", "kernel")].shape[0]))
    expected = _leaves(module)
    missing = sorted("/".join(p) for p in set(expected) - set(given))
    extra = sorted("/".join(p) for p in set(given) - set(expected))
    if missing or extra:
        raise ValueError(f"flax parameters do not match the module: missing {missing}, "
                         f"extra {extra}")
    arrays = {}
    for path, (param, (to_port, to_flax)) in expected.items():
        want = to_flax(_numpy(param)).shape
        if tuple(given[path].shape) != tuple(want):
            raise ValueError(f"{'/'.join(path)}: shape {given[path].shape} does not fit the "
                             f"module's {tuple(want)}")
        arrays[path] = np.array(to_port(given[path]), order="C")  # a writable copy
    with torch.no_grad():
        for path, (param, _) in expected.items():
            param.copy_(torch.from_numpy(arrays[path]).to(param.dtype))
    return module


def jax_params_of(module: Model) -> dict:
    """The module's parameters as flax variables of numpy arrays in flax's
    layouts, the inverse of :func:`load_jax_params` (a ``LaneRegressor``'s
    as the example's plain dict)."""
    tree: dict = {}
    for path, (param, (_, to_flax)) in _leaves(module).items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.ascontiguousarray(to_flax(_numpy(param)))
    return tree if _is_lane(module) else {"params": tree}
