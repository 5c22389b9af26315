"""Parameters of the JAX package's flax models in the port's modules.

``load_jax_params`` fills a :class:`~.centernet.CenterNetDetector` from the
flax variables of ``accvlab_tpu.models.centernet.CenterNetDetector``, given
as nested dicts of numpy arrays::

    {"params": {"ConvBlock_0": {"Conv_0": {"kernel": (3, 3, 3, 64)},
                                "GroupNorm_0": {"scale": (64,), "bias": (64,)}},
                ...,
                "head_heatmap": {"kernel": (1, 1, 128, 10), "bias": (10,)}, ...}}

Conv kernels are HWIO there and OIHW here. ``jax_params_of`` is the
inverse. No JAX is imported: the caller converts its arrays with numpy.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .centernet import CenterNetDetector

HWIO_TO_OIHW = (3, 2, 0, 1)
OIHW_TO_HWIO = (2, 3, 1, 0)


def _leaves(model: CenterNetDetector) -> Dict[Tuple[str, ...], Tuple[torch.Tensor, bool]]:
    """flax path -> (port parameter, is a conv kernel)."""
    out = {}
    for i, block in enumerate(model.blocks):
        out[(f"ConvBlock_{i}", "Conv_0", "kernel")] = (block.conv.weight, True)
        out[(f"ConvBlock_{i}", "GroupNorm_0", "scale")] = (block.norm.weight, False)
        out[(f"ConvBlock_{i}", "GroupNorm_0", "bias")] = (block.norm.bias, False)
    for name, head in model.heads().items():
        out[(f"head_{name}", "kernel")] = (head.weight, True)
        out[(f"head_{name}", "bias")] = (head.bias, False)
    return out


def _flatten(tree, prefix=()) -> Dict[Tuple[str, ...], np.ndarray]:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (str(k),)))
        return out
    return {prefix: np.asarray(tree)}


def load_jax_params(module: CenterNetDetector, params: dict) -> CenterNetDetector:
    """Copy flax variables ``{"params": {...}}`` into ``module`` (in place;
    returns it). Raises ``ValueError`` on a missing, extra or mis-shaped
    leaf, before anything is copied."""
    if set(params) != {"params"}:
        raise ValueError(f"expected the flax variables {{'params': ...}}, got keys {sorted(params)}")
    given = _flatten(params["params"])
    expected = _leaves(module)
    missing = sorted("/".join(p) for p in set(expected) - set(given))
    extra = sorted("/".join(p) for p in set(given) - set(expected))
    if missing or extra:
        raise ValueError(f"flax parameters do not match the module: missing {missing}, "
                         f"extra {extra}")
    arrays = {}
    for path, (param, is_kernel) in expected.items():
        arr = given[path]
        if is_kernel and arr.ndim == 4:
            arr = arr.transpose(HWIO_TO_OIHW)
        if tuple(arr.shape) != tuple(param.shape):
            raise ValueError(f"{'/'.join(path)}: shape {given[path].shape} does not fit the "
                             f"module's {tuple(param.shape)}")
        arrays[path] = np.array(arr, order="C")  # a writable copy
    with torch.no_grad():
        for path, (param, _) in expected.items():
            param.copy_(torch.from_numpy(arrays[path]).to(param.dtype))
    return module


def jax_params_of(module: CenterNetDetector) -> dict:
    """The module's parameters as flax variables of numpy arrays (HWIO
    kernels), the inverse of :func:`load_jax_params`."""
    tree: dict = {}
    for path, (param, is_kernel) in _leaves(module).items():
        arr = param.detach().cpu().numpy()
        if is_kernel:
            arr = arr.transpose(OIHW_TO_HWIO)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.ascontiguousarray(arr)
    return {"params": tree}
