"""Core array operators (port of ``accvlab_tpu/pipeline/operators/ops.py``).

Each function takes the per-sample numpy arrays of a host step and computes
in numpy, in the JAX package's float32 order (the numpy branch of its
``xp_for`` dispatch). Given torch tensors it takes the torch form, which a
device step calls on batched tensors: the per-sample layout with any number
of leading batch dimensions (``points`` is ``(..., N, D)``, a rotation
vector ``(..., 3)``). The torch forms make their constants on the tensor's
device or use Python scalars, so they copy nothing from host memory and
read nothing back.

``remove_inactive`` and ``check_bbox_visibility`` have data-dependent output
sizes or a sequential raster and stay host-only (numpy), as in the JAX
package.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def _is_torch(*values) -> bool:
    return any(isinstance(v, torch.Tensor) for v in values)


def _f32(values) -> list:
    """Python floats of ``values`` rounded to float32 (the JAX package's
    ``np.asarray(values, np.float32)``)."""
    return [float(v) for v in np.asarray(values, np.float32).reshape(-1)]


def pad_to_size(data, size: int, fill_value=0.0):
    """Pad (or truncate) ``dim==0`` to ``size``. Parity: ``ops.py:17``.
    The torch form pads dim 0 of the tensor it is given."""
    n = data.shape[0]
    if n >= size:
        return data[:size]
    if _is_torch(data):
        pad = torch.full((size - n, *data.shape[1:]), fill_value, dtype=data.dtype,
                         device=data.device)
        return torch.cat([data, pad], 0)
    pad = [(0, size - n)] + [(0, 0)] * (data.ndim - 1)
    return np.pad(data, pad, constant_values=fill_value)


def remove_inactive(data, active_mask, masked_dimension: int = 0):
    """Remove entries where ``active_mask`` is False along ``masked_dimension``.
    Parity: ``ops.py:29``. Host-only (numpy): the output size depends on the
    data."""
    data = np.asarray(data)
    mask = np.asarray(active_mask).astype(bool)
    if masked_dimension != 0:
        data = np.moveaxis(data, masked_dimension, 0)
    res = data[mask]
    if masked_dimension != 0:
        res = np.moveaxis(res, 0, masked_dimension)
    return res


def ensure_range(data, min_value: float, max_value: float, period: float):
    """Shift out-of-range values into ``[min_value, max_value]`` by integer
    multiples of ``period``. Parity: ``ops.py:47``."""
    if _is_torch(data):
        too_low = data < min_value
        too_high = data > max_value
        add = torch.ceil((min_value - data) / period) * period
        sub = torch.ceil((data - max_value) / period) * period
        res = torch.where(too_low, data + add, data)
        res = torch.where(too_high, data - sub, res)
        return res.to(data.dtype)
    data = np.asarray(data)
    too_low = data < min_value
    too_high = data > max_value
    add = np.ceil((min_value - data) / period) * period
    sub = np.ceil((data - max_value) / period) * period
    res = np.where(too_low, data + add, data)
    res = np.where(too_high, data - sub, res)
    return res.astype(data.dtype)


def replace_nans(data, replacement_value: float):
    """Replace NaNs. Parity: ``ops.py:61``."""
    if _is_torch(data):
        return torch.where(torch.isnan(data), torch.full_like(data, replacement_value), data)
    data = np.asarray(data)
    return np.where(np.isnan(data), np.asarray(replacement_value, data.dtype), data)


def check_bbox_visibility(bboxes, depths, image_hw, shrink_bbox_to_obtain_int_coords: bool = False):
    """Occlusion-aware visibility mask by the painter's algorithm: boxes are
    rasterized far-to-near onto an index canvas, and a box is visible iff its
    index survives anywhere. Parity: ``ops.py:68``; host-only (numpy)."""
    bboxes = np.asarray(bboxes, np.float32)
    depths = np.asarray(depths, np.float32)
    image_hw = np.asarray(image_hw, np.int32)
    h, w = int(image_hw[0]), int(image_hw[1])
    canvas = np.full((h, w), -1, np.int32)
    for doi in np.argsort(-depths):
        box = bboxes[doi]
        min_x, max_x = (box[0], box[2]) if box[0] < box[2] else (box[2], box[0])
        min_y, max_y = (box[1], box[3]) if box[1] < box[3] else (box[3], box[1])
        if shrink_bbox_to_obtain_int_coords:
            min_x, min_y = int(np.ceil(min_x)), int(np.ceil(min_y))
            max_x, max_y = int(np.floor(max_x)), int(np.floor(max_y))
        else:
            min_x, min_y = int(np.floor(min_x)), int(np.floor(min_y))
            max_x, max_y = int(np.ceil(max_x)), int(np.ceil(max_y))
        if min_x > w or max_x < 0 or min_y > h or max_y < 0:
            continue
        canvas[max(min_y, 0): min(max_y, h), max(min_x, 0): min(max_x, w)] = doi
    mask = np.zeros((bboxes.shape[0],), bool)
    visible = np.unique(canvas)
    mask[visible[visible >= 0]] = True
    return mask


def check_minimum_bbox_size(bboxes, min_size: float, image_hw):
    """True where the image-clipped box is at least ``min_size`` in both x
    and y. Parity: ``ops.py:103``. The torch form takes ``(..., N, 4)`` boxes
    and ``image_hw`` as ``(..., 2)`` sizes (one per sample) or a pair of
    Python numbers."""
    if _is_torch(bboxes):
        b = bboxes.to(torch.float32)
        if isinstance(image_hw, torch.Tensor):
            hw = image_hw.to(torch.float32)
            h, w = hw[..., 0, None], hw[..., 1, None]
            zero = torch.zeros_like(h)
            x1 = torch.minimum(torch.maximum(b[..., 0], zero), w)
            x2 = torch.minimum(torch.maximum(b[..., 2], zero), w)
            y1 = torch.minimum(torch.maximum(b[..., 1], zero), h)
            y2 = torch.minimum(torch.maximum(b[..., 3], zero), h)
        else:
            h, w = float(image_hw[0]), float(image_hw[1])
            x1, x2 = b[..., 0].clamp(0.0, w), b[..., 2].clamp(0.0, w)
            y1, y2 = b[..., 1].clamp(0.0, h), b[..., 3].clamp(0.0, h)
        return ((x2 - x1).abs() >= min_size) & ((y2 - y1).abs() >= min_size)
    bboxes = np.asarray(bboxes, dtype=np.float32)
    h = image_hw[0]
    w = image_hw[1]
    x1 = np.clip(bboxes[:, 0], 0.0, w)
    x2 = np.clip(bboxes[:, 2], 0.0, w)
    y1 = np.clip(bboxes[:, 1], 0.0, h)
    y2 = np.clip(bboxes[:, 3], 0.0, h)
    return (np.abs(x2 - x1) >= min_size) & (np.abs(y2 - y1) >= min_size)


def check_points_in_box(points, min_point: Sequence[float], max_point: Sequence[float]):
    """True where a point lies inside the (closed) box in every dimension.
    Parity: ``ops.py:118``. The torch form takes ``(..., N, D)`` points."""
    if _is_torch(points):
        lo, hi = _f32(min_point), _f32(max_point)
        inside = torch.ones(points.shape[:-1], dtype=torch.bool, device=points.device)
        for d in range(points.shape[-1]):
            inside = inside & (points[..., d] >= lo[d]) & (points[..., d] <= hi[d])
        return inside
    points = np.asarray(points)
    lo = np.asarray(min_point, np.float32)[None, :]
    hi = np.asarray(max_point, np.float32)[None, :]
    return np.all((points >= lo) & (points <= hi), axis=1)


def crop_coordinates(points, min_point: Sequence[float], max_point: Sequence[float]):
    """Clip each coordinate into the box. Parity: ``ops.py:128``. The torch
    form takes ``(..., N, D)`` points."""
    if _is_torch(points):
        # the bounds rounded to the points' dtype (numpy's of the same name: no
        # tensor is made, so the traced device stage reads none on the host)
        np_dtype = np.dtype(str(points.dtype).removeprefix("torch."))
        lo = [v.item() for v in np.asarray(min_point, np_dtype).reshape(-1)]
        hi = [v.item() for v in np.asarray(max_point, np_dtype).reshape(-1)]
        cols = [points[..., d].clamp(lo[d], hi[d]) for d in range(points.shape[-1])]
        return torch.stack(cols, -1)
    points = np.asarray(points)
    lo = np.asarray(min_point, points.dtype)[None, :]
    hi = np.asarray(max_point, points.dtype)[None, :]
    return np.clip(points, lo, hi)


def get_rot_mat_from_rot_vector(rot_vector, as_homog: bool = False, eps: float = 1e-7):
    """Rodrigues rotation vector -> 3x3 (or homogeneous 4x4) rotation matrix.
    Parity: ``ops.py:137``. The torch form takes ``(..., 3)`` vectors."""
    if _is_torch(rot_vector):
        v = rot_vector.to(torch.float32)
        angle = torch.sqrt((v * v).sum(-1))
        safe = torch.where(angle < eps, torch.ones_like(angle), angle)
        axis = v / safe[..., None]
        zero = torch.zeros_like(angle)
        cross = torch.stack([
            torch.stack([zero, -axis[..., 2], axis[..., 1]], -1),
            torch.stack([axis[..., 2], zero, -axis[..., 0]], -1),
            torch.stack([-axis[..., 1], axis[..., 0], zero], -1),
        ], -2)
        eye = torch.eye(3, dtype=torch.float32, device=v.device)
        rot = (eye + torch.sin(angle)[..., None, None] * cross
               + (1.0 - torch.cos(angle))[..., None, None] * (cross @ cross))
        rot = torch.where((angle < eps)[..., None, None], eye, rot)
        if as_homog:
            out = torch.zeros((*rot.shape[:-2], 4, 4), dtype=torch.float32, device=v.device)
            out[..., :3, :3] = rot
            out[..., 3, 3] = 1.0
            return out
        return rot
    v = np.asarray(rot_vector, dtype=np.float32)
    angle = np.sqrt(np.sum(v * v))
    safe_angle = np.where(angle < eps, 1.0, angle)
    axis = v / safe_angle
    zero = np.zeros((), np.float32)
    cross = np.stack([np.stack([zero, -axis[2], axis[1]]),
                      np.stack([axis[2], zero, -axis[0]]),
                      np.stack([-axis[1], axis[0], zero])])
    eye = np.eye(3, dtype=np.float32)
    rot = eye + np.sin(angle) * cross + (1.0 - np.cos(angle)) * (cross @ cross)
    rot = np.where(angle < eps, eye, rot)
    if as_homog:
        out = np.zeros((4, 4), np.float32)
        out[:3, :3] = rot
        out[3, 3] = 1.0
        return out
    return rot.astype(np.float32)


def get_translation_mat_from_vector(translation):
    """Translation vector -> homogeneous 4x4. Parity: ``ops.py:170``. The torch
    form takes ``(..., 3)`` vectors."""
    if _is_torch(translation):
        t = translation.to(torch.float32)
        res = torch.eye(4, dtype=torch.float32, device=t.device).expand(*t.shape[:-1], 4, 4)
        res = res.clone()
        res[..., :3, 3] = t
        return res
    t = np.asarray(translation, dtype=np.float32)
    res = np.eye(4, dtype=np.float32)
    res[:3, 3] = t
    return res


def get_scaling_mat_from_vector(scaling, as_homog: bool = False):
    """Per-axis scaling vector -> 3x3 (or homogeneous 4x4) matrix.
    Parity: ``ops.py:182``. The torch form takes ``(..., 3)`` vectors."""
    if _is_torch(scaling):
        s = scaling.to(torch.float32)[..., :3]
        if as_homog:
            s = torch.cat([s, torch.ones_like(s[..., :1])], -1)
        return torch.diag_embed(s)
    s = np.asarray(scaling, dtype=np.float32)
    size = 4 if as_homog else 3
    diag = np.concatenate([s[:3], np.ones((size - 3,), np.float32)]) if as_homog else s[:3]
    return np.diag(diag).astype(np.float32)


def apply_matrix(
    to_apply_to,
    matrix,
    in_homog: bool = False,
    to_apply_to_is_transposed: bool = False,
    matrix_is_transposed: bool = False,
    matrix_is_inverted: bool = False,
    multiply_matrix_from_right: bool = False,
    make_apply_to_homog: Optional[bool] = None,
):
    """Apply a matrix to a point set (optionally homogeneous, transposed,
    inverted or right-multiplied). Parity: ``ops.py:192``.

    ``to_apply_to`` is (D, N), or (N, D) with ``to_apply_to_is_transposed``;
    1-D inputs are one vector. The torch form takes any leading batch
    dimensions on both, (..., D, N) and (..., M, D)."""
    if make_apply_to_homog is not None:
        in_homog = make_apply_to_homog
    if _is_torch(to_apply_to, matrix):
        dev = (to_apply_to if isinstance(to_apply_to, torch.Tensor) else matrix).device
        data = torch.as_tensor(to_apply_to, dtype=torch.float32, device=dev)
        mat = torch.as_tensor(matrix, dtype=torch.float32, device=dev)
        cat, trans = torch.cat, (lambda a: a.transpose(-1, -2))
        # inv_ex: linalg.inv's result without its check of the info on the
        # host (a synchronisation on the card); a singular matrix gives
        # non-finite entries, as jnp.linalg.inv does
        inv = lambda a: torch.linalg.inv_ex(a)[0]  # noqa: E731
        ones = lambda shape: torch.ones(shape, dtype=torch.float32, device=dev)  # noqa: E731
    else:
        data = np.asarray(to_apply_to, dtype=np.float32)
        mat = np.asarray(matrix, dtype=np.float32)
        cat, trans = np.concatenate, (lambda a: np.swapaxes(a, -1, -2))
        inv, ones = np.linalg.inv, (lambda shape: np.ones(shape, np.float32))
    was_1d = data.ndim == 1
    if was_1d:
        data = data.reshape(-1, 1)
        to_apply_to_is_transposed = False
    if to_apply_to_is_transposed:
        data = trans(data)
    if in_homog:
        data = cat([data, ones((*data.shape[:-2], 1, data.shape[-1]))], -2)
    if matrix_is_transposed:
        mat = trans(mat)
    if matrix_is_inverted:
        mat = inv(mat)
    data = (data @ mat) if multiply_matrix_from_right else (mat @ data)
    if in_homog:
        data = data[..., :-1, :] / data[..., -1:, :]
    if to_apply_to_is_transposed:
        data = trans(data)
    if was_1d:
        data = data.reshape(-1)
    return data


def get_center_from_bboxes(bboxes):
    """Box centers from [x1, y1, x2, y2] boxes. Parity: ``ops.py:231``.
    The torch form takes ``(..., N, 4)`` boxes."""
    if _is_torch(bboxes):
        b = bboxes.to(torch.float32)
        return torch.stack(
            [(b[..., 0] + b[..., 2]) * 0.5, (b[..., 1] + b[..., 3]) * 0.5], dim=-1
        )
    b = np.asarray(bboxes, dtype=np.float32)
    return np.stack([(b[:, 0] + b[:, 2]) * 0.5, (b[:, 1] + b[:, 3]) * 0.5], axis=1)


def get_radii_from_bboxes(bboxes, scaling_factor: float = 0.8, centers=None):
    """Gaussian radius per box: min distance from the center to any box edge,
    clamped at 0, times ``scaling_factor``. Parity: ``ops.py:238``. The torch
    form takes ``(..., N, 4)`` boxes."""
    if not _is_torch(bboxes):
        b = np.asarray(bboxes, dtype=np.float32)
        c = get_center_from_bboxes(b) if centers is None else np.asarray(centers, np.float32)
        left, right = np.minimum(b[:, 0], b[:, 2]), np.maximum(b[:, 0], b[:, 2])
        top, bottom = np.minimum(b[:, 1], b[:, 3]), np.maximum(b[:, 1], b[:, 3])
        dists = np.stack([c[:, 0] - left, c[:, 1] - top, right - c[:, 0], bottom - c[:, 1]],
                         axis=1)
        return np.maximum(0.0, np.min(dists, axis=1)) * np.float32(scaling_factor)
    b = bboxes.to(torch.float32)
    c = get_center_from_bboxes(b) if centers is None else centers.to(torch.float32)
    left = torch.minimum(b[..., 0], b[..., 2])
    right = torch.maximum(b[..., 0], b[..., 2])
    top = torch.minimum(b[..., 1], b[..., 3])
    bottom = torch.maximum(b[..., 1], b[..., 3])
    dists = torch.stack(
        [c[..., 0] - left, c[..., 1] - top, right - c[..., 0], bottom - c[..., 1]], dim=-1
    )
    return torch.clamp(dists.amin(dim=-1), min=0.0) * float(scaling_factor)


# the reference exports this function under a misspelled name; the alias
# keeps its call sites working
check_bbox_visibiity = check_bbox_visibility
