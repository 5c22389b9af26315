"""Plain reference of the input pipeline's device stage on raw frames.

From the benchmark's frames and boxes and the pipeline's seed, it works out
what each batch should hold, in float32 (TF32 off unless ``tf32``):

1. the augmentation draws of batch ``k``: a CPU ``torch.Generator`` seeded
   from ``SeedSequence([seed, k])`` (``[seed, k, echo]`` with echoing), per
   sample, in the order the steps ask: scaling value then its coin,
   translation x, y then its coin; five photometric coins, the contrast mode,
   brightness, contrast, hue and saturation values, the channel permutation;
2. each sample's affine map ``stretch @ translate? @ scale?`` (about the
   frame's centre), and the images warped through its inverse with bilinear
   sampling at pixel centres, 0 outside, rounded to bytes;
3. the photometric distortion on [0, 1] values (brightness, contrast before
   or after, saturation by luma, hue as a rotation in YIQ, channel
   permutation), truncated back to bytes;
4. the per-channel mean / std normalization;
5. the heatmap targets from the boxes alone (they are not warped): boxes
   scaled to the heatmap grid and clipped, the clipped area share >= 0.25
   and a valid class make a target active, its peak at the floor of the
   clipped centre, radius ``0.8 *`` the centre's least distance to an edge,
   clamped to [0.5, 10], a Gaussian of sigma ``r / 3`` over ``|dx|, |dy| <=
   ceil(r)``, the maximum over the class's targets.

It imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

# the NTSC RGB -> YIQ matrix of the linear hue rotation
RGB2YIQ = np.array([[0.299, 0.587, 0.114], [0.5959, -0.2746, -0.3213],
                    [0.2115, -0.5227, 0.3112]], np.float32)
LUMA = (0.299, 0.587, 0.114)
PERMS = ((0, 1, 2), (0, 2, 1), (1, 0, 2), (2, 1, 0), (2, 0, 1), (1, 2, 0))


def batch_generator(seed: int, batch_idx: int, echo=None) -> torch.Generator:
    key = [int(seed), int(batch_idx)] + ([] if echo is None else [int(echo)])
    state = np.random.SeedSequence(key).generate_state(2, np.uint32)
    gen = torch.Generator(device="cpu")
    gen.manual_seed((int(state[0]) << 31) ^ int(state[1]))
    return gen


def draws(gen: torch.Generator, b: int, aug: dict) -> Dict[str, torch.Tensor]:
    """Every draw of one batch of ``b`` samples, in the steps' order."""
    def u(lo, hi):
        return torch.rand((b,), generator=gen, dtype=torch.float32) * (hi - lo) + lo

    def ri(hi):
        return torch.randint(0, hi, (b,), generator=gen, dtype=torch.int32)

    a, p = aug["affine"], aug["photometric"]
    d = {}
    d["scale"], d["scale_coin"] = u(*a["scaling"]), u(0.0, 1.0)
    d["tx"], d["ty"] = u(a["translation"][0], a["translation"][1]), u(a["translation"][0],
                                                                      a["translation"][1])
    d["translate_coin"] = u(0.0, 1.0)
    for name in ("brightness", "contrast", "saturation", "hue", "swap"):
        d[name + "_coin"] = u(0.0, 1.0)
    d["contrast_mode"] = ri(2)
    d["brightness"] = u(*p["brightness"])
    d["contrast"] = u(*p["contrast"])
    d["hue"] = u(*p["hue"])
    d["saturation"] = u(*p["saturation"])
    d["perm"] = ri(6)
    return d


def affine_maps(d: Dict[str, torch.Tensor], frame_hw, out_hw, prob: float) -> torch.Tensor:
    """``(B, 2, 3)`` float32 maps from frame to output pixels: ``stretch @
    translate @ scale``, each factor applied where its coin is below
    ``prob``."""
    h, w = frame_hw
    f32 = torch.float32
    cx, cy = torch.tensor(w * 0.5, dtype=f32), torch.tensor(h * 0.5, dtype=f32)
    one = torch.ones_like(d["scale"])
    s = torch.where(d["scale_coin"] < prob, d["scale"], one)
    moved = d["translate_coin"] < prob
    tx = torch.where(moved, d["tx"], 0.0)
    ty = torch.where(moved, d["ty"], 0.0)
    # translate @ scale about the centre
    a02 = (cx - s * cx) + tx
    a12 = (cy - s * cy) + ty
    sw = torch.tensor(float(out_hw[1]), dtype=f32) / torch.tensor(float(w), dtype=f32)
    sh = torch.tensor(float(out_hw[0]), dtype=f32) / torch.tensor(float(h), dtype=f32)
    zero = torch.zeros_like(s)
    return torch.stack([torch.stack([sw * s, zero, sw * a02], -1),
                        torch.stack([zero, sh * s, sh * a12], -1)], -2)


def invert(m: torch.Tensor) -> torch.Tensor:
    """Inverse of ``(B, 2, 3)`` affine maps: the adjugate over the
    determinant."""
    a, b, c = m[:, 0, 0], m[:, 0, 1], m[:, 0, 2]
    d, e, f = m[:, 1, 0], m[:, 1, 1], m[:, 1, 2]
    inv_det = 1.0 / (a * e - b * d)
    ia, ib, id_, ie = e * inv_det, -b * inv_det, -d * inv_det, a * inv_det
    return torch.stack([torch.stack([ia, ib, -(ia * c + ib * f)], -1),
                        torch.stack([id_, ie, -(id_ * c + ie * f)], -1)], -2)


def warp(frames: torch.Tensor, maps: torch.Tensor, out_hw) -> torch.Tensor:
    """Bilinear warp of ``(B, H, W, 3)`` uint8 frames to ``out_hw`` through
    the inverse of ``maps`` (pixel centres at whole coordinates); bytes."""
    b, h, w, _ = frames.shape
    oh, ow = out_hw
    dev = frames.device
    inv = invert(maps.to(dev))
    ys = torch.arange(oh, device=dev, dtype=torch.float32).view(1, oh, 1)
    xs = torch.arange(ow, device=dev, dtype=torch.float32).view(1, 1, ow)

    def row(i):
        return (inv[:, i, 0].view(b, 1, 1) * xs + inv[:, i, 1].view(b, 1, 1) * ys
                + inv[:, i, 2].view(b, 1, 1))

    sx, sy = row(0), row(1)
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    flat = frames.reshape(b, h * w, 3).float()

    def at(yy, xx):
        idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).long().reshape(b, -1, 1)
        return torch.gather(flat, 1, idx.expand(b, idx.shape[1], 3)).reshape(b, oh, ow, 3)

    top = at(y0, x0) * (1 - fx) + at(y0, x0 + 1) * fx
    bottom = at(y0 + 1, x0) * (1 - fx) + at(y0 + 1, x0 + 1) * fx
    val = top * (1 - fy) + bottom * fy
    inside = ((sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1))[..., None]
    return torch.where(inside, val, 0.0).round().clamp(0, 255).to(torch.uint8)


def photometric(images: torch.Tensor, d: Dict[str, torch.Tensor], prob: float,
                tf32: bool = False) -> torch.Tensor:
    dev = images.device

    def e(v):
        return v.to(dev)[:, None, None, None]

    def gate(name):
        return e(d[name + "_coin"] < prob)

    x = images.float() / 255.0
    x = torch.where(gate("brightness"), (x + e(d["brightness"]) / 255.0).clamp(0, 1), x)
    contrast = gate("contrast")
    mode = e(d["contrast_mode"])
    x = torch.where(contrast & (mode == 1), (x * e(d["contrast"])).clamp(0, 1), x)
    gray = (x[..., 0] * LUMA[0] + x[..., 1] * LUMA[1] + x[..., 2] * LUMA[2])[..., None]
    x = torch.where(gate("saturation"), gray + e(d["saturation"]) * (x - gray), x)
    rad = d["hue"].double() * math.pi / 180.0
    rot = torch.zeros(rad.shape[0], 3, 3, dtype=torch.float64)
    rot[:, 0, 0] = 1.0
    rot[:, 1, 1], rot[:, 1, 2] = torch.cos(rad), -torch.sin(rad)
    rot[:, 2, 1], rot[:, 2, 2] = torch.sin(rad), torch.cos(rad)
    rgb2yiq = torch.from_numpy(RGB2YIQ.astype(np.float64))
    m = (torch.linalg.inv(rgb2yiq) @ rot @ rgb2yiq).to(device=dev, dtype=torch.float32)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        hued = torch.einsum("bhwc,bkc->bhwk", x, m)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    x = torch.where(gate("hue"), hued, x)
    x = torch.where(contrast & (mode == 0), (x * e(d["contrast"])).clamp(0, 1), x)
    perm = torch.tensor(PERMS, device=dev)[d["perm"].to(dev).long()]
    swapped = torch.gather(x, -1, perm[:, None, None, :].expand(x.shape))
    x = torch.where(gate("swap"), swapped, x)
    return (x * 255.0).clamp(0, 255).to(torch.uint8)


def normalize(images: torch.Tensor, mean: Sequence[float], std: Sequence[float]) -> torch.Tensor:
    dev = images.device
    return (images.float() - torch.tensor(mean, device=dev)) / torch.tensor(std, device=dev)


def targets(boxes: torch.Tensor, cats: torch.Tensor, frame_hw, heat_hw,
            num_classes: int) -> Dict[str, torch.Tensor]:
    """``boxes (B, T, 4)``, ``cats (B, T)`` -> the heatmap ``(B, C, Hh, Wh)``
    and the per-target ``active``, ``center``, ``offset``, ``hw``; float32."""
    dev = boxes.device
    hh, hw_ = heat_hw
    f32 = torch.float32
    sx = torch.tensor(float(hw_), dtype=f32) / torch.tensor(float(frame_hw[1]), dtype=f32)
    sy = torch.tensor(float(hh), dtype=f32) / torch.tensor(float(frame_hw[0]), dtype=f32)
    sx, sy = sx.to(dev), sy.to(dev)
    x1, y1, x2, y2 = (boxes[..., i] for i in range(4))
    px1, px2, py1, py2 = x1 * sx, x2 * sx, y1 * sy, y2 * sy
    cx1, cx2 = px1.clamp(0, hw_ - 1), px2.clamp(0, hw_ - 1)
    cy1, cy2 = py1.clamp(0, hh - 1), py2.clamp(0, hh - 1)
    h_c, w_c = (cy2 - cy1).abs(), (cx2 - cx1).abs()
    frac = (h_c * w_c) / ((py2 - py1).abs() * (px2 - px1).abs())
    cx = (((x1 + x2) * 0.5) * sx).clamp(0, hw_ - 1)
    cy = (((y1 + y2) * 0.5) * sy).clamp(0, hh - 1)
    active = (cats < num_classes) & (frac >= 0.25)
    dist = torch.stack([cx - torch.minimum(cx1, cx2), cy - torch.minimum(cy1, cy2),
                        torch.maximum(cx1, cx2) - cx, torch.maximum(cy1, cy2) - cy], -1)
    radius = (dist.amin(-1).clamp(min=0) * 0.8).clamp(0.5, 10.0)
    fx, fy = torch.floor(cx), torch.floor(cy)
    b, t = cats.shape
    heat = torch.zeros(b, num_classes, hh, hw_, dtype=f32, device=dev)
    gy = torch.arange(hh, device=dev, dtype=f32).view(1, 1, hh, 1)
    gx = torch.arange(hw_, device=dev, dtype=f32).view(1, 1, 1, hw_)
    dy, dx = gy - fy[..., None, None], gx - fx[..., None, None]
    reach = torch.ceil(radius)[..., None, None]
    sigma = radius / 3.0
    val = torch.exp(-(dx * dx + dy * dy) / (2 * sigma * sigma)[..., None, None])
    inside = (dx.abs() <= reach) & (dy.abs() <= reach) & active[..., None, None]
    cls = cats.clamp(0, num_classes - 1)
    for c in range(num_classes):
        sel = inside & (cls == c)[..., None, None]
        heat[:, c] = torch.where(sel, val, 0.0).amax(dim=1)
    return {"heatmap": heat, "active": active,
            "center": torch.stack([fx, fy], -1).to(torch.int32),
            "offset": torch.stack([cx - fx, cy - fy], -1),
            "hw": torch.stack([h_c, w_c], -1)}


def batch_outputs(frames: torch.Tensor, boxes: torch.Tensor, cats: torch.Tensor, seed: int,
                  batch_idx: int, config: dict, echo=None, tf32: bool = False) -> List[dict]:
    """One batch per camera: ``frames (B, cams, H, W, 3)`` uint8, ``boxes (B,
    cams, T, 4)`` and ``cats (B, cams, T)``, all on the device that computes.
    Returns per camera ``{"image", "heatmap", "active", "center", "offset",
    "hw"}``."""
    aug = config["augment"]
    b = frames.shape[0]
    d = draws(batch_generator(seed, batch_idx, echo), b, aug)
    maps = affine_maps(d, config["frame_hw"], config["out_hw"], aug["affine"]["prob"])
    out = []
    for c in range(frames.shape[1]):
        img = warp(frames[:, c], maps, config["out_hw"])
        img = photometric(img, d, aug["photometric"]["prob"], tf32=tf32)
        img = normalize(img, aug["mean"], aug["std"])
        tg = targets(boxes[:, c], cats[:, c], config["frame_hw"], config["heatmap_hw"],
                     config["num_classes"])
        out.append({"image": img, **tg})
    return out
