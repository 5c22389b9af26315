"""Plain reference of CenterNet's ``res_18`` network and its loss, on a dict
of leaves.

The network (CenterNet, ``msra_resnet.py``): a ResNet (7x7 stride-2 conv,
batch norm, ReLU, 3x3 stride-2 max pool, four stages of basic blocks, the
first block of stages 2-4 at stride 2 with a 1x1 conv and batch norm on its
shortcut), three 4x4 stride-2 transposed convs each with batch norm and
ReLU, and per head a 3x3 conv with bias, ReLU and a 1x1 conv with bias:
``hm`` (class heatmap logits), ``reg`` (centre offsets), ``wh`` (box
sizes), on NHWC ``(N, H/4, W/4, .)``. Batch norm uses the batch's
statistics, as in training. Precision: ``layers.conv``.

The loss (CenterNet, eq. 1 and the L1 terms): the penalty-reduced focal loss
(alpha 2, beta 4, the sigmoid clipped to [1e-6, 1 - 1e-6], a positive where
the target is >= 0.999) summed and divided by the number of positives (at
least 1); the L1 of the offset and of the size heads at each active target's
peak, averaged over a sample's active targets (0 for a sample without
any), then over samples and the two coordinates; total = focal + offset +
0.1 * size.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import torch
import torch.nn.functional as F

from .layers import Leaves, batch_norm, conv

#: the heads: CenterNet's name, the loss's name, and the output count
HEADS = (("hm", "heatmap", None), ("reg", "offset", 2), ("wh", "size", 2))


def basic_blocks(cfg: dict) -> Iterator[Tuple[str, int, int, int]]:
    """``(prefix, cin, cout, stride)`` of every basic block."""
    cin = int(cfg["widths"][0])
    for s, (n, cout) in enumerate(zip(cfg["blocks"], cfg["widths"])):
        for j in range(int(n)):
            yield f"layer{s + 1}.{j}", cin, int(cout), 2 if s > 0 and j == 0 else 1
            cin = int(cout)


def has_shortcut_conv(cin: int, cout: int, stride: int) -> bool:
    return stride != 1 or cin != cout


def deconvs(cfg: dict) -> List[Tuple[str, int, int]]:
    """``(prefix, cin, cout)`` of the transposed convs, named as in
    CenterNet's ``deconv_layers``; their batch norms follow at the next index."""
    cin, out = int(cfg["widths"][-1]), []
    for i, cout in enumerate(cfg["deconv_filters"]):
        out.append((f"deconv_layers.{3 * i}", cin, int(cout)))
        cin = int(cout)
    return out


def head_outputs(cfg: dict) -> Dict[str, int]:
    return {name: int(cfg["num_classes"]) if n is None else n for name, _, n in HEADS}


def leaf_specs(cfg: dict) -> List[tuple]:
    """``(name, shape, init)`` of every parameter, named as the program's
    network names them."""
    def bn(prefix, c):
        return [(prefix + ".weight", (c,), ("const", 1.0)), (prefix + ".bias", (c,), ("const", 0.0))]

    w0 = int(cfg["widths"][0])
    specs = [("conv1.weight", (w0, 3, 7, 7), ("lecun", 3 * 49))] + bn("bn1", w0)
    for prefix, cin, cout, stride in basic_blocks(cfg):
        specs += [(prefix + ".conv1.weight", (cout, cin, 3, 3), ("lecun", cin * 9))]
        specs += bn(prefix + ".bn1", cout)
        specs += [(prefix + ".conv2.weight", (cout, cout, 3, 3), ("lecun", cout * 9))]
        specs += bn(prefix + ".bn2", cout)
        if has_shortcut_conv(cin, cout, stride):
            specs += [(prefix + ".downsample.0.weight", (cout, cin, 1, 1), ("lecun", cin))]
            specs += bn(prefix + ".downsample.1", cout)
    k = int(cfg["deconv_kernel"])
    for prefix, cin, cout in deconvs(cfg):
        specs += [(prefix + ".weight", (cin, cout, k, k), ("lecun", cin * k * k // 4))]
        specs += bn(bn_of(prefix), cout)
    feat, hc = int(cfg["deconv_filters"][-1]), int(cfg["head_conv"])
    for name, n in head_outputs(cfg).items():
        bias = float(cfg["heatmap_bias"]) if name == "hm" else 0.0
        specs += [(f"{name}.0.weight", (hc, feat, 3, 3), ("lecun", feat * 9)),
                  (f"{name}.0.bias", (hc,), ("const", 0.0)),
                  (f"{name}.2.weight", (n, hc, 1, 1), ("lecun", hc)),
                  (f"{name}.2.bias", (n,), ("const", bias))]
    return specs


def bn_of(deconv_prefix: str) -> str:
    head, idx = deconv_prefix.rsplit(".", 1)
    return f"{head}.{int(idx) + 1}"


def forward(p: Leaves, images: torch.Tensor, cfg: dict, conv_dtype: str) -> Dict[str, torch.Tensor]:
    """``images (N, H, W, 3)`` float32 -> NHWC head outputs under the loss's
    names."""
    eps = float(cfg["bn_eps"])

    def cbr(x, w, prefix, stride, padding, relu=True, transposed=False):
        y = batch_norm(conv(x, p[w], conv_dtype, stride, padding, transposed=transposed), p,
                       prefix, eps)
        return F.relu(y) if relu else y

    x = cbr(images.permute(0, 3, 1, 2), "conv1.weight", "bn1", 2, 3)
    x = F.max_pool2d(x, 3, 2, 1)
    for prefix, cin, cout, stride in basic_blocks(cfg):
        out = cbr(x, prefix + ".conv1.weight", prefix + ".bn1", stride, 1)
        out = cbr(out, prefix + ".conv2.weight", prefix + ".bn2", 1, 1, relu=False)
        if has_shortcut_conv(cin, cout, stride):
            x = cbr(x, prefix + ".downsample.0.weight", prefix + ".downsample.1", stride, 0,
                    relu=False)
        x = F.relu(out + x)
    for prefix, _, _ in deconvs(cfg):
        x = cbr(x, prefix + ".weight", bn_of(prefix), 2, 1, transposed=True)
    out = {}
    for name, loss_name, _ in HEADS:
        h = F.relu(conv(x, p[f"{name}.0.weight"], conv_dtype, 1, 1, bias=p[f"{name}.0.bias"]))
        out[loss_name] = conv(h, p[f"{name}.2.weight"], conv_dtype,
                              bias=p[f"{name}.2.bias"]).permute(0, 2, 3, 1)
    return out


def loss(out: Dict[str, torch.Tensor], heat: torch.Tensor, active: torch.Tensor,
         center: torch.Tensor, offset: torch.Tensor, hw: torch.Tensor) -> torch.Tensor:
    """``heat (N, Hf, Wf, C)``; per target ``(N, T)``: ``active``, ``center``
    (x, y), ``offset`` (x, y), ``hw`` (h, w)."""
    pred = torch.sigmoid(out["heatmap"]).clamp(1e-6, 1 - 1e-6)
    pos = heat >= 0.999
    focal = torch.where(pos, -torch.log(pred) * (1 - pred) ** 2,
                        -torch.log(1 - pred) * pred ** 2 * (1 - heat) ** 4)
    focal = focal.sum() / pos.sum().clamp(min=1)
    n, hf, wf, _ = out["offset"].shape
    idx = (center[..., 1] * wf + center[..., 0]).long()
    counts = active.sum(dim=1).float()

    def l1(head, target):
        flat = out[head].reshape(n, hf * wf, 2)
        picked = torch.gather(flat, 1, idx[..., None].expand(n, idx.shape[1], 2))
        per_sample = torch.where(active[..., None], (picked - target).abs(), 0.0).sum(1)
        return torch.nan_to_num(per_sample / counts[:, None], nan=0.0).mean()

    return focal + l1("offset", offset) + 0.1 * l1("size", hw.flip(-1))


def step_inputs(cams: List[dict]) -> dict:
    """The model's inputs from the per-camera pipeline outputs, camera-major."""
    return {"images": torch.cat([c["image"] for c in cams]),
            "heat": torch.cat([c["heatmap"] for c in cams]).permute(0, 2, 3, 1),
            **{k: torch.cat([c[k] for c in cams]) for k in ("active", "center", "offset", "hw")}}


def loss_and_grads(p: Leaves, inputs: dict, cfg: dict, conv_dtype: str):
    leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    out = forward(leaves, inputs["images"], cfg, conv_dtype)
    total = loss(out, inputs["heat"], inputs["active"], inputs["center"], inputs["offset"],
                 inputs["hw"])
    grads = torch.autograd.grad(total, list(leaves.values()))
    return total.detach(), dict(zip(leaves, grads))
