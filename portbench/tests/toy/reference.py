"""Plain reference of the toy family (``families/toy.py``), copied to
``reference/toy.py`` of a copy of the benchmark: the same network and
memory on a dict of leaves, and plain SGD, in ``dtype`` (the control:
bfloat16)."""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F


def leaf_specs(cfg: dict) -> List[tuple]:
    w, c = int(cfg["width"]), int(cfg["num_classes"])
    return [("conv1.weight", (w, 3, 3, 3), ("lecun", 27)), ("conv1.bias", (w,), ("const", 0.0)),
            ("conv2.weight", (c, w, 3, 3), ("lecun", w * 9)),
            ("conv2.bias", (c,), ("const", 0.0)),
            ("memory.weight", (c, c), ("lecun", c)), ("memory.bias", (c,), ("const", 0.1))]


def forward(p: dict, images: torch.Tensor, memory: torch.Tensor, dtype) -> torch.Tensor:
    q = {k: v.to(dtype) for k, v in p.items()}
    x = F.relu(F.conv2d(images.permute(0, 3, 1, 2).to(dtype), q["conv1.weight"],
                        q["conv1.bias"], stride=2, padding=1))
    y = F.conv2d(x, q["conv2.weight"], q["conv2.bias"], stride=2, padding=1)
    m = memory.to(dtype) @ q["memory.weight"].T + q["memory.bias"]
    return (y + m[None, :, None, None]).float()


def steps(cfg: dict, weights: dict, batches: List[List[dict]], dtype) -> dict:
    p = {k: v.detach().clone() for k, v in weights.items()}
    memory = torch.zeros(int(cfg["num_classes"]), device=next(iter(p.values())).device)
    losses, first = [], None
    for cams in batches:
        images = torch.cat([c["image"] for c in cams])
        heat = torch.cat([c["heatmap"] for c in cams])
        leaves = {k: v.requires_grad_(True) for k, v in p.items()}
        pred = forward(leaves, images, memory, dtype)
        loss = ((torch.sigmoid(pred) - heat) ** 2).mean()
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        losses.append(float(loss.detach()))
        first = grads if first is None else first
        p = {k: (v - float(cfg["lr"]) * grads[k]).detach() for k, v in leaves.items()}
        memory = 0.5 * memory + 0.5 * pred.detach().mean(dim=(0, 2, 3))
    return {"losses": losses, "grads": first, "params": p}
