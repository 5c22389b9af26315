"""A second family for the harness's tests, copied to ``families/toy.py``
of a copy of the benchmark: a network that is not CenterNet's, trained on
the same pipeline's images and heatmaps, with a step that carries one
tensor of state from step to step.

The network: a 3x3 stride-2 conv to ``width`` channels, ReLU, a 3x3
stride-2 conv to the classes, plus a linear head over the carried memory
(one value per class): after each step the memory becomes half itself
plus half the batch's mean prediction per class. The loss: the mean
squared error of the sigmoid against the heatmap. Plain SGD. The inputs,
the feed and the pipeline's numbers are CenterNet's.

``fault``: ``stateless`` (the step drops its memory before each step).
"""

from __future__ import annotations

import importlib.util
import os
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from portbench import flops
from portbench.families import centernet, load_weights

FAULTS = ("stateless",)
make_inputs = centernet.make_inputs
Feed = centernet.Feed
reference_batch = centernet.reference_batch
flat = centernet.flat
pipeline_numbers = centernet.pipeline_numbers


def _reference():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "reference", "toy.py")
    spec = importlib.util.spec_from_file_location("portbench_reference_toy", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


ref = _reference()
leaf_specs = ref.leaf_specs


class Net(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        w, c = int(cfg["width"]), int(cfg["num_classes"])
        self.conv1 = nn.Conv2d(3, w, 3, 2, 1)
        self.conv2 = nn.Conv2d(w, c, 3, 2, 1)
        self.memory = nn.Linear(c, c)

    def forward(self, images: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.conv1(images.permute(0, 3, 1, 2)))
        return self.conv2(x) + self.memory(memory)[None, :, None, None]


class Step:
    def __init__(self, config: dict, weights, device, fault: Optional[str]):
        self.cams = int(config["num_cams"])
        with torch.device(device):
            self.model = Net(config)
        load_weights(self.model, weights)
        self.opt = torch.optim.SGD(self.model.parameters(), lr=float(config["lr"]))
        self.memory = torch.zeros(int(config["num_classes"]), device=device)
        self.fault = fault
        self.first = None

    def __call__(self, out: dict) -> torch.Tensor:
        images = torch.cat([out[f"cameras.[{c}].image"] for c in range(self.cams)])
        heat = torch.cat([out[f"cameras.[{c}].annotations.heatmap"] for c in range(self.cams)])
        if self.fault == "stateless":
            self.memory = torch.zeros_like(self.memory)
        self.opt.zero_grad()
        pred = self.model(images, self.memory)
        loss = F.mse_loss(torch.sigmoid(pred), heat)
        loss.backward()
        if self.first is None:
            self.first = {n: p.grad.detach().clone() for n, p in self.model.named_parameters()}
        self.opt.step()
        self.memory = 0.5 * self.memory + 0.5 * pred.detach().mean(dim=(0, 2, 3))
        return loss.detach()

    def first_grads(self) -> Dict[str, torch.Tensor]:
        return self.first

    def params(self) -> Dict[str, torch.Tensor]:
        return {n: p.detach().clone() for n, p in self.model.named_parameters()}

    def close(self) -> None:
        del self.model, self.opt


def reference_steps(config: dict, weights, batches: List[List[dict]], low: bool) -> dict:
    return ref.steps(config, weights, batches, torch.bfloat16 if low else torch.float32)


def step_flops(cfg: dict) -> float:
    n = int(cfg["batch_size"]) * int(cfg["num_cams"])
    h, w = (-(-int(x) // 2) for x in cfg["out_hw"])
    first = flops.conv_ops(n, 3, int(cfg["width"]), 3, h * w)
    second = flops.conv_ops(n, int(cfg["width"]), int(cfg["num_classes"]), 3,
                            -(-h // 2) * -(-w // 2))
    return 3.0 * (first + second) - first


def tiny(cfg: dict, traffic: dict) -> None:
    centernet.tiny(cfg, traffic)
