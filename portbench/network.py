"""The network that the cell's training job brings: CenterNet's ``res_18``
(``msra_resnet.py`` of the CenterNet repository), written as a user of the
port writes a model, in ``torch.nn``.

The port ships no detector of a published shape, and its original, a
toolkit of input-pipeline and training helpers, ships none either: its
users train their own. So the benchmark holds the network, as it holds the
traffic, and the program under test is what the port gives such a job: its
pipeline feeding the step, and ``models.centernet.make_train_step``'s step
with the port's CenterNet loss on the port's ragged batches.

Precision, as the configuration states it: every convolution takes
bfloat16 operands and gives a bfloat16 result, which goes on in float32;
biases, batch norm (the batch's statistics), ReLU, pooling and the residual
adds are float32. Images ``(N, H, W, 3)`` float32 in, heads NHWC float32
out, under the port's loss's names.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

#: CenterNet's head names and the port's loss's
HEAD_NAMES = {"hm": "heatmap", "reg": "offset", "wh": "size"}


def conv(x: torch.Tensor, m: nn.Module) -> torch.Tensor:
    """``m``'s convolution (``nn.Conv2d`` or ``nn.ConvTranspose2d``) of
    bfloat16 operands, its result in float32, plus a float32 bias."""
    xb, wb = x.to(torch.bfloat16), m.weight.to(torch.bfloat16)
    if isinstance(m, nn.ConvTranspose2d):
        y = F.conv_transpose2d(xb, wb, stride=m.stride, padding=m.padding,
                               output_padding=m.output_padding)
    else:
        y = F.conv2d(xb, wb, stride=m.stride, padding=m.padding)
    y = y.float()
    return y if m.bias is None else y + m.bias[:, None, None]


def batch_norm(c: int, cfg: dict) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=float(cfg["bn_eps"]), momentum=float(cfg["bn_momentum"]))


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, cfg: dict):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = batch_norm(cout, cfg)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = batch_norm(cout, cfg)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False),
                                            batch_norm(cout, cfg))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(conv(x, self.conv1)))
        out = self.bn2(conv(out, self.conv2))
        if self.downsample is not None:
            x = self.downsample[1](conv(x, self.downsample[0]))
        return F.relu(out + x)


class CenterNetResNet(nn.Module):
    """CenterNet with a ResNet of basic blocks (``res_18``: two per stage)."""

    def __init__(self, cfg: dict):
        super().__init__()
        widths, k = [int(w) for w in cfg["widths"]], int(cfg["deconv_kernel"])
        self.conv1 = nn.Conv2d(3, widths[0], 7, 2, 3, bias=False)
        self.bn1 = batch_norm(widths[0], cfg)
        cin = widths[0]
        for s, (n, cout) in enumerate(zip(cfg["blocks"], widths)):
            blocks = []
            for j in range(int(n)):
                blocks.append(BasicBlock(cin, cout, 2 if s > 0 and j == 0 else 1, cfg))
                cin = cout
            setattr(self, f"layer{s + 1}", nn.Sequential(*blocks))
        deconv = []
        for cout in cfg["deconv_filters"]:
            deconv += [nn.ConvTranspose2d(cin, int(cout), k, 2, 1, 0, bias=False),
                       batch_norm(int(cout), cfg), nn.ReLU()]
            cin = int(cout)
        self.deconv_layers = nn.Sequential(*deconv)
        hc = int(cfg["head_conv"])
        outs = {"hm": int(cfg["num_classes"]), "reg": 2, "wh": 2}
        for name, n in outs.items():
            setattr(self, name, nn.Sequential(nn.Conv2d(cin, hc, 3, 1, 1), nn.ReLU(),
                                              nn.Conv2d(hc, n, 1)))

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = F.relu(self.bn1(conv(images.permute(0, 3, 1, 2), self.conv1)))
        x = F.max_pool2d(x, 3, 2, 1)
        for s in range(1, 5):
            x = getattr(self, f"layer{s}")(x)
        layers = list(self.deconv_layers)
        for i in range(0, len(layers), 3):
            x = F.relu(layers[i + 1](conv(x, layers[i])))
        out = {}
        for name, loss_name in HEAD_NAMES.items():
            head = getattr(self, name)
            out[loss_name] = conv(F.relu(conv(x, head[0])), head[2]).permute(0, 2, 3, 1)
        return out
