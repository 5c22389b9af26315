"""Lane regression trained through differentiable polyline resampling, on the port.

The counterpart of ``examples/lane_regression_training.py``: a small MLP
reads a BEV occupancy raster of one synthetic lane and predicts its control
points; the loss resamples the prediction AND the variable-length ground
truth at the same relative arc lengths (:mod:`.polyline`) and compares them
with an L2 term, so gradients flow through the interpolation weights.

* :class:`LaneRegressor`: the example's 1024 -> 128 -> 128 -> 16 MLP
  (``predict``), its parameters loadable from the example's ``init_params``
  through :func:`.models.params.load_jax_params`;
* :func:`make_lane_batch`: the example's numpy batch, the same draws from
  the same ``numpy.random.Generator``;
* :func:`arc_length_loss`, :func:`make_train_step` and :func:`run`, the
  example's loop with ``torch.optim.Adam(lr=3e-3)`` where it uses
  ``optax.adam(3e-3)``.

Adam: optax computes ``mu_hat / (sqrt(nu_hat) + eps)``, torch divides
``sqrt(v)`` by ``sqrt(1 - beta2^t)`` before adding eps. The two agree in
exact arithmetic but round differently, so losses after a few steps agree
within a tolerance, not bitwise. Matrix products run in full float32 (TF32
off). Entry points run on the card unless ``device="cpu"``.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ._device import DeviceLike, F32MatmulScope, resolve_device
from .polyline import interpolate, interpolate_var_size_batch
from .ragged import RaggedBatch

Tensor = torch.Tensor

GRID = 32  # BEV raster resolution
MAX_GT_PTS = 12  # static bound on the ground-truth polyline length
NUM_CTRL = 8  # predicted control points per lane
NUM_SAMPLES = 16  # arc-length samples of the loss
HIDDEN = 128
LR = 3e-3


def make_lane_batch(batch_size: int, rng: np.random.Generator):
    """Synthetic quadratic lanes: a BEV occupancy raster (the model's input)
    and the generating polyline with a variable number of vertices (the
    ground truth). Returns ``(rasters (B, GRID, GRID) f32, points (B,
    MAX_GT_PTS, 2) f32, sizes (B,) i32)``, drawn as the JAX example draws."""
    rasters = np.zeros((batch_size, GRID, GRID), np.float32)
    pts = np.zeros((batch_size, MAX_GT_PTS, 2), np.float32)
    sizes = np.zeros((batch_size,), np.int32)
    for b in range(batch_size):
        n = int(rng.integers(5, MAX_GT_PTS + 1))
        a, c = rng.uniform(-0.6, 0.6), rng.uniform(0.2, 0.8)
        y = np.linspace(0.05, 0.95, n)
        x = np.clip(c + a * (y - 0.5) ** 2 * 4.0, 0.02, 0.98)
        pts[b, :n, 0], pts[b, :n, 1] = x, y
        sizes[b] = n
        # rasterize with a dense resample so the input actually shows the lane
        dense = np.linspace(0, 1, 64)
        xd = np.interp(dense, y, x)
        rasters[b, (dense * (GRID - 1)).astype(int), (xd * (GRID - 1)).astype(int)] = 1.0
    return rasters, pts, sizes


class LaneRegressor(nn.Module):
    """(B, GRID, GRID) occupancy -> (B, NUM_CTRL, 2) control points in [0, 1].

    ``fc1``/``fc2``/``fc3`` are the example's ``w1, b1`` .. ``w3, b3``
    (``Linear`` weights ``(out, in)``, the transposes of its ``(in, out)``).
    Without ``seed`` the layers keep torch's default initialization; with
    it, the weights are drawn like the example's ``init_params`` (normal
    times 1/GRID, sqrt(2/HIDDEN) and 0.01; zero biases) from a torch
    generator, whose bits differ from ``jax.random``'s.
    """

    def __init__(self, seed: Optional[int] = None):
        super().__init__()
        self.fc1 = nn.Linear(GRID * GRID, HIDDEN)
        self.fc2 = nn.Linear(HIDDEN, HIDDEN)
        self.fc3 = nn.Linear(HIDDEN, NUM_CTRL * 2)
        if seed is not None:
            gen = torch.Generator().manual_seed(seed)
            scales = (1.0 / GRID, (2.0 / HIDDEN) ** 0.5, 0.01)
            with torch.no_grad():
                for layer, scale in zip((self.fc1, self.fc2, self.fc3), scales):
                    layer.weight.copy_(torch.randn(layer.weight.shape, generator=gen) * scale)
                    layer.bias.zero_()

    def forward(self, rasters: Tensor) -> Tensor:
        x = rasters.reshape(rasters.shape[0], -1)
        x = torch.relu(self.fc1(x))
        x = torch.relu(self.fc2(x))
        ctrl = torch.sigmoid(self.fc3(x))
        return ctrl.reshape(-1, NUM_CTRL, 2)


def arc_length_loss(model: LaneRegressor, rasters: Tensor, gt: RaggedBatch) -> Tensor:
    """Resample the prediction and the variable-length ground truth at the
    same relative arc lengths, then the mean squared distance."""
    pred = model(rasters)  # (B, NUM_CTRL, 2)
    b = pred.shape[0]
    fracs = torch.linspace(0.0, 1.0, NUM_SAMPLES, device=pred.device).expand(b, NUM_SAMPLES)
    pred_samples = interpolate(pred, fracs, relative=True)
    gt_fracs = RaggedBatch.FromFullTensor(fracs)
    gt_samples = interpolate_var_size_batch(gt, gt_fracs, relative=True)
    err = pred_samples - gt_samples.tensor  # every NUM_SAMPLES row is valid
    return torch.mean(torch.sum(err * err, dim=-1))


def batch_to_device(rasters: np.ndarray, pts: np.ndarray, sizes: np.ndarray,
                    device: torch.device) -> Tuple[Tensor, RaggedBatch]:
    """One :func:`make_lane_batch` batch as ``(rasters, gt)`` on ``device``."""
    def put(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t

    return put(rasters), RaggedBatch(put(pts), sample_sizes=put(sizes))


def make_train_step(model: LaneRegressor, lr: float = LR
                    ) -> Tuple[Callable[[Tensor, RaggedBatch], Tensor], torch.optim.Adam]:
    """``step(rasters, gt) -> loss``: forward, backward and one Adam update.
    Nothing is read back to the host; the loss stays on the device."""
    opt = torch.optim.Adam(model.parameters(), lr=lr)

    def step(rasters: Tensor, gt: RaggedBatch) -> Tensor:
        with F32MatmulScope():
            opt.zero_grad(set_to_none=True)
            loss = arc_length_loss(model, rasters, gt)
            loss.backward()
            opt.step()
        return loss.detach()

    return step, opt


def make_model(seed: int = 0, params: Optional[dict] = None,
               device: DeviceLike = None) -> LaneRegressor:
    """A :class:`LaneRegressor` on ``device``: the example's ``init_params``
    as numpy arrays (``{"w1": (1024, 128), ...}``) when given, else drawn
    from ``seed``."""
    dev = resolve_device(device)
    if params is None:
        return LaneRegressor(seed).to(dev)
    from .models.params import load_jax_params

    return load_jax_params(LaneRegressor(), params).to(dev)


def train(num_steps: int = 150, batch_size: int = 32, seed: int = 0, device: DeviceLike = None,
          params: Optional[dict] = None, verbose: bool = False
          ) -> Tuple[LaneRegressor, List[float]]:
    """The example's loop; returns the model and every step's loss (read
    back per step, as the example's ``float(loss)`` does)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    model = make_model(seed, params, dev)
    step, _ = make_train_step(model)
    losses = []
    for i in range(num_steps):
        rasters, gt = batch_to_device(*make_lane_batch(batch_size, rng), dev)
        losses.append(float(step(rasters, gt)))
        if verbose and (i % 25 == 0 or i == num_steps - 1):
            print(f"step {i:3d}  arc-length L2 loss {losses[-1]:.5f}")
    return model, losses


def run(num_steps: int = 150, batch_size: int = 32, seed: int = 0, device: DeviceLike = None,
        params: Optional[dict] = None, verbose: bool = False) -> Tuple[float, float]:
    """The example's ``run``: ``(first loss, last loss)``."""
    _, losses = train(num_steps, batch_size, seed, device, params, verbose)
    return losses[0], losses[-1]


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="'cpu' for the CPU (default: the card)")
    ap.add_argument("--steps", type=int, default=150)
    args = ap.parse_args()
    first, last = run(num_steps=args.steps, device=args.device, verbose=True)
    print(f"loss {first:.5f} -> {last:.5f}")
    assert last < first * 0.5, "training did not converge"
    print("OK")
