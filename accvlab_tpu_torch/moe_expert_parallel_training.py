"""Expert-parallel MoE training over a (data x expert) mesh: the counterpart
of ``examples/moe_expert_parallel_training.py``, at its widths.

The expert weights carry a leading expert dim that is ``Shard(0)`` over the
mesh's ``expert`` axis, the batch is ``Shard(0)`` over ``data``, and
:mod:`.models.moe` writes out the combine GSPMD inserts: each rank runs its
experts on every token, then the partial outputs are summed over ``expert``.
Both routings run: ``num_selected=1`` (Switch) and ``num_selected=2``
(GShard-style top-2 with renormalized gates). 8 experts, dim 32, 5 classes,
a batch of 8 x 16 tokens x 12 features, 40 SGD steps at lr 5e-2.

The mesh follows the example's rule over ranks: ``expert`` is 4 when the
world divides by 4, else 2 when it divides by 2, else 1, and ``data`` takes
the rest. Every rank holds ``8 / expert`` experts; :func:`train` asserts it
and that the loss fell.

Run: ``python -m accvlab_tpu_torch.moe_expert_parallel_training`` (the card,
one NCCL rank), with ``--device cpu`` on the CPU (one gloo rank). A
multi-rank run initialises its group first and calls :func:`train` on every
rank.
"""

from __future__ import annotations

import argparse
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ._device import resolve_device
from .models.moe import (
    MoEClassifier,
    make_moe_example_batch,
    make_moe_shardings,
    make_moe_train_step,
    shard_moe_params,
)
from .parallel import _collectives as col
from .parallel import make_mesh_nd

NUM_EXPERTS, DIM, NUM_CLASSES = 8, 32, 5
BATCH, TOKENS, IN_DIM = 8, 16, 12
STEPS, LR = 40, 5e-2


def _expert_mesh(device=None):
    """``(data, expert)`` over every rank: expert 4, else 2, else 1."""
    kind = resolve_device(device).type
    n = dist.get_world_size() if dist.is_initialized() else 1
    expert = 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)
    return make_mesh_nd((max(1, n // expert), expert), ("data", "expert"), device_type=kind)


def build(num_selected: int, device=None, mesh=None, seed: int = 0):
    """``(model, batch, step, mesh)``: the example's classifier drawn from
    ``seed`` with its weights placed on ``mesh`` (default :func:`_expert_mesh`),
    the example batch as DTensors ``Shard(0)`` over ``data``, and the SGD step."""
    mesh = mesh if mesh is not None else _expert_mesh(device)
    from .parallel.mesh import mesh_device

    dev = mesh_device(mesh)
    model = MoEClassifier(num_experts=NUM_EXPERTS, dim=DIM, num_classes=NUM_CLASSES,
                          num_selected=num_selected)
    full = make_moe_example_batch(batch_size=BATCH, tokens=TOKENS, in_dim=IN_DIM,
                                  num_classes=NUM_CLASSES, device=dev)
    init_fn, train_step = make_moe_train_step(model)
    model = init_fn(seed, full["tokens"])
    params_sh, batch_sh = make_moe_shardings(mesh, model, full)
    shard_moe_params(model, mesh, params_sh)
    batch = {k: col.from_full(v, mesh, batch_sh[k]) for k, v in full.items()}
    return model, batch, train_step, mesh


def train(num_selected: int, steps: int = STEPS, device=None, mesh=None):
    """Train the example's classifier for ``steps`` steps; returns ``(mesh,
    final loss, losses)``. ``device`` defaults to the card (raises without
    one); ``"cpu"`` runs on gloo ranks."""
    model, batch, train_step, mesh = build(num_selected, device=device, mesh=mesh)
    losses = []
    for _ in range(steps):
        model, metrics = train_step(model, batch, LR)
        losses.append(metrics["loss"])
    losses = [float(x) for x in torch.stack(losses).cpu()]
    assert losses[-1] < losses[0], "training did not reduce the loss"
    # the expert weights really live sharded over the expert axis
    w_in = model.switch.w_in
    n_expert = mesh.size(mesh.mesh_dim_names.index("expert"))
    assert isinstance(w_in, DTensor) and w_in.to_local().shape[0] == NUM_EXPERTS // n_expert
    return mesh, losses[-1], losses


def main(device: Optional[str] = None) -> dict:
    created = not dist.is_initialized()
    out = {}
    try:
        for k in (1, 2):
            mesh, loss, losses = train(num_selected=k, device=device)
            d, e = mesh.shape
            out[k] = losses
            if not dist.is_initialized() or dist.get_rank() == 0:
                print(f"top-{k} routing on a {d}x{e} (data x expert) mesh: final loss "
                      f"{loss:.4f} (first {losses[0]:.4f}), each rank holds "
                      f"{NUM_EXPERTS // e} experts")
    finally:
        if created and dist.is_initialized():
            dist.destroy_process_group()
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="'cpu' for the CPU (default: the card)")
    main(ap.parse_args().device)
