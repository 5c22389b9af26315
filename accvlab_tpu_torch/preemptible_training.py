"""Preemption-safe training on a mesh: the counterpart of
``examples/preemptible_training.py``.

* input: a synthetic JPEG dataset through the port's pipeline (host JPEG
  decode, tile padding and range normalization, then the random
  ``PhotoMetricDistorter`` on the device) on a :mod:`.parallel` mesh: each
  rank reads its data coordinate's shard of the input
  (:func:`~.parallel.mesh.data_shard_info`)
  and gets its part of the global batch as ``DTensor``\\ s;
* training: CenterNet (width 8) with Adam, data-parallel: each rank takes the
  gradient of its part of the batch and the gradients are averaged over
  ``data`` by an explicit all-reduce, where JAX's GSPMD inserts the
  ``psum``;
* checkpoints: :mod:`.models.checkpoint` saves the parameters, the optimizer
  state and ``pipe.get_state()``, the consumed position, every step;
* preemption: the run stops after step 3; a new run rebuilds everything,
  restores and continues.

:func:`main` asserts that the resumed run's losses and final parameters are
bitwise those of an uninterrupted run, on a mesh of one rank (the card or
the CPU) or of several gloo ranks.

The restarted run's rebuilt pipeline reuses the first run's traced device
stage (:mod:`.tools.program_cache`; on the card its CUDA graph): :func:`main`
asserts that the resumed run's stage is a cache hit. JAX also builds the
train step with ``shared_jit`` (``examples/preemptible_training.py:151-166``);
here the step stays an ``nn.Module`` with a ``torch.optim`` optimizer,
whose state is not a tensor tree, so it runs eagerly (ROADMAP.md §3).

JAX's elastic stanza resumes the same global batch onto half the devices of
one process. With one process per device, two ranks' stream positions
cannot merge into one, so :func:`elastic_restore` restores a checkpoint's
replicated parameters onto any mesh (the sharded restore); the stream's
elastic resize is :class:`~.pipeline.inputs.ElasticShardedInputCallable`'s.

Run: ``python -m accvlab_tpu_torch.preemptible_training`` (the card), with
``--device cpu`` on the CPU. A multi-rank run initialises its gloo or NCCL
group first and calls :func:`main` on every rank.
"""

from __future__ import annotations

import argparse
import io
import shutil
import tempfile
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
import torch.utils._pytree as pytree
from torch.distributed.tensor import DTensor, Replicate

from .models.centernet import CenterNetDetector, adam, init_params
from .models.checkpoint import (
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
    wait_for_checkpoints,
)
from .parallel import make_mesh
from .parallel.mesh import data_shard_info, mesh_device
from .pipeline import DType, PipelineDefinition, SampleDataGroup
from .pipeline.inputs import DataProvider, ShuffledShardedInputCallable
from .pipeline.processing_steps import (
    ImageDecoder,
    ImageRange01Normalizer,
    ImageToTileSizePadder,
    PhotoMetricDistorter,
)
from .tools.program_cache import program_cache_stats

NUM_CLASSES = 3
HW = (24, 32)


class SyntheticProvider(DataProvider):
    """Tiny JPEG dataset; 32 samples keep a full demo epoch at 4 batches so
    the run crosses an epoch boundary and the preemption lands mid-epoch."""

    def __init__(self, n=32):
        from PIL import Image

        self._jpegs = []
        rng = np.random.default_rng(7)
        for _ in range(n):
            img = rng.integers(0, 255, (*HW, 3), np.uint8)
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, format="JPEG", quality=92)
            self._jpegs.append(np.frombuffer(buf.getvalue(), np.uint8).copy())
        self._n = n

    @property
    def sample_data_structure(self):
        sdg = SampleDataGroup()
        sdg.add_data_field("image", DType.UINT8)
        sdg.add_data_field("label", DType.INT32)
        return sdg

    def get_data(self, i):
        sdg = self.sample_data_structure
        sdg["image"] = self._jpegs[i]
        sdg["label"] = i % NUM_CLASSES
        return sdg

    def get_number_of_samples(self):
        return self._n


def _data_size(mesh) -> int:
    return mesh.size(mesh.mesh_dim_names.index("data"))


def build_pipeline(mesh, batch_size: int):
    """The example's pipeline on ``mesh``: this rank reads its data
    coordinate's shard of the input, ``batch_size // num_shards`` samples
    per batch."""
    shard_id, num_shards = data_shard_info(mesh)
    local = batch_size // num_shards
    inp = ShuffledShardedInputCallable(SyntheticProvider(), batch_size=local, shuffle=True,
                                       shard_id=shard_id, num_shards=num_shards)
    definition = PipelineDefinition(
        inp,
        [
            ImageDecoder("image"),
            ImageToTileSizePadder("image", 8),
            ImageRange01Normalizer("image"),
            # random device augmentation: the resumed stream must reproduce
            # the draws, not just the sample order
            PhotoMetricDistorter(
                "image",
                min_max_brightness=[-0.1, 0.1],
                min_max_hue=[-8.0, 8.0],
                min_max_contrast=[0.9, 1.1],
                min_max_saturation=[0.9, 1.1],
            ),
        ],
    )
    return definition.get_pipeline(batch_size=local, num_threads=2, seed=11, mesh=mesh)


def make_train_state(mesh):
    """``(model, optimizer, step)``: the same seeded parameters on every
    rank, Adam(1e-3), and a data-parallel step over ``mesh``'s ``data``
    axis that returns the global batch's loss."""
    model = CenterNetDetector(num_classes=NUM_CLASSES, width=8)
    init_params(model, torch.Generator().manual_seed(0))
    model.to(mesh_device(mesh))
    opt = adam(model.parameters())
    n = _data_size(mesh)
    group = mesh.get_group("data") if n > 1 else None

    def step(images, labels):
        out = model(images)
        pooled = out["heatmap"].float().mean(dim=(1, 2))
        onehot = F.one_hot(labels.long(), NUM_CLASSES).float()
        loss = ((torch.sigmoid(pooled) - onehot) ** 2).mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        loss = loss.detach()
        if group is not None:  # the mean over the global batch
            for p in model.parameters():
                if p.grad is not None:  # the offset and size heads take no part
                    dist.all_reduce(p.grad, group=group)
                    p.grad.div_(n)
            dist.all_reduce(loss, group=group)
            loss = loss / n
        opt.step()
        return loss

    return model, opt, step


def next_batch(pipe):
    """Epoch handling: reset and continue at the epoch's end."""
    try:
        return pipe.run()
    except StopIteration:
        pipe.reset()
        return pipe.run()


def train(mesh, batch_size: int, num_steps: int, ckpt_dir: Optional[str] = None,
          ckpt_every: int = 0, preempt_after: Optional[int] = None,
          resume_from: Optional[str] = None):
    """Run ``num_steps`` steps; optionally checkpoint, stop early (a
    preemption) or resume from a checkpoint first. Returns the losses and
    the final parameters."""
    pipe = build_pipeline(mesh, batch_size)
    model, opt, train_step = make_train_state(mesh)
    step = 0
    if resume_from is not None:
        params, opt_state, meta = restore_checkpoint(
            resume_from, {"params": model.state_dict(), "opt_state": None})
        model.load_state_dict(params)
        opt.load_state_dict(opt_state)
        step = int(meta["step"])
        pipe.set_state(meta["pipeline"])

    losses = []
    try:
        while step < num_steps:
            batch = next_batch(pipe)
            losses.append(train_step(batch["image"].to_local(), batch["label"].to_local()))
            step += 1
            if ckpt_every and ckpt_dir and step % ckpt_every == 0:
                save_checkpoint(ckpt_dir, step, model.state_dict(), opt.state_dict(),
                                pipeline_state=pipe.get_state(), asynchronous=True, keep=3)
            if preempt_after is not None and step >= preempt_after:
                break  # the preemption: no cleanup, no draining
    finally:
        if ckpt_dir:
            # a preemption handler flushes in-flight saves on SIGTERM
            wait_for_checkpoints()
        pipe.stop()
    return losses, {k: v.detach().clone() for k, v in model.state_dict().items()}


def elastic_restore(mesh, path: str):
    """A checkpoint's parameters restored onto ``mesh``, replicated over
    every mesh dim (``DTensor`` leaves), whatever the world that saved it.
    Returns the parameters and the checkpoint's meta."""
    model = CenterNetDetector(num_classes=NUM_CLASSES, width=8)
    replicated = tuple(Replicate() for _ in range(mesh.ndim))
    template = pytree.tree_map(
        lambda v: DTensor.from_local(torch.empty(v.shape, device="meta"), mesh, replicated,
                                     run_check=False, shape=v.shape, stride=v.stride()),
        model.state_dict())
    params, _, meta = restore_checkpoint(path, {"params": template, "opt_state": None})
    return params, meta


def main(num_steps: int = 6, preempt_after: int = 3, workdir: Optional[str] = None,
         device_type: Optional[str] = None) -> dict:
    """The uninterrupted run, the run preempted after ``preempt_after``
    steps (checkpointing every step) and the resumed run, on
    ``make_mesh(device_type=device_type)``. Every rank of a group calls this
    with the same ``workdir``, a directory they share. Asserts the resumed
    tail bitwise and that the resumed run's device stage was a hit of the
    shared-program cache; returns the losses and parameters of each run, and
    the cache's counters over the resumed run (``resume_program_cache``)."""
    mesh = make_mesh(device_type=device_type)
    if workdir is None and dist.get_world_size() > 1:
        raise ValueError("a run of several ranks needs a workdir that they share")
    batch_size = max(8, _data_size(mesh))  # divisible by the data axis
    owns_dir = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="accvlab_torch_preempt_")
    cudnn = torch.backends.cudnn.deterministic
    # bitwise reruns on the card need deterministic convolution algorithms
    torch.backends.cudnn.deterministic = True
    try:
        ref_losses, ref_params = train(mesh, batch_size, num_steps)
        pre_losses, pre_params = train(mesh, batch_size, num_steps, ckpt_dir=workdir,
                                       ckpt_every=1, preempt_after=preempt_after)
        ckpt = latest_checkpoint(workdir)
        before = program_cache_stats()
        res_losses, res_params = train(mesh, batch_size, num_steps, resume_from=ckpt)
        after = program_cache_stats()
        cache = {k: after[k] - before[k] for k in ("hits", "misses", "declined")}
        assert cache == {"hits": 1, "misses": 0, "declined": 0}, (
            f"the resumed run's device stage did not reuse the shared program: {cache}")
        assert torch.equal(torch.stack(ref_losses[preempt_after:]), torch.stack(res_losses)), (
            "the resumed losses differ from the uninterrupted run's")
        for k, v in ref_params.items():
            assert torch.equal(v, res_params[k]), f"parameter {k} differs after the resume"
        return {"ref_losses": ref_losses, "pre_losses": pre_losses, "res_losses": res_losses,
                "pre_params": pre_params, "res_params": res_params, "checkpoint": ckpt,
                "resume_program_cache": cache}
    finally:
        torch.backends.cudnn.deterministic = cudnn
        if owns_dir:
            shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="the mesh's device type (default: the card)")
    args = ap.parse_args()
    res = main(device_type=args.device)
    print(f"preemption at step 3/6 on a mesh of {dist.get_world_size()} rank(s): the resumed "
          f"losses {[round(float(x), 6) for x in res['res_losses']]} and final parameters are "
          "bitwise the uninterrupted run's")
    dist.destroy_process_group()
