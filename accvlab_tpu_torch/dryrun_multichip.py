"""The multichip dry run over ranks: the counterpart of
``__graft_entry__.py``'s ``dryrun_multichip`` (its six stanzas) and of the
FSDP train step of ``tests/test_models_and_parallel.py:629``.

Each stanza builds its mesh over the ranks, places its parameters and batch
on it, and runs one train step (two for the input pipeline) at JAX's widths
and mesh shapes for ``n_devices = 8`` (``n_devices`` a multiple of 8 scales
the data axis as JAX does; one rank runs every stanza on a mesh of ones,
with the batches of 8 devices):

1. ``dp_tp``: CenterNet (8 classes, width 16, 32x32, Adam) on (data, model).
   The ``head_*`` convs hold C/m output channels per ``model`` rank: a local
   conv, then the all-gather of :mod:`.parallel._collectives` (DTensor's conv
   rule shards only the batch and would gather the weights). The focal
   loss' numerator and positive count are summed over ``data`` before the
   division.
2. ``petr``: PETR (dim 32, 16 queries, 2 layers, AdamW) on (data, seq,
   model): cameras split over ``seq``, the backbone on the local cameras,
   the tokens all-gathered over ``seq`` before the decoder; every 2-D
   ``Dense``/``head_`` kernel whose out-features divide by the ``model``
   size is column-parallel, picked by its flax path (JAX's rule).
3. ``moe``: the MoE classifier (8 experts, dim 32) on (data, expert), plain
   SGD (:mod:`.models.moe`).
4. ``pp``: the GPipe tick loop on (data, pipe 4): 4 stages of
   ``tanh(x @ w + b)``, dim 32, 6 microbatches (:func:`.parallel.pipeline_loss`).
5. ``pp_tp``: dp x pp x tp on (data, pipe 2, model 2): each stage a
   column-parallel then row-parallel MLP with a ``psum`` over ``model``.
6. ``input_pipeline``: the port's input pipeline on (data, model) (host JPEG
   decode, range normalization, heatmaps on the device) delivering its
   batches ``Shard(0)`` over ``data`` into a tensor-parallel CenterNet Adam
   step, two steps.
7. ``fsdp``: CenterNet (4 classes, width 16, 32x48, SGD) with
   :func:`.parallel.make_fsdp_shardings` placements over ``data``: each large
   leaf gathered for the step, its gradient reduce-scattered.

Every stanza returns its loss, the local shapes of its sharded leaves and
the (full) gradients or parameters its tests compare. :func:`reference_loss`
runs each stanza's step unsharded through the port's own APIs.

Run: ``python -m accvlab_tpu_torch.dryrun_multichip`` (one NCCL rank per
card, 8 cards) or ``--device cpu`` (8 gloo ranks in fresh processes);
``--n-devices 1`` runs every stanza on one rank.
"""

from __future__ import annotations

import argparse
import io
import json
import math
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from .models import centernet as cn
from .models import moe as moe_mod
from .models import petr as petr_mod
from .models.params import _leaves, load_jax_params
from .parallel import _collectives as col
from .parallel import make_fsdp_shardings, make_mesh_nd, pipeline_loss
from .parallel.mesh import mesh_device
from .ragged import RaggedBatch, average_over_targets, batched_indexing_access

# the seconds each rank process of dryrun_multichip may take
RANK_TIMEOUT_S = 900.0

STANZAS = ("dp_tp", "petr", "moe", "pp", "pp_tp", "input_pipeline", "fsdp")


def mesh_shapes(n: int) -> dict:
    """Each stanza's mesh axes and sizes on ``n`` ranks (JAX's rules; one
    rank gives a mesh of ones)."""
    if n == 1:
        one = {"dp_tp": (1, 1), "petr": (1, 1, 1), "moe": (1, 1), "pp": (1, 1),
               "pp_tp": (1, 1, 1), "input_pipeline": (1, 1), "fsdp": (1, 1)}
    elif n % 8 == 0:
        one = {"dp_tp": (n // 2, 2), "petr": (n // 4, 2, 2), "moe": (n // 4, 4),
               "pp": (n // 4, 4), "pp_tp": (n // 4, 2, 2), "input_pipeline": (n // 2, 2),
               "fsdp": (n, 1)}
    else:
        raise ValueError(f"the dry run takes 1 rank or a multiple of 8, not {n}")
    names = {"dp_tp": ("data", "model"), "petr": ("data", "seq", "model"),
             "moe": ("data", "expert"), "pp": ("data", "pipe"),
             "pp_tp": ("data", "pipe", "model"), "input_pipeline": ("data", "model"),
             "fsdp": ("data", "model")}
    return {k: (one[k], names[k]) for k in STANZAS}


def sizes(n: int) -> dict:
    """The stanzas' batch sizes at ``n`` devices (those of 8 on one rank)."""
    n = 8 if n == 1 else n
    return {"dp_tp": max(2, n // 2), "petr": max(2, n // 4), "moe": max(2, n // 4) * 2,
            "pp": 2 * (n // 4), "pp_tp": 2 * (n // 4), "input_pipeline": 8, "fsdp": 8}


# --------------------------------------------------------------------------- #
# helpers                                                                     #
# --------------------------------------------------------------------------- #


def _gsum(x: torch.Tensor, mesh, axes=("data",)) -> torch.Tensor:
    """The sum over ``axes`` (none without a mesh); its cotangent passes
    through."""
    if mesh is None:
        return x
    for a in axes:
        x = col.psum(x, mesh, a)
    return x


def _gcount(n: int, mesh, axes=("data",)) -> int:
    if mesh is None:
        return n
    return n * math.prod(col.axis_size(mesh, a) for a in axes)


def _sum_grads(params, mesh, axes) -> None:
    """Sum each gradient over ``axes`` (GSPMD's reduction of a replicated
    parameter whose ranks saw different parts of the batch)."""
    for p in params:
        for a in axes:
            if col.axis_size(mesh, a) > 1:
                dist.all_reduce(p.grad, group=mesh.get_group(a))


def _rows(x, mesh, axis="data"):
    """This rank's rows of a full batch leaf (a tensor or RaggedBatch)."""
    n, r = col.axis_size(mesh, axis), mesh.get_local_rank(axis)
    if isinstance(x, RaggedBatch):
        return RaggedBatch(_rows(x.tensor, mesh, axis), sample_sizes=_rows(x.sample_sizes, mesh,
                                                                          axis))
    return x.chunk(n, dim=0)[r]


def _full(local: torch.Tensor, mesh, placements) -> torch.Tensor:
    shape = list(local.shape)
    for d, p in enumerate(placements):
        if isinstance(p, Shard):
            shape[p.dim] *= mesh.size(d)
    shape = torch.Size(shape)
    return DTensor.from_local(local.contiguous(), mesh, tuple(placements), run_check=False,
                              shape=shape, stride=torch.empty(shape, device="meta").stride()
                              ).full_tensor()


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy() if t.dtype == torch.bfloat16 else \
        t.detach().cpu().numpy()


def _nest(flat: dict, prefix: str) -> dict:
    """``{"a/b/c": x}`` under ``prefix/`` as nested dicts."""
    out: dict = {}
    for key, v in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        node = out
        parts = key[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def flatten_inputs(prefix: str, tree: dict) -> dict:
    """The inverse of :func:`_nest` (for writing inputs to one ``.npz``)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten_inputs(f"{prefix}/{k}", v))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def _to_flax(model, tensors_by_param_id: dict) -> dict:
    """``{flax path: numpy}`` of tensors keyed by the id of the model's
    parameter they stand for, in flax's layouts."""
    out = {}
    for path, (p, (_, to_flax)) in _leaves(model).items():
        if id(p) in tensors_by_param_id:
            out["/".join(path)] = np.ascontiguousarray(to_flax(_numpy(tensors_by_param_id[id(p)])))
    return out


# --------------------------------------------------------------------------- #
# CenterNet with column-parallel heads                                        #
# --------------------------------------------------------------------------- #

HEADS = ("heatmap", "offset", "size")


def _make_centernet(num_classes, width, params, seed, dev):
    model = cn.CenterNetDetector(num_classes=num_classes, width=width)
    if params is not None:
        load_jax_params(model, params)
    else:
        cn.init_params(model, torch.Generator().manual_seed(seed))
    return model.to(dev)


def _tp_heads(model, mesh) -> dict:
    """Each head's conv weight and bias, this ``model`` rank's output
    channels, as new leaves."""
    out = {}
    for name, head in model.heads().items():
        w = col.local_shard(head.weight.detach(), mesh, _over(mesh, "model", 0))
        b = col.local_shard(head.bias.detach(), mesh, _over(mesh, "model", 0))
        out[name] = (nn.Parameter(w.clone()), nn.Parameter(b.clone()))
    return out


def _over(mesh, axis: str, dim: int) -> tuple:
    """``Shard(dim)`` over ``axis``, replicated over the other axes."""
    return tuple(Shard(dim) if n == axis else Replicate() for n in mesh.mesh_dim_names)


def _tp_centernet(model, heads, images, mesh) -> dict:
    """CenterNet's forward with column-parallel heads: the replicated
    features enter each rank's head channels (their gradient summed over
    ``model``), the local outputs are all-gathered over ``model``."""
    x = images.to(torch.bfloat16).permute(0, 3, 1, 2)
    for block in model.blocks:
        x = block(x)
    feat = col.sum_grad_over(x.float(), mesh, ("model",))
    out = {}
    for name in HEADS:
        w, b = heads[name]
        y = F.conv2d(feat, w, b).permute(0, 2, 3, 1)
        out[name] = col.all_gather(y, mesh, "model", dim=-1)
    return out


def _centernet_loss(outputs, targets, mesh) -> torch.Tensor:
    """``centernet_loss`` over the whole batch: the focal sum and positive
    count summed over ``data`` before the division, the L1 means over the
    global batch."""
    pred = torch.clamp(torch.sigmoid(outputs["heatmap"]), 1e-6, 1.0 - 1e-6)
    tgt = targets["heatmap"]
    pos = tgt >= 0.999
    pos_loss = -torch.log(pred) * (1.0 - pred) ** 2.0
    neg_loss = -torch.log(1.0 - pred) * pred ** 2.0 * (1.0 - tgt) ** 4.0
    num = _gsum(torch.where(pos, pos_loss, neg_loss).sum(), mesh)
    num_pos = _gsum(pos.sum().to(num.dtype), mesh).clamp(min=1.0)
    heat = num / num_pos

    centers = targets["centers"]
    b, wf = outputs["offset"].shape[0], outputs["offset"].shape[2]
    idx = centers.create_with_sample_sizes_like_self(
        (centers.tensor[..., 1] * wf + centers.tensor[..., 0]).to(torch.int32))

    def l1(head, tgt_rb):
        pred_rb = batched_indexing_access(head.reshape(b, -1, head.shape[-1]), idx)
        per_sample = average_over_targets(pred_rb.apply(lambda t: torch.abs(t - tgt_rb.tensor)))
        return _gsum(per_sample.sum(), mesh) / _gcount(per_sample.numel(), mesh)

    return heat + l1(outputs["offset"], targets["offsets"]) + 0.1 * l1(outputs["size"],
                                                                        targets["sizes"])


def _head_grads(model, heads, mesh) -> dict:
    """The heads' full gradients in flax's layouts."""
    grads = {}
    for name, (w, b) in heads.items():
        head = model.heads()[name]
        grads[id(head.weight)] = _full(w.grad, mesh, _over(mesh, "model", 0))
        grads[id(head.bias)] = _full(b.grad, mesh, _over(mesh, "model", 0))
    return _to_flax(model, grads)


def stanza_dp_tp(mesh, inputs: dict, n: int) -> dict:
    dev = mesh_device(mesh)
    model = _make_centernet(8, 16, inputs.get("params"), 0, dev)
    batch = cn.make_example_batch(batch_size=sizes(n)["dp_tp"], hw=(32, 32), num_classes=8,
                                  device=dev)
    heads = _tp_heads(model, mesh)
    params = list(model.blocks.parameters()) + [t for wb in heads.values() for t in wb]
    opt = cn.adam(params)
    images = _rows(batch["images"], mesh)
    targets = {k: _rows(v, mesh) for k, v in batch["targets"].items()}
    loss = _centernet_loss(_tp_centernet(model, heads, images, mesh), targets, mesh)
    loss.backward()
    _sum_grads(params, mesh, ("data",))
    grads = _head_grads(model, heads, mesh)
    opt.step()
    return {"loss": float(loss.detach()), "grads": grads,
            "local_shapes": {f"head_{k}": list(w.shape) for k, (w, _) in heads.items()}}


# --------------------------------------------------------------------------- #
# PETR on (data, seq, model)                                                  #
# --------------------------------------------------------------------------- #


def _petr_tp_layers(model, m: int) -> list:
    """The ``nn.Linear``\\ s whose flax kernel is 2-D with out-features
    divisible by ``m`` and whose path names a ``Dense`` or ``head_``."""
    linears = {id(mod.weight): mod for mod in model.modules() if isinstance(mod, nn.Linear)}
    out = []
    for path, (p, (_, to_flax)) in _leaves(model).items():
        if path[-1] != "kernel" or id(p) not in linears:
            continue
        shape = to_flax(np.empty(tuple(p.shape), np.float32)).shape
        if any("Dense" in s or "head_" in s for s in path) and len(shape) == 2 \
                and shape[-1] % m == 0:
            out.append(linears[id(p)])
    return out


@contextmanager
def _petr_parallel(model, mesh, local_weights: dict):
    """PETR's ``dense`` column-parallel over ``model`` for the layers in
    ``local_weights`` (layer -> this rank's rows), the token projection's
    output all-gathered over ``seq``. The module function is swapped for the
    stanza's forward and restored after it, whatever happens: the stanza is
    its only caller."""
    plain = petr_mod.dense

    def dense(x, layer, dtype=torch.float32):
        w = local_weights.get(layer)
        if w is None:
            return plain(x, layer, dtype)
        rows = w.shape[0]
        first = mesh.get_local_rank("model") * rows
        bias = col.sum_grad_over(layer.bias, mesh, ("model",))[first: first + rows]
        x = col.sum_grad_over(x, mesh, ("model",)).to(dtype)
        y = torch.matmul(x, w.to(dtype).t()) + bias.to(dtype)
        y = col.all_gather(y, mesh, "model", dim=-1)
        if layer is model.token_proj:
            y = col.all_gather(y, mesh, "seq", dim=1)
        return y

    petr_mod.dense = dense
    try:
        yield
    finally:
        petr_mod.dense = plain


def _petr_loss(outputs, batch, mesh) -> torch.Tensor:
    """``petr_loss`` with its means over the whole batch."""
    gt_box_m = batched_indexing_access(batch["gt_boxes"], batch["matches_gt"])
    gt_cls_m = batched_indexing_access(batch["gt_classes"], batch["matches_gt"])
    pred_box_m = batched_indexing_access(outputs["boxes3d"], batch["matches_pred"])
    pred_logit_m = batched_indexing_access(outputs["logits"], batch["matches_pred"])

    def gmean(x):
        return _gsum(x.sum(), mesh) / _gcount(x.numel(), mesh)

    box_l1 = torch.abs(gt_box_m.tensor - pred_box_m.tensor).sum(dim=-1)
    box = gmean(average_over_targets(gt_box_m.create_with_sample_sizes_like_self(box_l1)))
    ce = -torch.log_softmax(pred_logit_m.tensor, dim=-1)
    cls_data = torch.gather(ce, -1, gt_cls_m.tensor.to(torch.int64)[..., None])[..., 0]
    cls = gmean(average_over_targets(gt_cls_m.create_with_sample_sizes_like_self(cls_data)))
    target = petr_mod.get_mask_from_indices(outputs["existence"].shape[1],
                                            batch["matches_pred"]).float()
    p = torch.sigmoid(outputs["existence"])
    ex = gmean(-(target * torch.log(p + 1e-8) + (1 - target) * torch.log(1 - p + 1e-8)))
    return box * 0.25 + cls + ex


def _make_petr(params, dev):
    model = petr_mod.PETRDetector(num_classes=6, dim=32, num_queries=16, num_layers=2)
    if params is not None:
        load_jax_params(model, params)
    else:
        petr_mod.init_params(model, torch.Generator().manual_seed(0))
    return model.to(dev)


def _petr_batch(n, dev):
    return petr_mod.make_petr_example_batch(batch_size=sizes(n)["petr"], num_cams=4,
                                            hw=(16, 16), num_classes=6, device=dev)


def stanza_petr(mesh, inputs: dict, n: int) -> dict:
    dev = mesh_device(mesh)
    model = _make_petr(inputs.get("params"), dev)
    batch = _petr_batch(n, dev)
    m = col.axis_size(mesh, "model")
    tp = _petr_tp_layers(model, m)
    local = {layer: nn.Parameter(col.local_shard(layer.weight.detach(), mesh,
                                                 _over(mesh, "model", 0)).clone())
             for layer in tp}
    tp_ids = {id(layer.weight) for layer in tp}
    params = [p for p in model.parameters() if id(p) not in tp_ids] + list(local.values())
    # the backbone and the token projection see this rank's cameras only
    seq_split = {id(p) for p in model.backbone.parameters()} | {id(model.token_proj.bias)}
    seq_split.add(id(local[model.token_proj]) if model.token_proj in local
                  else id(model.token_proj.weight))
    opt = petr_mod.adamw(params)
    images = _rows(batch["images"], mesh)
    s, r = col.axis_size(mesh, "seq"), mesh.get_local_rank("seq")
    images = images.chunk(s, dim=1)[r]
    local_batch = {k: _rows(v, mesh) for k, v in batch.items() if k != "images"}
    with _petr_parallel(model, mesh, local):
        outputs = model(images)
    loss = _petr_loss(outputs, local_batch, mesh)
    loss.backward()
    _sum_grads([p for p in params if id(p) in seq_split], mesh, ("data", "seq"))
    _sum_grads([p for p in params if id(p) not in seq_split], mesh, ("data",))
    grads = _to_flax(model, {id(layer.weight): _full(w.grad, mesh, _over(mesh, "model", 0))
                             for layer, w in local.items()})
    opt.step()
    names = {id(p): "/".join(path) for path, (p, _) in _leaves(model).items()}
    return {"loss": float(loss.detach()), "grads": grads,
            "local_shapes": {"images": list(images.shape),
                             **{names[id(layer.weight)]: list(w.shape[::-1])
                                for layer, w in local.items()}}}


# --------------------------------------------------------------------------- #
# MoE, pipeline parallelism                                                   #
# --------------------------------------------------------------------------- #


def _moe_model(inputs, dev):
    model = moe_mod.MoEClassifier(num_experts=8, dim=32, num_classes=6)
    if "params" in inputs:
        load_jax_params(model, inputs["params"])
    else:
        model.build(24)
        moe_mod.init_params(model, torch.Generator().manual_seed(1))
    return model.to(dev)


def _moe_batch(inputs, n, dev):
    if "batch" in inputs:
        return {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in inputs["batch"].items()}
    return moe_mod.make_moe_example_batch(sizes(n)["moe"], 16, 24, 6, device=dev)


def stanza_moe(mesh, inputs: dict, n: int) -> dict:
    dev = mesh_device(mesh)
    model = _moe_model(inputs, dev)
    full = _moe_batch(inputs, n, dev)
    params_sh, batch_sh = moe_mod.make_moe_shardings(mesh, model, full)
    moe_mod.shard_moe_params(model, mesh, params_sh)
    batch = {k: col.from_full(v, mesh, batch_sh[k]) for k, v in full.items()}
    loss = moe_mod.moe_loss(model, batch)
    loss.backward()
    sw = model.switch
    grads = _to_flax(model, {id(p): p.grad.full_tensor() for p in
                             (sw.w_in, sw.w_out, sw.router.weight, model.dense_0.weight)})
    with torch.no_grad():
        for p in model.parameters():
            p.sub_(1e-2 * p.grad)
    return {"loss": float(loss.detach()), "grads": grads,
            "local_shapes": {"w_in": list(sw.w_in.to_local().shape),
                             "w_out": list(sw.w_out.to_local().shape)}}


def _pp_inputs(inputs, key: str, n: int, dev) -> dict:
    """The stanza's stage parameters, microbatches and targets (JAX's when
    given, else drawn from a CPU generator: one stage per rank of ``pipe``,
    so one on one rank)."""
    if inputs:
        return {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in inputs.items()}
    gen = torch.Generator().manual_seed(2 if key == "pp" else 4)
    mb = sizes(n)[key]
    s = mesh_shapes(n)[key][0][1]  # one stage per rank of the pipe axis
    if key == "pp":
        out = {"w": torch.randn(s, 32, 32, generator=gen) * 0.2,
               "b": torch.randn(s, 32, generator=gen) * 0.05,
               "xs": torch.randn(6, mb, 32, generator=gen),
               "tgts": torch.randn(6, mb, 32, generator=gen)}
    else:
        out = {"w1": torch.randn(s, 16, 32, generator=gen) * 0.2, "b1": torch.zeros(s, 32),
               "w2": torch.randn(s, 32, 16, generator=gen) * 0.2, "b2": torch.zeros(s, 16),
               "xs": torch.randn(6, mb, 16, generator=gen),
               "tgts": torch.randn(6, mb, 16, generator=gen)}
    return {k: v.to(dev) for k, v in out.items()}


def _mse(y, t):
    return ((y - t) ** 2).mean()


def _pp_stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _pp_tp_stage(mesh):
    def stage(p, x):
        # x is replicated over model and enters this rank's hidden columns
        x = col.sum_grad_over(x, mesh, ("model",))
        h = torch.tanh(x @ p["w1"] + p["b1"])
        return torch.tanh(col.psum(h @ p["w2"], mesh, "model") + p["b2"])

    return stage


PP_TP_SPECS = {"w1": ("pipe", None, "model"), "b1": ("pipe", "model"),
               "w2": ("pipe", "model", None), "b2": ("pipe",)}


def _spec_placements(mesh, spec) -> tuple:
    """A JAX ``PartitionSpec``'s entries as placements on ``mesh``."""
    return tuple(Shard(spec.index(name)) if name in spec else Replicate()
                 for name in mesh.mesh_dim_names)


def _pipeline_step(mesh, data: dict, specs: dict, stage_fn) -> dict:
    params = {k: col.from_full(data[k], mesh, _spec_placements(mesh, specs[k])).requires_grad_()
              for k in specs}
    xspec = _spec_placements(mesh, (None, "data"))
    xs, tgts = (col.from_full(data[k], mesh, xspec) for k in ("xs", "tgts"))
    pl = {k: _spec_placements(mesh, s) for k, s in specs.items()}
    loss = pipeline_loss(params, xs, tgts, stage_fn, _mse, mesh=mesh, data_spec=("data",),
                         param_specs=pl)
    loss.backward()
    grads = {k: _numpy(p.grad.full_tensor()) for k, p in params.items()}
    with torch.no_grad():
        for p in params.values():
            p.sub_(1e-2 * p.grad)
    return {"loss": float(loss.detach()), "grads": grads,
            "local_shapes": {k: list(p.to_local().shape) for k, p in params.items()}}


def stanza_pp(mesh, inputs: dict, n: int) -> dict:
    data = _pp_inputs(inputs, "pp", n, mesh_device(mesh))
    return _pipeline_step(mesh, data, {"w": ("pipe",), "b": ("pipe",)}, _pp_stage)


def stanza_pp_tp(mesh, inputs: dict, n: int) -> dict:
    data = _pp_inputs(inputs, "pp_tp", n, mesh_device(mesh))
    return _pipeline_step(mesh, data, PP_TP_SPECS, _pp_tp_stage(mesh))


# --------------------------------------------------------------------------- #
# the input pipeline feeding a TP CenterNet step                              #
# --------------------------------------------------------------------------- #

PIPE_HW, PIPE_CLASSES, PIPE_STEPS = (64, 96), 4, 2


def _pipeline_definition(num_shards: int = 1, shard_id: int = 0):
    """The stanza's provider and steps (``__graft_entry__.py:480-543``)."""
    from PIL import Image

    from .pipeline import DType, PipelineDefinition, SampleDataGroup
    from .pipeline.inputs import DataProvider, ShuffledShardedInputCallable
    from .pipeline.processing_steps import (
        BoundingBoxToHeatmapConverter,
        ImageDecoder,
        ImageRange01Normalizer,
    )

    hw = PIPE_HW

    class Provider(DataProvider):
        def __init__(self):
            rng = np.random.default_rng(0)
            self._jpegs = []
            for _ in range(4):
                img = rng.integers(0, 255, (*hw, 3), np.uint8)
                buf = io.BytesIO()
                Image.fromarray(img).save(buf, format="JPEG", quality=85)
                self._jpegs.append(np.frombuffer(buf.getvalue(), np.uint8).copy())

        @property
        def sample_data_structure(self):
            ann = SampleDataGroup()
            ann.add_data_field("bboxes", DType.FLOAT)
            ann.add_data_field("categories", DType.INT32)
            sdg = SampleDataGroup()
            sdg.add_data_field("image", DType.UINT8)
            sdg.add_data_field("image_hw", DType.INT32)
            sdg.add_data_group_field("annotations", ann)
            return sdg

        def get_data(self, i):
            rng = np.random.default_rng(i)
            sdg = self.sample_data_structure
            sdg["image"] = self._jpegs[i % len(self._jpegs)]
            sdg["image_hw"] = np.asarray(hw, np.int32)
            x1 = rng.uniform(0, hw[1] - 20, (4,))
            y1 = rng.uniform(0, hw[0] - 20, (4,))
            sdg["annotations"]["bboxes"] = np.stack([x1, y1, x1 + 16, y1 + 12],
                                                    1).astype(np.float32)
            sdg["annotations"]["categories"] = rng.integers(0, PIPE_CLASSES,
                                                            (4,)).astype(np.int32)
            return sdg

        def get_number_of_samples(self):
            return 16

    batch = 8 // num_shards
    return PipelineDefinition(
        ShuffledShardedInputCallable(Provider(), batch_size=batch, shard_id=shard_id,
                                     num_shards=num_shards),
        [
            ImageDecoder("image", decode_resize_hw=hw),
            ImageRange01Normalizer("image"),
            BoundingBoxToHeatmapConverter(
                annotation_field_name="annotations", bboxes_in_name="bboxes",
                heatmap_out_name="heatmap", heatmap_hw=(hw[0] // 4, hw[1] // 4),
                image_hw_field_name="image_hw", categories_in_name="categories",
                num_categories=PIPE_CLASSES, is_active_opt_out_name="active",
                center_opt_out_name="center", center_offset_opt_out_name="offset"),
        ],
        check_data_format=False, copy_external_source_passthrough_outputs=False,
    ), batch


def _pipe_loss(out, images_heat, mesh) -> torch.Tensor:
    """The stanza's focal loss + 0.01 x the mean |offset| and |size|, over
    the whole batch."""
    heat_t = images_heat.permute(0, 2, 3, 1)
    pred = torch.sigmoid(out["heatmap"].float())
    pos = heat_t >= 0.999
    pos_l = torch.where(pos, (1 - pred) ** 2 * -torch.log(pred + 1e-6), 0.0)
    neg_l = torch.where(~pos, (1 - heat_t) ** 4 * pred ** 2 * -torch.log(1 - pred + 1e-6), 0.0)
    focal = _gsum(pos_l.sum() + neg_l.sum(), mesh) / torch.clamp(
        _gsum(pos.sum().float(), mesh), min=1.0)
    reg = sum(_gsum(out[k].abs().sum(), mesh) / _gcount(out[k].numel(), mesh)
              for k in ("offset", "size"))
    return focal + 0.01 * reg


def stanza_input_pipeline(mesh, inputs: dict, n: int) -> dict:
    dev = mesh_device(mesh)
    shard, shards = mesh.get_local_rank("data"), col.axis_size(mesh, "data")
    definition, batch_size = _pipeline_definition(shards, shard)
    pipe = definition.get_pipeline(batch_size=batch_size, num_threads=2, device=dev, seed=0,
                                   mesh=mesh)
    try:
        model = _make_centernet(PIPE_CLASSES, 16, inputs.get("params"), 0, dev)
        heads = _tp_heads(model, mesh)
        params = list(model.blocks.parameters()) + [t for wb in heads.values() for t in wb]
        opt = cn.adam(params)
        delivered, losses = [], []
        for _ in range(PIPE_STEPS):
            batch = pipe.run()
            img, heat = batch["image"], batch["annotations.heatmap"]
            if not (isinstance(img, DTensor) and img.placements == _over(mesh, "data", 0)):
                raise RuntimeError("the input batch must arrive data-sharded over the mesh")
            delivered.append((_numpy(img.full_tensor()), _numpy(heat.full_tensor())))
            opt.zero_grad(set_to_none=True)
            loss = _pipe_loss(_tp_centernet(model, heads, img.to_local(), mesh),
                              heat.to_local(), mesh)
            loss.backward()
            _sum_grads(params, mesh, ("data",))
            opt.step()
            losses.append(float(loss))
    finally:
        pipe.stop()
    return {"loss": losses[-1], "losses": losses,
            "batches": {f"{i}/{k}": v for i, (im, ht) in enumerate(delivered)
                        for k, v in (("image", im), ("heatmap", ht))},
            "local_shapes": {"image": list(img.to_local().shape),
                             **{f"head_{k}": list(w.shape) for k, (w, _) in heads.items()}}}


# --------------------------------------------------------------------------- #
# FSDP                                                                        #
# --------------------------------------------------------------------------- #


def stanza_fsdp(mesh, inputs: dict, n: int) -> dict:
    dev = mesh_device(mesh)
    model = _make_centernet(4, 16, inputs.get("params"), 0, dev)
    batch = cn.make_example_batch(batch_size=sizes(n)["fsdp"], hw=(32, 48), num_classes=4,
                                  device=dev)
    named = dict(model.named_parameters())
    placements = make_fsdp_shardings({k: v.detach() for k, v in named.items()}, mesh,
                                     min_size=1024)
    local = {k: nn.Parameter(col.local_shard(v.detach(), mesh, placements[k]).clone())
             for k, v in named.items()}

    def gathered(k):
        pl = placements[k]
        x = local[k]
        for d, p in enumerate(pl):
            if isinstance(p, Shard):
                x = col.all_gather(x, mesh, mesh.mesh_dim_names[d], dim=p.dim)
        # every data rank uses the whole leaf on its own rows: the cotangents
        # are summed, then each rank keeps its slice (a reduce-scatter)
        return col.sum_grad_over(x, mesh, ("data",))

    full = {k: gathered(k) for k in named}
    outputs = torch.func.functional_call(model, full, (_rows(batch["images"], mesh),))
    targets = {k: _rows(v, mesh) for k, v in batch["targets"].items()}
    loss = _centernet_loss(outputs, targets, mesh)
    loss.backward()
    with torch.no_grad():
        for p in local.values():
            p.sub_(1e-2 * p.grad)
    after = {id(named[k]): _full(local[k].detach(), mesh, placements[k]) for k in named}
    return {"loss": float(loss.detach()), "params": _to_flax(model, after),
            "local_shapes": {k: list(v.shape) for k, v in local.items()
                             if any(isinstance(p, Shard) for p in placements[k])}}


RUNNERS = {"dp_tp": stanza_dp_tp, "petr": stanza_petr, "moe": stanza_moe, "pp": stanza_pp,
           "pp_tp": stanza_pp_tp, "input_pipeline": stanza_input_pipeline, "fsdp": stanza_fsdp}


# --------------------------------------------------------------------------- #
# the steps unsharded, through the port's own APIs                            #
# --------------------------------------------------------------------------- #


def reference_loss(stanza: str, n: int = 8, device=None, inputs: Optional[dict] = None) -> float:
    """The stanza's loss, one step (the input pipeline's two) unsharded on
    ``device`` (default the card) through the port's public trainers."""
    from ._device import resolve_device

    dev = resolve_device(device)
    inputs = inputs or {}
    if stanza in ("dp_tp", "fsdp"):
        classes, hw = (8, (32, 32)) if stanza == "dp_tp" else (4, (32, 48))
        model = _make_centernet(classes, 16, inputs.get("params"), 0, dev)
        batch = cn.make_example_batch(batch_size=sizes(n)[stanza], hw=hw, num_classes=classes,
                                      device=dev)
        opt = (cn.adam if stanza == "dp_tp" else
               (lambda p: torch.optim.SGD(p, lr=1e-2)))(model.parameters())
        _, step = cn.make_train_step(model)
        return float(step(model, opt, batch)[2]["loss"])
    if stanza == "petr":
        model = _make_petr(inputs.get("params"), dev)
        _, step = petr_mod.make_petr_train_step(model)
        return float(step(model, petr_mod.adamw(model.parameters()), _petr_batch(n, dev))[2]
                     ["loss"])
    if stanza == "moe":
        model = _moe_model(inputs, dev)
        _, step = moe_mod.make_moe_train_step(model)
        return float(step(model, _moe_batch(inputs, n, dev))[1]["loss"])
    if stanza in ("pp", "pp_tp"):
        data = _pp_inputs(inputs, stanza, n, dev)
        names = ("w", "b") if stanza == "pp" else ("w1", "b1", "w2", "b2")

        def chain(x):
            for s in range(data[names[0]].shape[0]):
                p = {k: data[k][s] for k in names}
                if stanza == "pp":
                    x = _pp_stage(p, x)
                else:
                    x = torch.tanh(torch.tanh(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"])
            return x

        xs, tgts = data["xs"], data["tgts"]
        return float(sum(_mse(chain(xs[i]), tgts[i]) for i in range(xs.shape[0])) / xs.shape[0])
    if stanza == "input_pipeline":
        definition, batch_size = _pipeline_definition()
        pipe = definition.get_pipeline(batch_size=batch_size, num_threads=2, device=dev, seed=0)
        try:
            model = _make_centernet(PIPE_CLASSES, 16, inputs.get("params"), 0, dev)
            opt = cn.adam(model.parameters())
            for _ in range(PIPE_STEPS):
                batch = pipe.run()
                opt.zero_grad(set_to_none=True)
                loss = _pipe_loss(model(batch["image"]), batch["annotations.heatmap"], None)
                loss.backward()
                opt.step()
        finally:
            pipe.stop()
        return float(loss)
    raise ValueError(f"unknown stanza {stanza!r}")


# --------------------------------------------------------------------------- #
# drivers                                                                     #
# --------------------------------------------------------------------------- #


def run_stanzas(device_type: str, inputs: Optional[dict] = None, stanzas=STANZAS) -> dict:
    """Every stanza on this rank (the process group is the caller's, or one
    rank made here); ``inputs`` holds flat ``"stanza/..."`` numpy arrays
    (JAX's parameters and batches) or nothing. Returns ``{stanza: result}``
    with each stanza's mesh shape."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    shapes = mesh_shapes(n)
    inputs = inputs or {}
    out = {}
    for name in stanzas:
        shape, axes = shapes[name]
        mesh = make_mesh_nd(shape, axes, device_type=device_type)
        res = RUNNERS[name](mesh, _nest(inputs, name), n)
        res["mesh"] = dict(zip(axes, shape))
        out[name] = res
    return out


def _rank_main(args) -> None:
    if args.device == "cuda":
        torch.cuda.set_device(args.rank)
    backend = "nccl" if args.device == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.FileStore(args.store, args.world),
                            rank=args.rank, world_size=args.world)
    try:
        res = run_stanzas(args.device)
        summary = {k: {"loss": v["loss"], "mesh": v["mesh"], "local_shapes": v["local_shapes"]}
                   for k, v in res.items()}
        with open(f"{args.out}.{args.rank}.json", "w") as f:
            json.dump(summary, f)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int = 8, device=None) -> dict:
    """Run the stanzas on ``n_devices`` ranks in fresh processes: one NCCL
    rank per card (the default; raises without enough cards), or gloo ranks
    on the CPU with ``device="cpu"``. Returns rank 0's ``{stanza: {"loss",
    "mesh", "local_shapes"}}``."""
    kind = "cuda" if device is None else torch.device(device).type
    if kind == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"no CUDA device is available for each of {n_devices} ranks (found "
                           f"{torch.cuda.device_count()}); pass device='cpu' for gloo ranks")
    mesh_shapes(n_devices)  # raises for a world the stanzas do not take
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "result")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [repo] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]),
            OMP_NUM_THREADS="1")
        procs = [subprocess.Popen(
            [sys.executable, "-m", "accvlab_tpu_torch.dryrun_multichip", "--rank", str(r),
             "--world", str(n_devices), "--store", os.path.join(tmp, "store"), "--out", out,
             "--device", kind], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=repo) for r in range(n_devices)]
        try:
            with ThreadPoolExecutor(n_devices) as pool:
                logs = list(pool.map(lambda p: p.communicate(timeout=RANK_TIMEOUT_S), procs))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, (_, err)) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise RuntimeError(f"dry-run rank {r} failed:\n{err[-3000:]}")
        with open(f"{out}.0.json") as f:
            return json.load(f)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="'cpu' for gloo ranks (default: the card)")
    ap.add_argument("--n-devices", type=int, default=8)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        _rank_main(args)
        return
    for name, res in dryrun_multichip(args.n_devices, args.device).items():
        mesh = " x ".join(f"{k} {v}" for k, v in res["mesh"].items())
        print(f"dryrun_multichip {name}: mesh {mesh}, loss={res['loss']:.4f}")


if __name__ == "__main__":
    main()
