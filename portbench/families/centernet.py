"""CenterNet's family: the port's pipeline feeding the port's CenterNet
training step, and the plain reference of both.

The program, called through the port's public entry points as a training
job calls them: each step takes ``TorchPipeline.run()``'s next batch
(``bench_pipeline.headline_steps`` over the benchmark's inputs, in sample
order), through ``train_centernet_e2e.batch_to_train_inputs``, into
``models.centernet.make_train_step``'s step with the port's Adam, training
the job's network, :class:`portbench.network.CenterNetResNet`.

The inputs, made from ``--seed`` by the benchmark itself; both sides get
the same arrays, the program through :func:`provider`, a data provider of
the port's pipeline, and the reference directly:

* frames: ``num_unique`` sets of ``num_cams`` uint8 RGB frames of
  ``frame_hw``, uniform bytes; sample ``i`` shows set ``i % num_unique``;
* boxes: bench.py's per-camera draws (``x1`` in ``[0, W - 40)``, ``y1`` in
  ``[0, H - 40)``, width in ``[10, 200)``, height in ``[10, 120)``, class in
  ``[0, num_classes)``), made for every sample at once.

The pipeline's numbers: the share of image values off by more than
``IMAGE_TOL`` (a thousandth of a normalized unit, under a tenth of one
8-bit level), the largest heatmap difference, and the targets (active flag,
peak, offset, size) that differ. The control: the reference with its
convolutions' operands in fp8 instead of bf16 and the pipeline's hue
product in TF32.

``fault`` plants one of :data:`FAULTS`: ``frozen`` (the step leaves its
state unchanged), ``half_batch`` (half of the batch left out, the mean
taken over the rest), or an answer altered where the pipeline hands it out,
in camera 0 of the batch's first sample: ``altered_image`` (its image one
8-bit level brighter), ``altered_heatmap`` (its heatmap cleared) or
``altered_target`` (its first target's flag flipped).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import flops
from portbench.data import substream
from portbench.families import load_weights
from portbench.reference import centernet as ref_centernet
from portbench.reference import pipeline as ref_pipeline
from portbench.reference.layers import Adam

FAULTS = ("frozen", "half_batch", "altered_image", "altered_heatmap", "altered_target")
IMAGE_TOL = 1e-3
TARGET_TOL = 1e-5
leaf_specs = ref_centernet.leaf_specs


@dataclass
class Inputs:
    frames: np.ndarray  # (num_unique * num_cams, H, W, 3) uint8
    boxes: np.ndarray  # (num_samples, num_cams, T, 4) float32, x1 y1 x2 y2
    categories: np.ndarray  # (num_samples, num_cams, T) int32
    num_cams: int

    @property
    def num_unique(self) -> int:
        return self.frames.shape[0] // self.num_cams

    def frame(self, sample: int, cam: int) -> np.ndarray:
        return self.frames[(sample % self.num_unique) * self.num_cams + cam]


def make_inputs(seed: int, config: dict, traffic: dict) -> Inputs:
    cams = int(config["num_cams"])
    h, w = config["frame_hw"]
    n, t = int(traffic["num_samples"]), int(config["max_objects"])
    frames = substream(seed, 1).integers(0, 256, (traffic["num_unique"] * cams, h, w, 3),
                                         dtype=np.uint8)
    rng = substream(seed, 2)
    x1 = rng.uniform(0, w - 40, (n, cams, t))
    y1 = rng.uniform(0, h - 40, (n, cams, t))
    bw = rng.uniform(10, 200, (n, cams, t))
    bh = rng.uniform(10, 120, (n, cams, t))
    boxes = np.stack([x1, y1, x1 + bw, y1 + bh], axis=-1).astype(np.float32)
    categories = rng.integers(0, config["num_classes"], (n, cams, t)).astype(np.int32)
    return Inputs(frames, boxes, categories, cams)


def provider(inputs: Inputs, config: dict):
    """A data provider of the port's pipeline over ``inputs``: sample ``i``
    is ``cameras[c].{image, image_hw, annotations.{bboxes, categories}}``."""
    from accvlab_tpu_torch.pipeline import DType, SampleDataGroup
    from accvlab_tpu_torch.pipeline.inputs import DataProvider

    hw = np.asarray(config["frame_hw"], np.int32)

    def structure() -> SampleDataGroup:
        cam = SampleDataGroup()
        cam.add_data_field("image", DType.UINT8)
        cam.add_data_field("image_hw", DType.INT32)
        ann = SampleDataGroup()
        ann.add_data_field("bboxes", DType.FLOAT)
        ann.add_data_field("categories", DType.INT32)
        cam.add_data_group_field("annotations", ann)
        root = SampleDataGroup()
        root.add_data_group_field_array("cameras", cam, inputs.num_cams)
        return root

    class SeededCameras(DataProvider):
        @property
        def sample_data_structure(self) -> SampleDataGroup:
            return structure()

        def get_data(self, sample_index: int) -> SampleDataGroup:
            sdg = structure()
            for c in range(inputs.num_cams):
                cam = sdg["cameras"][c]
                cam["image"] = inputs.frame(sample_index, c)
                cam["image_hw"] = hw
                cam["annotations"]["bboxes"] = inputs.boxes[sample_index, c]
                cam["annotations"]["categories"] = inputs.categories[sample_index, c]
            return sdg

        def get_number_of_samples(self) -> int:
            return inputs.boxes.shape[0]

    return SeededCameras()


def build_pipeline(config: dict, traffic: dict, inputs: Inputs, seed: int, device):
    """The configuration's pipeline over the benchmark's inputs, in sample
    order, seeded with ``seed``."""
    from accvlab_tpu_torch.bench_pipeline import headline_steps
    from accvlab_tpu_torch.pipeline import PipelineDefinition
    from accvlab_tpu_torch.pipeline.inputs import ShuffledShardedInputCallable

    if traffic["wire"] != "frames":
        raise NotImplementedError(f"wire {traffic['wire']!r}: only raw frames are checked")
    b = int(config["batch_size"])
    prov = provider(inputs, config)
    inp = ShuffledShardedInputCallable(prov, batch_size=b, shuffle=False)
    aug = config["augment"]
    steps = headline_steps(tuple(config["out_hw"]), tuple(config["heatmap_hw"]),
                           num_classes=config["num_classes"], affine_prob=aug["affine"]["prob"],
                           photometric_prob=aug["photometric"]["prob"], hw_out_name="hw")
    definition = PipelineDefinition(inp, steps, check_data_format=False,
                                    copy_external_source_passthrough_outputs=False)
    return definition.get_pipeline(batch_size=b, num_threads=traffic.get("num_threads") or
                                   max(2, os.cpu_count() or 4),
                                   device=device, seed=seed,
                                   worker_mode=traffic.get("worker_mode", "thread"),
                                   echo_factor=int(traffic.get("echo_factor", 1)))


class Feed:
    """Hands out the pipeline's batches, the ``k``-th from host batch
    ``source(k)``."""

    def __init__(self, config: dict, traffic: dict, inputs: Inputs, seed: int, device,
                 fault: Optional[str]):
        self.echo = int(traffic.get("echo_factor", 1))
        self.pipe = build_pipeline(config, traffic, inputs, seed, device)
        self.fault = fault
        self.count = 0

    def _altered(self, out: dict) -> dict:
        what = {"altered_image": "image", "altered_heatmap": "annotations.heatmap",
                "altered_target": "annotations.active"}.get(self.fault)
        if what is None:
            return out
        key = f"cameras.[0].{what}"
        value = out[key].clone()
        if what == "image":
            value[0] += 1.0 / 57.4
        elif what == "annotations.heatmap":
            value[0] = 0.0
        else:
            value[0, 0] = ~value[0, 0]
        return {**out, key: value}

    def next(self) -> dict:
        self.count += 1
        return self._altered(self.pipe.run())

    def source(self, k: int):
        """``(host batch, echo or None)`` of the ``k``-th handed-out batch."""
        return (k // self.echo, k % self.echo if self.echo > 1 else None)

    def stats(self) -> dict:
        return dict(self.pipe.stats())

    def close(self) -> None:
        if self.pipe is not None:
            self.pipe.stop()
            self.pipe = None


class Step:
    """``models.centernet.make_train_step``'s step, with the port's Adam, on
    every camera of a batch, training :class:`portbench.network.CenterNetResNet`."""

    def __init__(self, config: dict, weights, device, fault: Optional[str]):
        from accvlab_tpu_torch.models.centernet import adam, make_train_step
        from accvlab_tpu_torch.train_centernet_e2e import batch_to_train_inputs

        from portbench.network import CenterNetResNet

        self.cams = list(range(int(config["num_cams"])))
        self.to_inputs = batch_to_train_inputs
        with torch.device(device):
            self.model = CenterNetResNet(config)
        load_weights(self.model, weights)
        _, self.train_step = make_train_step(self.model)
        self.opt = adam(self.model.parameters())
        self.b1 = self.opt.defaults["betas"][0]
        self.fault = fault
        if fault == "frozen":
            self.opt.step = lambda *a, **k: None

    def __call__(self, out: dict) -> torch.Tensor:
        if self.fault == "half_batch":
            half = next(iter(out.values())).shape[0] // 2
            out = {k: v[:half] for k, v in out.items()}
        _, _, metrics = self.train_step(self.model, self.opt, self.to_inputs(out, cam=self.cams))
        return metrics["loss"]

    def named(self):
        return list(self.model.named_parameters())

    def first_grads(self) -> Dict[str, torch.Tensor]:
        """The first step's gradient as Adam holds it: ``exp_avg / (1 - b1)``."""
        return {n: (self.opt.state[p]["exp_avg"] / (1 - self.b1)).clone()
                if p in self.opt.state else torch.zeros_like(p) for n, p in self.named()}

    def params(self) -> Dict[str, torch.Tensor]:
        return {n: p.detach().clone() for n, p in self.named()}

    def close(self) -> None:
        del self.model, self.opt


def reference_batch(inputs: Inputs, config: dict, seed: int, source, device,
                    low: bool = False) -> List[dict]:
    """The reference's batch of ``source`` (``(host batch, echo)``), per
    camera; ``low``: the hue product in TF32."""
    host_batch, echo = source
    b = int(config["batch_size"])
    idx = np.arange(host_batch * b, (host_batch + 1) * b)
    frames = np.stack([np.stack([inputs.frame(int(i), c) for c in range(inputs.num_cams)])
                       for i in idx])
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return ref_pipeline.batch_outputs(put(frames), put(inputs.boxes[idx]),
                                      put(inputs.categories[idx]), seed, host_batch, config,
                                      echo=echo, tf32=low)


def reference_steps(config: dict, weights: Dict[str, torch.Tensor], batches: List[List[dict]],
                    low: bool) -> dict:
    """The reference's first steps from ``weights`` on the reference's
    batches, with Adam, the convolutions' operands in bf16 (``low``: fp8):
    losses, the first gradients and the parameters after the steps."""
    opt = config["optimizer"]
    adam = Adam(opt["lr"], opt["b1"], opt["b2"], opt["eps"])
    p = {k: v.detach().clone() for k, v in weights.items()}
    losses, first = [], None
    for cams in batches:
        loss, grads = ref_centernet.loss_and_grads(p, ref_centernet.step_inputs(cams), config,
                                                   "fp8" if low else "bfloat16")
        losses.append(float(loss))
        first = grads if first is None else first
        p = adam.step(p, grads)
    return {"losses": losses, "grads": first, "params": p}


def flat(cams: list) -> dict:
    """A reference batch under the program's output names."""
    out = {}
    for c, d in enumerate(cams):
        out[f"cameras.[{c}].image"] = d["image"]
        for k in ("heatmap", "active", "center", "offset", "hw"):
            out[f"cameras.[{c}].annotations.{k}"] = d[k]
    return out


def pipeline_numbers(prog: List[dict], ref: List[List[dict]], config: dict) -> Dict[str, float]:
    """``prog``: the program's output dicts; ``ref``: per batch, per camera."""
    off = total = 0
    heat = 0.0
    targets = 0
    for out, cams_ref in zip(prog, ref):
        for c in range(int(config["num_cams"])):
            r = cams_ref[c]

            def p(key):
                return out[f"cameras.[{c}].{key}"]

            d = (p("image").float() - r["image"]).abs()
            off += int((d > IMAGE_TOL).sum())
            total += d.numel()
            heat = max(heat, float((p("annotations.heatmap") - r["heatmap"]).abs().max()))
            act_p, act_r = p("annotations.active").bool(), r["active"]
            bad = act_p != act_r
            bad |= act_r & (p("annotations.center").int() != r["center"]).any(-1)
            bad |= act_r & ((p("annotations.offset") - r["offset"]).abs() > TARGET_TOL).any(-1)
            bad |= act_r & ((p("annotations.hw") - r["hw"]).abs() > TARGET_TOL * 64).any(-1)
            targets += int(bad.sum())
    return {"image_off_share": off / max(total, 1), "heatmap_max_diff": heat,
            "targets_off": float(targets)}


def step_flops(cfg: dict) -> float:
    """One training step of CenterNet's ResNet network (``network.py``) on
    every camera of a batch at ``out_hw``: the 7x7 stem, the basic blocks and
    their 1x1 shortcuts, the transposed convs, and per head its 3x3 and 1x1
    convs, counted as ``flops`` says."""
    conv_ops = flops.conv_ops
    n = int(cfg["batch_size"]) * int(cfg["num_cams"])
    h, w = (-(-int(x) // 2) for x in cfg["out_hw"])
    widths = [int(c) for c in cfg["widths"]]
    first = conv_ops(n, 3, widths[0], 7, h * w)
    fwd = first
    h, w = -(-h // 2), -(-w // 2)  # the max pool
    cin = widths[0]
    for s, (blocks, cout) in enumerate(zip(cfg["blocks"], widths)):
        for j in range(int(blocks)):
            if s > 0 and j == 0:
                h, w = -(-h // 2), -(-w // 2)
            fwd += conv_ops(n, cin, cout, 3, h * w) + conv_ops(n, cout, cout, 3, h * w)
            if (s > 0 and j == 0) or cin != cout:
                fwd += conv_ops(n, cin, cout, 1, h * w)
            cin = cout
    for cout in cfg["deconv_filters"]:
        fwd += conv_ops(n, cin, int(cout), int(cfg["deconv_kernel"]), h * w)
        h, w, cin = 2 * h, 2 * w, int(cout)
    hc = int(cfg["head_conv"])
    for outs in (int(cfg["num_classes"]), 2, 2):
        fwd += conv_ops(n, cin, hc, 3, h * w) + conv_ops(n, hc, outs, 1, h * w)
    return 3.0 * fwd - first


def tiny(cfg: dict, traffic: dict) -> None:
    """A few small frames, two cameras, a narrow network."""
    cfg.update(frame_hw=[48, 64], out_hw=[32, 64], heatmap_hw=[8, 16], batch_size=2,
               num_cams=2, max_objects=4, widths=[4, 8, 8, 8], deconv_filters=[8, 8, 8],
               head_conv=4)
    traffic.update(num_unique=3, num_samples=200, warmup_steps=2, breakdown_steps=2,
                   profile_steps=2, num_threads=2)
