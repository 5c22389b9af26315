"""StreamPETR training end to end: bench.py's pipeline in drive order ->
motion-aware streaming PETR.

The port's counterpart of ``examples/stream_petr_video_training.py``, with
the port's own pipeline in place of the video reader (as
:mod:`.train_centernet_e2e` is for the CenterNet example): bench.py's six
JPEG cameras on the YUV wire (:func:`~.bench_pipeline.build_pipeline`) read
through ``SamplerInputCallable(MultiCameraJpegProvider, SequenceSampler)``,
160 drives of 40 frames (nuScenes' scene length), so each batch slot walks
one drive forward. Each batch trains
:func:`~.models.petr.make_motion_petr_train_step` with the example's
synthetic labels (:func:`synth_labels`) and ego motion (:func:`ego_forward`),
carrying ``(memory, memory_ref)`` from step to step; as in the example, the
memory is not reset at a drive boundary. :meth:`StreamTrainer.evaluate` is
the example's evaluation: ``decode_detections_3d`` and the nuScenes
centre-distance mAP. Driven on the card by ``chip_smoke.py`` (phase
``petr``).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .bench_pipeline import build_pipeline
from .models.eval import DetectionEvaluator
from .models.params import load_jax_params
from .models.petr import PETRDetector, decode_detections_3d, make_motion_petr_train_step
from .pipeline.inputs import SequenceSampler
from .ragged import RaggedBatch

#: nuScenes' scene length in frames, and drives to cover bench.py's 6,400 samples
DRIVE_LENGTH = 40
NUM_DRIVES = 160


def build_stream_pipeline(batch_size: int = 8, num_drives: int = NUM_DRIVES,
                          drive_length: int = DRIVE_LENGTH, seed: int = 0,
                          sampler_iterations: int = 1024, wire: str = "yuv", **kwargs):
    """bench.py's pipeline (the other arguments of
    :func:`~.bench_pipeline.build_pipeline`; the YUV wire by default) over a
    ``SequenceSampler(total_batch_size=batch_size, sequence_lengths=
    [drive_length] * num_drives, seed=seed)``: batch slot ``i`` walks its
    drives frame by frame. It delivers ``sampler_iterations`` batches."""
    sampler = SequenceSampler(total_batch_size=batch_size,
                              sequence_lengths=[drive_length] * num_drives, seed=seed)
    return build_pipeline(batch_size=batch_size, num_samples=num_drives * drive_length,
                          seed=seed, sampler=sampler, sampler_iterations=sampler_iterations,
                          wire=wire, **kwargs)


def batch_to_petr_inputs(batch: Dict[str, torch.Tensor], num_cams: int = 6) -> torch.Tensor:
    """The pipeline's ``cameras.[c].image`` stacked into PETR's images
    ``(B, num_cams, H, W, 3)``."""
    return torch.stack([batch[f"cameras.[{c}].image"] for c in range(num_cams)], dim=1)


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``; to the card through pinned memory and an
    asynchronous copy, so the step makes no host synchronisation."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def synth_labels(rng: np.random.Generator, batch_size: int, num_classes: int, max_gt: int,
                 num_slots: int, device: torch.device) -> Dict[str, RaggedBatch]:
    """The example's stand-in 3-D ground truth (its ``synth_labels``, with
    ``max_gt`` objects at most and ``matches_pred`` drawn over all
    ``num_slots`` query slots, fresh and memory), in the example's draw
    order."""
    sizes = rng.integers(1, max_gt + 1, (batch_size,)).astype(np.int32)
    matches = np.stack([rng.permutation(max_gt) for _ in range(batch_size)]).astype(np.int32)
    sizes_t = to_device(sizes, device)
    mk = lambda x: RaggedBatch(to_device(x, device), sample_sizes=sizes_t)  # noqa: E731
    return {
        "gt_boxes": mk(rng.normal(size=(batch_size, max_gt, 7)).astype(np.float32)),
        "gt_classes": mk(rng.integers(0, num_classes, (batch_size, max_gt)).astype(np.float32)),
        "matches_gt": mk(matches),
        "matches_pred": mk(rng.integers(0, num_slots, (batch_size, max_gt)).astype(np.int32)),
    }


def ego_forward(batch_size: int, device: torch.device, dx: float = 0.5) -> torch.Tensor:
    """The example's ego motion: a constant forward translation ``dx`` per
    frame, ``(B, 4, 4)``."""
    m = np.eye(4, dtype=np.float32)
    m[0, 3] = dx
    return to_device(np.broadcast_to(m, (batch_size, 4, 4)), device)


class StreamTrainer:
    """The example's training loop, one step per pipeline batch.

    ``model`` defaults to the full-width ``PETRDetector(num_memory=64,
    motion_aware=True)`` (128 queries, dim 128, 3 layers, 10 classes): the
    example's ratio of memory to queries. Parameters are drawn from ``seed``
    at the first step, or are ``jax_params`` (flax variables of numpy
    arrays, through :func:`~.models.params.load_jax_params`); labels come
    from ``default_rng(seed)``.
    """

    def __init__(self, model: Optional[PETRDetector] = None, seed: int = 0, num_cams: int = 6,
                 max_gt: int = 32, jax_params: Optional[dict] = None):
        self.model = model if model is not None else PETRDetector(num_memory=64,
                                                                  motion_aware=True)
        self.num_cams = num_cams
        self.max_gt = max_gt
        self.seed = seed
        self.jax_params = jax_params
        self.rng = np.random.default_rng(seed)
        self._init_fn, self._train_step = make_motion_petr_train_step(self.model)
        self.opt = None
        self.memory = self.memory_ref = None
        self.batch = None
        self.eval_memory = self.eval_memory_ref = None

    def make_batch(self, out: Dict[str, torch.Tensor]) -> dict:
        """One pipeline batch with the next synthetic labels and ego motion."""
        images = batch_to_petr_inputs(out, self.num_cams)
        b, dev = images.shape[0], images.device
        slots = self.model.num_queries + self.model.num_memory
        return {"images": images, "ego_transform": ego_forward(b, dev),
                **synth_labels(self.rng, b, self.model.num_classes, self.max_gt, slots, dev)}

    def step(self, batch: dict) -> Dict[str, torch.Tensor]:
        """One train step on ``batch`` (from :meth:`make_batch`), carrying the
        memory; returns the detached device metrics."""
        if self.opt is None:
            self.model, self.opt, self.memory, self.memory_ref = self._init_fn(self.seed,
                                                                               batch["images"])
            if self.jax_params is not None:  # before any step: the optimizer holds no state
                load_jax_params(self.model, self.jax_params)
        self.batch = batch
        # the memory INPUT of this batch: evaluating with the post-step memory
        # would apply the ego compensation twice
        self.eval_memory, self.eval_memory_ref = self.memory, self.memory_ref
        _, self.opt, self.memory, self.memory_ref, metrics = self._train_step(
            self.model, self.opt, batch, self.memory, self.memory_ref)
        return metrics

    def evaluate(self, max_detections: int = 16, score_threshold: float = 0.05) -> dict:
        """The example's evaluation on the last batch: the trained model with
        that batch's memory input, ``decode_detections_3d`` and the
        centre-distance evaluator on the nuScenes ladder (0.5, 1, 2, 4 m)."""
        batch = self.batch
        with torch.no_grad():
            outputs = self.model(batch["images"], memory=self.eval_memory,
                                 memory_ref=self.eval_memory_ref,
                                 ego_transform=batch["ego_transform"])
        dets = decode_detections_3d(outputs, max_detections=max_detections,
                                    score_threshold=score_threshold)
        gt_classes = batch["gt_classes"]
        gt = {"boxes3d": batch["gt_boxes"],
              "classes": gt_classes.create_with_sample_sizes_like_self(
                  gt_classes.tensor.to(torch.int32))}
        ev = DetectionEvaluator(metric="center_distance", thresholds=(0.5, 1.0, 2.0, 4.0))
        ev.update(dets, gt)
        return ev.compute()


def run_stream_training(pipe, num_steps: int, trainer: Optional[StreamTrainer] = None):
    """``num_steps`` steps on fresh batches of ``pipe`` in drive order; reads
    each step's loss back to the host, as the example does. Returns
    ``(trainer, losses)``."""
    trainer = trainer if trainer is not None else StreamTrainer()
    losses = []
    for _ in range(num_steps):
        metrics = trainer.step(trainer.make_batch(pipe.run()))
        losses.append(float(metrics["loss"]))  # the example's per-step read-back
    return trainer, losses
