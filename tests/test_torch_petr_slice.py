"""The StreamPETR slice end to end on the CPU, in both packages.

The port's stream pipeline (bench.py's JPEG cameras on the YUV wire, read in
drive order through ``SequenceSampler``; 2 cameras of 96x256, batch 2, out
64x176, 4 drives of 5 frames) feeds three carried steps of a narrow
motion-aware PETR through ``train_petr_e2e.StreamTrainer``. The same images,
labels and flax weights go through the JAX package's
``make_motion_petr_train_step``, as the example's loop runs it
(``examples/stream_petr_video_training.py:225-243``), and through the
example's evaluation.

Each step runs in the JAX package from the point the port's step starts
from: the port's weights and carried memory. Left to run freely, the two
would drift apart: AdamW moves every parameter by about ±lr whatever the size
of its gradient, so the bf16 rounding noise flips the update of the
parameters whose gradient is near zero, and the next step's outputs then
differ by several percent of their largest magnitude. ``tests/test_torch_petr.py`` holds one step's parameters
within 2·lr.

Tolerances (see ``tests/test_torch_petr.py`` for the reasons): losses
within 2e-2 relative per step; forward outputs within 3e-2 of their largest
magnitude; the carried memory and reference points within 3e-2 on the
queries both packages choose; the decoded scores within 3e-2 of their
largest value. mAP: the TP/FP flags are thresholded, so a score or a
distance within rounding of a gate may flip one; the mAP agrees within
0.05.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accvlab_tpu.models import DetectionEvaluator as JEvaluator
from accvlab_tpu.models import decode_detections_3d as jax_decode_3d
from accvlab_tpu.models import petr as J
from accvlab_tpu.ragged import RaggedBatch as JRB
from accvlab_tpu_torch.models.params import jax_params_of, load_jax_params
from accvlab_tpu_torch.models.petr import PETRDetector, decode_detections_3d
from accvlab_tpu_torch.train_petr_e2e import (StreamTrainer, batch_to_petr_inputs,
                                              build_stream_pipeline, ego_forward, synth_labels)
from test_torch_petr import memory_agreement, rel_to_max

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
KW = dict(num_queries=8, num_classes=10, dim=16, num_layers=2, num_memory=4, motion_aware=True)
STEPS, CAMS, MAX_GT = 3, 2, 6


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def batches():
    torch.set_num_threads(1)
    pipe = build_stream_pipeline(batch_size=2, device="cpu", num_threads=2, hw=(96, 256),
                                 num_cams=CAMS, out_hw=(64, 176), heatmap_hw=(16, 44),
                                 num_drives=4, drive_length=5, sampler_iterations=STEPS)
    try:
        return [{k: v.clone() for k, v in pipe.run().items()} for _ in range(STEPS)]
    finally:
        pipe.stop()


def to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def runs(batches):
    """The port's trainer through the three carried steps. Each step also
    runs in the JAX package from the same point: the port's weights and
    carried memory entering the step (the JAX initial weights and zero
    memory at the first). Per step: both forwards at the step's input (the
    memory is chosen from them), both new memories, both losses; then both
    evaluations with the final weights and the last step's memory input."""
    model_j = J.PETRDetector(**KW)
    images0 = jnp.asarray(batch_to_petr_inputs(batches[0], CAMS).numpy())
    init_j, step_j = J.make_motion_petr_train_step(model_j)
    params, opt_state, mem_in, ref_in = init_j(jax.random.PRNGKey(0), images0)
    weights = jax.tree_util.tree_map(np.asarray, params)
    step_j = jax.jit(step_j)

    trainer = StreamTrainer(PETRDetector(**KW), seed=0, num_cams=CAMS, max_gt=MAX_GT,
                            jax_params=weights)
    out = {"t": [], "j": []}
    for out_pipe in batches:
        batch_t = trainer.make_batch(out_pipe)
        batch_j = {k: (jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor) else
                       JRB(jnp.asarray(v.tensor.numpy()),
                           sample_sizes=jnp.asarray(v.sample_sizes.numpy())))
                   for k, v in batch_t.items()}
        with torch.no_grad():  # the forward of the step's input, where the memory is chosen
            if trainer.opt is None:  # the trainer builds its model at its first step
                model = load_jax_params(PETRDetector(**KW), weights)
                zeros = torch.zeros(2, KW["num_memory"], KW["dim"]), torch.zeros(2, 4, 3)
                fwd_t = model(batch_t["images"], *zeros, batch_t["ego_transform"])
            else:
                params = to_jax(jax_params_of(trainer.model))
                mem_in, ref_in = jnp.asarray(trainer.memory), jnp.asarray(trainer.memory_ref)
                fwd_t = trainer.model(batch_t["images"], trainer.memory, trainer.memory_ref,
                                      batch_t["ego_transform"])
        fwd_j = model_j.apply(params, batch_j["images"], mem_in, ref_in, batch_j["ego_transform"])
        _, opt_state, mem_j, ref_j, metrics_j = step_j(params, opt_state, batch_j, mem_in, ref_in)
        metrics_t = trainer.step(batch_t)
        out["t"].append((fwd_t, trainer.memory, trainer.memory_ref, metrics_t))
        out["j"].append((fwd_j, mem_j, ref_j, metrics_j))
    final = to_jax(jax_params_of(trainer.model))
    outputs_j = model_j.apply(final, batch_j["images"], jnp.asarray(trainer.eval_memory),
                              jnp.asarray(trainer.eval_memory_ref), batch_j["ego_transform"])
    dets_j = jax_decode_3d(outputs_j, max_detections=16, score_threshold=0.05)
    gt_j = {"boxes3d": batch_j["gt_boxes"],
            "classes": batch_j["gt_classes"].create_with_sample_sizes_like_self(
                batch_j["gt_classes"].tensor.astype(jnp.int32))}
    ev = JEvaluator(metric="center_distance", thresholds=(0.5, 1.0, 2.0, 4.0))
    ev.update(dets_j, gt_j)
    return {"trainer": trainer, "steps_t": out["t"], "steps_j": out["j"], "map_j": ev.compute(),
            "dets_j": dets_j}


def test_losses_match_jax_every_step(runs):
    for (_, _, _, mt), (_, _, _, mj) in zip(runs["steps_t"], runs["steps_j"]):
        assert set(mt) == set(mj)
        for k in mj:
            assert np.isfinite(float(mt[k]))
            np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=2e-2)


def test_forward_and_carried_memory_match_jax_every_step(runs):
    trainer = runs["trainer"]
    assert float(trainer.memory_ref.abs().sum()) > 0.0
    for (ft, mt, rt, _), (fj, mj, rj, _) in zip(runs["steps_t"], runs["steps_j"]):
        for k in fj:
            assert rel_to_max(ft[k], fj[k]) < 3e-2, k
        memory_agreement(ft, fj, [mt, rt], [mj, rj], KW["num_memory"])


def test_evaluation_matches_jax(runs):
    trainer = runs["trainer"]
    res = trainer.evaluate()
    assert np.isfinite(res["mAP"]) and 0.0 <= res["mAP"] <= 1.0
    batch = trainer.batch
    with torch.no_grad():
        out = trainer.model(batch["images"], trainer.eval_memory, trainer.eval_memory_ref,
                            batch["ego_transform"])
    dets = decode_detections_3d(out, max_detections=16, score_threshold=0.05)
    want = runs["dets_j"]
    assert rel_to_max(dets["scores"].tensor, want["scores"].tensor) < 3e-2
    assert abs(res["mAP"] - runs["map_j"]["mAP"]) < 0.05


def test_pipeline_batches_are_in_drive_order(batches):
    """Frames of one drive follow each other in a batch slot: the
    provider's sample ``i`` uses JPEG set ``i % 16``, so consecutive batches
    of a slot show consecutive sets."""
    from accvlab_tpu_torch.pipeline.inputs import SequenceSampler

    sampler = SequenceSampler(total_batch_size=2, sequence_lengths=[5] * 4, seed=0)
    rows = [sampler.get_next_batch_indices() for _ in range(STEPS)]
    assert all(b - a == 1 for r0, r1 in zip(rows, rows[1:]) for a, b in zip(r0, r1))
    images = [batch_to_petr_inputs(b, CAMS) for b in batches]
    assert all(tuple(i.shape) == (2, CAMS, 64, 176, 3) for i in images)
    assert not torch.equal(images[0], images[1])


def test_labels_and_ego_motion_follow_the_example():
    sys.path.insert(0, EXAMPLES)
    try:
        import stream_petr_video_training as example
    finally:
        sys.path.remove(EXAMPLES)
    want = example.synth_labels(np.random.default_rng(5), 2, 6)
    got = synth_labels(np.random.default_rng(5), 2, 6, max_gt=8, num_slots=24,
                       device=torch.device("cpu"))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].tensor.numpy(), np.asarray(want[k].tensor))
        np.testing.assert_array_equal(got[k].sample_sizes.numpy(),
                                      np.asarray(want[k].sample_sizes))
    ego = ego_forward(3, torch.device("cpu")).numpy()
    m = np.eye(4, dtype=np.float32)
    m[0, 3] = 0.5
    np.testing.assert_array_equal(ego, np.broadcast_to(m, (3, 4, 4)))
