"""Parity of ``accvlab_tpu_torch.models.eval`` with ``accvlab_tpu.models.eval``
on the cases of ``tests/test_detection_eval.py``.

Tolerances: the IoU matrix and the centre distances are the same float32
operations in the same order, within 1e-6 relative; the TP/FP flags are
booleans and equal; AP and mAP come from the same numpy code on equal flags
and scores, within 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accvlab_tpu.models import eval as J
from accvlab_tpu.models.petr import decode_detections_3d as jax_decode_3d
from accvlab_tpu.ragged import RaggedBatch as JRB
from accvlab_tpu_torch.models import eval as T
from accvlab_tpu_torch.models.centernet import decode_detections
from accvlab_tpu_torch.models.petr import decode_detections_3d
from accvlab_tpu_torch.ragged import RaggedBatch as TRB


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def mk(arr, sizes):
    """The same RaggedBatch in both packages."""
    arr, sizes = np.asarray(arr), np.asarray(sizes, np.int32)
    return (JRB(jnp.asarray(arr), sample_sizes=jnp.asarray(sizes)),
            TRB(torch.from_numpy(arr.copy()), sample_sizes=torch.from_numpy(sizes.copy())))


def split(*pairs):
    return [p[0] for p in pairs], [p[1] for p in pairs]


def assert_results_equal(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        if k == "per_class":
            assert got[k].keys() == w.keys()
            for t in w:
                assert got[k][t].keys() == w[t].keys()
                np.testing.assert_allclose(list(got[k][t].values()), list(w[t].values()),
                                           rtol=0, atol=1e-12)
        else:
            np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-12)


def boxes2d(rng, shape):
    xy = rng.uniform(0, 30, (*shape, 2))
    wh = rng.uniform(1, 15, (*shape, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def test_iou_matrix_matches_jax():
    rng = np.random.default_rng(0)
    b1, b2 = boxes2d(rng, (2, 4)), boxes2d(rng, (2, 3))
    b1[0, 0] = 0.0  # a degenerate box
    want = np.asarray(J.box_iou_matrix(jnp.asarray(b1), jnp.asarray(b2)))
    got = T.box_iou_matrix(torch.from_numpy(b1), torch.from_numpy(b2)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got[0, 0].max() == 0.0
    z = torch.zeros((1, 1, 4))
    assert float(T.box_iou_matrix(z, z)[0, 0, 0]) == 0.0


BOX = [10.0, 10.0, 20.0, 20.0]
GT_A, GT_B, DET = [0.0, 0.0, 10.0, 10.0], [0.0, 0.0, 14.0, 10.0], [0.0, 0.0, 11.0, 10.0]
HAND_2D = {  # name: (pred boxes, scores, classes, pred sizes, gt boxes, gt classes, gt sizes)
    "duplicate_and_class": ([[BOX, BOX, BOX]], [[0.9, 0.8, 0.7]], [[0, 0, 1]], [3], [[BOX]],
                            [[0]], [1]),
    "consumed_falls_through": ([[DET, DET]], [[0.9, 0.8]], [[0, 0]], [2], [[GT_A, GT_B]],
                               [[0, 0]], [2]),
    "padded_slots": ([[GT_A, GT_A]], [[0.9, 0.9]], [[0, 0]], [1], [[GT_A, GT_A]], [[0, 0]], [2]),
}


@pytest.mark.parametrize("name", sorted(HAND_2D))
def test_match_hand_cases_match_jax(name):
    pb, ps, pc, psz, gb, gc, gsz = HAND_2D[name]
    j, t = split(mk(np.float32(pb), psz), mk(np.float32(ps), psz), mk(np.int32(pc), psz),
                 mk(np.float32(gb), gsz), mk(np.int32(gc), gsz))
    want = np.asarray(J.match_detections(*j))
    got = T.match_detections(*t)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


def test_match_empty_gt_or_pred():
    box = [0.0, 0.0, 10.0, 10.0]
    _, t = split(mk(np.zeros((1, 0, 4), np.float32), [0]), mk(np.zeros((1, 0), np.float32), [0]),
                 mk(np.zeros((1, 0), np.int32), [0]), mk(np.float32([[box]]), [1]),
                 mk(np.int32([[0]]), [1]))
    assert tuple(T.match_detections(*t).shape) == (1, 0)
    assert tuple(T.match_detections_3d(*t).shape) == (1, 0)


def random_case(seed, dims):
    rng = np.random.default_rng(seed)
    b, kmax, mmax, ncls = 3, 8, 6, 3
    psz, gsz = rng.integers(0, kmax + 1, b), rng.integers(0, mmax + 1, b)
    if dims == 2:
        pb, gb = boxes2d(rng, (b, kmax)), boxes2d(rng, (b, mmax))
    else:
        pb = rng.uniform(-20, 20, (b, kmax, 7)).astype(np.float32)
        gb = rng.uniform(-20, 20, (b, mmax, 7)).astype(np.float32)
    scores = -np.sort(-rng.uniform(0, 1, (b, kmax)).astype(np.float32), axis=1)
    pcls = rng.integers(0, ncls, (b, kmax)).astype(np.int32)
    gcls = rng.integers(0, ncls, (b, mmax)).astype(np.int32)
    return split(mk(pb, psz), mk(scores, psz), mk(pcls, psz), mk(gb, gsz), mk(gcls, gsz))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("thr", [0.1, 0.5, 0.7])
def test_match_random_matches_jax(seed, thr):
    j, t = random_case(seed, 2)
    np.testing.assert_array_equal(T.match_detections(*t, iou_threshold=thr).numpy(),
                                  np.asarray(J.match_detections(*j, iou_threshold=thr)))


def _box7(x, y):
    return [x, y, 0.0, 2.0, 4.0, 1.5, 0.0]


@pytest.mark.parametrize("thr", [2.0, 4.0])
def test_match_3d_nearest_first_matches_jax(thr):
    j, t = split(mk(np.float32([[_box7(1.0, 0.0), _box7(0.0, 0.0)]]), [2]),
                 mk(np.float32([[0.9, 0.8]]), [2]), mk(np.int32([[0, 0]]), [2]),
                 mk(np.float32([[_box7(0.0, 0.0), _box7(2.2, 0.0)]]), [2]),
                 mk(np.int32([[0, 0]]), [2]))
    want = np.asarray(J.match_detections_3d(*j, distance_threshold=thr))
    np.testing.assert_array_equal(T.match_detections_3d(*t, distance_threshold=thr).numpy(), want)


@pytest.mark.parametrize("seed", [100, 101, 102, 103])
def test_match_3d_random_matches_jax(seed):
    j, t = random_case(seed, 3)
    thr = float(np.random.default_rng(seed).uniform(2.0, 15.0))
    np.testing.assert_array_equal(T.match_detections_3d(*t, distance_threshold=thr).numpy(),
                                  np.asarray(J.match_detections_3d(*j, distance_threshold=thr)))


@pytest.mark.parametrize("metric,ladder", [("iou", (0.1, 0.3, 0.5, 0.75)),
                                           ("center_distance", (0.5, 1.0, 2.0, 4.0))])
def test_threshold_ladder_matches_jax(metric, ladder):
    j, t = random_case(7, 2 if metric == "iou" else 3)
    got = T._match_all_thresholds(metric, ladder, *t)
    want = np.asarray(J._match_all_thresholds(metric, ladder, *j))
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_interpolated_ap_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 40))
    scores, tp = rng.uniform(0, 1, n), rng.integers(0, 2, n).astype(float)
    num_gt = max(int(tp.sum() + rng.integers(0, 5)), 1)
    assert T._interpolated_ap(scores, tp, num_gt) == J._interpolated_ap(scores, tp, num_gt)
    assert np.isnan(T._interpolated_ap(scores, tp, 0))
    assert T._interpolated_ap(np.zeros(0), np.zeros(0), 3) == 0.0


def run_both(kwargs, batches):
    """The same batches through both evaluators; returns both results."""
    ev_j, ev_t = J.DetectionEvaluator(**kwargs), T.DetectionEvaluator(**kwargs)
    for dets, gt in batches:
        ev_j.update({k: v[0] for k, v in dets.items()}, {k: v[0] for k, v in gt.items()})
        ev_t.update({k: v[1] for k, v in dets.items()}, {k: v[1] for k, v in gt.items()})
    return ev_t, ev_j


def test_evaluator_perfect_predictions_matches_jax():
    box, box2 = [5.0, 5.0, 25.0, 30.0], [40.0, 40.0, 60.0, 55.0]
    gt = {"boxes": mk(np.float32([[box, box2]]), [2]), "classes": mk(np.int32([[0, 1]]), [2])}
    dets = {"boxes": mk(np.float32([[box, box2]]), [2]), "scores": mk(np.float32([[0.9, 0.8]]), [2]),
            "classes": mk(np.int32([[0, 1]]), [2])}
    ev_t, ev_j = run_both(dict(iou_thresholds=(0.5, 0.75)), [(dets, gt)])
    res = ev_t.compute()
    assert res["mAP"] == pytest.approx(1.0)
    assert_results_equal(res, ev_j.compute())


def test_evaluator_streaming_and_reset_match_jax():
    box, off = [0.0, 0.0, 10.0, 10.0], [100.0, 100.0, 110.0, 110.0]
    gt = {"boxes": mk(np.float32([[box]]), [1]), "classes": mk(np.int32([[0]]), [1])}
    hit = {"boxes": mk(np.float32([[box]]), [1]), "scores": mk(np.float32([[0.9]]), [1]),
           "classes": mk(np.int32([[0]]), [1])}
    miss = {"boxes": mk(np.float32([[off]]), [1]), "scores": mk(np.float32([[0.8]]), [1]),
            "classes": mk(np.int32([[0]]), [1])}
    ev_t, ev_j = run_both({}, [(hit, gt), (miss, gt)])
    assert_results_equal(ev_t.compute(), ev_j.compute())
    ev_t.reset()
    ev_t.update({k: v[1] for k, v in hit.items()}, {k: v[1] for k, v in gt.items()})
    assert ev_t.compute()["mAP@0.5"] == pytest.approx(1.0)


def test_evaluator_class_absent_from_gt_matches_jax():
    box = [0.0, 0.0, 10.0, 10.0]
    gt = {"boxes": mk(np.float32([[box]]), [1]), "classes": mk(np.int32([[2]]), [1])}
    dets = {"boxes": mk(np.float32([[box]]), [1]), "scores": mk(np.float32([[0.9]]), [1]),
            "classes": mk(np.int32([[5]]), [1])}
    ev_t, ev_j = run_both({}, [(dets, gt)])
    res = ev_t.compute()
    assert list(res["per_class"][0.5]) == [2]
    assert_results_equal(res, ev_j.compute())


def test_evaluator_composes_with_centernet_decode():
    heat = np.full((1, 8, 8, 2), -8.0, np.float32)
    heat[0, 2, 3, 1] = 8.0
    outputs = {"heatmap": torch.from_numpy(heat), "offset": torch.zeros((1, 8, 8, 2)),
               "size": torch.full((1, 8, 8, 2), 2.0)}
    dets = decode_detections(outputs, max_detections=4, score_threshold=0.5)
    gt = {"boxes": TRB(torch.tensor([[[8.0, 4.0, 16.0, 12.0]]]), sample_sizes=torch.tensor([1])),
          "classes": TRB(torch.tensor([[1]], dtype=torch.int32), sample_sizes=torch.tensor([1]))}
    ev = T.DetectionEvaluator(iou_thresholds=(0.5,))
    ev.update(dets, gt)
    assert ev.compute()["mAP@0.5"] == pytest.approx(1.0)


@pytest.mark.parametrize("gt_xy", [(10.5, 5.0), (30.0, 30.0)])
def test_evaluator_center_distance_with_petr_decode_matches_jax(gt_xy):
    b, q, c = 1, 6, 3
    logits = np.full((b, q, c), -4.0, np.float32)
    existence = np.full((b, q), -6.0, np.float32)
    boxes3d = np.zeros((b, q, 7), np.float32)
    logits[0, 2, 1], existence[0, 2], boxes3d[0, 2, :2] = 6.0, 6.0, (10.0, 5.0)
    outs = {"logits": logits, "existence": existence, "boxes3d": boxes3d}
    dets_j = jax_decode_3d({k: jnp.asarray(v) for k, v in outs.items()}, 4, 0.5)
    dets_t = decode_detections_3d({k: torch.from_numpy(v) for k, v in outs.items()}, 4, 0.5)
    gt = {"boxes3d": mk(np.float32([[_box7(*gt_xy)]]), [1]), "classes": mk(np.int32([[1]]), [1])}
    dets = {k: (dets_j[k], dets_t[k]) for k in dets_j}
    ev_t, ev_j = run_both(dict(metric="center_distance", thresholds=(0.5, 1.0, 2.0, 4.0)),
                          [(dets, gt)])
    res = ev_t.compute()
    assert res["mAP"] == pytest.approx(0.75 if gt_xy[0] < 20 else 0.0)
    assert_results_equal(res, ev_j.compute())


def test_evaluator_metric_validation():
    with pytest.raises(ValueError, match="unknown metric"):
        T.DetectionEvaluator(metric="giou")
