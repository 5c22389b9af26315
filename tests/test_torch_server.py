"""Micro-batching inference server of the port (``accvlab_tpu_torch.models.server``),
case by case with ``tests/test_inference_server.py`` (all but the sharded
artifact, which waits for the port of ``parallel``).

The batching policy (bucket choice, padding, the delay window), the client
contract (futures, per-request error fan-out, drain on close) and
artifact-backed serving. Where the JAX file counts jit traces ("serving
retraces nothing"), the port counts calls: ``warmup`` calls ``fn`` once per
bucket, and traffic never calls it at a batch size that is not a bucket.
"""

import threading
import time

import numpy as np
import pytest
import torch

from accvlab_tpu_torch.models.server import InferenceServer, ServerClosed, _stack_samples
from accvlab_tpu_torch.ragged import RaggedBatch


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _double_fn(x):
    return x * 2.0


def _np(x):
    return np.asarray(x)


def test_results_match_direct_under_concurrency():
    server = InferenceServer(_double_fn, batch_sizes=(1, 2, 4), max_delay_ms=1.0)
    samples = [np.full((3,), i, np.float32) for i in range(24)]
    results = [None] * len(samples)

    def client(lo, hi):
        for i in range(lo, hi):
            results[i] = server.infer(samples[i], timeout=60)

    threads = [threading.Thread(target=client, args=(i * 8, (i + 1) * 8)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    server.close()
    for i, r in enumerate(results):
        assert r.shape == (1, 3)  # leading dim preserved
        np.testing.assert_array_equal(_np(r), samples[i][None] * 2.0)
    st = server.stats()
    assert st["requests"] == 24
    assert st["errors"] == 0
    assert st["batches"] <= 24
    assert sum(st["batch_size_counts"].values()) == st["batches"]


def test_bucket_selection_and_padding():
    seen = []

    def spy_fn(x):
        seen.append(x.shape[0])
        return x + 1.0

    server = InferenceServer(spy_fn, batch_sizes=(1, 2, 4), max_delay_ms=250.0)
    futs = [server.submit(np.float32([i])) for i in range(3)]
    outs = [f.result(timeout=60) for f in futs]
    server.close()
    assert seen == [4]  # 3 requests in one window -> one batch padded to 4
    for i, o in enumerate(outs):
        np.testing.assert_array_equal(_np(o), [[i + 1.0]])
    st = server.stats()
    assert st["padded_samples"] == 1
    assert st["batch_size_counts"] == {4: 1}


def test_oversized_burst_splits_into_max_bucket_batches():
    seen = []

    def spy_fn(x):
        seen.append(x.shape[0])
        return x

    server = InferenceServer(spy_fn, batch_sizes=(2,), max_delay_ms=100.0)
    futs = [server.submit(np.float32([i])) for i in range(5)]
    for f in futs:
        f.result(timeout=60)
    server.close()
    assert all(s == 2 for s in seen) and sum(seen) >= 5


def test_error_fans_out_per_batch_and_server_survives():
    def picky_fn(x):
        if float(x.max()) > 100.0:
            raise ValueError("bad sample")
        return x

    server = InferenceServer(picky_fn, batch_sizes=(1,), max_delay_ms=0.0)
    bad = server.submit(np.float32([101.0]))
    with pytest.raises(ValueError, match="bad sample"):
        bad.result(timeout=60)
    np.testing.assert_array_equal(_np(server.infer(np.float32([1.0]), timeout=60)), [[1.0]])
    assert server.stats()["errors"] == 1
    server.close()


def test_close_drains_queued_requests():
    release = threading.Event()

    def slow_fn(x):
        release.wait(30)
        return x

    server = InferenceServer(slow_fn, batch_sizes=(1,), max_delay_ms=0.0)
    futs = [server.submit(np.float32([i])) for i in range(4)]
    release.set()
    server.close(drain=True)
    for i, f in enumerate(futs):
        np.testing.assert_array_equal(_np(f.result(timeout=0)), [[float(i)]])
    with pytest.raises(ServerClosed):
        server.submit(np.float32([0.0]))


def test_drain_covers_requests_racing_with_close():
    from accvlab_tpu_torch.models.server import _Request

    started = threading.Event()
    release = threading.Event()

    def slow_fn(x):
        started.set()
        release.wait(30)
        return x

    server = InferenceServer(slow_fn, batch_sizes=(1,), max_delay_ms=0.0)
    first = server.submit(np.float32([7.0]))
    assert started.wait(30)
    closer = threading.Thread(target=server.close, kwargs={"drain": True})
    closer.start()
    time.sleep(0.05)  # let close() enqueue the sentinel
    racer = _Request((np.float32([9.0]),))
    server._q.put(racer)  # a submit that lost the race
    release.set()
    closer.join(30)
    assert not closer.is_alive()
    np.testing.assert_array_equal(_np(first.result(timeout=0)), [[7.0]])
    np.testing.assert_array_equal(_np(racer.future.result(timeout=0)), [[9.0]])


def test_close_without_drain_fails_pending():
    started = threading.Event()
    release = threading.Event()

    def slow_fn(x):
        started.set()
        release.wait(30)
        return x

    server = InferenceServer(slow_fn, batch_sizes=(1,), max_delay_ms=0.0)
    first = server.submit(np.float32([0.0]))
    assert started.wait(30)
    pending = [server.submit(np.float32([i])) for i in range(3)]
    closer = threading.Thread(target=server.close, kwargs={"drain": False})
    closer.start()
    time.sleep(0.05)
    release.set()
    closer.join(30)
    assert not closer.is_alive()
    first.result(timeout=30)  # the batch in flight still completes
    for f in pending:
        with pytest.raises(ServerClosed):
            f.result(timeout=30)


def test_structured_ragged_output_splits_intact():
    def detect_fn(x):  # (B, 4) -> RaggedBatch (B, 3) with per-sample sizes
        tensor = x[:, :3] + 1.0
        sizes = torch.clamp(x[:, 0].to(torch.int32), 0, 3)
        return {"dets": RaggedBatch(tensor, sample_sizes=sizes), "plain": x * 0.5}

    server = InferenceServer(detect_fn, batch_sizes=(1, 4), max_delay_ms=100.0)
    futs = [server.submit(np.float32([i, 10 + i, 20 + i, 0])) for i in range(4)]
    outs = [f.result(timeout=60) for f in futs]
    server.close()
    for i, out in enumerate(outs):
        rb = out["dets"]
        assert isinstance(rb, RaggedBatch)
        assert rb.tensor.shape == (1, 3)
        np.testing.assert_allclose(_np(rb.tensor), [[i + 1.0, 11.0 + i, 21.0 + i]])
        assert int(rb.sample_sizes[0]) == min(i, 3)
        assert out["plain"].shape == (1, 4)


def test_warmup_runs_every_bucket_and_serving_calls_no_new_size():
    calls = []

    def fn(x):
        calls.append(x.shape[0])
        return x * 3.0

    server = InferenceServer(fn, batch_sizes=(1, 2, 4), max_delay_ms=50.0)
    server.warmup(np.zeros((5,), np.float32))
    assert sorted(calls) == [1, 2, 4]
    futs = [server.submit(np.full((5,), i, np.float32)) for i in range(3)]
    for f in futs:
        f.result(timeout=60)
    server.close()
    assert set(calls) == {1, 2, 4}  # traffic ran buckets only


def test_artifact_backed_server(tmp_path):
    from accvlab_tpu_torch.models import serving

    w = torch.arange(12, dtype=torch.float32).reshape(3, 4)

    def fn(x):
        return {"y": x @ w, "norm": x.sum(dim=-1)}

    path = str(tmp_path / "model.accvserve")
    serving.save_inference(path, fn, torch.zeros((2, 3)), batch_polymorphic=True)
    server = InferenceServer.from_artifact(path, device="cpu", batch_sizes=(1, 2),
                                           max_delay_ms=100.0)
    server.warmup(np.zeros((3,), np.float32))
    x0, x1 = np.float32([1, 2, 3]), np.float32([4, 5, 6])
    f0, f1 = server.submit(x0), server.submit(x1)
    r0, r1 = f0.result(60), f1.result(60)
    server.close()
    np.testing.assert_allclose(_np(r0["y"]), x0[None] @ w.numpy())
    np.testing.assert_allclose(_np(r1["y"]), x1[None] @ w.numpy())
    np.testing.assert_allclose(_np(r1["norm"]), [15.0])


def test_output_contract_violation_fails_futures_not_thread():
    def bad_fn(x):  # scalar output, no leading batch dim
        return x.sum()

    server = InferenceServer(bad_fn, batch_sizes=(1,), max_delay_ms=0.0)
    with pytest.raises(ValueError, match="leading batch dim"):
        server.infer(np.float32([1.0]), timeout=60)
    with pytest.raises(ValueError, match="leading batch dim"):
        server.infer(np.float32([2.0]), timeout=60)
    server.close()


def test_stack_samples_pads_by_replication():
    stacked = _stack_samples([(np.float32([1, 2]),), (np.float32([3, 4]),)], 4)
    np.testing.assert_array_equal(_np(stacked[0]), [[1, 2], [3, 4], [3, 4], [3, 4]])


def test_invalid_batch_sizes_rejected():
    with pytest.raises(ValueError):
        InferenceServer(_double_fn, batch_sizes=())
    with pytest.raises(ValueError):
        InferenceServer(_double_fn, batch_sizes=(0, 2))


def test_context_manager_closes():
    with InferenceServer(_double_fn, batch_sizes=(1,), max_delay_ms=0.0) as server:
        np.testing.assert_array_equal(_np(server.infer(np.float32([2.0]), timeout=60)), [[4.0]])
    with pytest.raises(ServerClosed):
        server.submit(np.float32([0.0]))


def test_cancelled_future_does_not_kill_dispatcher():
    release = threading.Event()

    def slow_fn(x):
        release.wait(30)
        return x

    server = InferenceServer(slow_fn, batch_sizes=(1,), max_delay_ms=0.0)
    blocker = server.submit(np.float32([0.0]))
    queued = server.submit(np.float32([1.0]))
    assert queued.cancel()
    release.set()
    blocker.result(timeout=60)
    np.testing.assert_array_equal(_np(server.infer(np.float32([3.0]), timeout=60)), [[3.0]])
    server.close()


def test_submit_close_race_straggler_is_reaped():
    from accvlab_tpu_torch.models.server import _Request

    server = InferenceServer(_double_fn, batch_sizes=(1,), max_delay_ms=0.0)
    server.close()
    racer = _Request((np.float32([4.0]),))
    server._q.put(racer)
    server._reap_stragglers()
    np.testing.assert_array_equal(_np(racer.future.result(timeout=0)), [[8.0]])


@pytest.mark.parametrize("depth", [2, 3])
def test_pipeline_depth_correctness_under_burst(depth):
    server = InferenceServer(_double_fn, batch_sizes=(1, 2), max_delay_ms=1.0,
                             pipeline_depth=depth)
    futs = [server.submit(np.full((2,), i, np.float32)) for i in range(12)]
    for i, f in enumerate(futs):
        np.testing.assert_array_equal(_np(f.result(timeout=60)), np.full((1, 2), i) * 2.0)
    extra = server.infer(np.float32([5.0, 5.0]), timeout=60)
    np.testing.assert_array_equal(_np(extra), [[10.0, 10.0]])
    st = server.stats()
    server.close()
    assert st["requests"] == 13
    assert st["errors"] == 0


def test_pipeline_depth_dispatch_error_attributed_to_its_batch():
    def picky_fn(x):
        if float(x.max()) > 100.0:
            raise ValueError("poison")
        return x

    server = InferenceServer(picky_fn, batch_sizes=(1,), max_delay_ms=0.0, pipeline_depth=2)
    good1 = server.submit(np.float32([1.0]))
    bad = server.submit(np.float32([200.0]))
    good2 = server.submit(np.float32([2.0]))
    np.testing.assert_array_equal(_np(good1.result(60)), [[1.0]])
    with pytest.raises(ValueError, match="poison"):
        bad.result(60)
    np.testing.assert_array_equal(_np(good2.result(60)), [[2.0]])
    server.close()


def test_pipeline_depth_validation():
    with pytest.raises(ValueError, match="pipeline_depth"):
        InferenceServer(_double_fn, pipeline_depth=0)


def test_from_artifact_fixed_batch_defaults_to_export_bucket(tmp_path):
    from accvlab_tpu_torch.models import serving

    w = torch.eye(3) * 3.0
    path = str(tmp_path / "fixed.accvserve")
    serving.save_inference(path, lambda x: x @ w, torch.zeros((4, 3)))
    server = InferenceServer.from_artifact(path, device="cpu", max_delay_ms=50.0)
    assert server._buckets == (4,)
    out = server.infer(np.float32([1, 2, 3]), timeout=60)  # padded 1 -> 4
    server.close()
    np.testing.assert_allclose(_np(out), [[3.0, 6.0, 9.0]])
