"""``shared_jit`` on a card: the CUDA graphs of a shared executable.

A replay is bitwise the function run eagerly, each dispatch context (the
float32 matmul precision) gets its own graph, donation frees the donated
leaf's memory on the card, two threads on two streams share one executable
with their own constants, a replay counts the hand kernels it launches (as
many as the profiler sees on the card), and the pipeline's device stage
replays bitwise its eager stage.

Every test here needs an NVIDIA card and skips without one. No JAX is
imported, so the file runs on a card machine without it:
    python -m pytest tests/test_torch_program_cache_cuda.py -q
"""

import threading
import time

import pytest
import torch

from accvlab_tpu_torch.tools import program_cache_stats, shared_jit


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA graphs of the shared programs)")
    return torch.device("cuda", 0)


def _fn(table):
    def fn(x, y):
        h = torch.relu(x @ table) * 0.5 + y[:, None]
        return h.sum(dim=1), torch.tanh(h).to(torch.bfloat16), x.flip(0)

    return fn


def _inputs(dev, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(64, 32, generator=g).to(dev), torch.randn(64, generator=g).to(dev)


@pytest.mark.cuda
def test_replay_is_bitwise_the_eager_function(cuda):
    table = torch.randn(32, 48, generator=torch.Generator().manual_seed(1)).to(cuda)
    fn = _fn(table)
    prog = shared_jit(fn, _inputs(cuda, 0))
    for seed in range(4):  # the capture's warm-up, then replays
        x, y = _inputs(cuda, seed)
        got, want = prog(x, y), fn(x, y)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
    graphs = list(prog._exe.graphs.values())
    assert len(graphs) == 1 and graphs[0].pool_bytes > 0
    # the outputs are the caller's: a later replay does not overwrite them
    first = prog(*_inputs(cuda, 5))
    keep = [t.clone() for t in first]
    prog(*_inputs(cuda, 6))
    assert all(torch.equal(a, b) for a, b in zip(first, keep))


@pytest.mark.cuda
def test_one_graph_per_precision_context(cuda):
    a = torch.randn(256, 256, generator=torch.Generator().manual_seed(2)).to(cuda)

    def f(x):
        return x @ a

    prog = shared_jit(f, (a,))
    prec = torch.get_float32_matmul_precision()
    try:
        outs = {}
        for p in ("highest", "high", "highest", "high"):
            torch.set_float32_matmul_precision(p)
            outs.setdefault(p, []).append(prog(a))
            assert torch.equal(outs[p][-1], f(a))  # the context's own kernels
    finally:
        torch.set_float32_matmul_precision(prec)
    assert len(prog._exe.graphs) == 2
    assert torch.equal(outs["highest"][0], outs["highest"][1])


@pytest.mark.cuda
def test_donation_frees_storage_on_the_card(cuda):
    def f(x, y):
        return x * 2.0 + 1.0, y

    prog = shared_jit(f, (torch.ones(1024, 1024, device=cuda), torch.zeros(4, device=cuda)),
                      donate_argnums=(0,))
    for _ in range(2):  # the capture, then a replay
        x = torch.full((1024, 1024), 3.0, device=cuda)
        y = torch.zeros(4, device=cuda)
        out, y_out = prog(x, y)
        torch.cuda.synchronize()
        assert torch.equal(out, torch.full((1024, 1024), 7.0, device=cuda))
        assert x.untyped_storage().nbytes() == 0 and x.numel() == 0
        assert y.untyped_storage().nbytes() == 16 and torch.equal(y_out, y)


@pytest.mark.cuda
def test_two_threads_share_one_executable(cuda):
    """Two callers with their own constants, each on its own thread and
    stream, replay one executable's graph in turns: each gets its own
    results."""
    tables = [torch.randn(32, 48, generator=torch.Generator().manual_seed(k)).to(cuda)
              for k in (10, 11)]
    progs = [shared_jit(_fn(t), _inputs(cuda, 0)) for t in tables]
    assert progs[0]._exe is progs[1]._exe
    progs[0](*_inputs(cuda, 0))  # the capture
    errors = []

    def worker(k):
        try:
            stream = torch.cuda.Stream(cuda)
            with torch.cuda.stream(stream):
                for seed in range(40):
                    x, y = _inputs(cuda, 100 * k + seed)
                    got, want = progs[k](x, y), _fn(tables[k])(x, y)
                    if not all(torch.equal(a, b) for a, b in zip(got, want)):
                        errors.append((k, seed))
            stream.synchronize()
        except Exception as e:  # reported below: a thread's failure fails the test
            errors.append((k, repr(e)))

    threads = [threading.Thread(target=worker, args=(k,)) for k in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and errors == []
    assert len(progs[0]._exe.graphs) == 1


@pytest.mark.cuda
def test_replays_count_the_rasterizer_launches(cuda):
    from accvlab_tpu_torch.heatmap import LAUNCHES, draw_gaussians, reset_launch_counts

    g = torch.Generator().manual_seed(3)
    hm = torch.zeros(4, 3, 32, 48, device=cuda)
    centers = (torch.rand(4, 8, 2, generator=g) * 40).to(cuda)
    radii = torch.randint(1, 6, (4, 8), generator=g, dtype=torch.int32).to(cuda)
    ids = torch.randint(0, 3, (4, 8), generator=g, dtype=torch.int32).to(cuda)
    active = torch.ones(4, 8, dtype=torch.bool, device=cuda)

    def f(hm, active, ids, centers, radii):
        return draw_gaussians(hm, active, ids, centers, radii, [1.0, 1.0, 1.0], 1.0 / 3.0)

    args = (hm, active, ids, centers, radii)
    prog = shared_jit(f, args)
    reset_launch_counts()
    outs = [prog(*args) for _ in range(5)]  # warm-up + capture, then 4 replays
    torch.cuda.synchronize()
    assert LAUNCHES["draw_gaussians"] == 5
    assert all(torch.equal(o, f(*args)) for o in outs)
    # the counter against the kernels the profiler sees the card run in 4
    # replays, inside half a second of idle host time on each side (Kineto
    # keeps only the device records that fall inside its window on the
    # host's clock)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    n0 = LAUNCHES["draw_gaussians"]
    with profile(activities=[ProfilerActivity.CUDA]) as trace:
        time.sleep(0.5)
        for _ in range(4):
            prog(*args)
        torch.cuda.synchronize()
        time.sleep(0.5)
    grew = LAUNCHES["draw_gaussians"] - n0
    seen = {e.key[:60]: e.count for e in trace.key_averages() if e.device_type == DeviceType.CUDA}
    ran = sum(n for k, n in seen.items() if "draw_heatmap_kernel" in k)
    assert ran == grew == 4, (f"the profiler saw {ran} draw_heatmap_kernel, the counter {grew}; "
                              f"the device rows: {seen}")


@pytest.mark.cuda
def test_pipeline_stage_replays_bitwise_eager(cuda):
    from accvlab_tpu_torch.bench_pipeline import build_pipeline

    # at this size a DCT leaf spec comes back about once in three batches
    pipe = build_pipeline(batch_size=2, device=cuda, num_threads=2, hw=(96, 256), num_cams=2,
                          out_hw=(64, 176), heatmap_hw=(16, 44), num_samples=32, wire="dct")
    kept = []
    stage = pipe.run_device_stage

    def keep(leaves, batch_idx, echo_i=0):
        kept.append(([x.clone() for x in leaves], batch_idx, echo_i))
        return stage(leaves, batch_idx, echo_i)

    pipe.run_device_stage = keep
    before = program_cache_stats()
    try:
        outs = [{k: v.clone() for k, v in pipe.run().items()} for _ in range(16)]
    finally:
        pipe.stop()
    assert program_cache_stats()["declined"] == before["declined"]
    assert any(e[2] and e[2]._exe.graphs for e in pipe._stage_specs.values())
    for (leaves, batch_idx, echo_i), out in zip(kept, outs):
        want, _ = pipe._run_eager(leaves, batch_idx, echo_i)
        assert all(torch.equal(a, b) for a, b in zip(out.values(), want))
