"""``StructuredOutputIterator`` and the executor's phase trace on the port,
against the JAX package's.

Both packages build the same pipeline (a provider of uint8 images, labels
and token strings; ``ImageRange01Normalizer`` on the host and a brightness
shift on the device) and wrap it in ``StructuredOutputIterator``: nested
dicts and ``SampleDataGroup`` outputs equal within 1e-6 absolute (float32
scaling), ``len``, ``reset`` and the next epoch, ``post_process_func``,
resume through ``set_state`` bit for bit, and ``isinstance(...,
DataLoader)``. The trace records JAX's span names (``host_build``,
``queue_put``, ``consumer_wait``, ``device_dispatch``, the instants
``epoch_end`` and ``reset``), each span's start before its end, and raises
as JAX does.
"""

import json

import numpy as np
import pytest
import torch
from torch.utils.data import DataLoader

import accvlab_tpu.pipeline as jpipe
import accvlab_tpu.pipeline.processing_steps as jsteps
import accvlab_tpu_torch.pipeline as tpipe
import accvlab_tpu_torch.pipeline.processing_steps as tsteps
from accvlab_tpu.pipeline.inputs import DataProvider as JProvider
from accvlab_tpu.pipeline.inputs import ShuffledShardedInputCallable as JInput
from accvlab_tpu_torch.pipeline.inputs import DataProvider as TProvider
from accvlab_tpu_torch.pipeline.inputs import ShuffledShardedInputCallable as TInput

ATOL = 1e-6
SPANS = {"host_build", "queue_put", "consumer_wait", "device_dispatch"}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _provider(base, pkg, n=8):
    class Provider(base):
        @property
        def sample_data_structure(self):
            sdg = pkg.SampleDataGroup()
            sdg.add_data_field("image", pkg.DType.UINT8)
            ann = pkg.SampleDataGroup()
            ann.add_data_field("label", pkg.DType.INT32)
            sdg.add_data_group_field("ann", ann)
            sdg.add_data_field("token", pkg.DType.STRING)
            return sdg

        def get_data(self, i):
            sdg = self.sample_data_structure
            sdg["image"] = np.random.default_rng(i).integers(0, 256, (6, 8, 3)).astype(np.uint8)
            sdg["ann"]["label"] = np.int32(i % 3)
            sdg["token"] = f"sample_{i:03d}"
            return sdg

        def get_number_of_samples(self):
            return n

    return Provider()


def _distort(steps):
    return steps.PhotoMetricDistorter(
        "image", min_max_brightness=(0.1, 0.1), min_max_hue=(0.0, 0.0),
        min_max_contrast=(1.0, 1.0), min_max_saturation=(1.0, 1.0), prob_brightness_aug=1.0,
        prob_hue_aug=0.0, prob_contrast_aug=0.0, prob_saturation_aug=0.0, prob_swap_channels=0.0)


def build(name, convert=True, post=None, echo_factor=1, shuffle=True):
    pkg, steps, base, inp_cls = {
        "jax": (jpipe, jsteps, JProvider, JInput),
        "torch": (tpipe, tsteps, TProvider, TInput),
    }[name]
    inp = inp_cls(_provider(base, pkg), batch_size=2, shuffle=shuffle)
    definition = pkg.PipelineDefinition(inp, [steps.ImageRange01Normalizer("image"),
                                              _distort(steps)],
                                        copy_external_source_passthrough_outputs=False)
    kw = {"device": "cpu"} if name == "torch" else {}
    pipe = definition.get_pipeline(batch_size=2, num_threads=2, seed=3, echo_factor=echo_factor,
                                   **kw)
    it = pkg.StructuredOutputIterator.CreateAsDataLoaderObject(
        num_batches_in_epoch=inp.length, pipeline=pipe,
        sample_data_structure_blueprint=definition.check_and_get_output_data_structure(),
        convert_sample_data_group_to_dict=convert, post_process_func=post)
    return it, pipe


def _leaves(tree, prefix=""):
    """A nested output as ``{"ann.label": array, ...}``."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((f"[{i}]", v) for i, v in enumerate(tree))
    else:
        return {prefix[:-1]: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(_leaves(v, f"{prefix}{k}."))
    return out


def _epoch(it):
    return [_leaves(b) for b in it]


def _assert_batches_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].shape == w[k].shape, k
            if w[k].dtype.kind == "f":
                np.testing.assert_allclose(g[k], w[k], rtol=0, atol=ATOL, err_msg=k)
            else:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_dict_output_len_reset_as_in_jax():
    its = {n: build(n) for n in ("jax", "torch")}
    try:
        for n, (it, _) in its.items():
            assert isinstance(it, DataLoader) and len(it) == 4 and it.dataset is it
        # brightness 0.1 on the device: the two packages' draws differ, so
        # the device step is scripted to a fixed shift (min == max)
        e1 = {n: _epoch(it) for n, (it, _) in its.items()}
        _assert_batches_close(e1["torch"], e1["jax"])
        assert len(e1["torch"]) == 4
        e2 = {n: _epoch(it) for n, (it, _) in its.items()}  # iter() resets: next epoch
        _assert_batches_close(e2["torch"], e2["jax"])
        assert set(e1["torch"][0]) == {"image", "ann.label", "token"}
        assert not all(np.array_equal(a["ann.label"], b["ann.label"])
                       for a, b in zip(e1["torch"], e2["torch"]))  # reshuffled
    finally:
        for _, pipe in its.values():
            pipe.stop()


def test_sample_data_group_output_and_post_process():
    def post(x):
        return {"n": x["ann"]["label"] * 10}

    for convert, fn in ((False, None), (True, post)):
        outs = {}
        for n in ("jax", "torch"):
            it, pipe = build(n, convert=convert, post=fn)
            try:
                b = next(iter(it))
            finally:
                pipe.stop()
            outs[n] = b
        if fn is not None:
            np.testing.assert_array_equal(np.asarray(outs["torch"]["n"]),
                                          np.asarray(outs["jax"]["n"]))
            continue
        t, j = outs["torch"], outs["jax"]
        assert isinstance(t, tpipe.SampleDataGroup)
        assert t.field_names_flat == j.field_names_flat
        for a, b in zip(t.get_data(), j.get_data()):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=ATOL)


def test_resume_through_set_state_bitwise():
    it, pipe = build("torch")
    try:
        ref = [{k: torch.as_tensor(v) for k, v in _leaves(b).items()} for b in it]
    finally:
        pipe.stop()
    it, pipe = build("torch")
    try:
        first = iter(it)
        next(first)
        state = json.loads(json.dumps(it.get_state()))
    finally:
        pipe.stop()
    it, pipe = build("torch")
    try:
        it.set_state(state)
        rest = [{k: torch.as_tensor(v) for k, v in _leaves(b).items()} for b in it]
    finally:
        pipe.stop()
    assert len(rest) == len(ref) - 1
    for got, want in zip(rest, ref[1:]):
        for k in want:
            assert torch.equal(got[k], want[k]), k
    assert it.internal_iterator is pipe
    assert it.sample_data_structure_blueprint.field_names_flat == pipe.output_blueprint \
        .field_names_flat
    assert tpipe.DALIStructuredOutputIterator is tpipe.StructuredOutputIterator


def _trace_events(pipe_name, echo_factor=1, reset=False):
    it, pipe = build(pipe_name, echo_factor=echo_factor, shuffle=False)
    try:
        trace = pipe.start_trace()
        if reset:
            pipe.run()
            pipe.reset()
            pipe.run()
        else:
            _epoch(it)
        doc = pipe.stop_trace().to_dict()
        assert trace.to_dict() == doc
    finally:
        pipe.stop()
    return doc["traceEvents"]


@pytest.mark.parametrize("echo_factor", [1, 2])
def test_trace_spans_as_in_jax(echo_factor, tmp_path):
    got, want = (_trace_events(n, echo_factor) for n in ("torch", "jax"))
    count = lambda evs, name: sum(e["name"] == name for e in evs)  # noqa: E731
    for name in ("consumer_wait", "device_dispatch", "epoch_end"):
        assert count(got, name) == count(want, name), name
    assert count(got, "host_build") >= 4 and count(got, "queue_put") >= 4
    assert {e["name"] for e in got if e["ph"] == "X"} == SPANS
    threads = {e["tid"]: e["args"]["name"] for e in got if e["name"] == "thread_name"}
    for e in got:
        if e["ph"] == "X":
            assert e["ts"] >= 0.0 and e["dur"] >= 0.0 and e["ts"] <= e["ts"] + e["dur"]
            assert threads[e["tid"]] == ("producer" if e["name"] in ("host_build", "queue_put")
                                         else "consumer")
    disp = [e["args"] for e in got if e["name"] == "device_dispatch"]
    want_disp = [e["args"] for e in want if e["name"] == "device_dispatch"]
    assert [(d["batch"], d["echo"]) for d in disp] == [(d["batch"], d["echo"]) for d in want_disp]
    assert all((d["bytes"] > 0) == (d["echo"] == 0) for d in disp)
    # per batch: built before it was waited for, waited for before its dispatch
    for b in range(4):
        build_end = min(e["ts"] + e["dur"] for e in got
                        if e["name"] == "host_build" and e["args"]["batch"] == b)
        wait = next(e for e in got if e["name"] == "consumer_wait" and e["args"]["batch"] == b)
        disp0 = next(e for e in got if e["name"] == "device_dispatch" and e["args"]["batch"] == b)
        assert build_end <= wait["ts"] + wait["dur"] + 1.0
        assert wait["ts"] + wait["dur"] <= disp0["ts"] + 1.0


def test_trace_reset_instant_and_errors():
    got = _trace_events("torch", reset=True)
    resets = [e for e in got if e["name"] == "reset"]
    assert len(resets) == 1 and resets[0]["ph"] == "i"
    _, pipe = build("torch")
    try:
        with pytest.raises(RuntimeError, match="no active"):
            pipe.stop_trace()
        first = pipe.start_trace()
        with pytest.raises(RuntimeError, match="already active"):
            pipe.start_trace()
        pipe.run()
        pipe.stop_trace()
        second = pipe.start_trace()
        assert second is not first and len(second) == 0
        pipe.run()
        pipe.stop_trace()
        assert len(second) > 0
    finally:
        pipe.stop()
