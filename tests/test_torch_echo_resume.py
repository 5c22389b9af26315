"""Data echoing (``echo_factor``) and checkpoint/resume (``get_state`` /
``set_state``) of the port's executor, after the JAX package's
tests/test_data_echoing.py and
tests/test_wire_compression.py::test_packed_wire_with_echo_mid_resume_bitwise.

Each host batch is transferred once and delivered ``echo_factor`` times, each
replay with its own device randomness; a state captured at any delivered
position, mid-echo included, continues bit for bit on a fresh pipeline; and
the state dicts are the JAX package's, key for key, after the same
consumption.
"""

import io
import json
import warnings

import numpy as np
import pytest
import torch

import accvlab_tpu.pipeline as jpipe
import accvlab_tpu.pipeline.processing_steps as jsteps
from accvlab_tpu.pipeline.inputs import DataProvider as JDataProvider
from accvlab_tpu.pipeline.inputs import ShuffledShardedInputCallable as JInput
from accvlab_tpu_torch.pipeline import DType, PipelineDefinition, SampleDataGroup
from accvlab_tpu_torch.pipeline.inputs import (
    CallableBase,
    DataProvider,
    IterableBase,
    ShuffledShardedInputCallable,
)
from accvlab_tpu_torch.pipeline.processing_steps import (
    DCTWirePacker,
    DCTWireUnpacker,
    ImageDecoder,
    PhotoMetricDistorter,
    WirePlanePacker,
    WirePlaneUnpacker,
    YCbCrToRGBConverter,
)

N_SAMPLES = 16


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def make_jpeg(seed, hw=(16, 24)):
    from PIL import Image

    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (hw[0] // 8, hw[1] // 8, 3), np.uint8)
    img = Image.fromarray(base).resize((hw[1], hw[0]), Image.BILINEAR)
    buf = io.BytesIO()
    img.save(buf, format="JPEG", quality=92)
    return np.frombuffer(buf.getvalue(), np.uint8).copy()


JPEGS = [make_jpeg(s) for s in range(N_SAMPLES)]


def _fill(sdg, i):
    sdg["image"] = JPEGS[i % len(JPEGS)]
    sdg["label"] = np.int32(i % 3)
    return sdg


class Provider(DataProvider):
    @property
    def sample_data_structure(self):
        sdg = SampleDataGroup()
        sdg.add_data_field("image", DType.UINT8)
        sdg.add_data_field("label", DType.INT32)
        return sdg

    def get_data(self, i):
        return _fill(self.sample_data_structure, i)

    def get_number_of_samples(self):
        return N_SAMPLES


class JaxProvider(JDataProvider):
    @property
    def sample_data_structure(self):
        sdg = jpipe.SampleDataGroup()
        sdg.add_data_field("image", jpipe.DType.UINT8)
        sdg.add_data_field("label", jpipe.DType.INT32)
        return sdg

    def get_data(self, i):
        return _fill(self.sample_data_structure, i)

    def get_number_of_samples(self):
        return N_SAMPLES


# no channel swaps, so that replays of one source stay correlated
PMD = dict(min_max_brightness=(-16.0, 16.0), min_max_hue=(-10.0, 10.0),
           min_max_contrast=(0.8, 1.2), min_max_saturation=(0.8, 1.2), prob_swap_channels=0.0)


def _build(echo_factor, batch_size=4, augment=True, depth=2):
    inp = ShuffledShardedInputCallable(Provider(), batch_size=batch_size, shuffle=True)
    steps = [ImageDecoder("image")] + ([PhotoMetricDistorter("image", **PMD)] if augment else [])
    definition = PipelineDefinition(inp, steps, copy_external_source_passthrough_outputs=False)
    return definition.get_pipeline(batch_size=batch_size, num_threads=2, device="cpu", seed=11,
                                   prefetch_queue_depth=depth, echo_factor=echo_factor)


def _jax_build(echo_factor, batch_size=4):
    inp = JInput(JaxProvider(), batch_size=batch_size, shuffle=True)
    steps = [jsteps.ImageDecoder("image"), jsteps.PhotoMetricDistorter("image", **PMD)]
    definition = jpipe.PipelineDefinition(inp, steps,
                                          copy_external_source_passthrough_outputs=False)
    return definition.get_pipeline(batch_size=batch_size, num_threads=2, seed=11,
                                   echo_factor=echo_factor)


def _arrays(batch):
    return {k: np.asarray(v) for k, v in batch.items()}


def _stream(pipe, n):
    try:
        return [_arrays(pipe.run()) for _ in range(n)]
    finally:
        pipe.stop()


def _assert_same(got, want, what=""):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what} field {k}")


# ------------------------- echoing -------------------------------------- #


def test_echo_replays_share_source_but_differ_in_augmentation():
    pipe = _build(echo_factor=3)
    try:
        replays = [_arrays(pipe.run()) for _ in range(3)]
        st = pipe.stats()
        assert st["consumed"] == 3 and st["transfers"] == 1 and st["produced"] >= 1
        imgs = [r["image"].astype(np.float64) for r in replays]
        assert not np.array_equal(imgs[0], imgs[1])
        assert not np.array_equal(imgs[1], imgs[2])
        np.testing.assert_array_equal(replays[0]["label"], replays[2]["label"])
        nxt = pipe.run()["image"].numpy().astype(np.float64)  # echo 0 of host batch 1
        assert pipe.stats()["transfers"] == 2

        def corr(a, b):
            a = a.ravel() - a.mean()
            b = b.ravel() - b.mean()
            return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-9))

        same_src, diff_src = corr(imgs[0], imgs[1]), corr(imgs[0], nxt)
        assert same_src > 0.9 > diff_src, (same_src, diff_src)
    finally:
        pipe.stop()


def test_echo_epoch_yields_factor_times_batches():
    counts = []
    for factor in (1, 2):
        pipe = _build(echo_factor=factor)
        n = 0
        try:
            while True:
                try:
                    pipe.run()
                    n += 1
                except StopIteration:
                    break
            counts.append((n, pipe.stats()["transfers"]))
        finally:
            pipe.stop()
    assert counts[0][0] > 0 and counts[1][0] == 2 * counts[0][0]
    assert counts[1][1] == counts[0][1] == counts[0][0]  # one transfer per host batch


def test_echo_without_augmentation_replays_identically_and_warns():
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        pipe = _build(echo_factor=2, augment=False)
    assert any("device-placed step" in str(w.message) for w in caught)
    try:
        _assert_same(_arrays(pipe.run()), _arrays(pipe.run()))
    finally:
        pipe.stop()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _build(echo_factor=2, augment=True).stop()
    assert not any("device-placed step" in str(w.message) for w in caught)


def test_echo_factor_validation():
    with pytest.raises(ValueError, match="echo_factor"):
        _build(echo_factor=0)


def test_echo_stream_is_deterministic():
    for x, y in zip(_stream(_build(echo_factor=2), 4), _stream(_build(echo_factor=2), 4)):
        _assert_same(x, y)


@pytest.mark.parametrize("factor,keys", [
    (1, [(11, 0), (11, 1), (11, 2)]),
    (2, [(11, 0, 0), (11, 0, 1), (11, 1, 0)]),
])
def test_device_keys(monkeypatch, factor, keys):
    """At factor 1 the device randomness stays keyed (seed, batch), as
    before echoing existed; above it each replay adds its echo index. A
    spec's first batch draws from a DeviceRandomContext, the later ones
    through the shared program from draws made on the host from the key."""
    import accvlab_tpu_torch.pipeline.pipeline as executor

    seen = []
    real = executor.DeviceRandomContext
    real_draws = executor._draws.make_draws

    def recording(key, device="cpu"):
        seen.append(tuple(key))
        return real(key, device=device)

    def recording_draws(schedule, key):
        seen.append(tuple(key))
        return real_draws(schedule, key)

    monkeypatch.setattr(executor, "DeviceRandomContext", recording)
    monkeypatch.setattr(executor._draws, "make_draws", recording_draws)
    _stream(_build(echo_factor=factor), 3)
    assert seen == keys


@pytest.mark.parametrize("consume", [1, 2, 3, 4, 5])
def test_echo_mid_resume_bitwise(consume):
    stream = _stream(_build(echo_factor=3), 8)
    pipe = _build(echo_factor=3)
    try:
        for i in range(consume):
            _assert_same(_arrays(pipe.run()), stream[i], f"batch {i}")
        state = pipe.get_state()
    finally:
        pipe.stop()
    state = json.loads(json.dumps(state))  # checkpoint-file roundtrip
    assert state["echo"] == {"factor": 3, "next": consume % 3}
    fresh = _build(echo_factor=3)
    try:
        fresh.set_state(state)
        for i in range(consume, 8):
            _assert_same(_arrays(fresh.run()), stream[i], f"batch {i}")
    finally:
        fresh.stop()


def test_echo_checkpoint_factor_mismatch_rejected():
    pipe = _build(echo_factor=2)
    try:
        pipe.run()
        state = pipe.get_state()
    finally:
        pipe.stop()
    for factor in (3, 1):
        other = _build(echo_factor=factor)
        try:
            with pytest.raises(ValueError, match="echo_factor"):
                other.set_state(state)
        finally:
            other.stop()


def test_pipeline_length_reflects_echo():
    p1, p3 = _build(echo_factor=1, augment=False), _build(echo_factor=3, augment=False)
    try:
        assert p1.length == 4  # 16 samples / batch 4
        assert p3.length == 12
        n = 0
        while True:
            try:
                p3.run()
                n += 1
            except StopIteration:
                break
        assert n == p3.length
    finally:
        p1.stop()
        p3.stop()


# ------------------------- resume --------------------------------------- #


def test_set_state_on_a_running_pipeline_rewinds_it():
    """set_state halts the running producer, drops what it prefetched and
    continues from the restored position."""
    stream = _stream(_build(echo_factor=2, depth=3), 7)
    pipe = _build(echo_factor=2, depth=3)
    try:
        pipe.run()
        state = pipe.get_state()
        for _ in range(4):
            pipe.run()
        pipe.set_state(state)
        for i in range(1, 7):
            _assert_same(_arrays(pipe.run()), stream[i], f"batch {i}")
    finally:
        pipe.stop()


def test_mid_epoch_reset_continues_like_an_uninterrupted_run():
    """A reset mid-epoch rolls the batch counter to the epoch's end, so the
    next epoch is keyed as in a run that consumed the whole epoch."""
    ref = _build(echo_factor=1)
    try:
        while True:
            try:
                ref.run()
            except StopIteration:
                break
        ref.reset()
        want = [_arrays(ref.run()) for _ in range(2)]
    finally:
        ref.stop()
    pipe = _build(echo_factor=1)
    try:
        pipe.run()
        pipe.reset()
        for i in range(2):
            _assert_same(_arrays(pipe.run()), want[i], f"epoch 1 batch {i}")
    finally:
        pipe.stop()


def test_resume_arms_one_iterator_front_reset():
    pipe = _build(echo_factor=2)
    try:
        pipe.run()
        pipe.run()
        pipe.run()
        state = pipe.get_state()
    finally:
        pipe.stop()
    fresh = _build(echo_factor=2)
    try:
        fresh.set_state(state)
        fresh._reset_from_iterator_front()  # the armed one: a no-op
        assert fresh.get_state() == state
        fresh.set_state(state)
        fresh.reset()  # a user's reset always resets
        assert fresh.get_state()["epoch"] == 1
        fresh.set_state(state)
        fresh._reset_from_iterator_front()
        fresh._reset_from_iterator_front()  # the second one resets
        assert fresh.get_state()["epoch"] == 1
    finally:
        fresh.stop()


def test_set_state_rejects_unknown_version():
    pipe = _build(echo_factor=1)
    try:
        with pytest.raises(ValueError, match="version"):
            pipe.set_state({"version": 2})
    finally:
        pipe.stop()


class _StateOnlyInput(CallableBase):
    """A callable with get_state but no set_state."""

    def __init__(self):
        self._inner = ShuffledShardedInputCallable(Provider(), batch_size=2, shuffle=False)

    @property
    def used_sample_data_structure(self):
        return self._inner.used_sample_data_structure

    def __call__(self, info):
        return self._inner(info)

    def get_state(self):
        return {"offset": 0}


class _Iterable(IterableBase):
    def __init__(self):
        self._i = 0

    @property
    def used_sample_data_structure(self):
        return Provider().sample_data_structure

    def __next__(self):
        self._i += 1
        sdgs = [Provider().get_data(self._i * 2 + k) for k in range(2)]
        return tuple([s.get_data()[f] for s in sdgs] for f in range(2))


@pytest.mark.parametrize("inp,match", [(_StateOnlyInput, "has no set_state"),
                                       (_Iterable, "iterable input without a saved")])
def test_set_state_warns_when_the_input_cannot_be_restored(inp, match):
    definition = PipelineDefinition(inp(), [ImageDecoder("image")])
    pipe = definition.get_pipeline(batch_size=2, num_threads=1, device="cpu")
    try:
        pipe.run()
        state = pipe.get_state()
        with pytest.warns(UserWarning, match=match):
            pipe.set_state(state)
    finally:
        pipe.stop()


@pytest.mark.parametrize("echo", [1, 3])
def test_state_dicts_equal_jax_after_the_same_consumption(echo):
    """The same consumption in both packages gives the same state dicts,
    key for key: before the first batch, mid-echo, at host-batch ends,
    after a mid-epoch reset and across the epoch's end."""
    tpipe, jpipe_ = _build(echo_factor=echo), _jax_build(echo_factor=echo)
    try:
        assert tpipe.length == jpipe_.length
        states = []

        def both(action):
            for p in (tpipe, jpipe_):
                action(p)
            states.append((tpipe.get_state(), jpipe_.get_state()))

        both(lambda p: None)
        for _ in range(4):
            both(lambda p: p.run())
        both(lambda p: p.reset())
        both(lambda p: p.run())

        def drain(p):
            while True:
                try:
                    p.run()
                except StopIteration:
                    return

        both(drain)
        both(lambda p: p.reset())
        both(lambda p: p.run())
    finally:
        tpipe.stop()
        jpipe_.stop()
    for i, (t, j) in enumerate(states):
        assert t == j, f"state {i}: {t} != {j}"
        assert json.loads(json.dumps(t)) == t


# ------------------------- the packed wire ------------------------------ #


def _assert_wire_echo_resume_bitwise(wire_steps):
    """Each replay decodes the same transferred wire fields again with its
    own randomness, and a mid-echo resume continues bit for bit."""
    def build():
        inp = ShuffledShardedInputCallable(Provider(), batch_size=2, shuffle=True)
        steps = wire_steps() + [
            YCbCrToRGBConverter("image"),
            PhotoMetricDistorter("image", min_max_brightness=(-10.0, 10.0),
                                 min_max_hue=(-5.0, 5.0), min_max_contrast=(0.9, 1.1),
                                 min_max_saturation=(0.9, 1.1)),
        ]
        definition = PipelineDefinition(inp, steps,
                                        copy_external_source_passthrough_outputs=False)
        return definition.get_pipeline(batch_size=2, num_threads=2, device="cpu", seed=3,
                                       echo_factor=2)

    stream = _stream(build(), 6)
    assert not np.array_equal(stream[0]["image"], stream[1]["image"])
    pipe = build()
    try:
        for i in range(3):
            _assert_same(_arrays(pipe.run()), stream[i], f"batch {i}")
        state = pipe.get_state()
        assert state["echo"] == {"factor": 2, "next": 1}
        assert pipe.stats()["transfers"] == 2
    finally:
        pipe.stop()
    fresh = build()
    try:
        fresh.set_state(state)
        for i in range(3, 6):
            _assert_same(_arrays(fresh.run()), stream[i], f"batch {i}")
    finally:
        fresh.stop()


def test_packed_wire_with_echo_mid_resume_bitwise():
    """Wire compression x echoing x resume."""
    _assert_wire_echo_resume_bitwise(lambda: [
        ImageDecoder("image", wire_format="yuv420"),
        WirePlanePacker(["image", "image_cbcr"]),
        WirePlaneUnpacker(["image", "image_cbcr"]),
    ])


def test_dct_wire_with_echo_mid_resume_bitwise():
    """The DCT wire x echoing x resume (the counterpart of
    tests/test_dct_wire.py::test_dct_wire_with_echo_mid_resume_bitwise): the
    replays decode the same transferred coefficients."""
    _assert_wire_echo_resume_bitwise(lambda: [
        DCTWirePacker("image", (16, 24), (16, 24)),
        DCTWireUnpacker("image", (16, 24), (16, 24)),
    ])
