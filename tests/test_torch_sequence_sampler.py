"""The port's drive-order samplers against ``accvlab_tpu.pipeline.inputs``.

``SequenceSampler``, ``SamplerInputCallable`` and ``SamplerInputIterable``
are numpy-only; the port keeps its own copies. Their index streams, lookups
and resume states must be **equal** to the JAX package's for the same
arguments (no tolerance: they are integers).
"""

import json

import numpy as np
import pytest

from accvlab_tpu.pipeline.inputs import SampleInfo as JSampleInfo
from accvlab_tpu.pipeline.inputs import SamplerInputCallable as JCallable
from accvlab_tpu.pipeline.inputs import SamplerInputIterable as JIterable
from accvlab_tpu.pipeline.inputs import SequenceSampler as JSequenceSampler
from accvlab_tpu_torch.pipeline.inputs import SampleInfo, SamplerInputCallable, SamplerInputIterable
from accvlab_tpu_torch.pipeline.inputs import SequenceSampler


class _Sample:
    def __init__(self, index):
        self.index = index

    def get_data(self):
        return (self.index, self.index * 10)


class IndexProvider:
    """Duck-typed provider: sample ``i`` is the tuple ``(i, 10 i)``."""

    def get_data(self, i):
        return _Sample(int(i))


SAMPLERS = {  # name: kwargs
    "nuscenes_like": dict(total_batch_size=8, sequence_lengths=[40] * 160, seed=0),
    "uneven": dict(total_batch_size=3, sequence_lengths=[5, 1, 7, 2, 9, 3, 4], seed=4),
    "not_random": dict(total_batch_size=2, sequence_lengths=[3, 4, 5], seed=1, randomize=False),
    "misspelled": dict(total_batch_size=4, sequence_lenghts=[6, 2, 8, 3, 5], seed=7),
}


def both(name):
    return JSequenceSampler(**SAMPLERS[name]), SequenceSampler(**SAMPLERS[name])


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_index_stream_equals_jax(name):
    j, t = both(name)
    stream_j = [j.get_next_batch_indices() for _ in range(120)]
    stream_t = [t.get_next_batch_indices() for _ in range(120)]
    assert stream_t == stream_j
    assert t.length is None and not t.is_epoch_based


def test_drive_order_walks_each_slot_forward():
    """Each batch slot advances one frame at a time inside one drive."""
    t = SequenceSampler(**SAMPLERS["nuscenes_like"])
    rows = np.array([t.get_next_batch_indices() for _ in range(40)])
    assert (rows[1:] - rows[:-1] == 1).all()
    assert (rows[0] % 40 == 0).all() and len(set(rows[0] // 40)) == 8


@pytest.mark.parametrize("name", sorted(SAMPLERS))
@pytest.mark.parametrize("draws", [0, 3, 57])
def test_resume_equals_jax(name, draws):
    j, t = both(name)
    for _ in range(draws):
        j.get_next_batch_indices()
        t.get_next_batch_indices()
    state = json.loads(json.dumps(t.get_state()))
    assert state == j.get_state()
    fresh_j, fresh_t = both(name)
    fresh_j.set_state(state)
    fresh_t.set_state(state)
    for _ in range(10):
        want = j.get_next_batch_indices()
        assert fresh_t.get_next_batch_indices() == want == fresh_j.get_next_batch_indices()
        assert t.get_next_batch_indices() == want


def test_set_state_rewinds():
    _, t = both("uneven")
    first = [t.get_next_batch_indices() for _ in range(6)]
    t.set_state({"draws": 2})
    assert [t.get_next_batch_indices() for _ in range(4)] == first[2:]


def test_reset_raises():
    _, t = both("uneven")
    with pytest.raises(RuntimeError, match="not epoch-based"):
        t.reset()


@pytest.mark.parametrize("num_shards,shard_id", [(1, 0), (2, 1), (4, 3)])
def test_sampler_input_callable_equals_jax(num_shards, shard_id):
    j, t = both("nuscenes_like")
    cj = JCallable(IndexProvider(), j, max_num_iterations=9, pre_fetch_queue_length=2,
                   shard_id=shard_id, num_shards=num_shards)
    ct = SamplerInputCallable(IndexProvider(), t, max_num_iterations=9, pre_fetch_queue_length=2,
                              shard_id=shard_id, num_shards=num_shards)
    assert ct.length == cj.length == 11
    local = 8 // num_shards
    for it in range(11):
        for i in range(local):
            kw = dict(idx_in_epoch=it * local + i, idx_in_batch=i, iteration=it, epoch_idx=0)
            assert ct(SampleInfo(**kw)) == cj(JSampleInfo(**kw))
    past = dict(idx_in_epoch=11 * local, idx_in_batch=0, iteration=11, epoch_idx=0)
    with pytest.raises(StopIteration):
        ct(SampleInfo(**past))
    with pytest.raises(RuntimeError, match="Maximum iteration count"):
        ct(SampleInfo(idx_in_epoch=0, idx_in_batch=0, iteration=0, epoch_idx=1))


@pytest.mark.parametrize("num_shards,shard_id", [(1, 0), (2, 1)])
def test_sampler_input_iterable_equals_jax_and_resumes(num_shards, shard_id):
    j, t = both("nuscenes_like")
    ij = iter(JIterable(IndexProvider(), j, shard_id=shard_id, num_shards=num_shards))
    it = iter(SamplerInputIterable(IndexProvider(), t, shard_id=shard_id, num_shards=num_shards))
    for _ in range(7):
        assert next(it) == next(ij)
    state = it.get_state()
    assert state == ij.get_state()
    resumed = SamplerInputIterable(IndexProvider(), both("nuscenes_like")[1], shard_id=shard_id,
                                   num_shards=num_shards)
    resumed.set_state(state)
    for _ in range(5):
        assert next(resumed) == next(it)


def test_sampler_input_iterable_needs_divisible_shards():
    with pytest.raises(AssertionError, match="not divisible"):
        next(SamplerInputIterable(IndexProvider(), both("uneven")[1], num_shards=2))
