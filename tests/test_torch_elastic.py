"""The port's ``ElasticShardedInputCallable`` and ``elastic_reshard`` against
the JAX package's, on the CPU.

A provider whose one field is the sample index shows which samples each
shard consumed. Checked: the delivered indices of every shard and step equal
the JAX callable's, for a 2 -> 3 reshard and for chained reshards
(2 -> 3 -> 1, 3 -> 2 -> 4), epoch after epoch; ``elastic_reshard`` gives the
JAX function's result on the same checkpoint; a checkpoint taken by a JAX
fleet (``TPUPipeline.get_state``) is resharded and resumed by a port fleet,
which drains the epoch with every sample exactly once; and the recorded-
value checks raise the JAX package's errors, message for message.
"""

import json

import numpy as np
import pytest
import torch

import accvlab_tpu.pipeline as jpipe
import accvlab_tpu.pipeline.inputs as jin
import accvlab_tpu_torch.pipeline as tpipe
import accvlab_tpu_torch.pipeline.inputs as tin


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def idx_provider(pkg, inputs, n):
    class IdxProvider(inputs.DataProvider):
        @property
        def sample_data_structure(self):
            root = pkg.SampleDataGroup()
            root.add_data_field("idx", pkg.DType.INT32)
            return root

        def get_data(self, sample_index):
            sdg = self.sample_data_structure
            sdg["idx"] = np.asarray([sample_index], np.int32)
            return sdg

        def get_number_of_samples(self):
            return n

    return IdxProvider()


def shard_stream(inputs, inp, epochs, batch):
    """Every (epoch, step) of one shard's samples through the raw __call__,
    until the epoch's StopIteration."""
    out = []
    for epoch in epochs:
        t = 0
        while True:
            try:
                out.append([int(inp(inputs.SampleInfo(t * batch + j, j, t, epoch))[0][0])
                            for j in range(batch)])
            except StopIteration:
                break
            t += 1
    return out


N, B, SEED = 30, 2, 13


def both_callables(num_shards, shard_id, **extra):
    return (jin.ElasticShardedInputCallable(idx_provider(jpipe, jin, N), B, shard_id=shard_id,
                                            num_shards=num_shards, shuffle=True, seed=SEED,
                                            **extra),
            tin.ElasticShardedInputCallable(idx_provider(tpipe, tin, N), B, shard_id=shard_id,
                                            num_shards=num_shards, shuffle=True, seed=SEED,
                                            **extra))


@pytest.mark.parametrize("plan", [[2, 3], [2, 3, 1], [3, 2, 4]])
def test_delivered_indices_equal_the_jax_callable(plan):
    """Each fleet of the plan takes one lockstep step, the checkpoint goes
    through elastic_reshard (both packages'), the last fleet drains two
    epochs; every shard's stream equal."""
    state = None
    for k, w in enumerate(plan):
        extra = {}
        if state is not None:
            j_kw, j_state = jin.elastic_reshard(json.loads(json.dumps(state)))
            t_kw, t_state = tin.elastic_reshard(json.loads(json.dumps(state)))
            assert (t_kw, t_state) == (j_kw, j_state)
            extra = t_kw
        last = k == len(plan) - 1
        for s in range(w):
            j, t = both_callables(w, s, **extra)
            epoch = extra.get("start_epoch", 0)
            if last:
                js, ts = (shard_stream(jin, j, [epoch, epoch + 1], B),
                          shard_stream(tin, t, [epoch, epoch + 1], B))
            else:
                js = [[int(j(jin.SampleInfo(i, i, 0, epoch))[0][0]) for i in range(B)]]
                ts = [[int(t(tin.SampleInfo(i, i, 0, epoch))[0][0]) for i in range(B)]]
            assert ts == js
            assert t.get_state() == j.get_state()
            assert t.steps_in_epoch(epoch) == j.steps_in_epoch(epoch) and t.length == j.length
        # the checkpoint of this fleet after one step, as the executor writes it
        state = {"version": 1, "epoch": extra.get("start_epoch", 0), "iteration": 1,
                 "global_batch": 1 + k, "input_state": t.get_state()}


def _drain(fleet):
    labels, done = [], [False] * len(fleet)
    while not all(done):
        for i, p in enumerate(fleet):
            if done[i]:
                continue
            try:
                labels += np.asarray(p.run()["idx"]).ravel().tolist()
            except StopIteration:
                done[i] = True
    return labels


def test_a_jax_checkpoint_resumes_on_a_port_fleet():
    """A 2-shard JAX fleet takes 2 steps; its get_state, through the port's
    elastic_reshard, resumes a 3-shard port fleet that drains the epoch."""
    n, bsz = 32, 4

    def fleet(pkg, inputs, w, extra=None, device=None):
        pipes = []
        for s in range(w):
            inp = inputs.ElasticShardedInputCallable(idx_provider(pkg, inputs, n), bsz,
                                                     shard_id=s, num_shards=w, shuffle=True,
                                                     seed=11, **(extra or {}))
            d = pkg.PipelineDefinition(inp, [], copy_external_source_passthrough_outputs=False)
            kw = {} if device is None else {"device": device}
            pipes.append(d.get_pipeline(batch_size=bsz, num_threads=1, seed=3, **kw))
        return pipes

    old = fleet(jpipe, jin, 2)
    labels = []
    try:
        for _ in range(2):
            for p in old:
                labels += np.asarray(p.run()["idx"]).ravel().tolist()
        state = json.loads(json.dumps(old[0].get_state()))
    finally:
        for p in old:
            p.stop()
    kw, new_state = tin.elastic_reshard(state)
    assert kw == {"start_offset": 16, "start_epoch": 0}
    new = fleet(tpipe, tin, 3, kw, device="cpu")
    try:
        for p in new:
            p.set_state(dict(new_state))
        labels += _drain(new)
    finally:
        for p in new:
            p.stop()
    # 16 on the old fleet, one lockstep step of 12 on the new one (the
    # 4-sample tail is dropped)
    assert len(labels) == 28 and len(set(labels)) == 28
    perm = np.random.default_rng(seed=11).permutation(n)
    assert sorted(labels) == sorted(perm[:28].tolist())


def _error(fn):
    try:
        fn()
    except (ValueError, StopIteration) as e:
        return type(e), str(e)
    return None


CHECKS = {
    "batch_size_disagrees": lambda m: m.elastic_reshard(
        {"version": 1, "epoch": 0, "iteration": 1, "global_batch": 1,
         "input_state": {"start_offset": 0, "start_epoch": 0, "num_shards": 2,
                         "batch_size": 4}}, batch_size=3),
    "num_shards_disagrees": lambda m: m.elastic_reshard(
        {"version": 1, "epoch": 0, "iteration": 1, "global_batch": 1,
         "input_state": {"start_offset": 0, "start_epoch": 0, "num_shards": 2,
                         "batch_size": 4}}, checkpoint_num_shards=3),
    "no_snapshot_no_arguments": lambda m: m.elastic_reshard(
        {"version": 1, "epoch": 0, "iteration": 1, "global_batch": 1, "input_state": None}),
    "unknown_version": lambda m: m.elastic_reshard({"version": 99}, batch_size=2,
                                                   checkpoint_num_shards=2),
    "shard_id_out_of_range": lambda m: m.ElasticShardedInputCallable(None, 2, shard_id=2,
                                                                     num_shards=2),
    "negative_offset": lambda m: m.ElasticShardedInputCallable(None, 2, start_offset=-1),
}


@pytest.mark.parametrize("name", sorted(CHECKS))
def test_recorded_value_checks_raise_as_in_jax(name):
    want = _error(lambda: CHECKS[name](jin))
    assert want is not None
    assert _error(lambda: CHECKS[name](tin)) == want


def test_mid_echo_checkpoint_restarts_at_echo_zero_as_in_jax():
    state = {"version": 1, "epoch": 0, "iteration": 3, "global_batch": 3,
             "input_state": {"start_offset": 0, "start_epoch": 0, "num_shards": 2,
                             "batch_size": 2},
             "echo": {"factor": 2, "next": 1}}
    assert tin.elastic_reshard(dict(state)) == jin.elastic_reshard(dict(state))
    assert tin.elastic_reshard(dict(state))[1]["echo"] == {"factor": 2, "next": 0}
