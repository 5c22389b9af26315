"""Elastic sharded input: exact data accounting across shard-count changes.

The port's own copy of the JAX package's module (numpy only). The contract
of :class:`ShuffledShardedInputCallable` slices the per-epoch permutation
into ``num_shards`` CONTIGUOUS blocks. That is fine for a fixed fleet, but a
preempted job may resume on a different number of processes — and with
contiguous blocks a mid-epoch resume under a new ``num_shards``
re-partitions the permutation, silently repeating some samples and skipping
others.

:class:`ElasticShardedInputCallable` instead deals samples to shards in
per-step BLOCKS: training step ``t`` (all shards in lockstep, the
data-parallel contract) consumes exactly the global positions

    ``offset + t*B*W  ..  offset + (t+1)*B*W - 1``

of the epoch permutation (``B`` = per-shard batch size, ``W`` = shard
count), with shard ``s`` taking the sub-block ``offset + t*B*W + s*B + j``.
Consumption is therefore always a PREFIX of the permutation — a checkpoint
at step ``t`` means "the first ``offset + t*B*W`` samples of this epoch are
done", a statement independent of how many shards produced it. Resuming on
``W'`` shards continues from that prefix exactly: no sample is repeated, no
sample is skipped, for any ``W -> W'``.

Use :func:`elastic_reshard` to fold a pipeline checkpoint taken on the old
fleet into the constructor arguments + restored state for the new one.
Checkpoints of the JAX package's pipeline and of the port's
(``TorchPipeline.get_state``) have the same keys, so either may be resharded
and resumed by the other.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .base import CallableBase, DataProvider, SampleInfo
from ..sample_data_group import SampleDataGroup


class ElasticShardedInputCallable(CallableBase):
    """Per-epoch reshuffled input with shard-count-independent accounting.

    Drop-in alternative to :class:`ShuffledShardedInputCallable` (same
    constructor arguments; all shards must share ``seed``). The partial tail
    of each epoch (fewer than ``batch_size * num_shards`` samples) is
    dropped, mirroring the reference's partial-batch semantics.

    ``start_offset`` / ``start_epoch``: global samples of epoch
    ``start_epoch``'s permutation already consumed before this object was
    constructed (produced by :func:`elastic_reshard` from a checkpoint).
    Epochs after ``start_epoch`` run full-length from offset 0.
    """

    def __init__(
        self,
        data_provider: DataProvider,
        batch_size: int,
        shard_id: int = 0,
        num_shards: int = 1,
        shuffle: bool = False,
        seed: int = 21,
        start_offset: int = 0,
        start_epoch: int = 0,
    ):
        if not (0 <= shard_id < num_shards):
            raise ValueError(f"shard_id {shard_id} not in [0, {num_shards})")
        if start_offset < 0:
            raise ValueError(f"start_offset must be >= 0, got {start_offset}")
        self._data_provider = data_provider
        self._batch_size = batch_size
        self._shard_id = shard_id
        self._num_shards = num_shards
        self._shuffle = shuffle
        self._seed = seed
        self._start_offset = start_offset
        self._start_epoch = start_epoch

        self._data_len = data_provider.get_number_of_samples()
        self._permutation = None
        self._last_seen_epoch = -1

    @property
    def used_sample_data_structure(self) -> SampleDataGroup:
        res = self._data_provider.sample_data_structure
        res.set_apply_mapping(False)
        return res

    def _setup_permutation(self, epoch_idx: int) -> np.ndarray:
        # seeded per epoch, INDEPENDENT of shard layout — the invariant that
        # makes the consumed prefix transferable across shard counts (same
        # derivation as ShuffledShardedInputCallable for familiarity)
        if self._shuffle:
            return np.random.default_rng(seed=self._seed + epoch_idx).permutation(
                self._data_len
            )
        return np.arange(self._data_len)

    def _epoch_offset(self, epoch_idx: int) -> int:
        return self._start_offset if epoch_idx == self._start_epoch else 0

    def steps_in_epoch(self, epoch_idx: int) -> int:
        """Full lockstep steps available in ``epoch_idx`` (partial tail
        dropped)."""
        remaining = self._data_len - self._epoch_offset(epoch_idx)
        return max(0, remaining // (self._batch_size * self._num_shards))

    def __call__(self, sample_info: SampleInfo) -> tuple:
        if sample_info.iteration >= self.steps_in_epoch(sample_info.epoch_idx):
            raise StopIteration
        if self._last_seen_epoch != sample_info.epoch_idx:
            self._permutation = self._setup_permutation(sample_info.epoch_idx)
            self._last_seen_epoch = sample_info.epoch_idx
        g = (
            self._epoch_offset(sample_info.epoch_idx)
            + sample_info.iteration * self._batch_size * self._num_shards
            + self._shard_id * self._batch_size
            + sample_info.idx_in_batch
        )
        return self._data_provider.get_data(int(self._permutation[g])).get_data()

    @property
    def length(self) -> Optional[int]:
        """Steps of a full (offset-0) epoch — the stable sizing number for
        consumers. The resumed epoch itself may be shorter; use
        :meth:`steps_in_epoch` with the concrete epoch index for exactness."""
        return self._data_len // (self._batch_size * self._num_shards)

    def get_state(self) -> dict:
        """Static resume parameters, captured into the pipeline checkpoint
        (``TorchPipeline`` snapshots any input exposing ``get_state``). The
        callable itself is stateless — these are the constructor offsets
        :func:`elastic_reshard` needs so that CHAINED mid-epoch reshards
        account the prior offset instead of restarting from the epoch-local
        iteration alone."""
        return {
            "start_offset": self._start_offset,
            "start_epoch": self._start_epoch,
            "num_shards": self._num_shards,
            "batch_size": self._batch_size,
        }

    def set_state(self, state: dict) -> None:
        """No-op by design: the callable is a pure function of SampleInfo —
        position restoration happens through the pipeline counters plus the
        constructor offsets (see :func:`elastic_reshard`)."""
        del state


def elastic_reshard(
    pipeline_state: dict,
    *,
    batch_size: Optional[int] = None,
    checkpoint_num_shards: Optional[int] = None,
) -> tuple:
    """Translate a pipeline checkpoint into elastic-resume parameters.

    Args:
        pipeline_state: ``TorchPipeline.get_state()`` taken on ANY shard of
            the old fleet (all shards agree on the counters — the lockstep
            contract).
        batch_size: per-shard batch size (unchanged across the reshard; the
            global batch size changes with the shard count). Optional when
            the checkpoint carries the input snapshot (it records the true
            value); if given AND recorded, they must agree.
        checkpoint_num_shards: ``num_shards`` of the fleet that TOOK the
            checkpoint. Same optionality/validation as ``batch_size`` —
            passing a wrong value here would silently corrupt the sample
            accounting, so the recorded snapshot is authoritative.

    Returns:
        ``(input_kwargs, new_state)``:

        * ``input_kwargs`` — pass as extra keyword arguments
          (``start_offset``, ``start_epoch``) when constructing each new
          shard's :class:`ElasticShardedInputCallable` (with the NEW
          ``shard_id`` / ``num_shards``).
        * ``new_state`` — feed to ``TorchPipeline.set_state`` on the new
          fleet: the consumed prefix moves into the input offset, so the
          epoch-local iteration restarts at 0; ``global_batch`` (the
          device augmentation key stream) stays monotone so no
          fresh-sample key ever collides with an earlier batch's. (One
          deliberate exception: resuming a MID-ECHO checkpoint restarts
          the partially-delivered host batch at echo 0 with the same
          ``global_batch``, so the replays already delivered on the old
          fleet re-derive their keys for the re-produced — differently
          composed — batch. Statistically harmless: the samples under the
          key differ.)
    """
    if pipeline_state.get("version") != 1:
        raise ValueError(
            f"Unknown pipeline state version: {pipeline_state.get('version')!r}"
        )
    epoch = int(pipeline_state["epoch"])
    # chained reshards: the checkpointing fleet's input may itself have been
    # constructed with a resume offset (recorded into the checkpoint via the
    # input-state snapshot) — the consumed prefix includes it
    prior = pipeline_state.get("input_state") or {}
    # the snapshot's num_shards/batch_size are authoritative: a wrong
    # explicit argument would silently corrupt the sample accounting
    for name, given in (
        ("batch_size", batch_size),
        ("num_shards", checkpoint_num_shards),
    ):
        if name in prior and given is not None and int(prior[name]) != int(given):
            raise ValueError(
                f"Checkpoint records {name}={prior[name]} but "
                f"{'batch_size' if name == 'batch_size' else 'checkpoint_num_shards'}"
                f"={given} was passed — the recorded value is what the "
                "checkpointing fleet actually used."
            )
    batch_size = int(prior.get("batch_size", batch_size or 0))
    checkpoint_num_shards = int(prior.get("num_shards", checkpoint_num_shards or 0))
    if batch_size <= 0 or checkpoint_num_shards <= 0:
        raise ValueError(
            "The checkpoint carries no input snapshot; pass batch_size and "
            "checkpoint_num_shards explicitly."
        )
    prior_offset = (
        int(prior.get("start_offset", 0))
        if int(prior.get("start_epoch", epoch)) == epoch
        else 0
    )
    consumed = prior_offset + (
        int(pipeline_state["iteration"]) * batch_size * checkpoint_num_shards
    )
    input_kwargs = {
        "start_offset": consumed,
        "start_epoch": epoch,
    }
    new_state = dict(pipeline_state)
    new_state["iteration"] = 0
    new_state["input_state"] = None
    echo = new_state.get("echo")
    if echo is not None and int(echo.get("next", 0)) != 0:
        # A mid-echo checkpoint cannot replay its partial host batch under a
        # different shard count (the permutation window per batch changes
        # with W). The partially-echoed batch is already EXCLUDED from the
        # consumed prefix (the pipeline's iteration counter only advances on
        # the last replay), so restart it from echo 0: fresh-sample
        # accounting stays exact; the views delivered from it before the
        # preemption are re-delivered once — a few duplicated augmented
        # views at the reshard point, never a lost or duplicated sample.
        new_state["echo"] = {"factor": int(echo["factor"]), "next": 0}
    return input_kwargs, new_state
