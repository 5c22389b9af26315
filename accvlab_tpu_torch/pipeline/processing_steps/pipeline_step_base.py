"""Pipeline step base class.

PyTorch port of ``accvlab_tpu/pipeline/processing_steps/pipeline_step_base.py``.
The construction-time contract is identical: each step implements

* ``_check_and_adjust_data_format_input_to_output(blueprint) -> blueprint`` —
  validates the input format and advertises the output format, and
* ``_process(data) -> data`` — the actual transform,

and ``__call__`` cross-checks ``_process``'s output format against the
independently inferred blueprint (``pipeline_step_base.py:92-118`` of the
reference).

Execution model — the one difference from the JAX package:

* **host** steps (``placement="host"``) take ONE sample's
  :class:`SampleDataGroup` (numpy leaves without a batch dimension); the
  executor maps them over the batch on a thread pool, as in JAX.
* **device** steps (``placement="device"`` / ``"any"`` after the boundary)
  take the WHOLE batch: every leaf is a torch tensor with a leading batch
  dimension. JAX instead ``vmap``-s a per-sample ``_process`` inside one jit
  (``pipeline.py:474-501``); PyTorch runs eagerly, so the batch dimension is
  written out and randomness is drawn with ``shape=(batch,)``.
* Batch-level host steps set ``is_batch_level = True`` and implement
  ``_process_batch(samples)``.
* Randomness comes from an injected :class:`RandomContext` (``self.random``).
"""

from __future__ import annotations

import threading
import weakref
from abc import ABC, abstractmethod
from typing import List, Optional

from ..random_context import RandomContext
from ..sample_data_group import SampleDataGroup

# RandomContext injection is per-thread: the executor runs samples of one
# batch concurrently on a thread pool over SHARED step instances, so storing
# the context as plain instance state would let thread A read thread B's
# generator (non-deterministic, and np.random.Generator is not thread-safe).
# A module-level threading.local keeps steps picklable for process workers
# (threading.local as instance state would not pickle). The per-thread map
# is a WeakKeyDictionary keyed by the step OBJECT: entries die with the
# step (no unbounded growth across rebuilt pipelines), and unlike id() keys
# a freed-then-reused address can never hand a new step a dead step's
# generator.
_TLS = threading.local()


def _ctx_map():
    m = getattr(_TLS, "ctx_by_step", None)
    if m is None:
        m = weakref.WeakKeyDictionary()
        _TLS.ctx_by_step = m
    return m


class PipelineStepBase(ABC):
    """Base class for pipeline processing steps. See module docstring."""

    #: where the step may execute: "host", "device", or "any"
    placement: str = "device"
    #: True for steps that need the whole batch (host-only)
    is_batch_level: bool = False

    def __init__(self):
        pass

    # -- randomness ------------------------------------------------------ #

    @property
    def random(self) -> RandomContext:
        """The injected randomness source (set by the executor; thread-local)."""
        ctx = _ctx_map().get(self)
        assert ctx is not None, (
            f"{type(self).__name__} requested randomness but no RandomContext "
            "was injected (set_random_context) in this thread"
        )
        return ctx

    def set_random_context(self, ctx: Optional[RandomContext]):
        if ctx is None:
            _ctx_map().pop(self, None)
        else:
            _ctx_map()[self] = ctx

    # -- format contract (parity with the reference) --------------------- #

    def check_input_data_format_and_set_output_data_format(
        self, data_empty: SampleDataGroup
    ) -> SampleDataGroup:
        """Validate the input format and return the output format blueprint
        (parity: ``pipeline_step_base.py:143``)."""
        data_empty = data_empty.get_empty_like_self()
        return self._check_and_adjust_data_format_input_to_output(data_empty)

    @abstractmethod
    def _check_and_adjust_data_format_input_to_output(
        self, data_empty: SampleDataGroup
    ) -> SampleDataGroup:
        """Override: check compatibility, raise on mismatch, return the output
        blueprint (may modify ``data_empty`` in place and return it)."""

    # -- execution ------------------------------------------------------- #

    def __call__(self, data: SampleDataGroup) -> SampleDataGroup:
        """Apply ``_process`` and validate the output format against the
        advertised blueprint (parity: ``pipeline_step_base.py:92-118``).

        On the device path this runs at trace time, so like the reference's
        graph-construction-time check it costs nothing per batch.
        """
        return self._checked(self._process, data)

    def _checked(self, process, data: SampleDataGroup) -> SampleDataGroup:
        """``process(data)``, a stand-in for ``_process``, with its output
        format checked as :meth:`__call__` checks ``_process``'s."""
        blueprint_in = data.get_empty_like_self()
        processed = process(data)
        reference_blueprint = self.check_input_data_format_and_set_output_data_format(blueprint_in)
        if not processed.type_matches(reference_blueprint):
            raise AssertionError(
                "SampleDataGroup format returned by _process does not match the "
                "format advertised by check_input_data_format_and_set_output_data_format.\n"
                f"##### From _process():\n{processed}\n"
                f"##### Reference:\n{reference_blueprint}\n##########"
            )
        return processed

    @abstractmethod
    def _process(self, data: SampleDataGroup) -> SampleDataGroup:
        """Override: transform one sample's data. May mutate ``data``."""


class BatchLevelStepBase(PipelineStepBase):
    """Host-only step operating on the whole batch (list of samples).

    ``_process`` receives/returns a single sample and is not used; override
    ``_process_batch`` instead.
    """

    placement = "host"
    is_batch_level = True

    def _process(self, data: SampleDataGroup) -> SampleDataGroup:  # pragma: no cover
        raise RuntimeError("Batch-level steps are applied via _process_batch")

    @abstractmethod
    def _process_batch(self, samples: List[SampleDataGroup]) -> List[SampleDataGroup]:
        """Transform the list of per-sample SampleDataGroups."""

    def process_batch_checked(
        self, samples: List[SampleDataGroup], check: bool
    ) -> List[SampleDataGroup]:
        if not samples:
            return samples
        blueprint_in = samples[0].get_empty_like_self()
        out = self._process_batch(samples)
        if check and out:
            ref = self.check_input_data_format_and_set_output_data_format(blueprint_in)
            if not out[0].type_matches(ref):
                raise AssertionError(
                    f"{type(self).__name__}: _process_batch output format does not "
                    "match the advertised blueprint"
                )
        return out
