"""Randomness injection for pipeline steps.

PyTorch port of ``accvlab_tpu/pipeline/random_context.py``. Every step gets
an explicit :class:`RandomContext`:

* :class:`HostRandomContext` — numpy ``Generator`` (host steps, per sample),
* :class:`DeviceRandomContext` — a ``torch.Generator`` seeded from
  ``(seed, batch_idx[, echo])`` (device steps, batched). The draws (a few
  scalars per sample) are made on the CPU and moved to the batch's device
  by an asynchronous copy from pinned memory (no host-card synchronisation),
  so a run on the card and a run on the CPU see the same numbers. Bounds
  may be tensors on the device (one range per sample); the draw is then
  scaled there. It cannot reproduce the JAX package's threefry bits; parity
  tests script both sides.
* :class:`ReplayRandomContext` — hands out the draws of a recorded
  schedule, given as tensors (the traceable form for the serving export),
* :class:`ScriptedRandomContext` — returns scripted sequences matched by
  value range; the test-injection pattern of the reference's
  ``DaliFakeRandomGenerator``.

All draws are shape-explicit. Device steps are batched, so they draw with a
leading batch dimension (``shape=(batch,)``) where the JAX steps draw one
scalar per sample under ``vmap``.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .. import _draws


class RandomContext(ABC):
    """Source of randomness handed to pipeline steps."""

    @abstractmethod
    def uniform(self, low: float = 0.0, high: float = 1.0, shape: Tuple[int, ...] = ()):
        """Uniform floats in ``[low, high)``."""

    @abstractmethod
    def normal(self, mean: float = 0.0, stddev: float = 1.0, shape: Tuple[int, ...] = ()):
        """Normal floats."""

    @abstractmethod
    def randint(self, low: int, high: int, shape: Tuple[int, ...] = ()):
        """Uniform ints in ``[low, high)``."""

    def coin_flip(self, probability: float = 0.5, shape: Tuple[int, ...] = ()):
        """Bernoulli draw (True with ``probability``)."""
        return self.uniform(0.0, 1.0, shape) < probability


class HostRandomContext(RandomContext):
    """numpy-backed context for host-side (per-sample) steps."""

    def __init__(self, seed_or_generator):
        if isinstance(seed_or_generator, np.random.Generator):
            self._rng = seed_or_generator
        else:
            self._rng = np.random.default_rng(seed_or_generator)

    def uniform(self, low=0.0, high=1.0, shape=()):
        return self._rng.uniform(low, high, shape).astype(np.float32)

    def normal(self, mean=0.0, stddev=1.0, shape=()):
        return self._rng.normal(mean, stddev, shape).astype(np.float32)

    def randint(self, low, high, shape=()):
        return self._rng.integers(low, high, shape, dtype=np.int32)


class DeviceRandomContext(RandomContext):
    """``torch.Generator``-backed context for device steps.

    The generator is seeded from ``key`` (a tuple of ints such as
    ``(seed, batch_idx)``, folded through numpy's ``SeedSequence``,
    :func:`accvlab_tpu_torch._draws.generator`); draws are made on the CPU in
    the order the steps request them and returned as tensors on ``device``.
    :attr:`schedule` records each draw's kind, shape and static bounds, in
    order (what :class:`ReplayRandomContext` replays).
    """

    def __init__(self, key, device="cpu"):
        self._gen = _draws.generator(key)
        self._device = torch.device(device)
        self.schedule: List[dict] = []

    def _out(self, x):
        if self._device.type == "cuda":
            # the caching host allocator keeps the pinned block until the copy is done
            return x.pin_memory().to(self._device, non_blocking=True)
        return x.to(self._device)

    def _draw(self, kind, a, b, shape):
        e = _draws.entry(kind, shape, a, b)
        self.schedule.append(e)
        return self._out(_draws.draw(self._gen, e))

    def uniform(self, low=0.0, high=1.0, shape=()):
        u = self._draw("uniform", low, high, shape)
        if isinstance(low, torch.Tensor) or isinstance(high, torch.Tensor):
            return u * (high - low) + low  # per-sample ranges, on the device
        return u

    def normal(self, mean=0.0, stddev=1.0, shape=()):
        return self._draw("normal", mean, stddev, shape)

    def randint(self, low, high, shape=()):
        return self._draw("randint", low, high, shape)


class ReplayRandomContext(RandomContext):
    """Hands out given draws in the order of a recorded schedule: the device
    stage as a function of ``(leaves, draws)``, which ``torch.export`` can
    trace (a ``torch.Generator`` cannot be traced).

    ``draws[i]`` is what :class:`DeviceRandomContext` copied to the device
    for ``schedule[i]`` (:func:`accvlab_tpu_torch._draws.make_draws` makes
    them from the key). A request whose kind, shape or bounds differ from
    the schedule's next entry raises, as does one past its end;
    :meth:`finish` raises when draws are left over.
    """

    def __init__(self, draws: Sequence[torch.Tensor], schedule: Sequence[dict]):
        if len(draws) != len(schedule):
            raise ValueError(f"{len(draws)} draws for a schedule of {len(schedule)}")
        self._draws = list(draws)
        self._schedule = list(schedule)
        self._i = 0

    def _next(self, kind, a, b, shape) -> torch.Tensor:
        if self._i >= len(self._schedule):
            raise RuntimeError(
                f"the device stage asked for draw {self._i + 1} ({kind} {tuple(shape)}), but "
                f"the recorded schedule has {len(self._schedule)}"
            )
        want = self._schedule[self._i]
        got = _draws.entry(kind, shape, a, b)
        if got != want:
            raise RuntimeError(f"draw {self._i}: the device stage asked for {got}, the "
                               f"recorded schedule has {want}")
        self._i += 1
        return self._draws[self._i - 1]

    def finish(self) -> None:
        """Raise unless every draw was handed out."""
        if self._i != len(self._schedule):
            raise RuntimeError(f"the device stage took {self._i} of the schedule's "
                               f"{len(self._schedule)} draws")

    def uniform(self, low=0.0, high=1.0, shape=()):
        u = self._next("uniform", low, high, shape)
        if isinstance(low, torch.Tensor) or isinstance(high, torch.Tensor):
            return u * (high - low) + low
        return u

    def normal(self, mean=0.0, stddev=1.0, shape=()):
        return self._next("normal", mean, stddev, shape)

    def randint(self, low, high, shape=()):
        return self._next("randint", low, high, shape)


class ScriptedRandomContext(RandomContext):
    """Deterministic scripted randomness for tests.

    Sequences are registered per ``(low, high)`` range (uniform/randint) or
    per ``(mean, stddev)`` (normal); each draw pops the next scripted value,
    broadcast to the requested shape. Unregistered ranges raise — a test
    exercising a new random draw must script it explicitly.
    """

    def __init__(self):
        self._uniform_seqs = {}
        self._normal_seqs = {}
        self._randint_seqs = {}

    def script_uniform(self, low, high, values: Sequence[float]):
        self._uniform_seqs.setdefault((float(low), float(high)), []).extend(values)

    def script_normal(self, mean, stddev, values: Sequence[float]):
        self._normal_seqs.setdefault((float(mean), float(stddev)), []).extend(values)

    def script_randint(self, low, high, values: Sequence[int]):
        self._randint_seqs.setdefault((int(low), int(high)), []).extend(values)

    @staticmethod
    def _pop(seqs, key, kind):
        if key not in seqs or not seqs[key]:
            raise AssertionError(f"No scripted {kind} values for range {key}")
        return seqs[key].pop(0)

    def uniform(self, low=0.0, high=1.0, shape=()):
        v = self._pop(self._uniform_seqs, (float(low), float(high)), "uniform")
        return np.full(shape, v, np.float32) if shape else np.float32(v)

    def normal(self, mean=0.0, stddev=1.0, shape=()):
        v = self._pop(self._normal_seqs, (float(mean), float(stddev)), "normal")
        return np.full(shape, v, np.float32) if shape else np.float32(v)

    def randint(self, low, high, shape=()):
        v = self._pop(self._randint_seqs, (int(low), int(high)), "randint")
        return np.full(shape, v, np.int32) if shape else np.int32(v)
