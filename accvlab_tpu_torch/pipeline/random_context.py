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
* :class:`ScriptedRandomContext` — returns scripted sequences matched by
  value range; the test-injection pattern of the reference's
  ``DaliFakeRandomGenerator``.

All draws are shape-explicit. Device steps are batched, so they draw with a
leading batch dimension (``shape=(batch,)``) where the JAX steps draw one
scalar per sample under ``vmap``.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Sequence, Tuple

import numpy as np
import torch


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
    ``(seed, batch_idx)``, folded through numpy's ``SeedSequence``); draws
    are made on the CPU in the order the steps request them and returned as
    tensors on ``device``.
    """

    def __init__(self, key, device="cpu"):
        state = np.random.SeedSequence([int(k) for k in key]).generate_state(2, np.uint32)
        self._gen = torch.Generator(device="cpu")
        self._gen.manual_seed((int(state[0]) << 31) ^ int(state[1]))
        self._device = torch.device(device)

    def _out(self, x):
        if self._device.type == "cuda":
            # the caching host allocator keeps the pinned block until the copy is done
            return x.pin_memory().to(self._device, non_blocking=True)
        return x.to(self._device)

    def uniform(self, low=0.0, high=1.0, shape=()):
        u = torch.rand(tuple(shape), generator=self._gen, dtype=torch.float32)
        if isinstance(low, torch.Tensor) or isinstance(high, torch.Tensor):
            return self._out(u) * (high - low) + low  # per-sample ranges, on the device
        return self._out(u * (float(high) - float(low)) + float(low))

    def normal(self, mean=0.0, stddev=1.0, shape=()):
        n = torch.randn(tuple(shape), generator=self._gen, dtype=torch.float32)
        return self._out(n * float(stddev) + float(mean))

    def randint(self, low, high, shape=()):
        r = torch.randint(int(low), int(high), tuple(shape), generator=self._gen,
                          dtype=torch.int32)
        return self._out(r)


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
