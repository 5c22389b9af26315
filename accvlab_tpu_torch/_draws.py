"""The device stage's random draws, made on the host from a key.

:class:`~.pipeline.random_context.DeviceRandomContext` draws on a CPU
``torch.Generator`` seeded from a key such as ``(seed, batch_idx)``, folded
through numpy's ``SeedSequence``. Which draws a batch makes (kind, shape and
static bounds, in order) does not depend on the data, so a recorded
*schedule* of them is enough to make the same numbers again from the key.
The pipeline's serving export records the schedule in the artifact's header;
the loader (:mod:`.models.serving`) makes the draws with this module alone,
without pipeline code.

A schedule entry is a JSON-able dict ``{"kind", "shape", "a", "b"}``:
``kind`` is ``"uniform"``, ``"normal"`` or ``"randint"``; ``a``/``b`` are
``low``/``high`` (``mean``/``stddev`` for ``"normal"``), or ``None`` where
a uniform draw has per-sample tensor bounds (the draw is then the unit draw,
scaled on the device).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

KINDS = ("uniform", "normal", "randint")


def generator(key) -> torch.Generator:
    """The CPU generator of a batch key (a sequence of ints)."""
    state = np.random.SeedSequence([int(k) for k in key]).generate_state(2, np.uint32)
    gen = torch.Generator(device="cpu")
    gen.manual_seed((int(state[0]) << 31) ^ int(state[1]))
    return gen


def entry(kind: str, shape, a, b) -> dict:
    """A schedule entry; tensor bounds are recorded as ``None``."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    if kind == "randint":
        a, b = int(a), int(b)
    elif kind == "uniform" and (isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor)):
        a = b = None
    else:
        a, b = float(a), float(b)
    return {"kind": kind, "shape": [int(s) for s in shape], "a": a, "b": b}


def draw(gen: torch.Generator, e: dict) -> torch.Tensor:
    """One draw on the CPU, as the device context makes it before the copy
    to the device: scaled by static bounds, the unit draw for tensor bounds."""
    shape, kind, a, b = tuple(e["shape"]), e["kind"], e["a"], e["b"]
    if kind == "uniform":
        u = torch.rand(shape, generator=gen, dtype=torch.float32)
        return u if a is None else u * (b - a) + a
    if kind == "normal":
        n = torch.randn(shape, generator=gen, dtype=torch.float32)
        return n * b + a
    return torch.randint(a, b, shape, generator=gen, dtype=torch.int32)


def make_draws(schedule: Sequence[dict], key) -> List[torch.Tensor]:
    """Every draw of ``schedule`` from ``key``, in order, on the CPU."""
    gen = generator(key)
    return [draw(gen, e) for e in schedule]
