"""Seeds for the inputs of a run, which each family makes from ``--seed``
(``families/<family>.py``'s ``make_inputs``): independent streams, one
for each purpose, of the one seed."""

from __future__ import annotations

import numpy as np


def substream(seed: int, purpose: int) -> np.random.Generator:
    """An independent numpy stream of ``seed`` for one purpose."""
    return np.random.default_rng([int(seed), int(purpose)])


def seed63(seed: int, purpose: int) -> int:
    """A 63-bit seed for a ``torch.Generator`` from ``seed`` and a purpose."""
    state = np.random.SeedSequence([int(seed), int(purpose)]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])
