"""``scripts/torch_soak_serving.py`` on the CPU: one seeded trial per mode of
the served function, and each mode's function against
``scripts/soak_serving.py``'s on the same batch.

The trials' seeds draw, in the JAX script's order: ``plain`` with poisoned
and cancelled requests from 3 clients, closed through the context manager
(42); ``jit`` from 4 clients with cancels and a 25 ms window (9); ``ragged``
through ``shared_jit`` from 4 clients, closed without draining (18).
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import torch_soak_serving as tsoak  # noqa: E402

SEEDS = {"plain": 42, "jit": 9, "ragged": 18}


def _jax_soak():
    spec = importlib.util.spec_from_file_location(
        "jax_soak_serving", os.path.join(REPO, "scripts", "soak_serving.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("mode", sorted(SEEDS))
def test_seeded_trial_passes(mode):
    from accvlab_tpu_torch.tools import program_cache_stats

    cfg, _, jit_it = tsoak.trial_config(SEEDS[mode])
    assert cfg["mode"] == mode
    assert cfg["clients"] > 1 and (mode != "plain" or cfg["poison_p"] > 0)
    assert mode == "plain" or jit_it
    before = program_cache_stats()
    assert tsoak.run_trial(SEEDS[mode], device="cpu")
    assert program_cache_stats()["declined"] == before["declined"]


@pytest.mark.parametrize("jit_it", [False, True])
@pytest.mark.parametrize("mode", sorted(SEEDS))
def test_served_function_equals_jax(mode, jit_it):
    jsoak = _jax_soak()
    x = np.random.default_rng(0).uniform(0, 10, (4, 3)).astype(np.float32)
    want = jsoak.make_fn(mode, jit_it)(x)
    got = tsoak.make_fn(mode, jit_it, torch.device("cpu"))(torch.from_numpy(x))
    if mode == "ragged":
        np.testing.assert_array_equal(got["rb"].tensor.numpy(), np.asarray(want["rb"].tensor))
        np.testing.assert_array_equal(got["rb"].sample_sizes.numpy(),
                                      np.asarray(want["rb"].sample_sizes))
        np.testing.assert_array_equal(got["sum"].numpy(), np.asarray(want["sum"]))
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if mode == "plain":
        x[1, 0] = tsoak.POISON
        with pytest.raises(ValueError, match="poisoned"):
            tsoak.make_fn(mode, jit_it, torch.device("cpu"))(torch.from_numpy(x))


def test_campaign_counts_trials_and_modes():
    res = tsoak.campaign(1.0, seed=9, device="cpu")
    assert res["trials"] >= 1 and res["failures"] == 0 and res["failed_seeds"] == []
    assert sum(res["modes"].values()) == res["trials"]
