"""``scripts/torch_soak_protocol.py`` on the CPU: its two scenarios at fixed
configs.

* ``run_resume_chain`` on three configs (the DCT wire with echo 2 and thread
  workers, the packed YUV wire with echo 3 and prefetch depth 1, RGB with
  echo 1 and process workers): every position of the chain bitwise the
  oracle's, with positions that the chain replayed through the shared
  program among those compared (some of them run eagerly by the oracle);
* ``run_elastic_chain`` against ``scripts/soak_protocol.py``'s on the same
  config and rng seed: the same fleets, epochs and ids at every lockstep
  step;
* the host decoder of the YUV and RGB chains against ``soak_protocol.py``'s
  on the soak's JPEGs: bitwise, both by libjpeg.
"""

import importlib.util
import os
import sys
import tempfile

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import torch_soak_protocol as tsoak  # noqa: E402  (process workers unpickle it by name)


def _jax_soak():
    spec = importlib.util.spec_from_file_location(
        "jax_soak_protocol", os.path.join(REPO, "scripts", "soak_protocol.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jpegs():
    return tsoak.make_jpegs(10, seed=123)


CONFIGS = {
    "dct_echo2_thread": {"wire": "dct", "echo": 2, "worker_mode": "thread", "depth": 2,
                         "batch_size": 2, "seed": 11},
    "yuv_packed_echo3_depth1": {"wire": "yuv_packed", "echo": 3, "worker_mode": "thread",
                                "depth": 1, "batch_size": 3, "seed": 12},
    "rgb_echo1_process": {"wire": "rgb", "echo": 1, "worker_mode": "process", "depth": 2,
                          "batch_size": 2, "seed": 13},
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_resume_chain_bitwise_with_program_replays(name, jpegs, tmp_path, monkeypatch):
    # a process pool's payload file goes to this test's own directory
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    res = tsoak.run_resume_chain(CONFIGS[name], jpegs, np.random.default_rng(5), device="cpu")
    modes = res["modes"]
    assert set(modes) <= {"eager/eager", "eager/program", "program/eager", "program/program"}
    assert 0 < sum(modes.values()) <= res["positions"]
    # the chain replayed positions, some of which the oracle ran eagerly
    assert modes.get("program/program", 0) > 0, modes
    assert modes.get("eager/program", 0) > 0, modes


def _recorder(module, log):
    """``module._build_fleet`` with every pipeline's deliveries logged as
    ``(fleet size, shard, ids)`` and every epoch end as ``("end", shard)``."""
    real = module._build_fleet

    class Recorded:
        def __init__(self, pipe, shard, size):
            self._pipe, self._shard, self._size = pipe, shard, size

        def run(self):
            try:
                out = self._pipe.run()
            except StopIteration:
                log.append(("end", self._shard))
                raise
            ids = out["idx"]
            ids = ids.numpy() if isinstance(ids, torch.Tensor) else np.asarray(ids)
            log.append((self._size, self._shard, ids.ravel().tolist()))
            return out

        def __getattr__(self, name):
            return getattr(self._pipe, name)

    def build(cfg, n, num_shards, input_kwargs, *device):
        fleet = real(cfg, n, num_shards, input_kwargs, *device)
        return [Recorded(p, s, num_shards) for s, p in enumerate(fleet)]

    return build


@pytest.mark.parametrize("seed", [3, 4])
def test_elastic_chain_steps_equal_jax(seed, monkeypatch):
    jsoak = _jax_soak()
    cfg = {"wire": "rgb", "echo": 2, "worker_mode": "thread", "depth": 2, "batch_size": 3,
           "seed": 7}
    want, got = [], []
    monkeypatch.setattr(jsoak, "_build_fleet", _recorder(jsoak, want))
    monkeypatch.setattr(tsoak, "_build_fleet", _recorder(tsoak, got))
    assert jsoak.run_elastic_chain(cfg, np.random.default_rng(seed)) == 2
    assert tsoak.run_elastic_chain(cfg, np.random.default_rng(seed), device="cpu") == 2
    assert got == want
    assert len({size for size, *_ in want if size != "end"}) > 1  # the fleet was resharded
    assert sum(1 for entry in want if entry[0] == "end") >= 2  # both epochs ended


@pytest.mark.parametrize("wire", ["yuv_packed", "rgb"])
def test_chain_decoder_equals_jax(wire, jpegs):
    """Each chain's first step, ``ImageDecoder`` with JAX's arguments, decodes
    the soak's JPEGs as ``soak_protocol.py``'s does: by libjpeg, bitwise
    (the YUV chain resizes 64x96 to 48x64)."""
    import accvlab_tpu.pipeline as jpipe
    import accvlab_tpu_torch.pipeline as tpipe

    jstep, tstep = _jax_soak().wire_steps(wire)[0], tsoak.wire_steps(wire)[0]
    for encoded in jpegs[:3]:
        outs = []
        for pkg, step in ((jpipe, jstep), (tpipe, tstep)):
            sdg = pkg.SampleDataGroup()
            sdg.add_data_field("image", pkg.DType.UINT8)
            sdg["image"] = encoded
            out = step(sdg)
            outs.append([np.asarray(v) for v in out.get_data()])
        want, got = outs
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    assert tstep.decoded_by == {"native": 3, "pil": 0}
