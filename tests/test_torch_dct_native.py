"""Differential fuzz of the port's native DCT band encoder
(``accvlab_tpu_torch/pipeline/dct_native.py`` over its copy of
``csrc/dctpack.cpp``) against its numpy backend and against the JAX
package's encoder, after tests/test_dct_native_fuzz.py.

Synthetic band arrays force every path of the engine: row widths with
``bwp % 16 == 8`` (the scalar tail after the vector loop), forced widths b in
{0, 1, 9, 12} (exception-only groups and the high-plane emit),
heavy-tailed values up to the reader's |coef| <= 2047, exception capacity
below, at and above the true count, every DC predictor, and appends at
``ne > 0``. Everything is compared byte for byte.
"""

import numpy as np
import pytest

from accvlab_tpu.pipeline.processing_steps.dct_wire import _CompsetEncoder as JEncoder
from accvlab_tpu_torch.pipeline import dct_native
from accvlab_tpu_torch.pipeline.processing_steps.dct_wire import _CompsetEncoder

_MODES = (0, 1, 2)


def _make_bands(rng, nb, bh, bwp):
    """Heavy-tailed synthetic bands within the |coef| <= 2047 contract."""
    small = rng.geometric(0.55, size=(nb, bh, bwp)).astype(np.int16) - 1
    sign = rng.choice([-1, 1], size=small.shape).astype(np.int16)
    bands = small * sign
    tail = rng.random(size=bands.shape) < 0.03
    bands[tail] = rng.integers(-2047, 2048, size=int(tail.sum()), dtype=np.int16)
    return np.ascontiguousarray(bands)


def _random_groups(rng, nb):
    """Contiguous partition with the mandatory (0, 1) DC group first."""
    cuts = sorted(set([1, nb]) | set(int(c) for c in rng.integers(1, nb,
                                                                  size=rng.integers(0, 5))))
    bounds = [0] + cuts
    return [(bounds[i], bounds[i + 1]) for i in range(len(bounds) - 1)]


def _numpy_encoder(bands, groups, monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(dct_native, "get_lib", lambda: None)
        return _CompsetEncoder(bands, groups)


def _pack(enc, g, dc_mode, b, cap, ne=0, into=None):
    p, v = into if into is not None else (np.full((cap,), -1, np.int32), np.zeros((cap,), np.int16))
    bp, ne = enc.pack_group_into(g, dc_mode, b, p, v, ne)
    return bp, ne, p, v


@pytest.mark.parametrize("case", range(12))
def test_native_matches_numpy_and_jax_on_synthetic_bands(case, monkeypatch):
    rng = np.random.default_rng(1000 + case)
    nb = int(rng.integers(2, 20))
    bh = int(rng.integers(1, 15))
    bwp = int(rng.choice([8, 24, 40, 56] if case % 2 else [16, 32, 64, 128]))
    bands = _make_bands(rng, nb, bh, bwp)
    groups = _random_groups(rng, nb)

    enc_nat = _CompsetEncoder(bands, groups)
    enc_np = _numpy_encoder(bands, groups, monkeypatch)
    enc_jax = JEncoder(bands, groups)
    assert enc_nat._native and not enc_np._native and enc_jax._native

    for mode in _MODES:
        for other in (enc_np, enc_jax):
            np.testing.assert_array_equal(enc_nat.fits(0, mode), other.fits(0, mode),
                                          err_msg=f"DC mode {mode}")
    for g in range(1, len(groups)):
        for other in (enc_np, enc_jax):
            np.testing.assert_array_equal(enc_nat.fits(g, 0), other.fits(g, 0),
                                          err_msg=f"group {g}")

    dc_mode = case % 3
    for g in range(len(groups)):
        for b in (0, 1, 9, 12):
            true_exc = enc_nat.exceptions_at(g, dc_mode, b)
            cap = true_exc + 5
            ctx = f"case {case} g={g} b={b} dc_mode={dc_mode} bwp={bwp}"
            bp1, ne1, p1, v1 = _pack(enc_nat, g, dc_mode, b, cap)
            for other in (enc_np, enc_jax):
                bp2, ne2, p2, v2 = _pack(other, g, dc_mode, b, cap)
                assert ne1 == ne2 == true_exc, ctx
                np.testing.assert_array_equal(bp1, bp2, err_msg=ctx)
                np.testing.assert_array_equal(p1, p2, err_msg=ctx)
                np.testing.assert_array_equal(v1, v2, err_msg=ctx)


def test_capacity_clip_returns_true_count(monkeypatch):
    """Entries beyond ``cap`` are dropped but the TRUE count is returned,
    and the written prefix (ascending positions) matches the numpy path."""
    rng = np.random.default_rng(7)
    bands = _make_bands(rng, 6, 9, 24)
    groups = [(0, 1), (1, 6)]
    enc_nat = _CompsetEncoder(bands, groups)
    enc_np = _numpy_encoder(bands, groups, monkeypatch)
    b = 1  # narrow width: plenty of exceptions
    true_exc = enc_nat.exceptions_at(1, 0, b)
    assert true_exc > 8, "the fixture must produce exceptions"
    for cap in (0, 1, true_exc // 2, true_exc, true_exc + 3):
        bp1, ne1, p1, v1 = _pack(enc_nat, 1, 0, b, cap)
        bp2, ne2, p2, v2 = _pack(enc_np, 1, 0, b, cap)
        assert ne1 == ne2 == true_exc, f"cap={cap}"
        np.testing.assert_array_equal(bp1, bp2, err_msg=f"cap={cap}")
        np.testing.assert_array_equal(p1, p2, err_msg=f"cap={cap}")
        np.testing.assert_array_equal(v1, v2, err_msg=f"cap={cap}")
        wrote = min(cap, true_exc)
        if wrote:
            assert (np.diff(p1[:wrote]) > 0).all(), f"cap={cap}"


def test_nonzero_start_offset_appends(monkeypatch):
    """Appending at ne > 0 (the unified exception list of a compset)."""
    rng = np.random.default_rng(11)
    bands = _make_bands(rng, 4, 5, 40)
    groups = [(0, 1), (1, 4)]
    enc_nat = _CompsetEncoder(bands, groups)
    enc_np = _numpy_encoder(bands, groups, monkeypatch)
    cap = 4096
    lists = [(np.full((cap,), -1, np.int32), np.zeros((cap,), np.int16)) for _ in range(2)]
    ne1 = ne2 = 0
    for g, b in ((0, 2), (1, 1)):
        bp1, ne1, _, _ = _pack(enc_nat, g, 2, b, cap, ne1, lists[0])
        bp2, ne2, _, _ = _pack(enc_np, g, 2, b, cap, ne2, lists[1])
        np.testing.assert_array_equal(bp1, bp2, err_msg=f"g={g}")
    assert ne1 == ne2 <= cap
    np.testing.assert_array_equal(lists[0][0], lists[1][0])
    np.testing.assert_array_equal(lists[0][1], lists[1][1])


def test_native_engine_checks_its_inputs():
    bands = np.zeros((4, 2, 16), np.int16)
    with pytest.raises(TypeError):
        dct_native.analyze(bands.astype(np.int32), [0, 1, 4])
    with pytest.raises(ValueError, match="divisible by 8"):
        dct_native.analyze(np.zeros((4, 2, 12), np.int16), [0, 1, 4])
    with pytest.raises(ValueError, match="C-contiguous"):
        dct_native.analyze(np.zeros((4, 2, 32), np.int16)[:, :, ::2], [0, 1, 4])
    with pytest.raises(ValueError, match="DC band"):
        dct_native.analyze(bands, [0, 2, 4])
    with pytest.raises(ValueError, match="bitplanes"):
        dct_native.pack_group(bands, 1, 4, 0, 2, np.zeros((1, 6, 2), np.uint8),
                              np.zeros(4, np.int32), np.zeros(4, np.int16), 0)
