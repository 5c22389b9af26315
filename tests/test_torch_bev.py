"""``BEVBBoxesTransformer3D`` on the port against the JAX step, on the CPU.

Samples come from ``chip_smoke.bev_provider`` at a small size (boxes with
centres, velocities, sizes and yaw; each camera's projection @ extrinsics;
ego_to_world and its inverse). The JAX step runs per sample, the port's on
the batch, both under a ``ScriptedRandomContext`` that records every draw:

* each table alone (rotation, scaling, translation) and all three together:
  the draws equal in order and range, every scripted value consumed, and
  every output within 1e-5 of the JAX step's, relative to the leaf's
  largest magnitude (float32 products, and LU inverses in LAPACK against
  XLA); a range with ``lo == hi`` draws nothing in either;
* all three tables with a different value for each sample in every draw
  (the port's ``(B,)`` draw returns them in sample order, each JAX sample
  is scripted with its own): every field, yaw included, within 1e-5, so no
  sample takes another's angle, scale or translation;
* with real draws (the port's ``DeviceRandomContext``), the JAX test's
  invariants: ``world_to_ego @ ego_to_world`` within 1e-4 of the identity,
  and every camera's projection of the moved centres that of the original
  ones within rtol 1e-3, atol 1e-3;
* a missing field raises ``KeyError``; the exported stage replays the
  eager stage's draws bit for bit; ``apply_matrix``'s inverse
  (``linalg.inv_ex``, which does not read its info back on the card) gives
  ``linalg.inv``'s bits.
"""

import numpy as np
import pytest
import torch

import accvlab_tpu.pipeline as jpipe
import accvlab_tpu_torch.pipeline as tpipe
from accvlab_tpu.pipeline.processing_steps import BEVBBoxesTransformer3D as JStep
from accvlab_tpu_torch.pipeline.operators import apply_matrix
from accvlab_tpu_torch.pipeline.processing_steps import BEVBBoxesTransformer3D as TStep
from chip_smoke import bev_definition, bev_invariants, bev_provider

REL = 1e-5
B, BOXES, CAMS = 3, 5, 2


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _step(cls, rotation=None, scaling=None, translation=None):
    return cls(data_field_names_points="centers3d", data_field_names_velocities="velocities",
               data_field_names_sizes="sizes3d", data_field_names_orientation="yaw",
               data_field_names_proj_matrices_and_extrinsics="cam_proj",
               data_field_names_ego_to_world="ego_to_world",
               data_field_names_world_to_ego="world_to_ego",
               rotation_range=rotation, rotation_axis=2 if rotation else None,
               scaling_range=scaling, translation_max_abs=translation)


def _recording(pkg, script):
    class Recording(pkg.ScriptedRandomContext):
        def __init__(self):
            super().__init__()
            self.log = []

        def uniform(self, low=0.0, high=1.0, shape=()):
            self.log.append((float(low), float(high)))
            return super().uniform(low, high, shape)

    ctx = Recording()
    for lo, hi, values in script:
        ctx.script_uniform(lo, hi, list(values))
    return ctx


def _samples():
    provider = bev_provider(B, boxes=BOXES, cams=CAMS)
    return provider, [provider.get_data(i).get_data() for i in range(B)]


def _jax_sample(leaves):
    ann = jpipe.SampleDataGroup()
    for name in ("centers3d", "velocities", "sizes3d", "yaw"):
        ann.add_data_field(name, jpipe.DType.FLOAT)
    sdg = jpipe.SampleDataGroup()
    sdg.add_data_group_field("annotations", ann)
    for name in ("cam_proj", "ego_to_world", "world_to_ego"):
        sdg.add_data_field(name, jpipe.DType.FLOAT)
    sdg.set_data(list(leaves))
    return sdg


def _port_batch(provider, samples):
    sdg = provider.sample_data_structure
    sdg.set_data([torch.from_numpy(np.stack(f)) for f in zip(*samples)])
    return sdg


CASES = {
    "rotation": (dict(rotation=(-0.5, 0.5)), [(-0.5, 0.5, [0.3])]),
    "rotation_constant": (dict(rotation=(0.2, 0.2)), []),
    "scaling": (dict(scaling=(0.9, 1.1)), [(0.9, 1.1, [1.05])]),
    "scaling_constant": (dict(scaling=(1.2, 1.2)), []),
    "translation": (dict(translation=(1.0, 2.0, 0.0)), [(-1.0, 1.0, [0.4]),
                                                        (-2.0, 2.0, [-1.5])]),
    "all_three": (dict(rotation=(-0.3925, 0.3925), scaling=(0.95, 1.05),
                       translation=(0.5, 0.5, 0.0)),
                  [(-0.3925, 0.3925, [0.1]), (0.95, 1.05, [0.97]), (-0.5, 0.5, [0.25, -0.4])]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_tables_equal_the_jax_step_under_scripted_draws(name):
    kwargs, script = CASES[name]
    provider, samples = _samples()
    j_out, j_logs = [], []
    for leaves in samples:
        step = _step(JStep, **kwargs)
        ctx = _recording(jpipe, script)
        step.set_random_context(ctx)
        j_out.append([np.asarray(v) for v in step(_jax_sample(leaves)).get_data()])
        j_logs.append(ctx.log)
        assert not any(ctx._uniform_seqs.values()), "JAX left scripted values"
    step = _step(TStep, **kwargs)
    ctx = _recording(tpipe, script)
    step.set_random_context(ctx)
    t_out = [v.numpy() for v in step(_port_batch(provider, samples)).get_data()]
    assert not any(ctx._uniform_seqs.values()), "the port left scripted values"
    assert ctx.log == j_logs[0] == [(lo, hi) for lo, hi, vs in script for _ in vs]
    for s in range(B):
        for got, want in zip(t_out, j_out[s]):
            assert got[s].shape == want.shape and got.dtype == want.dtype
            scale = max(float(np.abs(want).max()), 1e-30)
            assert float(np.abs(got[s].astype(np.float64) - want).max()) <= REL * scale


class _PerSampleContext(tpipe.ScriptedRandomContext):
    """Each ``uniform(lo, hi, (B,))`` pops the next scripted row of B values
    for its range: sample ``s`` gets ``row[s]``."""

    def __init__(self, script):
        super().__init__()
        self.log = []
        for lo, hi, rows in script:
            self.script_uniform(lo, hi, [np.asarray(r, np.float32) for r in rows])

    def uniform(self, low=0.0, high=1.0, shape=()):
        self.log.append((float(low), float(high)))
        row = self._pop(self._uniform_seqs, (float(low), float(high)), "uniform")
        assert tuple(shape) == row.shape
        return row.copy()


# every row holds one value per sample (B = 3), all different; translation's
# z range (0, 0) draws nothing
PER_SAMPLE_SCRIPT = [(-0.3925, 0.3925, [[0.35, -0.2, 0.05]]),
                     (0.95, 1.05, [[0.96, 1.04, 1.01]]),
                     (-0.5, 0.5, [[0.45, -0.3, 0.1], [-0.25, 0.4, -0.05]])]


def test_all_three_tables_with_a_different_draw_per_sample():
    kwargs = dict(rotation=(-0.3925, 0.3925), scaling=(0.95, 1.05),
                  translation=(0.5, 0.5, 0.0))
    provider, samples = _samples()
    j_out = []
    for s, leaves in enumerate(samples):
        step = _step(JStep, **kwargs)
        ctx = _recording(jpipe, [(lo, hi, [row[s] for row in rows])
                                 for lo, hi, rows in PER_SAMPLE_SCRIPT])
        step.set_random_context(ctx)
        j_out.append([np.asarray(v) for v in step(_jax_sample(leaves)).get_data()])
        assert not any(ctx._uniform_seqs.values()), "JAX left scripted values"
    step = _step(TStep, **kwargs)
    ctx = _PerSampleContext(PER_SAMPLE_SCRIPT)
    step.set_random_context(ctx)
    t_out = [v.numpy() for v in step(_port_batch(provider, samples)).get_data()]
    assert not any(ctx._uniform_seqs.values()), "the port left scripted values"
    assert ctx.log == [(lo, hi) for lo, hi, rows in PER_SAMPLE_SCRIPT for _ in rows]
    names = list(provider.sample_data_structure.field_names_flat)
    assert len(t_out) == len(names) == 7
    for s in range(B):
        for name, got, want in zip(names, t_out, j_out[s]):
            assert got[s].shape == want.shape and got.dtype == want.dtype, name
            scale = max(float(np.abs(want).max()), 1e-30)
            err = float(np.abs(got[s].astype(np.float64) - want).max())
            assert err <= REL * scale, (name, s, err)
    # each sample's yaw turned by its own angle
    yaw = names.index("annotations.yaw")
    turned = np.angle(np.exp(1j * (t_out[yaw].astype(np.float64) -
                                   np.stack([f[yaw] for f in samples]))))
    np.testing.assert_allclose(turned, np.broadcast_to(
        np.asarray(PER_SAMPLE_SCRIPT[0][2][0])[:, None], turned.shape), atol=1e-5)


@pytest.mark.parametrize("seed", range(3))
def test_invariants_with_real_draws(seed):
    provider, samples = _samples()
    before = [torch.from_numpy(np.stack(f)) for f in zip(*samples)]
    step = _step(TStep, rotation=(-1.0, 1.0), scaling=(0.8, 1.2), translation=(2.0, 2.0, 0.5))
    step.set_random_context(tpipe.DeviceRandomContext((seed, 0), device="cpu"))
    out = step(_port_batch(provider, samples))
    names = list(provider.sample_data_structure.field_names_flat)
    after = out.get_data()
    assert not torch.equal(after[0], before[0]), "the centres did not move"
    inv = bev_invariants(names, before, after)
    assert inv["w2e_e2w_identity_max_abs"] <= 1e-4
    assert inv["projection_rel"] <= 1.0


def test_missing_field_raises_key_error():
    step = _step(TStep, rotation=(0.0, 0.1))
    sdg = tpipe.SampleDataGroup()
    sdg.add_data_field("unrelated", tpipe.DType.FLOAT)
    with pytest.raises(KeyError, match="No occurrences of points field 'centers3d'"):
        step.check_input_data_format_and_set_output_data_format(sdg)


def test_exported_stage_replays_the_draws(tmp_path):
    from accvlab_tpu_torch.models.serving import load_inference

    definition = bev_definition(bev_provider(64, boxes=BOXES, cams=CAMS), batch=4)
    pipe = definition.get_pipeline(batch_size=4, num_threads=1, device="cpu", seed=3)
    try:
        pipe.run()
        pipe._halt_producer()
        idx, _, _, host = pipe._produce_host_batch()
        leaves = [torch.from_numpy(a) for a in host]
        want = pipe.run_device_stage(leaves, idx)
        path = str(tmp_path / "bev.accvserve")
        header = pipe.export_device_program(path)
        # angle, scale, x, y: the z range (0, 0) draws nothing
        assert [e["kind"] for e in header["draw_schedule"]] == ["uniform"] * 4
        got = load_inference(path, device="cpu")(leaves, (3, idx))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
    finally:
        pipe.stop()


def test_apply_matrix_inverse_equals_linalg_inv():
    rng = np.random.default_rng(0)
    mats = torch.from_numpy((rng.normal(size=(6, 4, 4)) + 4 * np.eye(4)).astype(np.float32))
    pts = torch.from_numpy(rng.normal(size=(6, 4, 7)).astype(np.float32))
    assert torch.equal(torch.linalg.inv_ex(mats)[0], torch.linalg.inv(mats))
    got = apply_matrix(pts, mats, matrix_is_inverted=True)
    assert torch.equal(got, torch.linalg.inv(mats) @ pts)
    # a singular matrix gives non-finite values, as jnp.linalg.inv does, and no error
    out = apply_matrix(pts[:1], torch.zeros((1, 4, 4)), matrix_is_inverted=True)
    assert not bool(torch.isfinite(out).all())
