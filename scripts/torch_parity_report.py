"""The largest differences between the port's training path and YUV wire and
the JAX package's.

Run from the repository root, on the CPU:
    JAX_PLATFORMS=cpu python3 scripts/torch_parity_report.py

The tests (``tests/test_torch_models.py``, ``tests/test_torch_yuv.py``)
assert tolerances; this prints what the same comparisons measure, one JSON
line, on the tests' inputs: the heads of a width-8 CenterNet with the same
flax weights (relative to each head's largest magnitude), the three losses
and their input gradients on float32 head outputs (relative), one
``make_train_step`` step (loss relative, parameters absolute); and for the
YUV wire the colour conversion's largest uint8 difference and differing
share per matrix and range (against numpy and jitted XLA), the decoder's
(against the JAX package's PIL path), and the wire slice's normalized
images.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

import test_torch_models as tm  # noqa: E402
import test_torch_yuv as ty  # noqa: E402
from accvlab_tpu.models import centernet as J  # noqa: E402
from accvlab_tpu_torch.models import centernet as T  # noqa: E402
from accvlab_tpu_torch.models.params import jax_params_of, load_jax_params  # noqa: E402


def rel(got, want) -> float:
    return abs(float(got) - float(want)) / abs(float(want))


def main() -> int:
    torch.set_num_threads(1)
    model = J.CenterNetDetector(num_classes=tm.CLASSES, width=tm.WIDTH)
    params = jax.jit(model.init)(jax.random.PRNGKey(1), jnp.zeros((1, 32, 48, 3), jnp.float32))
    report = {"forward_heads_rel_to_max": {}, "losses_rel": {}, "input_grads_rel_to_max": {}}

    for hw in [(32, 48), (33, 47)]:
        images = np.random.default_rng(hw[1]).uniform(0, 1, (2, *hw, 3)).astype(np.float32)
        want = jax.jit(model.apply)(params, jnp.asarray(images))
        got = tm.port_model(params)(torch.from_numpy(images))
        report["forward_heads_rel_to_max"][f"{hw[0]}x{hw[1]}"] = max(
            tm.rel_to_max(got[k].detach(), want[k]) for k in want)

    heads = tm.head_outputs(7)
    for name, (fn_j, fn_t) in tm.loss_cases().items():
        loss_j, grads_j = jax.value_and_grad(fn_j)({k: jnp.asarray(v) for k, v in heads.items()})
        heads_t = {k: torch.from_numpy(v).requires_grad_(True) for k, v in heads.items()}
        loss_t = fn_t(heads_t)
        loss_t.backward()
        report["losses_rel"][name] = rel(loss_t.detach(), loss_j)
        report["input_grads_rel_to_max"][name] = max(
            tm.rel_to_max(torch.zeros_like(h) if h.grad is None else h.grad, grads_j[k])
            for k, h in heads_t.items() if float(jnp.abs(grads_j[k]).max()) > 0)

    jb = J.make_example_batch(hw=(32, 48))
    tb = T.make_example_batch(hw=(32, 48), device="cpu")
    _, step_j = J.make_train_step(model)
    params2, _, metrics_j = jax.jit(step_j)(params, optax.adam(tm.LR).init(params), jb)
    init_t, step_t = T.make_train_step(T.CenterNetDetector(tm.CLASSES, tm.WIDTH))
    tmodel, opt = init_t(0, tb["images"])
    load_jax_params(tmodel, tm.np_tree(params))
    _, _, metrics_t = step_t(tmodel, opt, tb)
    diffs = np.concatenate([
        np.abs(g - w).ravel() for g, w in zip(jax.tree_util.tree_leaves(jax_params_of(tmodel)),
                                              jax.tree_util.tree_leaves(tm.np_tree(params2)))])
    report["train_step"] = {"loss_rel": rel(metrics_t["loss"], metrics_j["loss"]),
                            "param_abs_max": float(diffs.max()),
                            "param_abs_median": float(np.median(diffs)), "lr": tm.LR}
    report["yuv_wire"] = yuv_wire_report()
    print(json.dumps(report), flush=True)
    return 0


def uint8_diff(got, want) -> dict:
    d = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    return {"max_abs": int(d.max(initial=0)), "differing_share": float(np.mean(d > 0))}


def yuv_wire_report() -> dict:
    from accvlab_tpu import color as jcolor
    from accvlab_tpu.pipeline import native_jpeg

    from accvlab_tpu_torch import color as tcolor

    out = {"color": {}, "decoder": {}}
    for m in ty.MATRICES:
        for r in ty.RANGES:
            rng = np.random.default_rng(ty.MATRICES.index(m) * 2 + ty.RANGES.index(r))
            y = rng.integers(0, 256, (3, 64, 96), np.uint8)
            cbcr = rng.integers(0, 256, (3, 32, 48, 2), np.uint8)
            got = tcolor.ycbcr420_to_rgb(torch.from_numpy(y), torch.from_numpy(cbcr), m, r)
            xla = jax.jit(lambda a, b: jcolor.ycbcr420_to_rgb(a, b, m, r))(y, cbcr)
            out["color"][f"{m}/{r}"] = {
                "vs_numpy": uint8_diff(got, jcolor.ycbcr420_to_rgb(y, cbcr, m, r)),
                "vs_xla": uint8_diff(got, np.asarray(xla))}
    native_jpeg.available = lambda: False  # the JAX package's PIL path, as without libjpeg
    for case, (make, kw) in ty.DECODE_CASES.items():
        for fmt in ("rgb", "yuv420"):
            got, want = ty.decode_both(make(), wire_format=fmt, **kw)
            out["decoder"][f"{case}/{fmt}"] = max(
                (uint8_diff(got[k], want[k]) for k in want), key=lambda d: d["max_abs"])
    j = ty._outputs(ty.jax_wire_pipeline(True), 2)
    t = ty._outputs(ty.torch_wire_pipeline(True), 2)
    d = np.concatenate([np.abs(a[k] - b[k]).ravel() for a, b in zip(t, j)
                        for k in a if k.endswith(".image")])
    out["slice_image"] = {"max_abs": float(d.max()), "differing_share": float(np.mean(d > 0))}
    return out


if __name__ == "__main__":
    sys.exit(main())
