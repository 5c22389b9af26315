"""How far weight quantization moves CenterNet's heatmap, in both packages.

For int8 (per channel) and int4 (group 64, and one group), the quantized
model's heatmap against the float model's, on the same weights in both
packages (flax's initialisation, copied into the port with
``load_jax_params``) and the same seeded images: the largest absolute
difference over the float heatmap's largest magnitude, and the correlation.
``tests/test_quantize.py:71-85`` holds int8 to 0.12 and 0.99 at width 16 on
32x32 images. Runs on the CPU; both packages' quantized weights are the
same numbers (``tests/test_torch_quantize.py``).

    JAX_PLATFORMS=cpu python scripts/quantize_drift_torch_vs_jax.py [--width 64 --hw 256 704 --batch 2]

Prints one JSON line.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def drift(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return {"max_abs_over_max": float(np.abs(got - want).max() / np.abs(want).max()),
            "corrcoef": float(np.corrcoef(got.ravel(), want.ravel())[0, 1])}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--hw", type=int, nargs=2, default=(256, 704))
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--classes", type=int, default=10)
    args = ap.parse_args()

    import jax
    import torch
    from accvlab_tpu.models import quantize as JQ
    from accvlab_tpu.models.centernet import CenterNetDetector as JCenterNet
    from accvlab_tpu_torch.models import quantize as TQ
    from accvlab_tpu_torch.models.centernet import CenterNetDetector
    from accvlab_tpu_torch.models.params import load_jax_params

    x = np.random.default_rng(3).uniform(0, 1, (args.batch, *args.hw, 3)).astype(np.float32)
    jmodel = JCenterNet(num_classes=args.classes, width=args.width)
    params = jmodel.init(jax.random.PRNGKey(0), x[:1])
    model = load_jax_params(CenterNetDetector(args.classes, args.width),
                            jax.tree_util.tree_map(np.asarray, params)).eval()
    xt = torch.from_numpy(x)
    with torch.no_grad():
        j_float = jax.jit(jmodel.apply)(params, x)["heatmap"]
        t_float = model(xt)["heatmap"].numpy()
        out = {"config": {"width": args.width, "hw": list(args.hw), "batch": args.batch,
                          "classes": args.classes}}
        for name, kw in (("int8", {}), ("int4_group64", {"bits": 4, "group_size": 64}),
                         ("int4_one_group", {"bits": 4})):
            j_q = jax.jit(JQ.freeze_params_quantized(jmodel.apply,
                                                     JQ.quantize_params(params, **kw)))(x)
            t_q = TQ.freeze_params_quantized(model, TQ.quantize_params(model, **kw))(xt)
            out[name] = {"jax": drift(j_q["heatmap"], j_float),
                         "port": drift(t_q["heatmap"].numpy(), t_float)}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
