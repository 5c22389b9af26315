"""The training path end to end: bench.py's pipeline -> CenterNet train step.

The port's counterpart of ``examples/train_centernet_e2e.py``: the pipeline
of :mod:`.bench_pipeline`, which also hands out each box's (h, w) on the
heatmap grid as ``hw``, feeds :func:`~.models.centernet.make_train_step`
through :func:`batch_to_train_inputs`. Driven on the card by
``chip_smoke.py`` (phases ``train`` and ``input_idle``).
"""

from __future__ import annotations

from typing import Dict, Sequence, Union

import torch

from .bench_pipeline import build_pipeline
from .ragged import RaggedBatch
from .ragged.bool_indexing import stable_active_first
from .tools.trace_range import _profiled


def build_train_pipeline(**kwargs):
    """bench.py's pipeline on raw frames (the other arguments of
    :func:`~.bench_pipeline.build_pipeline`) whose heatmap converter also
    outputs each box's (h, w) as ``annotations.hw``."""
    return build_pipeline(hw_out_name="hw", wire="frames", **kwargs)


def batch_to_train_inputs(batch: Dict[str, torch.Tensor],
                          cam: Union[int, Sequence[int]] = 0) -> dict:
    """Adapt the pipeline's flat outputs to the model's batch contract.

    ``cam`` is one camera or several, whose samples are then concatenated
    camera-major along the batch axis. The active objects are moved to the
    front of each sample (a stable sort, so each group keeps its order) to
    form the RaggedBatch prefix, and ``hw`` becomes (w, h), the size head's
    convention. Nothing is read back to the host. While a profiler records,
    the adaptation is its ``accvlab.batch_to_train_inputs`` range.
    """
    with _profiled("accvlab.batch_to_train_inputs"):
        cams = [cam] if isinstance(cam, int) else list(cam)

        def field(name: str) -> torch.Tensor:
            vals = [batch[f"cameras.[{c}].{name}"] for c in cams]
            return vals[0] if len(vals) == 1 else torch.cat(vals, 0)

        images = field("image")
        heatmap = field("annotations.heatmap").permute(0, 2, 3, 1)  # (B, C, H, W) -> (B, H, W, C)
        act = field("annotations.active").to(torch.bool)
        sizes = act.sum(dim=1, dtype=torch.int32)
        order = stable_active_first(act)

        def mk(a: torch.Tensor) -> RaggedBatch:
            idx = order[..., None].expand(*order.shape, a.shape[2]) if a.ndim == 3 else order
            return RaggedBatch(torch.gather(a, 1, idx), sample_sizes=sizes)

        return {
            "images": images,
            "targets": {
                "heatmap": heatmap,
                "centers": mk(field("annotations.center").to(torch.int32)),
                "offsets": mk(field("annotations.offset")),
                "sizes": mk(field("annotations.hw").flip(-1)),
                "classes": mk(field("annotations.categories").to(torch.int32)),
            },
        }
