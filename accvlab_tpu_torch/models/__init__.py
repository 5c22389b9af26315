"""Models that drive the port end to end: PyTorch port of
``accvlab_tpu.models`` — the CenterNet and PETR detectors, ragged losses,
train steps and decodes, ``eval`` (batched matching and the streaming mAP
evaluator), ``train_utils``, ``params`` (flax parameters into the port's
modules), and the serving side: ``checkpoint``, ``quantize``, ``serving``
(``torch.export`` artifacts, sharded over a mesh too) and ``server`` (the
micro-batching ``InferenceServer``), and ``moe`` (the expert-parallel MoE).

Submodules resolve lazily (PEP 562), as in the JAX package: a serving host
that imports ``models.serving`` or ``models.checkpoint`` imports neither the
detectors nor the pipeline.
"""

import importlib

_CENTERNET = ("CenterNetDetector", "centernet_loss", "decode_detections", "focal_loss",
              "make_example_batch", "make_train_step")
_PETR = (
    "PETRDetector",
    "compensate_ref_points",
    "decode_detections_3d",
    "make_motion_petr_train_step",
    "make_petr_example_batch",
    "make_petr_train_step",
    "make_streaming_petr_train_step",
    "petr_loss",
    "propagate_queries",
    "propagate_queries_with_motion",
)
_TRAIN_UTILS = ("ema_init", "ema_params", "ema_update", "make_grad_accum_step")
_EVAL = ("DetectionEvaluator", "box_iou_matrix", "match_detections", "match_detections_3d")
_PARAMS = ("jax_params_of", "load_jax_params")
_SERVER = ("InferenceServer", "ServerClosed")

_EXPORTS = {name: module for module, names in (
    ("centernet", _CENTERNET), ("petr", _PETR), ("train_utils", _TRAIN_UTILS),
    ("eval", _EVAL), ("params", _PARAMS), ("server", _SERVER)) for name in names}

_SUBMODULES = ("centernet", "checkpoint", "eval", "moe", "params", "petr", "quantize",
               "server", "serving", "train_utils")

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__), name)
    if name in _SUBMODULES:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(__all__ + list(_SUBMODULES))
