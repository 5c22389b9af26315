"""Models that drive the port end to end: PyTorch port of the CenterNet and
PETR parts of ``accvlab_tpu.models`` (detectors, ragged losses, train steps,
decodes), ``eval`` (batched matching and the streaming mAP evaluator) and
``train_utils``, plus ``params`` (flax parameters into the port's modules).
MoE, checkpoint, quantize, serving and the server are not ported yet.
"""

from .centernet import (
    CenterNetDetector,
    centernet_loss,
    decode_detections,
    focal_loss,
    make_example_batch,
    make_train_step,
)
from .eval import DetectionEvaluator, box_iou_matrix, match_detections, match_detections_3d
from .params import jax_params_of, load_jax_params
from .petr import (
    PETRDetector,
    compensate_ref_points,
    decode_detections_3d,
    make_motion_petr_train_step,
    make_petr_example_batch,
    make_petr_train_step,
    make_streaming_petr_train_step,
    petr_loss,
    propagate_queries,
    propagate_queries_with_motion,
)
from .train_utils import ema_init, ema_params, ema_update, make_grad_accum_step

__all__ = [
    "CenterNetDetector",
    "DetectionEvaluator",
    "PETRDetector",
    "box_iou_matrix",
    "centernet_loss",
    "compensate_ref_points",
    "decode_detections",
    "decode_detections_3d",
    "ema_init",
    "ema_params",
    "ema_update",
    "focal_loss",
    "jax_params_of",
    "load_jax_params",
    "make_example_batch",
    "make_grad_accum_step",
    "make_motion_petr_train_step",
    "make_petr_example_batch",
    "make_petr_train_step",
    "make_streaming_petr_train_step",
    "make_train_step",
    "match_detections",
    "match_detections_3d",
    "petr_loss",
    "propagate_queries",
    "propagate_queries_with_motion",
]
