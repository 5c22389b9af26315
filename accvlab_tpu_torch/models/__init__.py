"""Models that drive the port end to end: PyTorch port of the CenterNet part
of ``accvlab_tpu.models`` (the detector, its ragged loss and train step) and
of ``train_utils``, plus ``params`` (flax parameters into the port's
modules). PETR, MoE, checkpoint, eval, quantize, serving and the server are
not ported yet.
"""

from .centernet import (
    CenterNetDetector,
    centernet_loss,
    decode_detections,
    focal_loss,
    make_example_batch,
    make_train_step,
)
from .params import jax_params_of, load_jax_params
from .train_utils import ema_init, ema_params, ema_update, make_grad_accum_step

__all__ = [
    "CenterNetDetector",
    "centernet_loss",
    "decode_detections",
    "ema_init",
    "ema_params",
    "ema_update",
    "focal_loss",
    "jax_params_of",
    "load_jax_params",
    "make_example_batch",
    "make_grad_accum_step",
    "make_train_step",
]
