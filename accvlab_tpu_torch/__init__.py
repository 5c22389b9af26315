"""PyTorch/CUDA port of ``accvlab_tpu`` for NVIDIA Hopper (H100).

The package mirrors ``accvlab_tpu`` subpackage for subpackage, module for
module (same relative paths), and is held against it by the parity tests in
``tests/test_torch_*.py``. It imports ``torch`` and never ``jax``, and it
imports nothing from ``accvlab_tpu``: what it needs from there it keeps as
its own copy.

Ported so far (the headline multi-camera pipeline of ``bench.py``):

* :mod:`.heatmap` — ``draw_heatmap``, ``draw_heatmap_batched`` and
  ``draw_gaussians`` on one hand-written CUDA rasterizer
  (``heatmap/csrc/draw_heatmap.cu``), each with a plain PyTorch version;
* :mod:`.ragged` — the minimal ``RaggedBatch`` the batched heatmap API takes;
* :mod:`.hostcopy` — packed pinned host-to-device copies;
* :mod:`.pipeline` — ``PipelineDefinition`` and the single-device executor,
  the shuffled sharded input callable, and the device steps of the headline
  pipeline.

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (or hands in CPU tensors); without a card they raise.
"""

__version__ = "0.1.0"

__all__ = ["heatmap", "hostcopy", "pipeline", "ragged"]
