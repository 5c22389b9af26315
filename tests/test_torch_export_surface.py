"""The port's public surface against the JAX package's, module by module.

For every public module of ``accvlab_tpu`` (one case each) the port's module
at the same relative path must export the JAX module's public names
(``__all__``, or else the public functions and classes defined there), and
each public function, each class ``__init__`` and each public method must
take the JAX parameters first, by name and in order, keyword-only ones
included. The port may add its own parameters (``device=``,
``implementation=``, ``decoder=``) after JAX's.

Every known difference stands in an allow-list below with its reason; a new
one fails here until it is repaired or written down (ROADMAP.md §3).
"""

import importlib
import inspect
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROOT = os.path.join(REPO, "accvlab_tpu")

FLAX = "flax module fields against torch.nn.Module"

# modules of the JAX package with no counterpart yet (ROADMAP.md §1)
NOT_PORTED = {
    "tools.program_cache": "program_cache waits for a CUDA graph of the device stage "
                           "(ROADMAP.md §1 item 3)",
    **{f"video{s}": "video needs FFmpeg, which the card machine lacks (ROADMAP.md §1 item 6)"
       for s in ("", ".decoder", ".encode", ".gop_storage", ".gop_store", ".native",
                 ".readers", ".types", ".utils")},
}

# public names of a JAX module that the port's module lacks
JAX_ONLY = {
    ("pipeline", "TPUPipeline"): "the port's executor is TorchPipeline",
    ("pipeline.pipeline", "TPUPipeline"): "the port's executor is TorchPipeline",
    ("tools", "shared_jit"): "program_cache is not ported yet",
    ("tools", "program_cache_stats"): "program_cache is not ported yet",
    ("tools", "clear_program_cache"): "program_cache is not ported yet",
}

# names in the port's __all__ that the JAX module's __all__ lacks
PORT_ONLY = {
    ("heatmap", "LAUNCHES"): "kernel launch counts, read by chip_smoke.py",
    ("heatmap", "reset_launch_counts"): "kernel launch counts, read by chip_smoke.py",
    ("models", "focal_loss"): "exported for the port's own trainers",
    ("models", "jax_params_of"): "moves flax parameters into the port's modules",
    ("models", "load_jax_params"): "moves flax parameters into the port's modules",
    ("models", "make_example_batch"): "exported for the port's own trainers",
    ("models", "make_petr_example_batch"): "exported for the port's own trainers",
    ("pipeline", "ReplayRandomContext"): "replays an exported device stage's draws",
    ("pipeline", "TorchPipeline"): "the port's executor (JAX: TPUPipeline)",
    ("pipeline", "torch_dtype_for"): "DType to torch dtype",
    ("pipeline.inputs", "MultiCameraJpegProvider"): "bench.py's dataset, port-only module",
    ("pipeline.inputs", "MultiCameraSyntheticProvider"): "bench.py's dataset, port-only module",
    ("pipeline.operators", "check_bbox_visibiity"): "JAX defines the alias but does not "
                                                    "export it",
    ("pipeline.operators", "invert_2x3"): "batched device steps (JAX: private _invert_2x3)",
    ("pipeline.operators", "pad_to_common_size"): "JAX defines it in point_ops but does not "
                                                  "export it",
    ("pipeline.operators", "transform_points"): "batched device steps",
    ("pipeline.operators", "warp_affine"): "batched device steps",
}

# (module, name) whose parameters differ from JAX's on purpose
SIGNATURES = {
    ("hostcopy.native", "parallel_pack"): "the port packs into a caller-owned (pinned) "
                                          "tensor; JAX returns a new numpy buffer",
    ("models", "CenterNetDetector"): FLAX,
    ("models", "PETRDetector"): FLAX,
    ("models", "make_grad_accum_step"): "the torch step takes the optimizer object",
    ("models.centernet", "CenterNetDetector"): FLAX,
    ("models.centernet", "ConvBlock"): FLAX + " (a torch conv needs its input channels)",
    ("models.petr", "CameraBackbone"): FLAX,
    ("models.petr", "DecoderLayer"): FLAX,
    ("models.petr", "PETRDetector"): FLAX,
    ("models.train_utils", "make_grad_accum_step"): "the torch step takes the optimizer "
                                                    "object",
    ("models.checkpoint", "restore_checkpoint"): "a template of tensors (DTensors for a "
                                                 "sharded restore) for orbax's abstract state",
    ("models.quantize", "freeze_params_quantized"): "apply_fn and variables become a module",
    ("models.quantize", "QuantizedTensor"): "a torch pytree node, not a JAX one "
                                            "(tree_flatten)",
    ("models.serving", "freeze_params"): "apply_fn and variables become a module",
    ("models.serving", "save_inference"): "apply_fn and variables become a module",
    ("models.moe", "MoEClassifier"): FLAX,
    ("models.moe", "SwitchFFN"): FLAX,
    ("pipeline.operators.image_ops", "warp_affine"): "batched device steps: images "
                                                     "(B, H, W, C)",
    ("ragged", "SIZE_DTYPE"): "a torch dtype, not a numpy scalar type",
    ("ragged.ragged_batch", "SIZE_DTYPE"): "a torch dtype, not a numpy scalar type",
}

RENAMED = {"TPUPipeline": "TorchPipeline"}


def _jax_modules():
    out = []
    for root, dirs, files in os.walk(JAX_ROOT):
        dirs[:] = sorted(d for d in dirs if d not in ("csrc", "__pycache__"))
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            parts = os.path.relpath(os.path.join(root, f), JAX_ROOT)[:-3].split(os.sep)
            if parts[-1] == "__init__":
                parts = parts[:-1]
            if not any(p.startswith("_") for p in parts):
                out.append(".".join(parts))
    return sorted(out)


def _import(pkg: str, rel: str):
    return importlib.import_module(pkg + ("." + rel if rel else ""))


def _public(mod):
    if hasattr(mod, "__all__"):
        return list(mod.__all__)
    return sorted(n for n, o in vars(mod).items()
                  if not n.startswith("_") and (inspect.isfunction(o) or inspect.isclass(o))
                  and getattr(o, "__module__", None) == mod.__name__)


def _params(fn):
    """(positional names in order, keyword-only names) of ``fn``."""
    params = inspect.signature(fn).parameters.values()
    positional = [("*" if p.kind == p.VAR_POSITIONAL else "") + p.name for p in params
                  if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD, p.VAR_POSITIONAL)]
    return positional, [p.name for p in params if p.kind == p.KEYWORD_ONLY]


def _signature_faults(what: str, j, t) -> list:
    try:
        jp, jk = _params(j)
        tp, tk = _params(t)
    except (TypeError, ValueError):  # builtins without a signature
        return []
    if tp[:len(jp)] != jp or not set(jk) <= set(tk) | set(tp):
        return [f"{what}: JAX takes {jp} + keywords {jk}, the port {tp} + keywords {tk}"]
    return []


def _class_faults(what: str, j, t) -> list:
    if not inspect.isclass(t):
        return [f"{what} is a class in JAX, not in the port"]
    faults = _signature_faults(f"{what}.__init__", j.__init__, t.__init__)
    for name, member in vars(j).items():
        if name.startswith("_") or not inspect.isfunction(member):
            continue
        if not hasattr(t, name):
            faults.append(f"{what}.{name} is missing in the port")
        else:
            faults += _signature_faults(f"{what}.{name}", member, getattr(t, name))
    return faults


def surface_faults(rel: str) -> list:
    """Every difference between the two modules at ``rel`` that no
    allow-list names."""
    j = _import("accvlab_tpu", rel)
    try:
        t = _import("accvlab_tpu_torch", rel)
    except ImportError as e:
        return [f"no port module: {e}"]
    faults = []
    jn = _public(j)
    if hasattr(j, "__all__"):
        extra = sorted(set(getattr(t, "__all__", ())) - set(jn))
        faults += [f"{n} is exported by the port only" for n in extra
                   if (rel, n) not in PORT_ONLY]
    for name in jn:
        if (rel, name) in JAX_ONLY:
            continue
        if hasattr(j, "__all__") and name not in getattr(t, "__all__", ()):
            faults.append(f"{name} is missing from the port's __all__")
            continue
        tname = RENAMED.get(name, name)
        if not hasattr(t, tname):
            faults.append(f"{name} is missing in the port")
            continue
        if (rel, name) in SIGNATURES:
            continue
        jo, to = getattr(j, name), getattr(t, tname)
        if inspect.isclass(jo):
            faults += _class_faults(name, jo, to)
        elif callable(jo):
            faults += _signature_faults(name, jo, to)
    return faults


@pytest.mark.parametrize("rel", _jax_modules())
def test_port_module_has_the_jax_surface(rel):
    if rel in NOT_PORTED:
        # an unported module stays absent until its slice lands and leaves
        # this list
        with pytest.raises(ImportError):
            _import("accvlab_tpu_torch", rel)
        return
    assert surface_faults(rel) == []


def test_allow_lists_name_existing_differences():
    """Every allow-listed name is still a difference: a repaired one leaves
    the list."""
    for (rel, name), reason in JAX_ONLY.items():
        assert reason and not hasattr(_import("accvlab_tpu_torch", rel), name), (rel, name)
    for (rel, name), reason in PORT_ONLY.items():
        assert reason and name in _import("accvlab_tpu_torch", rel).__all__, (rel, name)
        assert name not in _import("accvlab_tpu", rel).__all__, (rel, name)
    for (rel, name), reason in SIGNATURES.items():
        j, t = getattr(_import("accvlab_tpu", rel), name), getattr(
            _import("accvlab_tpu_torch", rel), name)
        if inspect.isclass(j) and inspect.isclass(t):
            diff = _class_faults(name, j, t)
        elif callable(t):
            diff = _signature_faults(name, j, t)
        else:
            diff = ["not callable in the port"]
        assert reason and diff, (rel, name)
