"""The port's public surface against the JAX package's, module by module.

For every public module of ``accvlab_tpu`` (one case each) the port's module
at the same relative path must export the JAX module's public names
(``__all__``, or else the public functions and classes defined there), and
each public function, each class ``__init__`` and each public method must
take the JAX parameters first, by name and in order, keyword-only ones
included. The port may add its own parameters (``device=``,
``implementation=``, ``decoder=``) after JAX's.

Defaults are held too: a JAX-named parameter takes JAX's default (enum
members by name, a numpy or ``jnp`` dtype as the torch dtype the port maps
it to), and every port-only parameter with a default stands in
``PORT_DEFAULTS`` with that default and the reason a caller that passes only
JAX's arguments still gets JAX's behaviour.

Every known difference stands in an allow-list below with its reason; a new
one fails here until it is repaired or written down (ROADMAP.md §3). The
results whose types differ on purpose stand in ``RESULTS``.
"""

import enum
import importlib
import inspect
import os

import pytest
import torch

from accvlab_tpu_torch.pipeline.dtypes import torch_dtype_for_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROOT = os.path.join(REPO, "accvlab_tpu")

FLAX = "flax module fields against torch.nn.Module"

# modules of the JAX package with no counterpart yet (ROADMAP.md §1)
NOT_PORTED: dict = {}

# public names of a JAX module that the port's module lacks
JAX_ONLY = {
    ("pipeline", "TPUPipeline"): "the port's executor is TorchPipeline",
    ("pipeline.pipeline", "TPUPipeline"): "the port's executor is TorchPipeline",
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

# (module, name) whose results differ in type from JAX's on purpose
D2H = ("device='cpu' returns a tree's CUDA leaves as CPU tensors (views of their chunk's "
       "host copy) where JAX returns numpy arrays (ROADMAP.md §3, recorded)")
RESULTS = {
    ("hostcopy", "start_copy"): D2H,
    ("hostcopy.async_copy", "start_copy"): D2H,
}

# (module, qualified name, parameter) of a JAX-named parameter whose default
# differs from JAX's on purpose, with the reason; module and qualified name
# are where the port defines the function. (freeze_params' and
# save_inference's optional params stand in SIGNATURES.)
DEFAULTS: dict = {}

# (module, qualified name, parameter) of every port-only parameter with a
# default: (the default, why a caller that passes only JAX's arguments still
# gets JAX's behaviour). An unlisted one fails, and so does a listed one
# whose default changed.
CARD = "None resolves to the card (JAX: the default device), and raises without one"
KERNEL = ("'auto': the hand kernel on CUDA tensors, the plain version on CPU tensors; "
          "both compute JAX's function")
PORT_DEFAULTS = {
    ("heatmap.draw", "draw_heatmap", "device"): (None, CARD),
    ("heatmap.draw", "draw_heatmap_batched", "device"): (None, CARD),
    ("heatmap.draw_gaussians", "draw_gaussians", "device"): (None, CARD),
    ("heatmap.draw_gaussians", "draw_gaussians", "exact"): (
        False, "the backend exp, JAX's only one; True is the goldens' bit-exact exp"),
    ("heatmap.draw_gaussians", "draw_gaussians", "implementation"): ("auto", KERNEL),
    ("models.centernet", "make_example_batch", "device"): (None, CARD),
    ("models.moe", "MoEClassifier.__init__", "in_dim"): (
        None, "the first Dense is built at the first call, as flax infers it at init"),
    ("models.moe", "make_moe_example_batch", "device"): (None, CARD),
    ("models.petr", "make_petr_example_batch", "device"): (None, CARD),
    ("models.quantize", "QuantizedTensor.__init__", "layout"): (
        "same", "the weight is already in flax's layout, as every JAX weight is"),
    ("models.server", "InferenceServer.__init__", "device"): (None, CARD),
    ("models.serving", "LoadedInference.__init__", "constants"): (
        (), "an unsharded artifact's program carries its constants, as JAX's does"),
    ("models.serving", "LoadedInference.__init__", "device"): (None, CARD + " (or the mesh's)"),
    ("models.serving", "load_inference", "device"): (None, CARD),
    ("parallel.mesh", "make_mesh", "device_type"): (None, CARD),
    ("parallel.mesh", "make_mesh_nd", "device_type"): (None, CARD),
    ("pipeline.internal_helpers", "get_as_data_node", "device"): (
        None, CARD + "; a tensor stays where it is"),
    ("pipeline.processing_steps.bounding_box_to_heatmap_converter",
     "BoundingBoxToHeatmapConverter.__init__", "implementation"): ("auto", KERNEL),
    ("pipeline.processing_steps.dct_wire", "decompress_jpeg_dct", "device"): (None, CARD),
    ("pipeline.processing_steps.image_decoder", "ImageDecoder.__init__", "decoder"): (
        "auto", "JAX's rule, image by image: libjpeg where it takes the image, PIL elsewhere"),
    ("pipeline.random_context", "DeviceRandomContext.__init__", "device"): (None, CARD),
    ("polyline.functions", "interpolate", "device"): (None, CARD),
    ("polyline.functions", "lengths", "device"): (None, CARD),
    ("ragged.matching", "auction_matching", "device"): (None, CARD),
    ("ragged.matching", "auction_matching", "implementation"): ("auto", KERNEL),
    ("ragged.matching", "batched_auction_matching", "device"): (None, CARD),
    ("ragged.matching", "batched_auction_matching", "implementation"): ("auto", KERNEL),
    ("tools.trace_range", "TraceRangeWrapper.enable", "device"): (None, CARD),
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


def _key(fn, name: str) -> tuple:
    """(module, qualified name, parameter) of a parameter of the port's ``fn``,
    where the port defines it."""
    module = getattr(fn, "__module__", None) or ""  # object.__init__ has none
    return module.removeprefix("accvlab_tpu_torch."), fn.__qualname__, name


def _same_default(j, t) -> bool:
    """Whether a JAX default and the port's mean the same: enum members (the
    two packages' ``DType``) by name, a numpy or ``jnp`` dtype against the
    torch dtype the port maps it to, anything else by ``==``."""
    if isinstance(j, enum.Enum) and isinstance(t, enum.Enum):
        return type(j).__name__ == type(t).__name__ and j.name == t.name
    if isinstance(t, torch.dtype):
        return torch_dtype_for_numpy(j) == t
    return j == t


def _default_faults(what: str, j, t, listed: bool = False) -> list:
    """A JAX-named parameter must have JAX's default (or stand in
    ``DEFAULTS``); a port-only parameter with a default must stand in
    ``PORT_DEFAULTS`` with that default. Where ``SIGNATURES`` lists the
    function (``listed``), its parameters differ on purpose: a port-only
    parameter may then be required, and a JAX parameter optional."""
    jparams = inspect.signature(j).parameters
    faults = []
    for name, p in inspect.signature(t).parameters.items():
        if p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD):
            continue
        key = _key(t, name)
        if name in jparams:
            jd = jparams[name].default
            if (not _same_default(jd, p.default) and key not in DEFAULTS
                    and not (listed and jd is p.empty)):
                faults.append(f"{what}({name}=): JAX's default {jd!r}, the port's {p.default!r}")
        elif p.default is p.empty:
            if not listed:
                faults.append(f"{what}({name}=): a port-only parameter without a default")
        elif key not in PORT_DEFAULTS or not _same_default(PORT_DEFAULTS[key][0], p.default):
            faults.append(f"{what}({name}={p.default!r}): a port-only default that "
                          f"PORT_DEFAULTS does not list as {key}")
    return faults


def _signature_faults(what: str, j, t, listed: bool = False) -> list:
    """Faults of the port's ``t`` against JAX's ``j``; ``listed``: only the
    defaults (``SIGNATURES`` names the function)."""
    try:
        jp, jk = _params(j)
        tp, tk = _params(t)
    except (TypeError, ValueError):  # builtins without a signature
        return []
    if not listed and (tp[:len(jp)] != jp or not set(jk) <= set(tk) | set(tp)):
        return [f"{what}: JAX takes {jp} + keywords {jk}, the port {tp} + keywords {tk}"]
    return _default_faults(what, j, t, listed)


def _class_faults(what: str, j, t, listed: bool = False) -> list:
    if not inspect.isclass(t):
        return [] if listed else [f"{what} is a class in JAX, not in the port"]
    faults = _signature_faults(f"{what}.__init__", j.__init__, t.__init__, listed)
    for name, member in vars(j).items():
        if name.startswith("_") or not inspect.isfunction(member):
            continue
        if hasattr(t, name):
            faults += _signature_faults(f"{what}.{name}", member, getattr(t, name), listed)
        elif not listed:
            faults.append(f"{what}.{name} is missing in the port")
    return faults


def _parameter(rel: str, qualname: str, param: str, pkg: str = "accvlab_tpu_torch"):
    """The ``inspect.Parameter`` ``param`` of ``qualname`` in ``pkg.rel``."""
    obj = _import(pkg, rel)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return inspect.signature(obj).parameters[param]


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
        jo, to = getattr(j, name), getattr(t, tname)
        listed = (rel, name) in SIGNATURES
        if inspect.isclass(jo):
            faults += _class_faults(name, jo, to, listed)
        elif callable(jo):
            faults += _signature_faults(name, jo, to, listed)
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
    for (rel, qualname, param), reason in DEFAULTS.items():
        t = _parameter(rel, qualname, param)
        j = _parameter(rel, qualname, param, "accvlab_tpu")
        assert reason and not _same_default(j.default, t.default), (rel, qualname, param)
    for (rel, qualname, param), (default, reason) in PORT_DEFAULTS.items():
        t = _parameter(rel, qualname, param)
        assert reason and t.default is not t.empty, (rel, qualname, param)
        assert _same_default(default, t.default), (rel, qualname, param, t.default)
    for (rel, name), reason in RESULTS.items():
        assert reason and callable(getattr(_import("accvlab_tpu", rel), name)), (rel, name)
        assert callable(getattr(_import("accvlab_tpu_torch", rel), name)), (rel, name)
