"""PipelineDefinition + single-device executor (PyTorch/CUDA).

Port of ``accvlab_tpu/pipeline/pipeline.py``. The executor has the same
stages:

* a **host stage**: parallel workers run the input callable and the
  host-placed steps per sample (numpy; per-sample semantics as in JAX),
* the **uniform boundary**: per-field per-sample arrays are stacked into
  batched numpy arrays (strings NUL-padded to the batch max),
* the **transfer**: the whole batch crosses to the device in packed pinned
  chunks (``hostcopy.start_copy``, one ``non_blocking`` copy per chunk),
* one **device stage**: the device-placed steps, in order, on BATCHED
  tensors (the JAX package traces ``jit(vmap(steps))``). The first
  :data:`EAGER_BATCHES_PER_SPEC` batches of a leaf spec run them eagerly and
  record their random draws; later batches of the spec run them as one
  traced program through :func:`..tools.program_cache.shared_jit` (on the
  card a CUDA graph, replayed), shared with every structurally identical
  pipeline of the process. A pipeline whose device steps equal, by type and
  state, those of one that built the spec's program already runs that
  program from the spec's first batch, with no trace. Both run the steps
  through :func:`.image_chain.run_device_steps`, which sends the image
  chain ``AffineTransformer`` -> ``PhotoMetricDistorter`` ->
  ``ImageMeanStdDevNormalizer`` through one kernel where its images are
  uint8 on the card,
* a **prefetch ring**: a background thread keeps ``prefetch_queue_depth``
  host batches ready, overlapping host work with the device.

Construction-time blueprint checking is kept 1:1
(``check_and_get_output_data_structure``). Randomness of device steps comes
from a ``torch.Generator`` seeded from ``(seed, batch_idx)`` — deterministic
for a batch regardless of prefetch timing, identical on the CPU and on the
card, and unrelated to the JAX package's threefry bits.

As in the JAX package the executor echoes data (``echo_factor``: each host
batch is transferred once and delivered that many times, each replay with
its own device randomness, keyed ``(seed, batch_idx, echo)``) and
checkpoints its consumed position (``get_state``/``set_state``, the JAX
package's state dict, mid-echo positions included).

Host work runs on threads or, with ``worker_mode="process"``, in spawned
worker processes (:mod:`.worker_pool`). ``start_trace``/``stop_trace``
record the executor's phase timeline (:mod:`..tools.chrome_trace`). While a
``torch.profiler`` records, the consumer's phases also show there as
``accvlab.pipeline.*`` ranges (``consumer_wait``; ``device_dispatch`` and,
inside it, ``transfer``, ``draws`` and ``stage``; ``program_build``), on
the profiler's clock; the producer thread's phases do not, since the
profiler records only the thread that started it.

The device stage can also be exported (``torch.export``) as a function of
the transferred leaves and the batch's random draws: ``device_program_text``
prints that program, ``export_device_program`` writes it as a serving
artifact (:mod:`..models.serving`) that reproduces the stage without
pipeline code.

On a mesh (``get_pipeline(mesh=)``, a :mod:`..parallel` ``DeviceMesh``) each
rank runs this executor on its own input shard: the packed transfer goes to
the rank's own device, the device stage runs on local tensors (the hand
kernels take plain tensors), and every delivered leaf is the rank's shard
of the global batch, a ``DTensor`` that is ``Shard(0)`` over ``data``
(:func:`..parallel.shard_batch`).
"""

from __future__ import annotations

import enum
import hashlib
import queue
import threading
import time
import types
import warnings
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from .. import _draws
from .._device import F32MatmulScope, resolve_device
from ..parallel.mesh import mesh_device, shard_batch
from ..tools.program_cache import (
    find_program,
    keep_program,
    program_cache_stats,
    program_text,
    shared_jit,
)
from ..tools.trace_range import _profiled
from .dtypes import DType
from .image_chain import find_image_chain, run_device_steps, takes_images
from .inputs.base import CallableBase, IterableBase, SampleInfo
from .processing_steps.pipeline_step_base import BatchLevelStepBase, PipelineStepBase
from .random_context import DeviceRandomContext, HostRandomContext, ReplayRandomContext
from .sample_data_group import SampleDataGroup

# fields up to this size ride the packed transfer (one field of bench.py's
# batch, 8 frames of 372x1024x3, is 9 MB)
_PACK_FIELD_MAX_BYTES = 32 << 20
# how long reset()/set_state() wait for a producer to finish its batch
_HALT_TIMEOUT_S = 60.0
#: the batches of a leaf spec that run the device steps eagerly before the
#: spec's program is traced and built: a spec seen fewer times never pays
#: for a trace (seconds on the host for a stage of a few thousand operators)
EAGER_BATCHES_PER_SPEC = 3
# the leaf specs a pipeline remembers, with their programs (the least
# recently seen are dropped): the process-global cache is as bounded
_SPECS_MAX = 64
_NOT_READ = object()
_HEAP_TYPE = 1 << 9  # Py_TPFLAGS_HEAPTYPE: a class defined in Python


def _value_key(obj, _path: tuple = ()):
    """A hashable key of ``obj`` by value: scalars, dtypes and enums as they
    are, tensors and arrays by dtype, shape, device and a digest of their
    bytes, containers item by item, and an instance of a class defined in
    Python as its class (the object itself) and its attributes. Classes and
    functions without a closure are keyed by identity, and the key holds
    them. Raises ``TypeError`` for state it cannot key by value: a closure,
    a bound method, an object of a C type (a lock, a ``functools.partial``),
    a cycle."""
    if obj is None or isinstance(obj, (bool, int, float, complex, str, bytes, np.generic)):
        return (type(obj), repr(obj))
    if isinstance(obj, (torch.dtype, torch.device, np.dtype)):
        return (type(obj), str(obj))
    if isinstance(obj, enum.Enum):
        return (type(obj), obj.name)
    if isinstance(obj, (type, types.BuiltinFunctionType, np.ufunc)) or (
            isinstance(obj, types.FunctionType) and obj.__closure__ is None):
        return obj
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu().contiguous().reshape(-1)
        return (torch.Tensor, str(t.dtype), tuple(obj.shape), str(obj.device),
                hashlib.sha256(t.view(torch.uint8).numpy().tobytes()).hexdigest())
    if isinstance(obj, np.ndarray):
        if obj.dtype.hasobject:
            raise TypeError("an object array")
        return (np.ndarray, str(obj.dtype), obj.shape,
                hashlib.sha256(np.ascontiguousarray(obj).tobytes()).hexdigest())
    if id(obj) in _path or len(_path) > 32:
        raise TypeError(f"a cycle through a {type(obj).__name__}")
    path = _path + (id(obj),)
    if isinstance(obj, (list, tuple)):
        return (type(obj), tuple(_value_key(x, path) for x in obj))
    if isinstance(obj, dict):
        return (type(obj), tuple((_value_key(k, path), _value_key(v, path))
                                 for k, v in obj.items()))
    if isinstance(obj, (set, frozenset)):
        return (type(obj), tuple(sorted((_value_key(x, path) for x in obj), key=repr)))
    cls = type(obj)
    if not all(c is object or c.__flags__ & _HEAP_TYPE for c in cls.__mro__):
        raise TypeError(f"a {cls.__name__}, whose state is not its attributes")
    state = dict(getattr(obj, "__dict__", {}))
    for c in cls.__mro__:
        names = c.__dict__.get("__slots__", ())
        for n in [names] if isinstance(names, str) else names:
            if n not in ("__dict__", "__weakref__") and hasattr(obj, n):
                state[n] = getattr(obj, n)
    return (cls, _value_key(state, path))


def _split_steps(steps: Sequence[PipelineStepBase]):
    """Partition steps into the host prefix and the device suffix."""
    host_steps: List[PipelineStepBase] = []
    device_steps: List[PipelineStepBase] = []
    in_device = False
    for s in steps:
        if s.placement == "device" or (in_device and s.placement == "any"):
            in_device = True
            device_steps.append(s)
        elif not in_device:
            host_steps.append(s)
        else:
            raise ValueError(
                f"Host-only step {type(s).__name__} cannot run after the "
                "host/device boundary (a device-placed step precedes it)."
            )
    return host_steps, device_steps


class _StepModule(nn.Module):
    """One device step inside the exported stage. It is registered under the
    step's class name, so every node it makes carries that name in its
    ``nn_module_stack``."""

    def __init__(self, step: PipelineStepBase, check: bool):
        super().__init__()
        self.__dict__["step"] = step
        self._check = check

    def forward(self, sdg, process):
        """``process``, the step's ``_process`` or its stand-in
        (:func:`.image_chain.run_device_steps`), on ``sdg``."""
        return self.step._checked(process, sdg) if self._check else process(sdg)


class _DeviceStage(nn.Module):
    """The device steps as a function of ``(leaves, draws)``: the draws that
    ``schedule`` records are handed out by a :class:`ReplayRandomContext`
    (``torch.export`` cannot trace a ``torch.Generator``)."""

    def __init__(self, blueprint: SampleDataGroup, steps, schedule, check: bool, chain):
        super().__init__()
        self.__dict__["blueprint"] = blueprint
        self._schedule = list(schedule)
        self._chain = chain
        for i, step in enumerate(steps):
            self.add_module(f"{type(step).__name__}_{i}", _StepModule(step, check))

    def forward(self, leaves, draws):
        sdg = self.blueprint.get_empty_like_self()
        sdg.set_data(list(leaves))
        ctx = ReplayRandomContext(draws, self._schedule)
        modules = list(self.children())
        with F32MatmulScope():
            sdg = run_device_steps([m.step for m in modules], sdg, ctx, self._chain,
                                   lambda i, fn, d: modules[i](d, fn))
        ctx.finish()
        return tuple(sdg.get_data())


class PipelineDefinition:
    """Composes an input source and processing steps into an input pipeline.

    Parity with ``accvlab_tpu.pipeline.PipelineDefinition``; the DALI
    pass-through-copy arguments are accepted and ignored (device steps never
    write into their inputs in place).
    """

    def __init__(
        self,
        data_loading_callable_iterable: Union[CallableBase, IterableBase],
        preprocess_functors: Optional[Sequence[Optional[PipelineStepBase]]] = None,
        check_data_format: bool = True,
        use_parallel_external_source: bool = True,
        prefetch_queue_depth: int = 2,
        print_sample_data_group_format: bool = False,
        copy_external_source_passthrough_outputs: Optional[bool] = None,
        passthrough_copy_field_names: Optional[Sequence] = None,
        passthrough_copy_field_names_scope_paths: Optional[Sequence] = None,
        passthrough_copy_branch_paths: Optional[Sequence] = None,
    ):
        self._input = data_loading_callable_iterable
        self._steps = [s for s in (preprocess_functors or []) if s is not None]
        self._check_data_format = check_data_format
        self._use_parallel = use_parallel_external_source
        self._prefetch_queue_depth = prefetch_queue_depth
        self._print_format = print_sample_data_group_format
        if copy_external_source_passthrough_outputs:
            warnings.warn(
                "copy_external_source_passthrough_outputs has no effect: device "
                "steps never write into their inputs in place."
            )

    @property
    def input_data_structure(self) -> SampleDataGroup:
        """Input format blueprint (from the data-loading functor)."""
        return self._input.used_sample_data_structure

    def check_and_get_output_data_structure(self) -> SampleDataGroup:
        """Infer the output format by folding every step's format check in
        the executor's order: host per-sample steps, host batch-level steps,
        then the device steps."""
        host_steps, device_steps = _split_steps(self._steps)
        ordered = (
            [s for s in host_steps if not s.is_batch_level]
            + [s for s in host_steps if s.is_batch_level]
            + list(device_steps)
        )
        blueprint = self.input_data_structure
        if self._print_format:
            print("### Input format:\n" + str(blueprint))
        for step in ordered:
            blueprint = step.check_input_data_format_and_set_output_data_format(blueprint)
            if self._print_format:
                print(f"### After {type(step).__name__}:\n" + str(blueprint))
        return blueprint

    def get_pipeline(
        self,
        batch_size: int,
        num_threads: int = 4,
        device=None,
        seed: int = 0,
        prefetch_queue_depth: Optional[int] = None,
        worker_mode: str = "thread",
        mesh=None,
        echo_factor: int = 1,
    ) -> "TorchPipeline":
        """Build the executable pipeline. ``device`` defaults to the CUDA
        device (raises without a card), or to the device of ``mesh``;
        ``device="cpu"`` runs every step's plain PyTorch version on the CPU.

        ``mesh``: a ``DeviceMesh`` with a ``data`` axis
        (:func:`..parallel.make_mesh`). Every delivered leaf is then a
        ``DTensor`` sharded over ``data``, whose local part is this rank's
        batch: each rank runs its own pipeline on its data coordinate's
        input shard (:func:`..parallel.mesh.data_shard_info`).

        ``worker_mode``: ``"thread"`` (the default; host steps that release
        the interpreter lock) or ``"process"`` (``num_threads`` spawned
        workers run the input callable and the per-sample host steps, which
        must pickle; batch-level host steps stay in the producer thread).
        Both give the same batches, bit for bit.

        ``echo_factor``: data echoing (Choi et al. 2019). Each host batch is
        delivered ``echo_factor`` times, transferred to the device once, with
        its own device randomness per replay, so the delivered batches per
        epoch grow by the factor while host work and transfer do not.
        """
        return TorchPipeline(
            self,
            batch_size=batch_size,
            num_threads=num_threads,
            device=device,
            seed=seed,
            prefetch_queue_depth=(
                self._prefetch_queue_depth if prefetch_queue_depth is None else prefetch_queue_depth
            ),
            parallel=self._use_parallel,
            check_data_format=self._check_data_format,
            worker_mode=worker_mode,
            mesh=mesh,
            echo_factor=echo_factor,
        )

    # the JAX package's alias for call sites written against the reference name
    get_dali_pipeline = get_pipeline


class TorchPipeline:
    """Executable input pipeline with prefetching. Yields name-keyed batches.

    Iteration protocol as in the JAX package: ``__next__`` returns
    ``[{flat_name: batched_tensor}]``, raises ``StopIteration`` at epoch end;
    ``reset()`` starts the next epoch.
    """

    def __init__(
        self,
        definition: PipelineDefinition,
        batch_size: int,
        num_threads: int,
        device,
        seed: int,
        prefetch_queue_depth: int,
        parallel: bool,
        check_data_format: bool,
        worker_mode: str = "thread",
        mesh=None,
        echo_factor: int = 1,
    ):
        if worker_mode not in ("thread", "process"):
            raise ValueError(f"worker_mode must be 'thread' or 'process', got {worker_mode!r}")
        self._mesh = mesh
        if mesh is not None:
            if device is not None and torch.device(device).type != mesh.device_type:
                raise ValueError(f"device={device!r} is not the mesh's {mesh.device_type!r}")
            device = mesh_device(mesh)
        self._device = resolve_device(device)
        if self._device.type == "cuda" and self._device.index is None:
            self._device = torch.device("cuda", torch.cuda.current_device())
        self._num_threads = num_threads
        self._worker_mode = worker_mode
        self._workers = None  # ProcessSampleWorkers, made at the first batch
        self._definition = definition
        self._batch_size = batch_size
        self._seed = seed
        self._depth = max(1, prefetch_queue_depth)
        self._parallel = parallel
        self._check = check_data_format

        self._host_steps, self._device_steps = _split_steps(definition._steps)

        # blueprint inference (construction time)
        self._input_blueprint = definition.input_data_structure
        bp = self._input_blueprint
        for s in self._host_steps:
            if not s.is_batch_level:
                bp = s.check_input_data_format_and_set_output_data_format(bp)
        self._per_sample_out_blueprint = bp
        for s in self._host_steps:
            if s.is_batch_level:
                bp = s.check_input_data_format_and_set_output_data_format(bp)
        self._host_out_blueprint = bp
        # the image chain through its kernel, where the images at the affine
        # step allow (.image_chain), else None
        chain = find_image_chain(self._device_steps)
        for i, s in enumerate(self._device_steps):
            if chain is not None and i == chain.affine and not takes_images(bp, chain.name,
                                                                             self._device):
                chain = None
            bp = s.check_input_data_format_and_set_output_data_format(bp)
        self._image_chain = chain
        self._output_blueprint = bp
        self._output_names = bp.field_names_flat
        self._host_out_types = self._host_out_blueprint.field_types_flat

        self._pool = (
            ThreadPoolExecutor(max_workers=num_threads, thread_name_prefix="accvlab-host")
            if parallel
            else None
        )
        self._epoch = 0
        self._iteration = 0
        self._global_batch = 0

        # consumed position (checkpoint/resume): what the caller has
        # retrieved, as opposed to the producer counters above, which run
        # ahead by the prefetch depth
        self._consumed_iteration = 0
        self._consumed_global = 0
        self._consumed_input_state = None
        self._input_state_captured = False
        # set_state arms this so that one iterator-front reset does not
        # discard the restored position; cleared on first use
        self._resume_armed = False

        # data echoing: each host batch is delivered echo_factor times,
        # transferred once, with its own device randomness per replay
        self._echo_factor = int(echo_factor)
        if self._echo_factor < 1:
            raise ValueError(f"echo_factor must be >= 1, got {echo_factor}")
        if self._echo_factor > 1 and not self._device_steps:
            warnings.warn(
                "echo_factor > 1 without any device-placed step replays "
                "identical batches (no augmentation to diversify them); "
                "example echoing still helps input-bound training but "
                "consider a device-side augmentation step."
            )
        self._echo_item = None  # ((idx, iter, state, batch), next_echo)
        self._echo_start = 0  # first echo index of the next popped batch
        self._consumed_echo_next = 0

        self._queue: "queue.Queue" = queue.Queue(maxsize=self._depth)
        self._producer: Optional[threading.Thread] = None
        self._producer_stop = threading.Event()
        self._exhausted = False

        # observability counters (see stats()); written by one thread each
        self._stat_produced = 0
        self._stat_consumed = 0
        self._stat_producer_busy_s = 0.0
        self._stat_producer_blocked_s = 0.0
        self._stat_consumer_wait_s = 0.0
        self._stat_device_stage_s = 0.0
        self._stat_fused_stage_batches = 0
        self._stat_transfer_bytes = 0
        self._stat_transfers = 0
        self._stat_transfer_s = 0.0
        # phase-timeline recorder (start_trace); when None the hot paths pay
        # one attribute read per phase
        self._trace = None
        # the last device-stage call's leaf specs and draw schedule (what
        # device_program_text/export_device_program trace), and the texts
        self._last_device_spec = None
        self._export_cache: dict = {}  # the last spec's ExportedProgram
        self._program_text_cache: dict = {}
        # per leaf spec, the least recently seen first: [batches seen, draw
        # schedule, program] (the program None until built, False when its
        # trace failed)
        self._stage_specs: "OrderedDict[tuple, list]" = OrderedDict()
        # the device steps by value (_value_key), read at the first batch;
        # None when a step's state cannot be keyed
        self._steps_value = _NOT_READ
        # True runs every batch eagerly (the measurement's comparison)
        self._eager_stage = False

    @property
    def device(self) -> torch.device:
        return self._device

    # ------------------------------------------------------------------ #
    # Host stage                                                         #
    # ------------------------------------------------------------------ #

    _EPOCH_END = object()

    def _load_sample(self, idx_in_batch: int):
        info = SampleInfo(
            idx_in_epoch=self._iteration * self._batch_size + idx_in_batch,
            idx_in_batch=idx_in_batch,
            iteration=self._iteration,
            epoch_idx=self._epoch,
        )
        try:
            return self._definition._input(info)
        except StopIteration:
            # PEP 479: StopIteration cannot cross executor.map generators
            return self._EPOCH_END

    def _run_host_steps(self, flat: tuple, idx_in_batch: int) -> SampleDataGroup:
        sdg = self._input_blueprint.get_empty_like_self()
        sdg.set_data(list(flat))
        if self._host_steps:
            rng = HostRandomContext(
                np.random.default_rng((self._seed, self._epoch, self._iteration, idx_in_batch))
            )
            for step in self._host_steps:
                if step.is_batch_level:
                    continue  # applied after the per-sample phase
                step.set_random_context(rng)
                sdg = step(sdg) if self._check else step._process(sdg)
        return sdg

    def _produce_host_batch(self):
        """Run input + host steps for one batch. Returns ``(batch_idx,
        iteration after it, the input's state after it, stacked numpy
        fields)`` or raises StopIteration."""
        is_callable = isinstance(self._definition._input, CallableBase)
        if is_callable and self._worker_mode == "process":
            from .worker_pool import ProcessSampleWorkers

            if self._workers is None:
                self._workers = ProcessSampleWorkers(
                    self._num_threads, self._definition._input, self._host_steps,
                    self._input_blueprint, self._check, self._seed)
            flats = self._workers.produce_batch(
                self._batch_size, self._iteration, self._epoch)  # raises StopIteration
            samples = []
            for flat in flats:
                # the workers ran the per-sample phase only
                sdg = self._per_sample_out_blueprint.get_empty_like_self()
                sdg.set_data(flat)
                samples.append(sdg)
        elif is_callable:
            if self._pool is not None:
                def load_and_process(i):
                    flat = self._load_sample(i)
                    if flat is self._EPOCH_END:
                        return self._EPOCH_END
                    return self._run_host_steps(flat, i)

                samples = list(self._pool.map(load_and_process, range(self._batch_size)))
            else:
                samples = []
                for i in range(self._batch_size):
                    flat = self._load_sample(i)
                    samples.append(
                        flat if flat is self._EPOCH_END else self._run_host_steps(flat, i)
                    )
            if any(s is self._EPOCH_END for s in samples):
                raise StopIteration  # partial batches are dropped (DALI semantics)
        else:
            per_field = next(self._definition._input)  # may raise StopIteration
            batch_size = len(per_field[0])
            flats = [tuple(field[i] for field in per_field) for i in range(batch_size)]
            if self._pool is not None:
                samples = list(
                    self._pool.map(lambda a: self._run_host_steps(*a),
                                   [(f, i) for i, f in enumerate(flats)])
                )
            else:
                samples = [self._run_host_steps(f, i) for i, f in enumerate(flats)]

        for step in self._host_steps:
            if step.is_batch_level:
                assert isinstance(step, BatchLevelStepBase)
                samples = step.process_batch_checked(samples, self._check)

        self._iteration += 1
        self._global_batch += 1
        return (self._global_batch - 1, self._iteration, self._capture_input_state(),
                self._stack_samples(samples))

    def _capture_input_state(self):
        """The input's resume state, or ``None`` for inputs without the
        protocol (plain callables are pure functions of ``SampleInfo``: the
        pipeline counters alone resume them)."""
        inp = self._definition._input
        if not hasattr(inp, "get_state"):
            return None
        try:
            return inp.get_state()
        except NotImplementedError:
            return None

    def _stack_samples(self, samples: List[SampleDataGroup]):
        names = self._host_out_blueprint.field_names_flat
        types = self._host_out_types
        per_sample_flat = [s.get_data() for s in samples]
        batched = []
        for fi, name in enumerate(names):
            vals = [np.asarray(ps[fi]) for ps in per_sample_flat]
            if types[fi] == DType.UINT8:
                # strings flatten as UINT8; pad 1-D uint8 fields of unequal
                # length with NULs
                if any(v.ndim == 1 and v.dtype == np.uint8 for v in vals):
                    max_len = max(v.shape[0] if v.ndim == 1 else -1 for v in vals)
                    if any(v.ndim == 1 and v.shape[0] != max_len for v in vals):
                        vals = [
                            np.pad(v, (0, max_len - v.shape[0])) if v.ndim == 1 else v
                            for v in vals
                        ]
            shapes = {v.shape for v in vals}
            if len(shapes) > 1:
                raise ValueError(
                    f"Field '{name}' has non-uniform per-sample shapes {shapes} at "
                    "the host->device boundary. Add a padding step before the "
                    "first device-placed step."
                )
            batched.append(np.stack(vals, axis=0))
        return tuple(batched)

    # ------------------------------------------------------------------ #
    # Transfer + device stage                                            #
    # ------------------------------------------------------------------ #

    def _transfer(self, host_batch: tuple, batch_idx: int = -1) -> tuple:
        """Host->device placement: one packed transfer (hostcopy engine).

        Every field of up to 32 MiB rides a packed chunk, merged across
        dtypes into raw-byte chunks. A failing transfer raises; there is no
        quiet fallback. ``batch_idx`` names the batch in the profiler's
        ``accvlab.pipeline.transfer`` range.
        """
        from ..hostcopy import start_copy

        t0 = time.monotonic()
        self._stat_transfer_bytes = sum(a.nbytes for a in host_batch)
        self._stat_transfers += 1
        with _profiled("accvlab.pipeline.transfer", batch=batch_idx,
                       bytes=self._stat_transfer_bytes):
            handle = start_copy(
                list(host_batch), device=self._device, use_background_thread=False,
                pack_candidate_max_bytes=_PACK_FIELD_MAX_BYTES, merge_dtype_chunks=True,
            )
            out = tuple(handle.get())
        self._stat_transfer_s += time.monotonic() - t0
        return out

    def run_device_stage(self, leaves: Sequence[torch.Tensor], batch_idx: int,
                         echo_i: int = 0) -> tuple:
        """The device steps on one transferred batch (flat leaves in the
        host-stage output order). Randomness is seeded from ``(seed,
        batch_idx)``, and with ``echo_factor > 1`` from ``(seed, batch_idx,
        echo_i)``, so the same leaves and indices give the same outputs. The
        leaves are not modified, so a replay may run on them again. Returns
        the flat output leaves.

        The first :data:`EAGER_BATCHES_PER_SPEC` calls with a leaf spec run
        the steps eagerly and record their draws; later calls run the shared
        program of the spec: the same outputs, bit for bit."""
        if not self._device_steps:
            return tuple(leaves)
        specs = tuple((tuple(x.shape), x.dtype) for x in leaves)
        entry = self._stage_specs.get(specs)
        if entry is None:
            name = self._stage_name(specs)
            found = find_program(name) if name is not None else None
            # [batches seen, schedule, program]: a program found is used at once
            entry = [0, None, None] if found is None else [0, found[1], found[0]]
            self._stage_specs[specs] = entry
            while len(self._stage_specs) > _SPECS_MAX:
                self._stage_specs.popitem(last=False)
        else:
            self._stage_specs.move_to_end(specs)
        entry[0] += 1
        if entry[2] is None and entry[0] > EAGER_BATCHES_PER_SPEC and not self._eager_stage:
            with _profiled("accvlab.pipeline.program_build", specs=len(self._stage_specs)):
                entry[2] = self._program(leaves, specs, entry[1])
        fused = int(self._image_chain is not None)
        self._stat_fused_stage_batches += fused
        if self._eager_stage or not entry[2]:
            with _profiled("accvlab.pipeline.stage", batch=batch_idx, mode="eager",
                           fused=fused):
                out, entry[1] = self._run_eager(leaves, batch_idx, echo_i)
            self._last_device_spec = (specs, entry[1])
            return out
        self._last_device_spec = (specs, entry[1])
        with _profiled("accvlab.pipeline.draws", batch=batch_idx):
            draws = self._draws_on_device(entry[1], self._batch_key(batch_idx, echo_i))
        with _profiled("accvlab.pipeline.stage", batch=batch_idx, mode="program",
                       fused=fused), \
                F32MatmulScope():  # the precision the steps' eager run sets
            return tuple(entry[2](tuple(leaves), draws))

    def _batch_key(self, batch_idx: int, echo_i: int) -> tuple:
        return (self._seed, batch_idx) if self._echo_factor == 1 else (self._seed, batch_idx,
                                                                       echo_i)

    def _run_eager(self, leaves: Sequence[torch.Tensor], batch_idx: int, echo_i: int = 0):
        """The device steps run eagerly, their draws from a
        :class:`DeviceRandomContext`: ``(outputs, schedule)``."""
        sdg = self._host_out_blueprint.get_empty_like_self()
        sdg.set_data(list(leaves))
        ctx = DeviceRandomContext(self._batch_key(batch_idx, echo_i), device=self._device)
        steps = self._device_steps

        def apply(i, fn, data):
            return steps[i]._checked(fn, data) if self._check else fn(data)

        with F32MatmulScope():
            sdg = run_device_steps(steps, sdg, ctx, self._image_chain, apply)
        return tuple(sdg.get_data()), tuple(ctx.schedule)

    def _draws_on_device(self, schedule, key) -> tuple:
        """The batch's draws, made on the host from ``key`` as
        :class:`DeviceRandomContext` makes them, and moved to the device in
        one copy from pinned memory (the same bits: each float32 draw rides
        as its int32 view)."""
        draws = _draws.make_draws(schedule, key)
        if self._device.type != "cuda" or not draws:
            return tuple(draws)
        flat = torch.cat([d.reshape(-1).view(torch.int32) for d in draws])
        # the caching host allocator keeps the pinned block until the copy is done
        dev = flat.pin_memory().to(self._device, non_blocking=True)
        pieces = torch.split(dev, [d.numel() for d in draws])
        return tuple(p.view(d.dtype).view(d.shape) for p, d in zip(pieces, draws))

    def _stage_name(self, specs: tuple):
        """The device stage's name for :func:`..tools.program_cache.find_program`
        of a leaf spec: the steps and the output blueprint by value, the
        spec, the device and the format check; ``None`` when a step's state
        cannot be keyed by value (its program is then found by its trace)."""
        if self._steps_value is _NOT_READ:
            try:
                self._steps_value = _value_key((self._host_out_blueprint,
                                                tuple(self._device_steps)))
            except TypeError:
                self._steps_value = None
        if self._steps_value is None:
            return None
        return ("device stage", self._steps_value, specs, str(self._device), self._check,
                torch.get_default_dtype())

    def _program(self, leaves, specs: tuple, schedule):
        """The shared program of a leaf spec and its schedule, kept under the
        stage's name with the schedule; ``False`` when its trace failed (the
        steps then run eagerly). The transferred leaves are not donated: the
        program's outputs are copies out of its graph's pool, and the
        executor drops the leaves after the stage anyway."""
        stage = self._stage_module(schedule)
        # the trace reads only the draws' shapes and dtypes
        draws = tuple(torch.empty(e["shape"], device=self._device,
                                  dtype=torch.int32 if e["kind"] == "randint" else torch.float32)
                      for e in schedule)

        def device_stage(leaves, draws):
            return stage(leaves, draws)

        # the name a declined trace's warning gives
        device_stage.__qualname__ = "device stage (" + ", ".join(
            type(s).__name__ for s in self._device_steps) + ")"
        program = shared_jit(device_stage, (tuple(leaves), draws))
        if program is device_stage:  # the trace failed: the steps run as written, eagerly
            return False
        name = self._stage_name(specs)
        if name is not None:
            keep_program(name, program, schedule)
        return program

    def _stage_module(self, schedule) -> _DeviceStage:
        return _DeviceStage(self._host_out_blueprint, self._device_steps, schedule, self._check,
                            self._image_chain)

    # ------------------------------------------------------------------ #
    # Device program: text and serving export                            #
    # ------------------------------------------------------------------ #

    def _device_spec(self):
        """The last device-stage call's ``(leaf specs, draw schedule)``;
        raises when there is nothing to export."""
        if not self._device_steps:
            raise RuntimeError(
                "this pipeline has no device-placed steps (no device program exists)"
            )
        if self._last_device_spec is None:
            raise RuntimeError(
                "no device program built yet — deliver at least one batch (pipe.run()) first"
            )
        return self._last_device_spec

    def _export_device_stage(self):
        """``torch.export`` of the device steps at the last batch's leaf
        specs and draw schedule: ``(ExportedProgram, schedule)``, traced once
        per spec."""
        specs, schedule = self._device_spec()
        key = (specs, repr(schedule))
        if self._export_cache.get("key") == key:
            return self._export_cache["program"], schedule
        stage = self._stage_module(schedule)
        # uint32 leaves (the DCT wire's packed exceptions) enter as their
        # int32 bits: torch.export's serializer (torch 2.11) has no uint32
        leaves = tuple(torch.zeros(shape, dtype=torch.int32 if dtype == torch.uint32 else dtype,
                                   device=self._device)
                       for shape, dtype in specs)
        draws = tuple(torch.zeros(e["shape"], device=self._device,
                                  dtype=torch.int32 if e["kind"] == "randint" else torch.float32)
                      for e in schedule)
        with torch.no_grad():
            ep = torch.export.export(stage, (leaves, draws), strict=False)
        self._export_cache = {"key": key, "program": ep}
        return ep, schedule

    def device_program_text(self, optimized: bool = False) -> str:
        """Text of the exported device stage at the most recent batch's
        shapes: one line per node with its dtype and shape, the call, and the
        device step (its class name) that made it. ``optimized=True`` prints
        the program after ``run_decompositions()`` (the core ATen ops it
        lowers to). Cached per batch spec.

        Raises ``RuntimeError`` before the first delivered batch and when the
        pipeline has no device-placed steps."""
        specs, schedule = self._device_spec()
        key = (specs, repr(schedule), bool(optimized))
        text = self._program_text_cache.get(key)
        if text is None:
            ep, _ = self._export_device_stage()
            text = program_text(ep.run_decompositions() if optimized else ep)
            self._program_text_cache[key] = text
        return text

    def export_device_program(self, path: Optional[str] = None):
        """Export the device stage as a self-contained serving artifact (the
        :mod:`..models.serving` container), at the most recent batch's
        shapes.

        The artifact takes ``(leaves, key)``: the flat host-stage output
        leaves (header ``pipeline_input_fields`` names them in order; a
        uint32 leaf is taken as its int32 bits, which the steps that read
        uint32 fields, the DCT wire's unpacker, view so themselves) and
        the batch key, ``(seed, batch_idx)`` (``(seed, batch_idx, echo)``
        with echoing); the header's ``draw_schedule`` lets the loader make
        the stage's random draws from it. It returns the flat output leaves
        (``pipeline_output_fields``), bit for bit those of
        :meth:`run_device_stage` on the same leaves. Raises as
        :meth:`device_program_text`.

        On a mesh pipeline the program is this rank's device stage: its
        leaves and outputs are recorded ``Shard(0)`` over ``data`` (replicated
        over the other axes) with their global shapes, and the draws are made
        from the key the caller gives (this rank's). Load it with
        ``load_inference(mesh=)``: it takes the rank's leaves (or the
        DTensors of the batch) and returns DTensors, as the pipeline delivers.

        Returns the header; the bytes go to ``path`` (atomic write) when it
        is given, else they are returned instead of the header.
        """
        from ..models import serving as _serving

        ep, schedule = self._export_device_stage()
        header = _serving._header(ep, False, "device_stage", "highest")
        header["draw_schedule"] = list(schedule)
        header["pipeline_input_fields"] = list(self._host_out_blueprint.field_names_flat)
        header["pipeline_output_fields"] = list(self._output_blueprint.field_names_flat)
        if self._mesh is not None:
            header.update(self._mesh_fields(ep, len(schedule)))
        data = _serving._pack(header, _serving.program_bytes(ep))
        if path is None:
            return data
        _serving._atomic_write(path, data)
        return header

    def _mesh_fields(self, ep, n_draws: int) -> dict:
        """The sharded-artifact header fields of this rank's device stage:
        every leaf and output ``Shard(0)`` over ``data``."""
        from ..models import serving as _serving
        from ..parallel.mesh import shard_like_batch

        mesh = self._mesh
        n_data = mesh.size(mesh.mesh_dim_names.index("data"))
        ins, outs = _serving._user_io(ep)
        ins = ins[:len(ins) - n_draws]

        def record(vals):
            pls = [_serving.placements_by_axis(mesh, shard_like_batch(mesh, v.ndim))
                   for v in vals]
            shapes = [[int(v.shape[0]) * n_data] + [int(d) for d in v.shape[1:]] for v in vals]
            return pls, shapes

        in_pl, in_shapes = record(ins)
        out_pl, out_shapes = record(outs)
        return {"nr_devices": int(mesh.size()), "mesh": _serving.mesh_record(mesh),
                "in_placements": in_pl, "in_shapes": in_shapes, "out_placements": out_pl,
                "out_shapes": out_shapes}

    # ------------------------------------------------------------------ #
    # Prefetching iterator protocol                                      #
    # ------------------------------------------------------------------ #

    _END = object()

    def _producer_loop(self):
        # The producer performs ONLY host-stage work; transfer and device
        # dispatch happen on the consumer thread (__next__), which keeps all
        # CUDA calls on one thread. Device work is asynchronous, so host
        # production of batch N+1 overlaps device compute of batch N.
        while not self._producer_stop.is_set():
            t0 = time.monotonic()
            try:
                item = self._produce_host_batch()
            except StopIteration:
                self._queue.put(self._END)
                return
            except Exception as e:  # propagate: the consumer must never block forever
                self._queue.put(e)
                return
            t1 = time.monotonic()
            self._queue.put(item)
            t2 = time.monotonic()
            self._stat_producer_busy_s += t1 - t0
            self._stat_producer_blocked_s += t2 - t1
            self._stat_produced += 1
            tr = self._trace  # one read: stop_trace may race from another thread
            if tr is not None:
                tr.complete("host_build", "producer", t0, t1 - t0, batch=item[0])
                tr.complete("queue_put", "producer", t1, t2 - t1, batch=item[0])

    def _ensure_producer(self):
        # spawn only when no producer exists for this run (reset()/set_state
        # clear it); a producer that ran and ended has already queued its
        # terminal item
        if self._producer is None and not self._exhausted:
            # iteration starts: a later reset is an epoch boundary again
            self._resume_armed = False
            # the input's state before the producer advances it is the
            # position get_state reports until a batch of this run is consumed
            if not self._input_state_captured:
                self._consumed_input_state = self._capture_input_state()
                self._input_state_captured = True
            self._producer_stop.clear()
            self._producer = threading.Thread(
                target=self._producer_loop, daemon=True, name="accvlab-prefetch"
            )
            self._producer.start()

    def __iter__(self):
        return self

    def __next__(self):
        if self._exhausted:
            raise StopIteration
        if self._echo_item is None:
            self._ensure_producer()
            t_wait0 = time.monotonic()
            # the producer hands out host batches in order: the next is the
            # first one not consumed
            with _profiled("accvlab.pipeline.consumer_wait", batch=self._consumed_global):
                while True:
                    try:
                        item = self._queue.get(timeout=5.0)
                        break
                    except queue.Empty:
                        if self._producer is None or not self._producer.is_alive():
                            self._exhausted = True
                            raise RuntimeError(
                                "pipeline producer thread died without delivering a batch "
                                "or an error"
                            )
            if item is self._END:
                self._exhausted = True
                tr = self._trace
                if tr is not None:
                    tr.instant("epoch_end", "consumer", epoch=self._epoch)
                raise StopIteration
            if isinstance(item, Exception):
                self._exhausted = True
                raise item
            t_wait1 = time.monotonic()
            self._stat_consumer_wait_s += t_wait1 - t_wait0
            tr = self._trace
            if tr is not None:
                tr.complete("consumer_wait", "consumer", t_wait0, t_wait1 - t_wait0,
                            batch=item[0])
            # this host batch starts at echo 0, or mid-echo after a resume
            self._echo_item = (item, self._echo_start)
            self._echo_start = 0
        (batch_idx, iter_after, input_state_after, batch), echo_i = self._echo_item
        t_dev0 = time.monotonic()
        transfer = isinstance(batch[0], np.ndarray)  # the first delivery transfers
        nbytes = sum(a.nbytes for a in batch) if transfer else 0  # 0 for an echo replay
        try:
            with _profiled("accvlab.pipeline.device_dispatch", batch=batch_idx, echo=echo_i,
                           bytes=nbytes):
                if transfer:
                    batch = self._transfer(batch, batch_idx)
                out = self.run_device_stage(batch, batch_idx, echo_i)
                if self._mesh is not None:
                    out = shard_batch(list(out), self._mesh)
        except Exception:
            self._exhausted = True
            self._echo_item = None
            raise
        t_dev1 = time.monotonic()
        self._stat_device_stage_s += t_dev1 - t_dev0
        self._stat_consumed += 1
        tr = self._trace
        if tr is not None:
            tr.complete("device_dispatch", "consumer", t_dev0, t_dev1 - t_dev0,
                        batch=batch_idx, echo=echo_i, bytes=nbytes)
        # batch delivered: advance the consumed position (the resume point)
        if echo_i + 1 < self._echo_factor:
            # keep the transferred batch for its next replay
            self._echo_item = ((batch_idx, iter_after, input_state_after, batch), echo_i + 1)
            self._consumed_global = batch_idx
            self._consumed_echo_next = echo_i + 1
        else:
            self._echo_item = None
            self._consumed_global = batch_idx + 1
            self._consumed_echo_next = 0
            self._consumed_iteration = iter_after
            self._consumed_input_state = input_state_after
        return [dict(zip(self._output_names, out))]

    def run(self):
        """Fetch one batch as a name-keyed dict (convenience around __next__)."""
        return self.__next__()[0]

    def _halt_producer(self):
        """Stop and join the producer thread, discard prefetched batches and
        any replays still due of the current host batch.

        Waits until the thread has exited (draining the queue so that a
        blocked ``put`` finishes): a producer still mid-batch would overwrite
        the counters ``set_state`` restores and advance a stateful input past
        the restored position. The wait is bounded, so an input stuck in
        external I/O raises instead of hanging ``reset()``/``set_state()``.
        """
        self._producer_stop.set()
        t = self._producer
        if t is not None and t.is_alive():
            t0 = time.monotonic()
            warn_at = t0 + 15.0
            while t.is_alive():
                try:
                    while True:
                        self._queue.get_nowait()
                except queue.Empty:
                    pass
                t.join(timeout=0.25)
                now = time.monotonic()
                if t.is_alive() and now >= warn_at:
                    warnings.warn(
                        "pipeline producer is still finishing its in-flight "
                        "host batch; waiting for it to stop cleanly"
                    )
                    warn_at = float("inf")
                if t.is_alive() and now - t0 >= _HALT_TIMEOUT_S:
                    raise RuntimeError(
                        f"pipeline producer did not stop within {_HALT_TIMEOUT_S:.0f}s: "
                        "the input callable appears stuck in external I/O. The "
                        "pipeline state is NOT safe for an exact resume."
                    )
        self._queue = queue.Queue(maxsize=self._depth)
        self._producer = None
        self._echo_item = None
        self._echo_start = 0
        self._consumed_echo_next = 0

    def _reset_from_iterator_front(self):
        """The reset an iterator front issues when it is constructed. The
        first one after :meth:`set_state` does nothing, so that the restored
        position is not discarded before a batch of the resumed run is
        consumed; a user's :meth:`reset` always resets."""
        if self._resume_armed:
            self._resume_armed = False
            return
        self.reset()

    def reset(self):
        """Start the next epoch (parity with the DALI iterator reset).

        A mid-epoch reset rolls the batch counter, which keys the device
        randomness, forward to the epoch's end when the input advertises
        its length, so the next epoch's batches equal an uninterrupted
        run's whatever the prefetch had produced.
        """
        self._resume_armed = False
        # a partly echoed batch means this epoch has delivered output even
        # when _iteration is 0; read it before _halt_producer clears it
        mid_echo = self._consumed_echo_next > 0 or self._echo_start > 0
        self._halt_producer()
        tr = self._trace
        if tr is not None:
            tr.instant("reset", "consumer", epoch=self._epoch)
        if self._exhausted or self._iteration > 0 or mid_echo:
            steps = getattr(self._definition._input, "length", None)  # host batches per epoch
            if steps is not None:
                # never back past batches the producer already keyed
                steps = max(int(steps), self._iteration)
                self._global_batch = self._global_batch - self._iteration + steps
            self._epoch += 1
        self._iteration = 0
        self._exhausted = False
        # prefetched batches were dropped: the consumed position re-syncs to
        # the producer counters, and the input's state is captured again at
        # the next producer start
        self._consumed_iteration = 0
        self._consumed_global = self._global_batch
        self._input_state_captured = False

    # ------------------------------------------------------------------ #
    # Checkpoint / resume                                                #
    # ------------------------------------------------------------------ #

    def get_state(self) -> dict:
        """JSON-serializable snapshot of the *consumed* position, in the JAX
        package's format (``version`` 1; ``echo`` with ``factor`` and
        ``next`` when ``echo_factor > 1``).

        Rebuild the pipeline with the same arguments and input and call
        :meth:`set_state` before the first ``__next__``: the batches then
        continue bit for bit, device randomness included, from the first
        batch the interrupted run did not consume.
        """
        if not self._input_state_captured:
            self._consumed_input_state = self._capture_input_state()
            self._input_state_captured = True
        state = {
            "version": 1,
            "epoch": self._epoch,
            "iteration": self._consumed_iteration,
            "global_batch": self._consumed_global,
            "input_state": self._consumed_input_state,
        }
        if self._echo_factor > 1:
            # global_batch points at the host batch to produce again; 'next'
            # is its first replay not yet delivered
            state["echo"] = {"factor": self._echo_factor, "next": self._consumed_echo_next}
        return state

    def set_state(self, state: dict):
        """Restore a position captured by :meth:`get_state`. Stops the
        producer (waiting for a batch in flight) and discards prefetched
        batches."""
        if state.get("version") != 1:
            raise ValueError(f"Unknown pipeline state version: {state.get('version')!r}")
        echo = state.get("echo")
        state_factor = 1 if echo is None else int(echo["factor"])
        if state_factor != self._echo_factor:
            raise ValueError(
                f"Checkpoint was taken with echo_factor={state_factor}; this "
                f"pipeline has echo_factor={self._echo_factor} — the delivered "
                "batch streams would diverge. Rebuild with the matching factor."
            )
        self._halt_producer()
        self._echo_start = 0 if echo is None else int(echo["next"])
        self._consumed_echo_next = self._echo_start
        self._epoch = int(state["epoch"])
        self._iteration = int(state["iteration"])
        self._global_batch = int(state["global_batch"])
        self._consumed_iteration = self._iteration
        self._consumed_global = self._global_batch
        self._exhausted = False
        input_state = state.get("input_state")
        if input_state is not None:
            if hasattr(self._definition._input, "set_state"):
                self._definition._input.set_state(input_state)
            else:
                warnings.warn(
                    "The checkpoint carries an input state (the input "
                    "implements get_state) but the input has no set_state — "
                    "the recorded position cannot be restored and the input "
                    "continues from its current (fresh-constructed) "
                    "position. Implement set_state, or carry the position "
                    "through constructor arguments."
                )
        elif isinstance(self._definition._input, IterableBase):
            warnings.warn(
                "Resuming a pipeline over an iterable input without a saved "
                "input state: the pipeline counters are restored, but the "
                "iterable continues from its current position — exact resume "
                "is only guaranteed for stateless inputs or iterables "
                "implementing get_state/set_state."
            )
        self._consumed_input_state = input_state
        # without an input snapshot, capture the input's own state at first use
        self._input_state_captured = input_state is not None
        self._resume_armed = True

    @property
    def length(self) -> Optional[int]:
        """Batches delivered per epoch when the input advertises its length:
        its host batches times ``echo_factor``; else ``None``."""
        n = getattr(self._definition._input, "length", None)
        return None if n is None else int(n) * self._echo_factor

    def stats(self) -> dict:
        """Live throughput/occupancy counters (the JAX executor's keys plus
        ``transfers`` and ``transfer_s``): ``produced`` (host batches built)
        / ``consumed`` (batches delivered, ``echo_factor`` per host batch),
        ``transfers``
        (host-to-device transfers, one per host batch), ``producer_busy_s``,
        ``producer_blocked_s``, ``consumer_wait_s``, ``device_stage_s``
        (transfer + enqueue of the device stage: the eager steps, or the
        program's copies and replay, with its trace and capture when a spec
        first goes through it; device work is asynchronous), ``transfer_s``
        (the part of ``device_stage_s`` spent in the transfers, counted once
        per host batch, not per echo replay: planning, packing into pinned
        staging and issuing the copy),
        ``queue_depth``/``queue_size``, ``bytes_per_batch`` (of the last
        transfer), ``input_bound_frac``, ``fused_stage_batches`` (the
        batches whose device stage sent the image chain through its kernel,
        :mod:`.image_chain`; eager or program) and ``program_cache``, the
        process-global shared-program cache's ``{hits, misses, declined,
        size}`` (:func:`..tools.program_cache_stats`; a rebuilt pipeline's
        device stage shows as a hit); with an ``ImageDecoder`` among the
        host steps (thread workers only), ``decoded_by``: the images each
        decoder took."""
        wait = self._stat_consumer_wait_s
        dev = self._stat_device_stage_s
        denom = wait + dev
        return {
            "produced": self._stat_produced,
            "consumed": self._stat_consumed,
            "transfers": self._stat_transfers,
            "producer_busy_s": self._stat_producer_busy_s,
            "producer_blocked_s": self._stat_producer_blocked_s,
            "consumer_wait_s": wait,
            "device_stage_s": dev,
            "transfer_s": self._stat_transfer_s,
            "queue_depth": self._depth,
            "queue_size": self._queue.qsize(),
            "bytes_per_batch": self._stat_transfer_bytes,
            "input_bound_frac": (wait / denom) if denom > 0.0 else 0.0,
            "fused_stage_batches": self._stat_fused_stage_batches,
            "program_cache": program_cache_stats(),
            **self._decoder_counts(),
        }

    def _decoder_counts(self) -> dict:
        counts = [s.decoded_by for s in self._host_steps if hasattr(s, "decoded_by")]
        if not counts or self._worker_mode == "process":
            return {}  # process workers decode with their own copies of the steps
        return {"decoded_by": {k: sum(c[k] for c in counts) for k in counts[0]}}

    def start_trace(self, max_events: int = 100_000):
        """Start recording the phase timeline (producer ``host_build`` and
        ``queue_put``, consumer ``consumer_wait`` and ``device_dispatch``,
        the instants ``epoch_end`` and ``reset``) into a
        :class:`~accvlab_tpu_torch.tools.chrome_trace.ChromeTraceRecorder`,
        which is returned (and handed back by :meth:`stop_trace`). One trace
        is active at a time. ``device_dispatch`` spans the transfer and the
        device steps' enqueue on the host; device time belongs to
        ``torch.profiler``."""
        if self._trace is not None:
            raise RuntimeError("a pipeline trace is already active (stop_trace() first)")
        from ..tools.chrome_trace import ChromeTraceRecorder

        trace = ChromeTraceRecorder(max_events=max_events)
        self._trace = trace
        return trace

    def stop_trace(self, path: Optional[str] = None):
        """Stop recording; optionally save to ``path`` (Chrome trace JSON).
        Returns the recorder. A producer span already in flight may still
        append to it after this call, after the ``path`` snapshot was
        written: for the complete picture call ``trace.save(path)`` once the
        pipeline is quiescent (after ``stop()`` or an epoch end). A later
        :meth:`start_trace` gets a fresh recorder."""
        trace = self._trace
        if trace is None:
            raise RuntimeError("no active pipeline trace (start_trace() first)")
        self._trace = None
        if path is not None:
            trace.save(path)
        return trace

    def stop(self):
        """Shut down the producer thread and the worker pool."""
        self._halt_producer()
        if self._pool is not None:
            self._pool.shutdown(wait=False)
        if self._workers is not None:
            self._workers.shutdown()
            self._workers = None

    @property
    def output_blueprint(self) -> SampleDataGroup:
        return self._output_blueprint.get_empty_like_self()

    @property
    def output_names(self):
        return self._output_names
