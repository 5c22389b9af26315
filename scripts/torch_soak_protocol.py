"""Randomized protocol soak over the port's TorchPipeline: resume, echo,
elastic resharding, wire and worker mode composed (the counterpart of
``scripts/soak_protocol.py``).

The in-suite tests cover each protocol axis deeply but briefly; this script
is the long-horizon campaign: random CONFIGS (wire format x echo factor x
worker mode x prefetch depth x batch size) crossed with random SCENARIOS,
for as many trials as a wall-clock budget allows. Two scenarios:

* ``resume_chain`` — an oracle pipeline delivers the uninterrupted stream
  (2 epochs); a chain of pipelines then reproduces it, handing off through
  ``get_state``/``set_state`` at random positions (mid-epoch, mid-echo,
  epoch boundaries). Every delivered batch must be BIT-identical to the
  oracle at its stream position (the TorchPipeline checkpoint contract).
  The device stage runs a leaf spec's first ``EAGER_BATCHES_PER_SPEC``
  batches eagerly and later ones through the shared program, and a rebuilt
  pipeline finds the program by value and replays it from its first batch;
  so one stream position may run eagerly in one pipeline and by replay in
  the other. Each trial counts the compared positions by how the oracle and
  the chain ran them.
* ``elastic_chain`` — a W-shard fleet of pipelines over an index-revealing
  provider runs in lockstep; at random points a checkpoint from shard 0 is
  translated by ``elastic_reshard`` into a NEW fleet of W' shards. Every
  lockstep step's freshly-produced ids must equal the per-epoch
  permutation slice at the running offset — exactly-once consumption under
  chained W -> W' -> W'' reshards (the ``ElasticShardedInputCallable``
  contract), including mid-echo checkpoints (the in-flight batch restarts
  at echo 0 on the new fleet).

The pipelines run on the card unless given ``--device cpu``. Failures print
the trial's config + seed (the repro key) and the campaign continues; the
exit code reflects whether any trial failed.

Usage::

    python scripts/torch_soak_protocol.py --minutes 20 [--seed 0] [--device cpu]
"""

import argparse
import io
import os
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from accvlab_tpu_torch._device import resolve_device
from accvlab_tpu_torch.hostcopy import start_copy
from accvlab_tpu_torch.pipeline import DType, PipelineDefinition, SampleDataGroup
from accvlab_tpu_torch.pipeline.inputs import (
    DataProvider,
    ElasticShardedInputCallable,
    ShuffledShardedInputCallable,
    elastic_reshard,
)
from accvlab_tpu_torch.pipeline.processing_steps import (
    DCTWirePacker,
    DCTWireUnpacker,
    ImageDecoder,
    ImageRange01Normalizer,
    PhotoMetricDistorter,
    WirePlanePacker,
    WirePlaneUnpacker,
    YCbCrToRGBConverter,
)
from accvlab_tpu_torch.tools import program_cache_stats

SRC_HW = (64, 96)
OUT_HW = (48, 64)
EPOCHS = 2


def make_jpegs(n, seed):
    from PIL import Image

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        base = rng.integers(0, 255, (SRC_HW[0] // 8, SRC_HW[1] // 8, 3), np.uint8)
        img = np.asarray(
            Image.fromarray(base).resize((SRC_HW[1], SRC_HW[0]), Image.BILINEAR),
            np.uint8,
        )
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="JPEG", quality=88)
        out.append(np.frombuffer(buf.getvalue(), np.uint8).copy())
    return out


class JpegProvider(DataProvider):
    """Module-level (picklable for worker_mode='process')."""

    def __init__(self, jpegs):
        self._jpegs = jpegs

    @property
    def sample_data_structure(self):
        s = SampleDataGroup()
        s.add_data_field("image", DType.UINT8)
        return s

    def get_data(self, idx):
        s = self.sample_data_structure
        s["image"] = self._jpegs[idx % len(self._jpegs)]
        return s

    def get_number_of_samples(self):
        return len(self._jpegs)


class IdxProvider(DataProvider):
    """Single int32 field that IS the sample index (elastic accounting)."""

    def __init__(self, n):
        self._n = n

    @property
    def sample_data_structure(self):
        s = SampleDataGroup()
        s.add_data_field("idx", DType.INT32)
        return s

    def get_data(self, idx):
        s = self.sample_data_structure
        s["idx"] = np.asarray([idx], np.int32)
        return s

    def get_number_of_samples(self):
        return self._n


def wire_steps(wire):
    if wire == "dct":
        head = [
            DCTWirePacker("image", SRC_HW, OUT_HW, num_threads=1),
            DCTWireUnpacker("image", SRC_HW, OUT_HW),
            YCbCrToRGBConverter("image"),
        ]
    elif wire == "yuv_packed":
        head = [
            ImageDecoder("image", decode_resize_hw=OUT_HW, wire_format="yuv420"),
            WirePlanePacker(["image", "image_cbcr"]),
            WirePlaneUnpacker(["image", "image_cbcr"]),
            YCbCrToRGBConverter("image"),
        ]
    elif wire == "rgb":
        head = [ImageDecoder("image")]
    else:
        raise ValueError(wire)
    return head + [
        PhotoMetricDistorter(
            "image",
            min_max_brightness=[-16.0, 16.0],
            min_max_hue=[-10.0, 10.0],
            min_max_contrast=[0.8, 1.2],
            min_max_saturation=[0.8, 1.2],
        ),
        ImageRange01Normalizer("image"),
    ]


def sample_config(rng):
    return {
        "wire": rng.choice(["dct", "yuv_packed", "rgb"]),
        "echo": int(rng.choice([1, 2, 3])),
        "worker_mode": str(rng.choice(["thread", "thread", "process"])),
        "depth": int(rng.choice([1, 2, 3])),
        "batch_size": int(rng.choice([2, 3])),
        "seed": int(rng.integers(0, 2**31)),
    }


def _arrays(batch):
    """A delivered batch on the host (through the packed device-to-host copy
    when it lies on the card), as numpy arrays of its own."""
    return {k: np.array(v.numpy()) for k, v in start_copy(batch, device="cpu").get().items()}


def stage_mode(pipe) -> str:
    """How the pipeline's last delivered batch went through its device
    stage: ``"program"`` (the shared program) or ``"eager"``."""
    specs = pipe._last_device_spec[0]
    entry = pipe._stage_specs.get(specs)
    return "program" if entry and entry[2] and not pipe._eager_stage else "eager"


# --------------------------------------------------------------------------- #
# scenario 1: chained bit-exact resume
# --------------------------------------------------------------------------- #


def run_resume_chain(cfg, jpegs, rng, device=None):
    """The oracle's stream, then the chain's, position by position. Returns
    ``{"positions", "modes"}``: the compared positions and their count per
    ``"<oracle>/<chain>"`` stage mode (``eager`` or ``program``)."""
    dev = resolve_device(device)

    def build():
        inp = ShuffledShardedInputCallable(
            JpegProvider(jpegs), batch_size=cfg["batch_size"], shuffle=True
        )
        defn = PipelineDefinition(
            inp, wire_steps(cfg["wire"]),
            copy_external_source_passthrough_outputs=False,
        )
        return defn.get_pipeline(
            batch_size=cfg["batch_size"],
            num_threads=1,
            device=dev,
            seed=cfg["seed"],
            prefetch_queue_depth=cfg["depth"],
            worker_mode=cfg["worker_mode"],
            echo_factor=cfg["echo"],
        )

    # oracle: the uninterrupted delivered stream across EPOCHS epochs
    pipe = build()
    stream, oracle_modes = [], []
    try:
        for _ in range(EPOCHS):
            while True:
                try:
                    stream.append(_arrays(pipe.run()))
                except StopIteration:
                    break
                oracle_modes.append(stage_mode(pipe))
            pipe.reset()
    finally:
        pipe.stop()

    # chained resume: random segment lengths, state handoff between
    # pipelines; epoch boundaries advance via reset() like the oracle.
    # Observability calls (tracing, stats, device_program_text) interleave
    # randomly — they must never perturb the bit-exact stream.
    modes = {}
    pipe = build()
    pos = 0
    tracing = False
    delivered = False  # a batch delivered on the CURRENT pipeline object
    try:
        while pos < len(stream):
            seg = int(rng.integers(1, 6))
            for _ in range(seg):
                if pos >= len(stream):
                    break
                r = rng.random()
                if r < 0.10 and not tracing:
                    pipe.start_trace()
                    tracing = True
                elif r < 0.20 and tracing:
                    pipe.stop_trace()
                    tracing = False
                elif r < 0.25:
                    pipe.stats()
                elif r < 0.30 and delivered:
                    txt = pipe.device_program_text()
                    assert "float64" not in txt  # JAX's "f64" check
                try:
                    got = _arrays(pipe.run())
                except StopIteration:
                    pipe.reset()
                    continue
                exp = stream[pos]
                if set(got) != set(exp):
                    raise AssertionError(
                        f"field sets differ at pos {pos}: {set(got)} vs {set(exp)}"
                    )
                for k in exp:
                    np.testing.assert_array_equal(
                        got[k], exp[k], err_msg=f"pos {pos} field {k}"
                    )
                key = f"{oracle_modes[pos]}/{stage_mode(pipe)}"
                modes[key] = modes.get(key, 0) + 1
                pos += 1
                delivered = True
            if pos >= len(stream):
                break
            state = pipe.get_state()
            pipe.stop()
            tracing = False
            delivered = False
            per_epoch = len(stream) // EPOCHS
            if rng.random() < 0.15 and pos % per_epoch:
                # a USER reset right after set_state is a genuine epoch
                # restart (only the iterator-front construction reset is
                # swallowed): the oracle position jumps to the next epoch
                # boundary
                pipe = build()
                pipe.set_state(state)
                pipe.reset()
                pos = min((pos // per_epoch + 1) * per_epoch, len(stream))
                continue
            pipe = build()
            pipe.set_state(state)
    finally:
        pipe.stop()
    return {"positions": len(stream), "modes": modes}


# --------------------------------------------------------------------------- #
# scenario 2: chained elastic reshard accounting
# --------------------------------------------------------------------------- #


def _build_fleet(cfg, provider_n, num_shards, input_kwargs, device=None):
    fleet = []
    for s in range(num_shards):
        inp = ElasticShardedInputCallable(
            IdxProvider(provider_n),
            cfg["batch_size"],
            shard_id=s,
            num_shards=num_shards,
            shuffle=True,
            seed=7,
            **input_kwargs,
        )
        defn = PipelineDefinition(
            inp, [], copy_external_source_passthrough_outputs=False
        )
        fleet.append(
            defn.get_pipeline(
                batch_size=cfg["batch_size"],
                num_threads=1,
                device=device,
                seed=cfg["seed"],
                prefetch_queue_depth=cfg["depth"],
                worker_mode="thread",
                echo_factor=cfg["echo"],
            )
        )
    return fleet


def run_elastic_chain(cfg, rng, device=None):
    dev = resolve_device(device)
    N = int(rng.integers(40, 80))
    B = cfg["batch_size"]
    E = cfg["echo"]
    n_epochs = 2

    def perm(epoch):
        return np.random.default_rng(seed=7 + epoch).permutation(N)

    W = int(rng.integers(1, 5))
    fleet = _build_fleet(cfg, N, W, {}, dev)
    offset = 0  # consumed prefix of the current epoch's permutation
    epoch = 0
    echo_next = 0  # delivery sub-position within the current host batch
    pending = None  # ids of the in-flight (partially delivered) host batch
    try:
        while epoch < n_epochs:
            # run one DELIVERY on every shard (lockstep)
            try:
                rows = [p.run()["idx"].cpu().numpy().ravel() for p in fleet]
            except StopIteration:
                # all shards hit the epoch end together (lockstep contract)
                if pending is not None:
                    raise AssertionError("epoch ended with an in-flight batch")
                # exactly-once: every full global batch of the epoch's
                # permutation was delivered before the epoch ended
                remaining = (N - offset) // (B * W)
                if remaining != 0:
                    raise AssertionError(
                        f"epoch ended with {remaining} undelivered full "
                        f"batches (N={N} offset={offset} B={B} W={W})"
                    )
                for p in fleet[1:]:
                    try:
                        p.run()
                        raise AssertionError("shards disagree on epoch end")
                    except StopIteration:
                        pass
                for p in fleet:
                    p.reset()
                epoch += 1
                offset = 0
                continue
            ids = np.concatenate(rows)
            if echo_next == 0:
                # fresh host batch: ids must be EXACTLY the permutation
                # slice at the running offset
                exp = perm(epoch)[offset : offset + B * W]
                np.testing.assert_array_equal(
                    np.sort(ids), np.sort(exp),
                    err_msg=f"epoch {epoch} offset {offset} (W={W})",
                )
                pending = ids
            else:
                np.testing.assert_array_equal(
                    np.sort(ids), np.sort(pending),
                    err_msg=f"echo replay differs (echo {echo_next})",
                )
            echo_next += 1
            if echo_next == E:
                offset += B * W
                echo_next = 0
                pending = None
            # random reshard point (possibly mid-echo)
            if rng.random() < 0.15:
                state = fleet[0].get_state()
                for p in fleet:
                    p.stop()
                W = int(rng.integers(1, 5))
                input_kwargs, new_state = elastic_reshard(state)
                fleet = _build_fleet(cfg, N, W, input_kwargs, dev)
                for p in fleet:
                    p.set_state(new_state)
                # the documented contract: consumed prefix moves into the
                # input offset; an in-flight batch restarts at echo 0
                assert input_kwargs["start_offset"] == offset, (
                    f"elastic_reshard start_offset {input_kwargs['start_offset']} "
                    f"!= tracked consumed prefix {offset}"
                )
                assert input_kwargs["start_epoch"] == epoch
                echo_next = 0
                pending = None
    finally:
        for p in fleet:
            p.stop()
    return n_epochs


# --------------------------------------------------------------------------- #


def _cache_delta(before: dict) -> dict:
    now = program_cache_stats()
    return {k: now[k] - before[k] for k in ("hits", "misses", "declined")}


def campaign(seconds, seed=0, device=None, out=print) -> dict:
    """Trials for ``seconds`` from the master seed ``seed``; ``out`` gets
    one line per trial. Returns ``{"trials", "failures", "failed",
    "modes"}``: the repro keys of the failed trials and the compared
    positions per oracle/chain stage mode over every resume chain."""
    jpegs = make_jpegs(10, seed=123)
    deadline = time.time() + seconds
    master = np.random.default_rng(seed)
    trials = fails = 0
    failed, modes = [], {}
    t0 = time.time()
    while time.time() < deadline:
        trial_seed = int(master.integers(0, 2**31))
        rng = np.random.default_rng(trial_seed)
        cfg = sample_config(rng)
        scenario = str(rng.choice(["resume_chain", "elastic_chain"]))
        trials += 1
        t1 = time.time()
        before = program_cache_stats()
        try:
            if scenario == "resume_chain":
                res = run_resume_chain(cfg, jpegs, rng, device)
                for k, v in res["modes"].items():
                    modes[k] = modes.get(k, 0) + v
                n = f"{res['positions']} positions, {res['modes']}"
            else:
                n = f"{run_elastic_chain(cfg, rng, device)} epochs"
            out(f"[{time.time() - t0:7.1f}s] trial {trials} OK  {scenario:13s} {cfg} ({n}, "
                f"program cache {_cache_delta(before)}, {time.time() - t1:.1f}s)")
        except Exception:
            fails += 1
            failed.append({"scenario": scenario, "cfg": {k: str(v) for k, v in cfg.items()},
                           "trial_seed": trial_seed})
            out(f"[{time.time() - t0:7.1f}s] trial {trials} FAIL {scenario} "
                f"cfg={cfg} trial_seed={trial_seed}\n{traceback.format_exc()}")
    return {"trials": trials, "failures": fails, "failed": failed, "modes": modes}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--minutes", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="'cpu' for the CPU (default: the card)")
    args = ap.parse_args()

    res = campaign(args.minutes * 60, args.seed, args.device,
                   out=lambda line: print(line, flush=True))
    print(f"\nsoak: {res['trials']} trials, {res['failures']} failures; compared positions "
          f"by oracle/chain stage mode {res['modes']}", flush=True)
    sys.exit(1 if res["failures"] else 0)


if __name__ == "__main__":
    main()
