"""The system under test: the port's pipeline feeding the port's training
step.

Everything here calls the program (``accvlab_tpu_torch``) through its public
entry points, as a training job would. The benchmark adds its own data
provider (:func:`..data.provider`), the network that the job trains
(:mod:`..network`) and its weights.

Each step takes ``TorchPipeline.run()``'s next batch, through
``train_centernet_e2e.batch_to_train_inputs``, into
``models.centernet.make_train_step``'s step with the port's Adam.

``fault`` plants one of the faults that the check has to catch: ``frozen``
(the step leaves its state unchanged), ``half_batch`` (half of the batch
left out, the mean taken over the rest), or an answer altered where the
pipeline hands it out, in camera 0 of the batch's first sample:
``altered_image`` (its image one 8-bit level brighter), ``altered_heatmap``
(its heatmap cleared) or ``altered_target`` (its first target's flag
flipped).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch

from . import data

FAULTS = ("frozen", "half_batch", "altered_image", "altered_heatmap", "altered_target")


def load_weights(model: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy the benchmark's leaves into ``model``; the names and shapes have
    to be the configuration's."""
    named = dict(model.named_parameters())
    if set(named) != set(weights):
        raise RuntimeError("the model's parameters are not the configuration's: "
                           f"{sorted(set(named) ^ set(weights))}")
    with torch.no_grad():
        for name, p in named.items():
            if tuple(p.shape) != tuple(weights[name].shape):
                raise RuntimeError(f"{name}: the model has {tuple(p.shape)}, the configuration "
                                   f"{tuple(weights[name].shape)}")
            p.copy_(weights[name])


def build_pipeline(config: dict, traffic: dict, inputs: data.Inputs, seed: int, device):
    """The configuration's pipeline over the benchmark's inputs, in sample
    order, seeded with ``seed``."""
    from accvlab_tpu_torch.bench_pipeline import headline_steps
    from accvlab_tpu_torch.pipeline import PipelineDefinition
    from accvlab_tpu_torch.pipeline.inputs import ShuffledShardedInputCallable

    if traffic["wire"] != "frames":
        raise NotImplementedError(f"wire {traffic['wire']!r}: only raw frames are checked")
    b = int(config["batch_size"])
    prov = data.provider(inputs, config)
    inp = ShuffledShardedInputCallable(prov, batch_size=b, shuffle=False)
    aug = config["augment"]
    steps = headline_steps(tuple(config["out_hw"]), tuple(config["heatmap_hw"]),
                           num_classes=config["num_classes"], affine_prob=aug["affine"]["prob"],
                           photometric_prob=aug["photometric"]["prob"], hw_out_name="hw")
    definition = PipelineDefinition(inp, steps, check_data_format=False,
                                    copy_external_source_passthrough_outputs=False)
    return definition.get_pipeline(batch_size=b, num_threads=traffic.get("num_threads") or
                                   max(2, os.cpu_count() or 4),
                                   device=device, seed=seed,
                                   worker_mode=traffic.get("worker_mode", "thread"),
                                   echo_factor=int(traffic.get("echo_factor", 1)))


class Feed:
    """Hands out the pipeline's batches, the ``k``-th from host batch
    ``source(k)``."""

    def __init__(self, config: dict, traffic: dict, inputs: data.Inputs, seed: int, device,
                 fault: Optional[str]):
        self.echo = int(traffic.get("echo_factor", 1))
        self.pipe = build_pipeline(config, traffic, inputs, seed, device)
        self.fault = fault
        self.count = 0

    def _altered(self, out: dict) -> dict:
        what = {"altered_image": "image", "altered_heatmap": "annotations.heatmap",
                "altered_target": "annotations.active"}.get(self.fault)
        if what is None:
            return out
        key = f"cameras.[0].{what}"
        value = out[key].clone()
        if what == "image":
            value[0] += 1.0 / 57.4
        elif what == "annotations.heatmap":
            value[0] = 0.0
        else:
            value[0, 0] = ~value[0, 0]
        return {**out, key: value}

    def next(self) -> dict:
        self.count += 1
        return self._altered(self.pipe.run())

    def source(self, k: int):
        """``(host batch, echo or None)`` of the ``k``-th handed-out batch."""
        return (k // self.echo, k % self.echo if self.echo > 1 else None)

    def stats(self) -> dict:
        return dict(self.pipe.stats())

    def close(self) -> None:
        if self.pipe is not None:
            self.pipe.stop()
            self.pipe = None


class Step:
    """``models.centernet.make_train_step``'s step, with the port's Adam, on
    every camera of a batch, training :class:`..network.CenterNetResNet`."""

    def __init__(self, config: dict, weights, device, fault: Optional[str]):
        from accvlab_tpu_torch.models.centernet import adam, make_train_step
        from accvlab_tpu_torch.train_centernet_e2e import batch_to_train_inputs

        from .network import CenterNetResNet

        self.cams = list(range(int(config["num_cams"])))
        self.to_inputs = batch_to_train_inputs
        with torch.device(device):
            self.model = CenterNetResNet(config)
        load_weights(self.model, weights)
        _, self.train_step = make_train_step(self.model)
        self.opt = adam(self.model.parameters())
        self.b1 = self.opt.defaults["betas"][0]
        self.fault = fault
        if fault == "frozen":
            self.opt.step = lambda *a, **k: None

    def __call__(self, out: dict) -> torch.Tensor:
        if self.fault == "half_batch":
            half = next(iter(out.values())).shape[0] // 2
            out = {k: v[:half] for k, v in out.items()}
        _, _, metrics = self.train_step(self.model, self.opt, self.to_inputs(out, cam=self.cams))
        return metrics["loss"]

    def named(self):
        return list(self.model.named_parameters())

    def first_grads(self) -> Dict[str, torch.Tensor]:
        """The first step's gradient as Adam holds it: ``exp_avg / (1 - b1)``."""
        return {n: (self.opt.state[p]["exp_avg"] / (1 - self.b1)).clone()
                if p in self.opt.state else torch.zeros_like(p) for n, p in self.named()}

    def params(self) -> Dict[str, torch.Tensor]:
        return {n: p.detach().clone() for n, p in self.named()}

    def close(self) -> None:
        del self.model, self.opt
