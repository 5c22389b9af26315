"""The networks that the benchmark trains, one module per family, found by
name.

A configuration's file names its family under ``"family"``; a file without
the key is CenterNet's, the one family that predates the key.
``spec.load_family`` reads ``families/<family>.py`` as ``spec.load_reader``
reads a metric, so a family is added by files alone. A family module gives:

* ``make_inputs(seed, cfg, traffic)``: the run's inputs, made from
  ``seed`` on the host; both sides take them.
* ``leaf_specs(cfg)``: ``(name, shape, init)`` of every parameter, as
  ``reference.layers.make_leaves`` draws them on the card.
* ``Feed(cfg, traffic, inputs, seed, device, fault)``: the program's input
  path. ``next()`` hands out the next batch, ``count`` the batches handed
  out, ``source(k)`` what the ``k``-th was made from (an argument of
  ``reference_batch``), ``stats()`` the program's counters (numbers, each
  read as its change over the window), ``close()``.
* ``Step(cfg, weights, device, fault)``: the program's training step from
  ``weights`` (``{name: tensor}``). Called on a batch, it steps and
  returns the loss as a tensor, read only after the window; any state
  carried from step to step stays inside it. ``first_grads()``: the first
  step's gradient as the optimizer holds it; ``params()``: the parameters
  now; ``close()`` frees the step.
* ``reference_batch(inputs, cfg, seed, source, device, low=False)``: the
  reference's batch of ``source``; ``low``: the control's, one precision
  step down.
* ``reference_steps(cfg, weights, batches, low)``: the plain reference's
  steps from ``weights`` over ``batches``: ``{"losses", "grads" (the
  first), "params" (after the last)}``. It owns its optimizer and any
  carried state; ``low``: the control's precision.
* ``flat(batch)``: a reference batch as the program hands its batches out
  (the control's outputs).
* ``pipeline_numbers(outputs, batches, cfg)``: the numbers that compare
  the program's batches with the reference's, ``{name: value}``.
* ``step_flops(cfg)``: the operations of one training step.
* ``FAULTS``: the faults ``Feed`` and ``Step`` can plant.
* ``tiny(cfg, traffic)``: cuts both, in place, to a size that a CPU test
  holds.

What a family reads from the program goes through the program's public
entry points; its plain reference lives under ``reference/`` and imports
nothing of the program.
"""

from __future__ import annotations

from typing import Dict

#: the family of a configuration that names none
DEFAULT = "centernet"


def load_weights(model, weights: Dict) -> None:
    """Copy the benchmark's leaves into ``model`` (a ``torch.nn.Module``);
    the names and shapes have to be the configuration's."""
    import torch

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
