"""Mean card time of a CenterNet training step: from the CUDA event recorded
once the step's batch is in hand to the one recorded after the step, over
the traced run's steps after its profiled stretches. The feed's own work
stays outside; time that the step's stream spends waiting for the batch's
copy or device stage counts."""


def read(ctx):
    times = ctx["step_device_ms"]
    return sum(times) / len(times) if times else None
