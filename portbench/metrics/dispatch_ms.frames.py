"""The consumer's host time in ``TorchPipeline.run()`` once its batch is in
hand, on the raw-frames wire: the change of
``TorchPipeline.stats()["device_stage_s"]`` (the transfer and the device
stage's enqueue) from the close of the profiled stretches to the window's
close, per batch delivered in those steps, which the profiler does not
slow."""


def read(ctx):
    pipe = ctx.get("pipeline_unprofiled") or {}
    if "device_stage_s" not in pipe or not pipe.get("consumed"):
        return None
    return 1e3 * pipe["device_stage_s"] / pipe["consumed"]
