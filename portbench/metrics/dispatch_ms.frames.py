"""The consumer's host time in ``TorchPipeline.run()`` once its batch is in
hand, on the raw-frames wire: the change of
``TorchPipeline.stats()["device_stage_s"]`` (the transfer and the device
stage's enqueue) over the window, per batch delivered."""


def read(ctx):
    pipe = ctx["pipeline"]
    if "device_stage_s" not in pipe or not pipe["consumed"]:
        return None
    return 1e3 * pipe["device_stage_s"] / pipe["consumed"]
