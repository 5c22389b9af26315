"""The host's time to plan, pack into pinned staging and issue a batch's
copy to the card, on the raw-frames wire: the change of
``TorchPipeline.stats()["transfer_s"]`` from the close of the profiled
stretches to the window's close, per transfer in those steps, which the
profiler does not slow."""


def read(ctx):
    pipe = ctx.get("pipeline_unprofiled") or {}
    if "transfer_s" not in pipe or not pipe.get("transfers"):
        return None
    return 1e3 * pipe["transfer_s"] / pipe["transfers"]
