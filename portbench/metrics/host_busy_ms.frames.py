"""The host stage's time per host batch on the raw-frames wire: the change
of ``TorchPipeline.stats()["producer_busy_s"]`` over the window, per host
batch produced."""


def read(ctx):
    pipe = ctx["pipeline"]
    if not pipe["produced"]:
        return None
    return 1e3 * pipe["producer_busy_s"] / pipe["produced"]
