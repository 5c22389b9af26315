"""What a step waited for its batch on the raw-frames wire: the change of
``TorchPipeline.stats()["consumer_wait_s"]`` over the window, per batch
delivered."""


def read(ctx):
    pipe = ctx["pipeline"]
    if not pipe["consumed"]:
        return None
    return 1e3 * pipe["consumer_wait_s"] / pipe["consumed"]
