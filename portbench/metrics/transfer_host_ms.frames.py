"""The host's time to plan, pack into pinned staging and issue a batch's
copy to the card, on the raw-frames wire: the change of
``TorchPipeline.stats()["transfer_s"]`` over the window, per transfer."""


def read(ctx):
    pipe = ctx["pipeline"]
    if "transfer_s" not in pipe or not pipe.get("transfers"):
        return None
    return 1e3 * pipe["transfer_s"] / pipe["transfers"]
