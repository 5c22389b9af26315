"""The port's Adam on the card, per step: the device time of the rows
launched inside the training step's ``accvlab.train_step.optimizer``
ranges (``zero_grad`` and ``step``) in the host-traced stretch, over its
steps."""


def read(ctx):
    spans = ctx.get("spans")
    opt = [r["device_s"] for r in spans["ranges"]
           if r["name"] == "train_step.optimizer"] if spans else []
    return 1e3 * sum(opt) / spans["steps"] if opt else None
