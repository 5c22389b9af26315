"""The port's CenterNet loss forward on the card, per step: the device time
of the rows launched inside the training step's
``accvlab.train_step.loss`` ranges in the host-traced stretch, over its
steps."""


def read(ctx):
    spans = ctx.get("spans")
    loss = [r["device_s"] for r in spans["ranges"]
            if r["name"] == "train_step.loss"] if spans else []
    return 1e3 * sum(loss) / spans["steps"] if loss else None
