"""The device stage's card time per batch on the raw-frames wire: the
device time of the rows launched inside the program's
``accvlab.pipeline.stage`` ranges (the program's replay, or the eager
steps) in the host-traced stretch, per range."""


def read(ctx):
    stages = [r["device_s"] for r in ctx.get("spans", {}).get("ranges", ())
              if r["name"] == "pipeline.stage"]
    return 1e3 * sum(stages) / len(stages) if stages else None
