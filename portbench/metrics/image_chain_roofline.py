"""The image chain's kernel's share of its roofline: the least time of one
launch over a camera field of a batch (``flops.image_chain_bound_s``: the
source frames read once and the float32 images written once at the
memory's rate) over the profiler's mean ``image_chain_kernel`` time in the
profiled stretch."""

from portbench import flops


def read(ctx):
    prof, peak = ctx.get("profile"), ctx.get("peaks")
    if not prof or not peak:
        return None
    times = [d for name, _, d in prof["rows"] if "image_chain_kernel" in name]
    if not times:
        return None
    return 100.0 * flops.image_chain_bound_s(ctx["config"], peak) / (sum(times) / len(times))
