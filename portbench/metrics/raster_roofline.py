"""The heatmap rasterizer's share of its roofline: the least time of one
launch over a batch (``flops.raster_bound_s``: the maps read and written
once and the targets read once at the memory's rate) over the profiler's
mean ``draw_heatmap_kernel`` time in the profiled stretch."""

from portbench import flops


def read(ctx):
    prof, peak = ctx.get("profile"), ctx.get("peaks")
    if not prof or not peak:
        return None
    times = [d for name, _, d in prof["rows"] if "draw_heatmap" in name]
    if not times:
        return None
    return 100.0 * flops.raster_bound_s(ctx["config"], peak) / (sum(times) / len(times))
