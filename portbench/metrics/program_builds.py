"""Device programs built during the window: misses of
``program_cache_stats()``. Set-up runs the cell's spec to its program, so a
steady pipeline reads 0."""


def read(ctx):
    return float(ctx["program_cache"]["misses"])
