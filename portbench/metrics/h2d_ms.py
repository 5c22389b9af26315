"""Host-to-card copies per step: the profiler's ``Memcpy HtoD`` rows in the
profiled stretch, summed, per step."""


def read(ctx):
    prof = ctx.get("profile")
    if not prof:
        return None
    total = sum(d for name, _, d in prof["rows"] if "HtoD" in name)
    return 1e3 * total / prof["steps"]
