"""The share of the profiled stretch in which nothing ran on the card: one
minus the union of the device rows over the stretch's length."""


def read(ctx):
    prof = ctx.get("profile")
    if not prof or not prof["window_s"]:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
