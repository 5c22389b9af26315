"""The CenterNet step's share of the card's dense bf16 peak: its operations
(``flops.centernet_step``) over the device stretch's time per step, from
its first device row to its last (``window_s / steps``), which holds every
step of the stretch whole."""


def read(ctx):
    peak, prof = ctx.get("peaks"), ctx.get("profile")
    if not peak or not prof or not prof["window_s"]:
        return None
    return 100.0 * ctx["step_flops"] * prof["steps"] / prof["window_s"] / peak["bf16_flops"]
