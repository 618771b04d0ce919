"""mfu.refine: The window's model FLOPs over its seconds, as a share of the card's bf16 peak."""

from portbench.readers import mfu_pct


def read(ctx):
    return mfu_pct(ctx)
