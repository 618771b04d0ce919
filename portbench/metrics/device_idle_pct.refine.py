"""device_idle_pct.refine: The share of the traced window with no operation on the device."""

from portbench.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
