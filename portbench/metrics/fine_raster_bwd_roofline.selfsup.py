"""fine_raster_bwd_roofline.selfsup: The kernel's share of its roofline on the traced window's first calls."""

from portbench.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "fine_raster_bwd", "fine_raster_bwd_kernel")
