"""fine_raster_fwd_roofline.refined: B1's share of its roofline on the traced window's first calls: the refiner's renders at its zoom and the student's render, in the order the step makes them."""

from portbench.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "fine_raster_fwd", "fine_raster_fwd_kernel")
