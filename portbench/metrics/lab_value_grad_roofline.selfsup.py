"""lab_value_grad_roofline.selfsup: The kernel's share of its roofline on the traced window's first calls."""

from portbench.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "lab_value_grad", "lab_kernel")
