"""refine.render_host_ms: The host's milliseconds a request in the render phases (boxes, projection, binning, packing, B1, crop), less its time blocked in CUDA calls over 100 us (spans.py)."""

from portbench.spans import phase_value


def read(ctx):
    return phase_value(ctx, "render", "own_ms")
