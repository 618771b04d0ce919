"""refined.refiner_render_ms: The in-step refiner's render phases (boxes, zoom, projection, binning, B1 at the zoom, crop) a step, summed over its iterations, on the card's clock from the step's mark hook."""

from portbench.readers import phase_ms


def read(ctx):
    return phase_ms(ctx, "render")
