"""refine.render_ms: The phase's mean milliseconds a step (a request for refine) on the card's clock, from the step's mark hook."""

from portbench.readers import phase_ms


def read(ctx):
    return phase_ms(ctx, "render")
