"""refined.refiner_network_ms: The in-step refiner's network forwards (FlowNetS) a step, summed over its iterations, on the card's clock from the step's mark hook."""

from portbench.readers import phase_ms


def read(ctx):
    return phase_ms(ctx, "network_fwd")
