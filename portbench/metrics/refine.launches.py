"""refine.launches: Kernel launches, copies and fills the host issued a request between its first and last phase marks (spans.py)."""

from portbench.spans import phase_value


def read(ctx):
    return phase_value(ctx, "step", "launches")
