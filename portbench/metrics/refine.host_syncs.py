"""refine.host_syncs: Synchronising CUDA calls the host made a request between its first and last phase marks (spans.py)."""

from portbench.spans import phase_value


def read(ctx):
    return phase_value(ctx, "step", "sync_calls")
