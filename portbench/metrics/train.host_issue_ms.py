"""train.host_issue_ms: The host's milliseconds a step from its first phase mark to its last, less its time blocked in CUDA calls over 100 us (spans.py)."""

from portbench.spans import phase_value


def read(ctx):
    return phase_value(ctx, "step", "own_ms")
