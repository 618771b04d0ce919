"""refined.refiner_render_host_ms: The host's milliseconds a step in the in-step refiner's render phases, summed over its iterations, less its time blocked in CUDA calls over 100 us (spans.py). The step's phases are split by the names its marks had, in order (the cell kind's mark_names), since the refiner's repeat within a step."""

from portbench import spans


def read(ctx):
    cell, events = getattr(ctx, "cell", None), getattr(ctx, "events", None)
    names = getattr(cell, "mark_names", None)
    if not names or not events:
        return None
    sp = spans.mark_spans(events, cell.traffic["profiled_steps"], names)
    if not sp:
        return None
    return spans.table(sp, events).get("render", {}).get("own_ms")
