"""The LAB opaque probe (port of tools/probes/lab_opaque_probe.py): the
whole flagship stage-II step in its split_lab form, its LAB gradient made
inside the step by an opaque kernel and re-entering the backward only
through InjectGrad's add on the masked render's cotangent.

Four variants:
  A   split_lab with a constant lab_linear = (0.1, zeros);
  J   lab_linear = (0, g) made inside the loss by kernel P1 (sign_g on the
      flattened (B, S²·3) masked render and image);
  J2  the same by kernel P2 (sign_g_split on the three channel planes);
  A'  A again, on A's state.
J and J2 start from the state A starts from, as the JAX probe's do: each is
built anew by build_stage2 from the same seed. The kernels read the masked
render and image detached (JAX's stop_gradient).

The variants take turns, one step each (A, J, J2, A', then again), so that
whatever drifts during a run (clocks, the allocator, the host) reaches all
four alike. The first WARMUP rounds are not timed; each timed step is
CUDA events around the step, then a synchronize, and a variant's ms per step
is the median of its steps, with the host clock's beside it. The step is
bench.py's: stage2_pose_flagship, 8 ROIs, weights from seed 0.

    python -m self6dpp_tpu_torch.probes.lab_opaque_probe [--steps 20]

Nothing runs at import.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time

import numpy as np
import torch
from torch import Tensor

from ..config import stage2_pose_flagship
from ..engine import self_engine as se
from ..ops.sign_cuda import sign_g, sign_g_split

VARIANTS = ("A", "J", "J2", "A'")
BATCH = 8                         # ROIs per step, as bench.py::build_stage2
SEED = 0
WARMUP = 2                        # untimed rounds before the timed ones


def probe_g(ren_m: Tensor, img_m: Tensor) -> Tensor:
    """pallas_g: P1 on (B, S²·3) views of the masked render and image."""
    b = ren_m.shape[0]
    g = sign_g(ren_m.detach().reshape(b, -1), img_m.detach().reshape(b, -1))
    return g.reshape(ren_m.shape)


def probe_g_split(ren_m: Tensor, img_m: Tensor) -> Tensor:
    """pallas_g_split: P2 on the channel planes (B, S²) of the masked render
    and image, stacked back to (B, S, S, 3)."""
    b, s = ren_m.shape[:2]
    rp, ip = ren_m.detach(), img_m.detach()
    outs = sign_g_split(tuple(rp[..., k].reshape(b, s * s) for k in range(3)),
                        tuple(ip[..., k].reshape(b, s * s) for k in range(3)))
    return torch.stack([o.reshape(b, s, s) for o in outs], dim=-1)


@contextlib.contextmanager
def in_graph_lab(make_g):
    """While active, the step's loss suite is called with lab_linear =
    (0, make_g(ren_m, img_m)) made from the step's own render, as the JAX
    probe's `patched` does; the loss function is restored on exit."""
    orig = se.compute_self_loss_pose

    def patched(cfg_loss, ren, out, pseudo, batch, lpips_fn=None,
                lab_linear=None, impl="kernel"):
        vis = pseudo["vis_mask"][..., None]
        g = make_g(ren["color"] * vis, batch["roi_img"] * vis)
        return orig(cfg_loss, ren, out, pseudo, batch, lpips_fn=lpips_fn,
                    lab_linear=(0.0, g), impl=impl)

    se.compute_self_loss_pose = patched
    try:
        yield
    finally:
        se.compute_self_loss_pose = orig


def _timed_step(step, state, batch, lab_linear):
    """One step: (device ms by CUDA events, host ms ending in a
    synchronize, metrics)."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    _, m = step(state, batch, lab_linear=lab_linear)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b), (time.perf_counter() - t0) * 1e3, m


def run_probe(steps: int = 20) -> dict:
    """The four variants on the stage-II step of build_stage2 at
    stage2_pose_flagship (the JAX probe's configuration) on the CUDA card,
    WARMUP untimed and `steps` timed rounds. Returns {variant: {ms_per_step
    (median of the device times), host_ms_per_step (median), step_ms (each
    device time), steps, total_loss (the last step's), sign_g_launches and
    sign_g_split_launches (over all its steps, warm-up included)}}."""
    cfg = stage2_pose_flagship()
    model, state, batch, lpips = se.build_stage2(cfg, BATCH, seed=SEED)
    step = se.make_self_train_step(cfg, model, lpips, split_lab=True)
    s = cfg.model.input_res
    const = (0.1, torch.zeros((BATCH, s, s, 3),
                              device=batch["roi_img"].device))
    states = {"A": state, "A'": state}
    for name in ("J", "J2"):
        states[name] = se.build_stage2(cfg, BATCH, seed=SEED)[1]
    hooks = {"A": contextlib.nullcontext, "A'": contextlib.nullcontext,
             "J": lambda: in_graph_lab(probe_g),
             "J2": lambda: in_graph_lab(probe_g_split)}
    lab = {"A": const, "A'": const, "J": None, "J2": None}
    dev = {k: [] for k in VARIANTS}
    host = {k: [] for k in VARIANTS}
    launches = {k: [0, 0] for k in VARIANTS}
    last = {}
    for r in range(WARMUP + steps):
        for name in VARIANTS:
            before = (sign_g.launches, sign_g_split.launches)
            with hooks[name]():
                d, h, m = _timed_step(step, states[name], batch, lab[name])
            launches[name][0] += sign_g.launches - before[0]
            launches[name][1] += sign_g_split.launches - before[1]
            last[name] = float(m["total_loss"])
            if r >= WARMUP:
                dev[name].append(d)
                host[name].append(h)
    return {k: {"ms_per_step": float(np.median(dev[k])),
                "host_ms_per_step": float(np.median(host[k])),
                "step_ms": dev[k], "steps": steps, "total_loss": last[k],
                "sign_g_launches": launches[k][0],
                "sign_g_split_launches": launches[k][1]} for k in VARIANTS}


_LABELS = {"A": "A step const-lab_linear", "J": "J in-graph P1-g + inject",
           "J2": "J2 channel-split P2-g + inject", "A'": "A' recheck"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20)
    res = run_probe(ap.parse_args(argv).steps)
    for k, v in res.items():
        print(f"{_LABELS[k]}: {v['ms_per_step']:.2f} ms (median; "
              f"{min(v['step_ms']):.2f}-{max(v['step_ms']):.2f})", flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0), **res}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
