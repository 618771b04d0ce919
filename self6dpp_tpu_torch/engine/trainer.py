"""The training loop (port of self6dpp_tpu/engine/trainer.py; reference
core/gdrn_modeling/engine/engine.py:204-520 without detectron2): batches
through the step, periodic checkpoints, evaluation, image grids and
metric lines.

The step's metrics stay on the device between flushes, so the loop never
waits for the card to report a loss. A flush comes at every log_period
iterations, before an image grid, an evaluation or a checkpoint, and at
the last iteration; it copies the pending metrics to the host, raises
FloatingPointError naming the first iteration whose total loss is not
finite, and writes them.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Iterator

import numpy as np
import torch

from ..config import Config
from ..parallel.dist import is_main, mean_metrics
from ..parallel.mesh import current_mesh, gathered, shard_state
from .checkpoint import CheckpointManager
from .train_state import TrainState
from .writers import EventStorage, JSONWriter, TensorboardWriter, \
    TerminalWriter

logger = logging.getLogger("self6dpp_tpu_torch")


def do_train(
    cfg: Config,
    state: TrainState,
    train_step: Callable[[TrainState, dict], tuple[TrainState, dict]],
    batches: Iterator[dict],
    to_device: Callable[[dict], dict],
    eval_fn: Callable[[TrainState], dict] | None = None,
    vis_fn: Callable[[TrainState, dict, EventStorage], None] | None = None,
    resume: bool = True,
    timings: list | None = None,
) -> TrainState:
    """Runs cfg.solver.total_iters iterations of train_step(state, device
    batch) -> (state, metrics of 0-d tensors with total_loss), from the
    latest checkpoint in <output_dir>/<exp_name>/ckpt when resume. Saves
    every cfg.ckpt_period iterations and once more at the end; writes
    metrics.json (and TensorBoard scalars with cfg.tensorboard); calls
    eval_fn(state) -> tables every test.eval_period iterations and
    vis_fn(state, device batch, storage) every vis_period. timings, when
    given, gets one {'wait_s', 'step_s'} per iteration: the host seconds
    spent getting the batch onto the device and in the step's call.
    Under data parallel (parallel/dist.py) the metrics are the ranks'
    means, and only rank 0 writes, saves, evaluates and draws. Under the
    rank grid of make_mesh with fsdp > 1 the state is sharded first
    (parallel/mesh.py::shard_state)."""
    out = f"{cfg.output_dir}/{cfg.exp_name}"
    ckpt = CheckpointManager(f"{out}/ckpt", max_to_keep=cfg.ckpt_max_to_keep,
                             save_period=cfg.ckpt_period)
    mesh = current_mesh()
    if mesh is not None and mesh.fsdp > 1 and state.fsdp is None:
        state = shard_state(state, mesh)
    state, start_iter = ckpt.resume_or_load(state, resume=resume)
    if start_iter > 0:
        logger.info(f"resumed from iteration {start_iter}")

    storage = EventStorage()
    main = is_main()
    writers = [TerminalWriter(storage, cfg.solver.total_iters, cfg.log_period),
               JSONWriter(storage, f"{out}/metrics.json", cfg.log_period)
               ] if main else []
    tb = None
    if main and (cfg.tensorboard or (cfg.vis_period > 0
                                     and vis_fn is not None)):
        tb = TensorboardWriter(storage, f"{out}/tb", cfg.log_period)
        writers.append(tb)
        storage.tb = tb

    pending: list[tuple[int, dict]] = []
    t_window = time.perf_counter()

    def flush() -> None:
        nonlocal t_window
        if not pending:
            return
        keys = [list(m) for _, m in pending]
        host = [torch.stack([m[k].float() for k in ks]).cpu().numpy()
                for (_, m), ks in zip(pending, keys)]
        per_iter = (time.perf_counter() - t_window) / len(pending)
        for (it1, _), ks, vals in zip(pending, keys, host):
            m = dict(zip(ks, vals.tolist()))
            if not np.isfinite(m["total_loss"]):
                logger.error(f"non-finite loss at iter {it1 - 1}: {m}")
                raise FloatingPointError(f"loss diverged at iter {it1 - 1}")
            storage.iter = it1
            storage.put_scalars(time_per_iter=per_iter, **m)
            for w in writers:
                w.write()
        pending.clear()
        t_window = time.perf_counter()

    for it in range(start_iter, cfg.solver.total_iters):
        t0 = time.perf_counter()
        batch = to_device(next(batches))
        t1 = time.perf_counter()
        state, metrics = train_step(state, batch)
        if timings is not None:
            timings.append({"wait_s": t1 - t0,
                            "step_s": time.perf_counter() - t1})
        pending.append((it + 1, mean_metrics(metrics)))
        vis_due = (vis_fn is not None and cfg.vis_period > 0
                   and (it + 1) % cfg.vis_period == 0)
        eval_due = (eval_fn is not None and cfg.test.eval_period > 0
                    and (it + 1) % cfg.test.eval_period == 0)
        ckpt_due = cfg.ckpt_period > 0 and (it + 1) % cfg.ckpt_period == 0
        if ((it + 1) % cfg.log_period == 0 or vis_due or eval_due or ckpt_due
                or it + 1 == cfg.solver.total_iters):
            flush()
        # rank 0 draws and evaluates; a sharded state is gathered whole on
        # every rank around it (parallel/mesh.py)
        if vis_due:
            with gathered(state):
                if main:
                    vis_fn(state, batch, storage)
        ckpt.save(state, step=it + 1)
        if eval_due:
            with gathered(state):
                tables = eval_fn(state) if main else None
        if eval_due and main:
            avg = tables.get("avg", {})
            logger.info(f"eval @ {it + 1}: {avg or tables}")
            storage.put_scalars(**{
                f"eval/{k}": float(v) for k, v in avg.items()
                if isinstance(v, (int, float))})
            if tb is not None:
                from .evaluator import table_to_markdown
                tb.add_text("eval/tables", table_to_markdown(tables), it + 1)

    flush()
    ckpt.save(state, force=True)
    for w in writers:
        getattr(w, "close", lambda: None)()
    return state
