"""The port's trainer, writers and checkpoints against the JAX package's on
the toy quadratic of tests/test_trainer.py (w in R^4 from ones, loss
|w - 0|², adam at 0.1 without warm-up): metrics.json equal iteration for
iteration (1e-5 relative), the checkpoints, resume (a run cut at 4 and
resumed to 6 ends where one of 6 does, and where the JAX loop does), the
finite-loss guard naming the iteration, the weights-only warm start with
a fresh solver, the periodic evaluation into TensorBoard, and the step
directories' marker (a foreign orbax step raises; the JAX package's
load_params_npz reads the port's model.npz)."""

import dataclasses
import itertools
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch import nn

from self6dpp_tpu.config.base import Config as JConfig, SolverConfig as JSolver
from self6dpp_tpu.engine.checkpoint import load_params_npz as j_load_npz
from self6dpp_tpu.engine.optim import build_optimizer as j_build_optimizer
from self6dpp_tpu.engine.train_state import create_train_state as j_state
from self6dpp_tpu.engine.trainer import do_train as j_do_train
from self6dpp_tpu_torch.config import Config, SolverConfig
from self6dpp_tpu_torch.config import TestConfig as EvalConfig
from self6dpp_tpu_torch.engine.checkpoint import CheckpointManager, MARKER
from self6dpp_tpu_torch.engine.optim import build_optimizer
from self6dpp_tpu_torch.engine.train_state import create_train_state
from self6dpp_tpu_torch.engine.trainer import do_train

RTOL = 1e-5                       # float32 adam, two packages


class Toy(nn.Module):
    def __init__(self):
        super().__init__()
        self.w = nn.Parameter(torch.ones(4))


def solver(optimizer="adam", total_iters=6, **kw):
    return dict(optimizer=optimizer, base_lr=0.1, warmup_iters=0,
                total_iters=total_iters, **kw)


def port_setup(out, total_iters=6, ckpt_period=3, optimizer="adam",
               with_ema=False, lr_sched="flat_and_anneal", **kw):
    cfg = Config(exp_name="t", output_dir=str(out),
                 solver=SolverConfig(**solver(optimizer, total_iters,
                                              lr_sched=lr_sched)),
                 ckpt_period=ckpt_period, log_period=2, **kw)
    model = Toy()
    state = create_train_state(model, build_optimizer(
        cfg.solver, model.parameters()), with_ema=with_ema)

    def train_step(state, batch):
        loss = ((state.model.w - batch["target"]) ** 2).sum()
        state.opt.zero_grad(set_to_none=True)
        loss.backward()
        state.opt.step()
        state.step += 1
        return state, {"total_loss": loss.detach()}
    batches = itertools.repeat({"target": np.zeros(4, np.float32)})
    to_dev = lambda b: {k: torch.as_tensor(v) for k, v in b.items()}
    return cfg, state, train_step, batches, to_dev


def jax_run(out, total_iters=6, ckpt_period=3):
    cfg = JConfig(exp_name="t", output_dir=str(out),
                  solver=JSolver(**solver("adam", total_iters)),
                  ckpt_period=ckpt_period, log_period=2)
    tx, _ = j_build_optimizer(cfg.solver)
    state = j_state({"w": jnp.ones((4,))}, {}, tx, with_ema=False)

    def train_step(state, batch, rng):
        loss, g = jax.value_and_grad(
            lambda p: ((p["w"] - batch["target"]) ** 2).sum())(state.params)
        return state.apply_gradients(g), {"total_loss": loss}
    return j_do_train(cfg, state, jax.jit(train_step),
                      itertools.repeat({"target": np.zeros(4, np.float32)}),
                      lambda b: {k: jnp.asarray(v) for k, v in b.items()},
                      resume=False)


def rows(out):
    with open(os.path.join(out, "t", "metrics.json")) as f:
        return [json.loads(line) for line in f]


def test_trainer_matches_jax_and_checkpoints(tmp_path):
    jstate = jax_run(tmp_path / "j")
    timings = []
    cfg, state, step, batches, to_dev = port_setup(tmp_path / "t")
    out = do_train(cfg, state, step, batches, to_dev, resume=False,
                   timings=timings)
    assert out.step == 6 and len(timings) == 6
    np.testing.assert_allclose(out.model.w.detach().numpy(),
                               np.asarray(jstate.params["w"]), rtol=RTOL)
    j, t = rows(tmp_path / "j"), rows(tmp_path / "t")
    assert [r["iteration"] for r in t] == [r["iteration"] for r in j] \
        == [2, 4, 6]
    for a, b in zip(j, t):
        np.testing.assert_allclose(b["total_loss"], a["total_loss"],
                                   rtol=RTOL)
        assert b.keys() == a.keys()
    ck = tmp_path / "t" / "t" / "ckpt"
    assert sorted(os.listdir(ck)) == ["3", "6"]
    assert set(os.listdir(ck / "6")) == {MARKER, "model.npz", "solver.pt"}
    # resume: nothing left to do, nothing written
    cfg, state, step, batches, to_dev = port_setup(tmp_path / "t")
    again = do_train(cfg, state, step, batches, to_dev, resume=True)
    assert again.step == 6 and rows(tmp_path / "t") == t
    np.testing.assert_array_equal(again.model.w.detach().numpy(),
                                  out.model.w.detach().numpy())


def test_resume_continues_where_the_run_stopped(tmp_path):
    """A run cut at 4 iterations and resumed to 6 (the solver's moments,
    its update count and the step restored) ends where a run of 6 does,
    with each iteration logged once; at a constant rate, which does not
    depend on total_iters."""
    cfg, state, step, batches, to_dev = port_setup(
        tmp_path / "cut", total_iters=4, ckpt_period=2, lr_sched="constant")
    do_train(cfg, state, step, batches, to_dev, resume=False)
    cfg, state, step, batches, to_dev = port_setup(
        tmp_path / "cut", total_iters=6, ckpt_period=2, lr_sched="constant")
    timings = []
    resumed = do_train(cfg, state, step, batches, to_dev, resume=True,
                       timings=timings)
    assert len(timings) == 2 and resumed.opt.count == 6
    cfg, state, step, batches, to_dev = port_setup(
        tmp_path / "whole", lr_sched="constant")
    whole = do_train(cfg, state, step, batches, to_dev, resume=False)
    np.testing.assert_array_equal(resumed.model.w.detach().numpy(),
                                  whole.model.w.detach().numpy())
    assert [r["iteration"] for r in rows(tmp_path / "cut")] == [2, 4, 6]
    assert sorted(os.listdir(tmp_path / "cut" / "t" / "ckpt")) == ["4", "6"]


def test_trainer_nan_guard(tmp_path):
    cfg, state, _, batches, to_dev = port_setup(tmp_path)

    def bad_step(state, batch):
        return state, {"total_loss": torch.tensor(float("nan"))}
    with pytest.raises(FloatingPointError, match="at iter 0"):
        do_train(cfg, state, bad_step, batches, to_dev, resume=False)


def test_load_weights_keeps_fresh_solver_state(tmp_path):
    """The stage-II warm start: the weights (student and teacher) of the
    stage-I run, the solver fresh at them (a Ranger over an adam
    checkpoint: no update counted, the Lookahead's slow weights the loaded
    ones), step 0. The JAX package keeps the solver state it had before
    the load, so its slow weights stay those of the init."""
    cfg, state, step, batches, to_dev = port_setup(tmp_path, with_ema=True)
    trained = do_train(cfg, state, step, batches, to_dev, resume=False)
    cfg2, fresh, *_ = port_setup(tmp_path / "s2", optimizer="ranger",
                                 with_ema=True)
    with torch.no_grad():
        fresh.model.w.zero_()
    warm = CheckpointManager(str(tmp_path / "t" / "ckpt")).load_weights(fresh)
    w = trained.model.w.detach()
    assert torch.equal(warm.model.w.detach(), w) and warm.step == 0
    assert torch.equal(warm.teacher.w.detach(), trained.teacher.w.detach())
    assert warm.opt.count == 0 and warm.opt.core == "ranger"
    assert torch.equal(warm.opt.state[warm.model.w]["slow"], w)
    assert not warm.opt.state[warm.model.w]["mu"].any()


def test_trainer_periodic_eval_to_tb(tmp_path):
    cfg, state, step, batches, to_dev = port_setup(
        tmp_path, test=EvalConfig(eval_period=2), tensorboard=True)
    calls = []

    def eval_fn(st):
        calls.append(st.step)
        return {"ape": {"ad_10": 75.0, "n": 4},
                "avg": {"ad_10": 75.0, "n": 4}}
    do_train(cfg, state, step, batches, to_dev, eval_fn=eval_fn,
             resume=False)
    assert calls == [2, 4, 6]
    tb_dir = tmp_path / "t" / "tb"
    blob = b"".join(open(tb_dir / f, "rb").read() for f in os.listdir(tb_dir))
    assert b"eval/tables" in blob and b"ad_10" in blob
    assert rows(tmp_path)[-1]["eval/ad_10"] == 75.0


def test_checkpoint_steps_are_marked(tmp_path):
    cfg, state, step, batches, to_dev = port_setup(tmp_path)
    out = do_train(cfg, state, step, batches, to_dev, resume=False)
    ck = str(tmp_path / "t" / "ckpt")
    tree = j_load_npz(os.path.join(ck, "6", "model.npz"),
                      {"params": {"w": jnp.zeros(4)}})
    np.testing.assert_array_equal(np.asarray(tree["params"]["w"]),
                                  out.model.w.detach().numpy())
    mgr = CheckpointManager(ck, max_to_keep=2, save_period=1)
    assert mgr.latest_step() == 6
    assert mgr.save(out, step=6) is False           # written once
    os.makedirs(os.path.join(ck, "9"))              # an orbax step
    with pytest.raises(RuntimeError, match="orbax"):
        mgr.latest_step()
