"""The port's stage-II training CLI against the JAX package's on the CPU,
on the JAX generator's synthetic set, at configs/self6dpp/synthetic_smoke.py
for 4 iterations in float32 (colour augmentation at probability 1): with
the config's seed and ratios (TRAIN2 0.3, geo 0.3) the iterations are geo,
synsup, synsup, pose, so every mode runs. The student and the teacher
start from a stage-I step directory the port's CheckpointManager wrote:
the port reads it as --weights, the JAX CLI its model.npz as --init-npz
(which also starts its teacher there). LPIPS reads one weights file on
both sides. The in-loop refiner and the repj loss are off here (the
refined step is held in test_torch_self_engine_refined.py); the port runs
them through the CLI in test_self6dpp_cli_refined_resume. The geo steps
take the JAX step's own warp and colour draws, recorded from its key
(jax.random cannot be reproduced in torch). Every loss of metrics.json
agrees at 1e-4 relative (1e-6 absolute); the mode sequences are equal.
"""

import os

import numpy as np
import pytest
import torch

from self6dpp_tpu.engine import self_engine as jse
from self6dpp_tpu.models import lpips as jlpips
from self6dpp_tpu_torch import config as tc
from self6dpp_tpu_torch.engine import gdrn_engine as tge
from self6dpp_tpu_torch.engine import self_engine as tse
from self6dpp_tpu_torch.engine.checkpoint import CheckpointManager
from self6dpp_tpu_torch.models.lpips import build_lpips
from self6dpp_tpu_torch.tools import train_self6dpp as tself
from test_torch_cli_train import (assert_metrics_close, dataset, one_thread,
                                  read_metrics, run_jax_cli)
from test_torch_geo_step import jax_geo_draws

CONFIG = "configs/self6dpp/synthetic_smoke.py"
ITERS = 4
__all__ = ["dataset", "one_thread"]


def opts(dataset, out, *extra):
    return ["--opts", f"data.dataset_root={dataset}", f"output_dir={out}",
            "dist.compute_dtype=float32", f"solver.total_iters={ITERS}",
            "log_period=1", f"ckpt_period={ITERS}", "data.color_aug_prob=1",
            *extra]


@pytest.fixture(scope="module")
def stage1(tmp_path_factory):
    """A stage-I step directory (step 5) of the seeded synthetic_smoke
    GDRN, and an LPIPS weights file in the reference layout."""
    d = tmp_path_factory.mktemp("stage1")
    model = tge.build_gdrn(tc.load_config(CONFIG), "cpu", seed=3)
    CheckpointManager(str(d / "ckpt")).save(tge.init_state(
        tc.load_config(CONFIG), model), step=5, force=True)
    sd = build_lpips("cpu").state_dict()
    lp = {k.removeprefix("alex."): v.numpy() for k, v in sd.items()}
    lp.update({f"{k}.weight": lp.pop(k) for k in list(lp)
               if k.startswith("lin")})
    np.savez(d / "lpips.npz", **lp)
    return str(d / "ckpt"), str(d / "lpips.npz")


def test_self6dpp_train_cli_matches_jax(dataset, stage1, tmp_path,
                                        monkeypatch):
    from tools import train_self6dpp as jcli
    ckpt, lp = stage1
    jmodes, draws = [], []
    load_lp = jlpips.load_lpips_params
    monkeypatch.setattr(jlpips, "load_lpips_params", lambda p: load_lp(lp))
    monkeypatch.setattr(tself, "LPIPS_WEIGHTS", lp)

    def recording(name, make):
        def build(cfg, *a, **kw):
            step = make(cfg, *a, **kw)

            def run(state, *args):
                jmodes.append(name)
                if name == "geo":
                    batch, rng = args[-2:]
                    draws.append(jax_geo_draws(cfg, batch["roi_img"], rng))
                return step(state, *args)
            return run
        return build
    for name, attr in (("pose", "jit_self_train_step"),
                       ("geo", "jit_self_geo_train_step"),
                       ("synsup", "jit_synsup_train_step")):
        monkeypatch.setattr(jse, attr, recording(name, getattr(jse, attr)))
    off = ["self_sup.refine_with_deepim=false", "self_sup.repj_refine=false"]
    run_jax_cli(jcli.main, ["--config", CONFIG, "--init-npz",
                            os.path.join(ckpt, "5", "model.npz")]
                + opts(dataset, tmp_path / "j", *off), None, None,
                monkeypatch)

    def jax_draws(cfg, batch, generator):
        return {k: torch.from_numpy(np.array(v))
                for k, v in draws.pop(0).items()}
    monkeypatch.setattr(tse, "draw_geo_aug", jax_draws)
    r = tself.main(["--config", CONFIG, "--weights", ckpt]
                   + opts(dataset, tmp_path / "t", *off),
                   device="cpu", impl="plain")
    assert jmodes == r["modes"] == ["geo", "synsup", "synsup", "pose"]
    assert not draws
    name = "self6dpp_synthetic_smoke/metrics.json"
    assert_metrics_close(tmp_path / "j" / name, r["metrics"], ITERS)
    last = read_metrics(r["metrics"])[-1]
    assert {"loss_percep_obj", "loss_ms_ssim", "loss_mask_self"} <= set(last)
    assert r["state"].step == ITERS
