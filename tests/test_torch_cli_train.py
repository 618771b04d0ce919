"""The port's training CLIs against the JAX package's on the CPU, on the
JAX generator's synthetic set (the 'synthetic' meta: 2 objects, 160x120),
for 3 iterations each in float32 (dist.compute_dtype=float32) on one mesh
device, every loader option at the CLI's own settings (4 worker threads,
prefetch, colour augmentation at probability 1):

  * tools/train_gdrn.py at configs/gdrn/synthetic_smoke.py;
  * tools/train_deepim.py at configs/deepim/synthetic_smoke.py, FlowNetS
    at micro widths on both sides;
  * tools/train_self6dpp.py at configs/self6dpp/synthetic_smoke.py with
    --weights from the port's stage-I run (the JAX side reads the same
    weights as --init-npz: the port's step directory holds the flat
    .npz), the geo mode and the TRAIN2 interleave at 1/2 each so that 6
    iterations take every mode, LPIPS from one weights file, the in-loop
    refiner and the repj loss off (held in test_torch_self_engine_refined).
    The geo steps take the JAX step's own warp and colour draws (jax.random
    cannot be reproduced in torch), recorded from its key.

Every loss of metrics.json agrees at 1e-4 relative (1e-6 absolute), the
iterations and the mode sequence exactly. The JAX CLIs start from their
random init; the port reads it as --init-npz (written by the JAX package's
save_params_npz from the JAX CLI's own init_state).
"""

import functools
import json
import os
import sys

import numpy as np
import pytest
import torch

import self6dpp_tpu.models.deepim as JDM
import self6dpp_tpu.parallel.mesh as jmesh
from self6dpp_tpu.engine import deepim_engine as jde
from self6dpp_tpu.engine import gdrn_engine as jge
from self6dpp_tpu.engine import self_engine as jse
from self6dpp_tpu.engine.checkpoint import save_params_npz
from self6dpp_tpu.models import lpips as jlpips
from self6dpp_tpu.models.backbones.flownet import FlowNetS as JFlowNetS
from self6dpp_tpu.ops import fps as jfps
from self6dpp_tpu_torch.engine import deepim_engine as tde
from self6dpp_tpu_torch.engine import self_engine as tse
from self6dpp_tpu_torch.models.deepim import DeepIM
from self6dpp_tpu_torch.models.lpips import build_lpips
from self6dpp_tpu_torch.tools import train_deepim as tdeepim
from self6dpp_tpu_torch.tools import train_gdrn as tgdrn
from self6dpp_tpu_torch.tools import train_self6dpp as tself

MICRO = (8, 12, 16, 16, 16, 24)
RTOL, ATOL = 1e-4, 1e-6


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from tools.make_synthetic_bop import generate_full
    root = str(tmp_path_factory.mktemp("synth"))
    generate_full(root, n_images=5)
    return root


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def opts(dataset, out, *extra):
    return ["--opts", f"data.dataset_root={dataset}", f"output_dir={out}",
            "dist.compute_dtype=float32", "solver.total_iters=3",
            "log_period=1", "ckpt_period=3", "data.color_aug_prob=1", *extra]


def run_jax_cli(main, argv, npz, init_state_owner, monkeypatch):
    """Run a JAX CLI's main in-process, its init state saved to `npz` (when
    given) as the CLI builds it."""
    def init_and_save(*a, **kw):
        state = inner_init(*a, **kw)
        save_params_npz(npz, {"params": state.params,
                              "batch_stats": state.batch_stats})
        return state

    if npz:
        inner_init = init_state_owner.init_state
        monkeypatch.setattr(init_state_owner, "init_state", init_and_save)
    monkeypatch.setattr(jmesh, "make_mesh", lambda *a, **kw: None)
    monkeypatch.setattr(jfps, "_lib", False)
    monkeypatch.setattr(sys, "argv", ["cli"] + argv)
    main()


def read_metrics(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def assert_metrics_close(jpath, tpath, n):
    j, t = read_metrics(jpath), read_metrics(tpath)
    assert [r["iteration"] for r in j] == [r["iteration"] for r in t] \
        == list(range(1, n + 1))
    for a, b in zip(j, t):
        # the port's DeepIM step logs each term beside the JAX total
        losses = {k for k in a if k.startswith(("loss", "total"))}
        assert losses <= {k for k in b if k.startswith(("loss", "total"))}
        for k in losses:
            np.testing.assert_allclose(b[k], a[k], rtol=RTOL, atol=ATOL,
                                       err_msg=f"{a['iteration']}: {k}")
        assert np.isfinite(b["total_loss"])


def test_gdrn_train_cli_matches_jax(dataset, tmp_path, monkeypatch):
    from tools import train_gdrn as jcli
    npz = str(tmp_path / "init.npz")
    run_jax_cli(jcli.main, ["--config", "configs/gdrn/synthetic_smoke.py"]
                + opts(dataset, tmp_path / "j"), npz, jge, monkeypatch)
    r = tgdrn.main(["--config", "configs/gdrn/synthetic_smoke.py",
                    "--init-npz", npz] + opts(dataset, tmp_path / "t"),
                   device="cpu", impl="plain")
    name = "gdrn_synthetic_smoke/metrics.json"
    assert_metrics_close(tmp_path / "j" / name, r["metrics"], 3)
    assert r["state"].step == 3 and len(r["timings"]) == 3
    assert os.listdir(tmp_path / "t" / "gdrn_synthetic_smoke" / "ckpt") \
        == ["3"]


def test_deepim_train_cli_matches_jax(dataset, tmp_path, monkeypatch):
    from tools import train_deepim as jcli
    monkeypatch.setattr(JDM, "FlowNetS",
                        functools.partial(JFlowNetS, widths=MICRO))
    monkeypatch.setattr(tde, "DeepIM", functools.partial(DeepIM, widths=MICRO))
    npz = str(tmp_path / "init.npz")
    run_jax_cli(jcli.main, ["--config", "configs/deepim/synthetic_smoke.py"]
                + opts(dataset, tmp_path / "j"), npz, jde, monkeypatch)
    r = tdeepim.main(["--config", "configs/deepim/synthetic_smoke.py",
                      "--init-npz", npz] + opts(dataset, tmp_path / "t"),
                     device="cpu", impl="plain")
    name = "deepim_synthetic_smoke/metrics.json"
    assert_metrics_close(tmp_path / "j" / name, r["metrics"], 3)
    assert r["state"].step == 3


@pytest.mark.parametrize("cli,config", [
    (tgdrn, "configs/gdrn/synthetic_smoke.py"),
    (tdeepim, "configs/deepim/synthetic_smoke.py"),
    (tself, "configs/self6dpp/synthetic_smoke.py")])
def test_training_clis_default_to_cuda(cli, config, tmp_path):
    """Without --device the CLIs run on the card, and raise without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--config", config, "--opts", f"output_dir={tmp_path}"])
