"""The port's eval CLIs against the JAX package's on the CPU, on the JAX
generator's synthetic set (the 'synthetic' meta: 2 objects, 160x120):

  * tools/train_gdrn.py --eval-only at configs/gdrn/synthetic_smoke.py
    against self6dpp_tpu_torch.tools.train_gdrn.main(device="cpu",
    impl="plain");
  * tools/train_deepim.py --eval-only at configs/deepim/synthetic_smoke.py
    against self6dpp_tpu_torch.tools.train_deepim.main, FlowNetS at micro
    widths on both sides (the JAX module's FlowNetS swapped for a partial
    in the test, as tests/test_torch_deepim.py does).

Both read an --init-npz that the JAX package's save_params_npz wrote from
the JAX CLI's own init (its init_state wrapped here). Both run in float32
(--opts dist.compute_dtype=float32: bf16 rounding is not what is compared)
on one mesh device. The tables agree within 1e-5 relative (counts'
percentages exactly) and the CSV rows' R and t within 1e-4.
"""

import functools
import os
import sys

import numpy as np
import pytest

import self6dpp_tpu.models.deepim as JDM
import self6dpp_tpu.parallel.mesh as jmesh
from self6dpp_tpu.engine import deepim_engine as jde
from self6dpp_tpu.engine import evaluator as JE
from self6dpp_tpu.engine import gdrn_engine as jge
from self6dpp_tpu.engine.checkpoint import save_params_npz
from self6dpp_tpu.models.backbones.flownet import FlowNetS as JFlowNetS
from self6dpp_tpu.ops import fps as jfps
from self6dpp_tpu_torch.engine import deepim_engine as tde
from self6dpp_tpu_torch.engine import evaluator as TE
from self6dpp_tpu_torch.engine.checkpoint import (load_params_npz,
                                                  save_params_npz as t_save)
from self6dpp_tpu_torch.models.deepim import DeepIM
from self6dpp_tpu_torch.tools import train_deepim as tdeepim
from self6dpp_tpu_torch.tools import train_gdrn as tgdrn

MICRO = (8, 12, 16, 16, 16, 24)
RECALL_KEYS = ("ad_", "rete_", "re_", "te_", "proj_", "ar_", "bop19_ar", "n")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from tools.make_synthetic_bop import generate_full
    root = str(tmp_path_factory.mktemp("synth"))
    generate_full(root, n_images=5)
    return root


def run_jax_cli(main, argv, npz, init_state_owner, monkeypatch):
    """Run a JAX CLI's main in-process, its init state saved to `npz`
    before the CLI loads that file; returns (tables, evaluator)."""
    seen = {}
    inner_init = init_state_owner.init_state

    def init_and_save(*a, **kw):
        state = inner_init(*a, **kw)
        save_params_npz(npz, {"params": state.params,
                              "batch_stats": state.batch_stats})
        return state

    inner_eval = JE.PoseEvaluator.evaluate

    def evaluate(self, *a, **kw):
        seen["tables"] = inner_eval(self, *a, **kw)
        seen["ev"] = self
        return seen["tables"]

    monkeypatch.setattr(init_state_owner, "init_state", init_and_save)
    monkeypatch.setattr(JE.PoseEvaluator, "evaluate", evaluate)
    monkeypatch.setattr(jmesh, "make_mesh", lambda *a, **kw: None)
    monkeypatch.setattr(jfps, "_lib", False)
    monkeypatch.setattr(sys, "argv", ["cli"] + argv)
    main()
    return seen["tables"], seen["ev"]


def assert_tables_close(j, t):
    assert list(j) == list(t)
    for name in j:
        assert set(j[name]) == set(t[name]), name
        for k, x in j[name].items():
            if k.startswith(RECALL_KEYS):
                assert t[name][k] == x, (name, k, x, t[name][k])
            else:
                np.testing.assert_allclose(t[name][k], x, rtol=1e-5,
                                           err_msg=f"{name}.{k}")


def assert_rows_close(j, t):
    assert len(j) == len(t) > 0
    for a, b in zip(j, t):
        assert [a[k] for k in ("scene_id", "im_id", "obj_id")] == \
            [b[k] for k in ("scene_id", "im_id", "obj_id")]
        np.testing.assert_allclose(b["R"], a["R"], rtol=0, atol=1e-4)
        np.testing.assert_allclose(b["t"], a["t"], rtol=0, atol=1e-4)


def opts(dataset, out):
    return ["--opts", f"data.dataset_root={dataset}", f"output_dir={out}",
            "dist.compute_dtype=float32"]


def test_gdrn_eval_cli_matches_jax(dataset, tmp_path, monkeypatch):
    from tools import train_gdrn as jcli
    npz = str(tmp_path / "gdrn.npz")
    cfg = ["--config", "configs/gdrn/synthetic_smoke.py", "--eval-only",
           "--init-npz", npz]
    jt, _ = run_jax_cli(jcli.main, cfg + opts(dataset, tmp_path / "j"), npz,
                        jge, monkeypatch)
    r = tgdrn.main(cfg + opts(dataset, tmp_path / "t"), device="cpu",
                   impl="plain")
    assert_tables_close(jt, r["tables"])
    assert r["tables"]["avg"]["n"] == 5 and "bop19_ar" in r["tables"]["avg"]
    jcsv = str(tmp_path / "j" / "gdrn_synthetic_smoke" / "results-bop.csv")
    assert r["csv"] == str(tmp_path / "t" / "gdrn_synthetic_smoke"
                           / "results-bop.csv")
    assert_rows_close(JE.load_bop_csv(jcsv), TE.load_bop_csv(r["csv"]))
    assert len(r["timings"]) == 2 and r["timings"][0]["label_render_s"] > 0
    # the port writes the file it read, value for value
    from self6dpp_tpu_torch.config import apply_overrides, load_config
    from self6dpp_tpu_torch.engine.gdrn_engine import build_gdrn
    tcfg = apply_overrides(load_config(cfg[1]), opts(dataset, "o")[1:])
    model = load_params_npz(npz, build_gdrn(tcfg, "cpu", seed=1))
    t_save(str(tmp_path / "back.npz"), model)
    a, b = dict(np.load(npz)), dict(np.load(str(tmp_path / "back.npz")))
    assert a.keys() == b.keys()
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_deepim_eval_cli_matches_jax(dataset, tmp_path, monkeypatch):
    from tools import train_deepim as jcli
    monkeypatch.setattr(JDM, "FlowNetS",
                        functools.partial(JFlowNetS, widths=MICRO))
    monkeypatch.setattr(tde, "DeepIM", functools.partial(DeepIM, widths=MICRO))
    npz = str(tmp_path / "deepim.npz")
    cfg = ["--config", "configs/deepim/synthetic_smoke.py", "--eval-only",
           "--init-npz", npz]
    jt, jev = run_jax_cli(jcli.main, cfg + opts(dataset, tmp_path / "j"),
                          npz, jde, monkeypatch)
    r = tdeepim.main(cfg + opts(dataset, tmp_path / "t"), device="cpu",
                     impl="plain")
    assert_tables_close(jt, r["tables"])
    assert_rows_close(jev.results_for_csv(), r["results"])
    assert len(r["timings"]) == 3          # 10 instances, 4 a batch


def test_cli_refuses_training_and_orbax_steps(dataset, tmp_path):
    """Training and eval refuse a checkpoint directory that holds orbax
    steps (the JAX CLIs' checkpoints, which the port cannot read), and a
    config the port has no function for."""
    argv = ["--config", "configs/gdrn/synthetic_smoke.py"] + \
        opts(dataset, tmp_path)
    os.makedirs(tmp_path / "gdrn_synthetic_smoke" / "ckpt" / "60")
    os.makedirs(tmp_path / "deepim_synthetic_smoke" / "ckpt" / "15")
    with pytest.raises(RuntimeError, match="orbax"):
        tgdrn.main(argv, device="cpu")
    with pytest.raises(RuntimeError, match="orbax"):
        tdeepim.main(["--config", "configs/deepim/synthetic_smoke.py"]
                     + opts(dataset, tmp_path), device="cpu")
    with pytest.raises(RuntimeError, match="orbax"):
        tgdrn.main(argv[:2] + ["--eval-only"] + argv[2:], device="cpu")
    with pytest.raises(KeyError, match="registered"):
        tgdrn.main(["--config", "configs/gdrn/nope.py", "--eval-only"],
                   device="cpu")
