"""The port's detector CLI (self6dpp_tpu_torch/tools/train_yolov4.py)
against the JAX package's (tools/train_yolov4.py) on the CPU, on the JAX
generator's synthetic set (<root>/lm/{train,test}, the 'synthetic' meta: 2
objects, 160x120), at configs/gdrn/synthetic_smoke.py with the detector at
128², width 0.125, depth 0.33, float32, batch ims_per_batch // 4 = 2, the
mosaic, a rotation and a shear in the augmentation, and the in-train
evaluation at the last iteration. At 64² batch norm at stride 32 takes
its statistics from 8 values a channel, which amplifies float32 rounding
in both packages (the float64 forwards agree, tests/test_torch_yolo.py):
the losses there part by up to 1.1e-4 relative; at 128² by 3.4e-5.

  * 3 iterations from the JAX CLI's own init (carried into the port by
    convert.yolo_flax_to_state_dict, the port CLI's build_model patched):
    every loss of metrics.json at 1e-4 relative (1e-6 absolute), the
    iterations exactly;
  * a resume to 4 iterations that redoes none;
  * --eval-only on the port's last step, the JAX CLI on the same weights
    (its create_train_state patched): the AP table equal and the
    detections json equal field by field but `time` (boxes at 1e-3 px,
    scores at 1e-5; the eval forward agrees to ~1e-6);
  * the json read by the port's train_gdrn --eval-only --det-file.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

import self6dpp_tpu.engine.train_state as jts
import self6dpp_tpu.parallel.mesh as jmesh
from self6dpp_tpu_torch import convert
from self6dpp_tpu_torch.tools import train_gdrn as tgdrn
from self6dpp_tpu_torch.tools import train_yolov4 as tyolo

RTOL, ATOL = 1e-4, 1e-6
BOX_TOL, SCORE_TOL = 1e-3, 1e-5
CONFIG = "configs/gdrn/synthetic_smoke.py"
NAME = "gdrn_synthetic_smoke"


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


def opts(dataset, out, iters=3, *extra):
    return ["--opts", f"data.dataset_root={dataset}", f"output_dir={out}",
            f"solver.total_iters={iters}", "log_period=1", "ckpt_period=3",
            "test.eval_period=3", "det.input_size=128",
            "det.width_multiple=0.125", "det.depth_multiple=0.33",
            "det.aug_mosaic=true", "det.rand_rotate_deg=5",
            "det.rand_shear=2", *extra]


def run_jax_cli(argv, monkeypatch, variables=None):
    """The JAX CLI's main in-process; returns the variables of the state it
    built (or, given `variables`, builds its state on those)."""
    from tools import train_yolov4 as jcli
    seen = {}
    inner = jts.create_train_state

    def create(params, batch_stats, tx, **kw):
        if variables is not None:
            params, batch_stats = variables["params"], variables["batch_stats"]
        seen["v"] = {"params": jax.tree.map(np.asarray, params),
                     "batch_stats": jax.tree.map(np.asarray, batch_stats)}
        return inner(params, batch_stats, tx, **kw)

    monkeypatch.setattr(jts, "create_train_state", create)
    monkeypatch.setattr(jmesh, "make_mesh", lambda *a, **kw: None)
    monkeypatch.setattr(sys, "argv", ["cli"] + argv)
    jcli.main()
    return seen["v"]


def read_metrics(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def loss_rows(rows):
    return [{k: v for k, v in r.items() if k.startswith(("loss", "total"))}
            for r in rows]


def test_yolov4_cli_matches_jax(dataset, tmp_path, monkeypatch):
    jout, tout = tmp_path / "j", tmp_path / "t"
    init = run_jax_cli(["--config", CONFIG, "--eval-max-images", "2"]
                       + opts(dataset, jout), monkeypatch)
    build = tyolo.build_model

    def from_jax_init(ycfg, device, seed):
        m = build(ycfg, device, seed)
        m.load_state_dict(convert.yolo_flax_to_state_dict(init, m))
        return m

    monkeypatch.setattr(tyolo, "build_model", from_jax_init)
    argv = ["--config", CONFIG, "--eval-max-images", "2"]
    r = tyolo.main(argv + opts(dataset, tout), device="cpu")
    j, t = read_metrics(jout / NAME / "metrics.json"), \
        read_metrics(r["metrics"])
    assert [x["iteration"] for x in j] == [x["iteration"] for x in t] \
        == [1, 2, 3]
    for a, b in zip(loss_rows(j), loss_rows(t)):
        assert set(a) == set(b) == {"loss_box", "loss_obj", "loss_cls",
                                    "total_loss"}
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=RTOL, atol=ATOL,
                                       err_msg=k)
    assert r["state"].step == 3 and len(r["timings"]) == 3
    assert all(t["host_s"] > 0 for t in r["timings"])

    # a resume to 4 redoes no iteration
    r2 = tyolo.main(argv + ["--resume"] + opts(dataset, tout, 4),
                    device="cpu")
    t2 = read_metrics(r2["metrics"])
    assert [x["iteration"] for x in t2] == [1, 2, 3, 4]
    assert loss_rows(t2[:3]) == loss_rows(t)
    assert r2["state"].step == 4 and len(r2["timings"]) == 1
    assert sorted(os.listdir(tout / NAME / "ckpt")) == ["3", "4"]

    # --eval-only on the port's step 4; the JAX CLI on the same weights
    monkeypatch.setattr(tyolo, "build_model", build)
    tdet = str(tmp_path / "t_dets.json")
    e = tyolo.main(["--config", CONFIG, "--eval-only", "--out-det", tdet]
                   + opts(dataset, tout, 4), device="cpu")
    jdet = str(tmp_path / "j_dets.json")
    trained = convert.yolo_state_dict_to_flax(r2["state"].model)
    from tools import train_yolov4 as jcli
    jax_ap, inner_eval = [], jcli.run_detector_eval

    def run_eval(*a, **kw):
        out = inner_eval(*a, **kw)
        jax_ap.append(out[0])
        return out
    monkeypatch.setattr(jcli, "run_detector_eval", run_eval)
    run_jax_cli(["--config", CONFIG, "--eval-only", "--out-det", jdet]
                + opts(dataset, tmp_path / "j_eval", 4), monkeypatch,
                variables=trained)
    with open(jdet) as f:
        jd = json.load(f)
    with open(tdet) as f:
        td = json.load(f)
    assert sorted(jd) == sorted(td) == sorted(e["dets"]) and len(td) == 5
    for key in jd:
        assert len(jd[key]) == len(td[key]) > 0, key
        for a, b in zip(jd[key], td[key]):
            assert set(a) == set(b) == {"obj_id", "bbox_est", "score", "time"}
            assert a["obj_id"] == b["obj_id"]
            np.testing.assert_allclose(b["bbox_est"], a["bbox_est"], rtol=0,
                                       atol=BOX_TOL)
            np.testing.assert_allclose(b["score"], a["score"], rtol=0,
                                       atol=SCORE_TOL)
    assert jax_ap[0] == e["ap"] and set(e["ap"]) == {"AP", "AP50", "AP75"}
    assert len(e["timings"]) == 3 and e["evaluate_s"] > 0

    # the GDRN eval CLI takes the json as its test detections
    g = tgdrn.main(["--config", CONFIG, "--eval-only", "--det-file", tdet,
                    "--opts", f"data.dataset_root={dataset}",
                    f"output_dir={tmp_path / 'g'}"],
                   device="cpu", impl="plain")
    assert len(g["results"]) > 0 and os.path.exists(g["csv"])


def test_yolov4_cli_defaults_to_cuda(tmp_path):
    """Without --device the CLI runs on the card, and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tyolo.main(["--config", CONFIG, "--opts", f"output_dir={tmp_path}"])
