"""The port's host tools against the JAX package's tools/ on the CPU, on
the JAX generator's synthetic set (2 objects, 160x120) with its GT-box
detections json:

  * tools/gen_pseudo_poses.py at configs/gdrn/synthetic_smoke.py, without
    and with --deepim-config configs/deepim/synthetic_smoke.py (FlowNetS at
    micro widths on both sides, float32), against
    self6dpp_tpu_torch.tools.gen_pseudo_poses.main(device="cpu",
    impl="plain"). Same weights: the JAX tool restores an orbax step that
    its own init wrote (its init_state wrapped here), the port reads a step
    directory of its own made from the same arrays (save_params_npz). The
    jsons agree field by field: keys, obj_id, bbox_est and score exactly,
    pose_est and pose_refine within 1e-4;
  * tools/merge_bop_results.py: the merged CSV byte for byte;
  * tools/compute_fps.py: the same points (the JAX FPS without its native
    library, which breaks ties otherwise);
  * the DeepIM CLI's --init-pose-file, taken and not read as by the JAX
    CLI: --eval-only with it gives the poses of the run without it.
"""

import functools
import json
import sys

import numpy as np
import pytest

import self6dpp_tpu.models.deepim as JDM
import self6dpp_tpu.parallel.mesh as jmesh
from self6dpp_tpu.config import base as jcb
from self6dpp_tpu.engine import deepim_engine as jde
from self6dpp_tpu.engine import gdrn_engine as jge
from self6dpp_tpu.engine.checkpoint import CheckpointManager as JCM
from self6dpp_tpu.engine.checkpoint import save_params_npz
from self6dpp_tpu.models.backbones.flownet import FlowNetS as JFlowNetS
from self6dpp_tpu.ops import fps as jfps
from self6dpp_tpu_torch import config as tc
from self6dpp_tpu_torch.engine import deepim_engine as tde
from self6dpp_tpu_torch.engine.checkpoint import CheckpointManager as TCM
from self6dpp_tpu_torch.engine.checkpoint import load_params_npz
from self6dpp_tpu_torch.engine.gdrn_engine import build_gdrn
from self6dpp_tpu_torch.engine.train_state import TrainState
from self6dpp_tpu_torch.models.deepim import DeepIM
from self6dpp_tpu_torch.tools import gen_pseudo_poses as tgen
from self6dpp_tpu_torch.tools import train_deepim as tdeepim

MICRO = (8, 12, 16, 16, 16, 24)
GDRN_CFG = "configs/gdrn/synthetic_smoke.py"
DEEPIM_CFG = "configs/deepim/synthetic_smoke.py"


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from tools.make_synthetic_bop import generate_full
    return generate_full(str(tmp_path_factory.mktemp("synth")), n_images=5)


def opts(dataset, out):
    return ["--opts", f"data.dataset_root={dataset['root']}",
            f"output_dir={out}", "dist.compute_dtype=float32"]


def float32_deepim(load):
    """load_config with DeepIM's compute dtype float32 (the tools apply no
    --opts to --deepim-config)."""
    import dataclasses

    def wrapped(path):
        cfg = load(path)
        if path.endswith(DEEPIM_CFG):
            cfg = dataclasses.replace(cfg, dist=dataclasses.replace(
                cfg.dist, compute_dtype="float32"))
        return cfg
    return wrapped


def boost_pose_head(state):
    """The DeepIM pose head's output biases at 0.05: at its init the
    refiner moves a pose by ~1e-4, the tolerance; so, by ~1e-2 each
    iteration."""
    import jax

    def f(path, x):
        name = jax.tree_util.keystr(path)
        return x + 0.05 if "pose_head" in name and "fc_" in name \
            and "bias" in name else x
    return state.replace(
        params=jax.tree_util.tree_map_with_path(f, state.params))


def orbax_init(owner, ckpt, npz, monkeypatch, edit=lambda s: s):
    """Wrap owner.init_state so that the state it returns (through edit) is
    also written as orbax step 1 in `ckpt` (which the tool then restores)
    and as a flat npz."""
    inner = owner.init_state

    def init(*a, **kw):
        state = edit(inner(*a, **kw))
        JCM(ckpt).save(state, step=1, force=True)
        save_params_npz(npz, {"params": state.params,
                              "batch_stats": state.batch_stats})
        return state
    monkeypatch.setattr(owner, "init_state", init)


def port_step(model, npz, ckpt):
    """A step directory of the port's holding the npz's weights."""
    load_params_npz(npz, model)
    TCM(ckpt).save(TrainState(step=1, model=model, teacher=None,
                              opt=_NoOpt()), step=1, force=True)


class _NoOpt:
    def state_dict(self):
        return {}


@pytest.mark.parametrize("refine", [False, True], ids=["gdrn", "deepim"])
def test_gen_pseudo_poses_matches_jax(dataset, tmp_path, monkeypatch,
                                      refine):
    from tools import gen_pseudo_poses as jtool
    monkeypatch.setattr(jmesh, "make_mesh", lambda *a, **kw: None)
    monkeypatch.setattr(jfps, "_lib", False)
    monkeypatch.setattr(JDM, "FlowNetS",
                        functools.partial(JFlowNetS, widths=MICRO))
    monkeypatch.setattr(tde, "DeepIM", functools.partial(DeepIM, widths=MICRO))
    monkeypatch.setattr(jcb, "load_config", float32_deepim(jcb.load_config))
    monkeypatch.setattr(tc, "load_config", float32_deepim(tc.load_config))
    j_ck, t_ck = tmp_path / "j_ckpt", tmp_path / "t_ckpt"
    orbax_init(jge, str(j_ck / "gdrn"), str(tmp_path / "gdrn.npz"),
               monkeypatch)
    argv = ["--config", GDRN_CFG, "--det-file", dataset["dets"]]
    if refine:
        orbax_init(jde, str(j_ck / "deepim"), str(tmp_path / "deepim.npz"),
                   monkeypatch, edit=boost_pose_head)
        argv += ["--deepim-config", DEEPIM_CFG]
    out_j, out_t = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    monkeypatch.setattr(sys, "argv", ["gen"] + argv + [
        "--gdrn-ckpt", str(j_ck / "gdrn"), "--out", out_j]
        + (["--deepim-ckpt", str(j_ck / "deepim")] if refine else [])
        + opts(dataset, tmp_path / "j"))
    jtool.main()

    tcfg = tc.apply_overrides(tc.load_config(GDRN_CFG),
                              opts(dataset, "o")[1:])
    port_step(build_gdrn(tcfg, "cpu", seed=1), str(tmp_path / "gdrn.npz"),
              str(t_ck / "gdrn"))
    targv = argv + ["--gdrn-ckpt", str(t_ck / "gdrn"), "--out", out_t]
    if refine:
        dcfg = tc.load_config(DEEPIM_CFG)
        port_step(tde.build_deepim(dcfg, "cpu"), str(tmp_path / "deepim.npz"),
                  str(t_ck / "deepim"))
        targv += ["--deepim-ckpt", str(t_ck / "deepim")]
    r = tgen.main(targv + opts(dataset, tmp_path / "t"), device="cpu",
                  impl="plain")

    with open(out_j) as f:
        j = json.load(f)
    with open(out_t) as f:
        t = json.load(f)
    assert json.loads(json.dumps(r["dets"])) == t
    assert list(j) == list(t) and r["n_rois"] == 10
    poses = ["pose_est"] + (["pose_refine"] if refine else [])
    for key in j:
        assert len(j[key]) == len(t[key]), key
        for a, b in zip(j[key], t[key]):
            assert set(a) == set(b) == {"obj_id", "bbox_est", "score",
                                        *poses}
            assert (a["obj_id"], a["bbox_est"], a["score"]) == \
                (b["obj_id"], b["bbox_est"], b["score"])
            for p in poses:
                np.testing.assert_allclose(b[p], a[p], rtol=0, atol=1e-4,
                                           err_msg=f"{key} {p}")
    if refine:
        moved = [np.abs(np.subtract(e["pose_refine"], e["pose_est"])).max()
                 for es in t.values() for e in es]
        assert max(moved) > 1e-3          # the refiner moved the poses


def _bop_rows(rng, keys, score):
    from scipy.spatial.transform import Rotation
    return [{"scene_id": s, "im_id": i, "obj_id": o, "score": float(score),
             "R": Rotation.random(random_state=int(rng.integers(1 << 30))
                                  ).as_matrix(),
             "t": rng.normal(0, 0.3, 3), "time": float(rng.random())}
            for s, i, o in keys]


def test_merge_bop_results_matches_jax(tmp_path, monkeypatch):
    """Two per-object CSVs overlapping on one key (the higher score wins)
    and a third with a tie: the merged file byte for byte."""
    from self6dpp_tpu.engine.evaluator import save_bop_csv
    from self6dpp_tpu_torch.tools import merge_bop_results as tmerge
    from tools import merge_bop_results as jmerge
    rng = np.random.default_rng(0)
    ins = []
    for n, (keys, score) in enumerate([
            ([(1, 3, 2), (1, 1, 5), (2, 0, 2)], 0.4),
            ([(1, 1, 5), (0, 7, 1)], 0.9),
            ([(2, 0, 2), (0, 0, 3)], 0.4)]):
        p = str(tmp_path / f"in{n}.csv")
        save_bop_csv(p, _bop_rows(rng, keys, score))
        ins.append(p)
    out_j, out_t = str(tmp_path / "j.csv"), str(tmp_path / "t.csv")
    monkeypatch.setattr(sys, "argv", ["merge", out_j] + ins)
    jmerge.main()
    rows = tmerge.main([out_t] + ins)
    assert len(rows) == 5 and rows[2]["score"] == 0.9
    with open(out_j, "rb") as a, open(out_t, "rb") as b:
        assert a.read() == b.read()


def test_compute_fps_matches_jax(dataset, tmp_path, monkeypatch):
    from self6dpp_tpu_torch.tools import compute_fps as tfps
    from tools import compute_fps as jtool
    monkeypatch.setattr(jfps, "_lib", False)
    out_j, out_t = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    monkeypatch.setattr(sys, "argv", ["fps", "--model-dir", dataset["models"],
                                      "--num-points", "16", "--out", out_j])
    jtool.main()
    r = tfps.main(["--model-dir", dataset["models"], "--num-points", "16",
                   "--out", out_t])
    with open(out_j) as a, open(out_t) as b:
        j, t = json.load(a), json.load(b)
    assert sorted(j) == sorted(t) == ["1", "2"] and t == r
    for k in j:
        assert np.asarray(t[k]).shape == (16, 3)
        assert t[k] == j[k], k


def test_deepim_eval_ignores_init_pose_file(dataset, tmp_path, monkeypatch,
                                            caplog):
    """test_deepim.sh CFG --init-pose-file x.json: the flag is taken, a
    warning says it is not read, and the poses are those of the run without
    it (ground truth plus the seeded noise, as the JAX CLI's)."""
    monkeypatch.setattr(tde, "DeepIM", functools.partial(DeepIM, widths=MICRO))
    argv = ["--config", DEEPIM_CFG, "--eval-only"] + \
        opts(dataset, tmp_path / "o")
    a = tdeepim.main(argv, device="cpu", impl="plain")
    with caplog.at_level("WARNING", logger="self6dpp_tpu_torch"):
        b = tdeepim.main(argv[:3] + ["--init-pose-file",
                                     str(tmp_path / "absent.json")]
                         + argv[3:], device="cpu", impl="plain")
    assert "init-pose-file" in caplog.text
    assert len(a["results"]) == len(b["results"]) == 10
    for x, y in zip(a["results"], b["results"]):
        assert np.array_equal(x["R"], y["R"]) and \
            np.array_equal(x["t"], y["t"])
