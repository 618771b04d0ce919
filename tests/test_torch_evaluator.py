"""The port's evaluator against the JAX package's on the CPU, on the JAX
generator's miniature BOP set: the recall and BOP19 tables of the same
predictions equal (VSD on full-frame renders: the JAX XLA rasterizer
against the port's plain fine stage), the BOP CSV text equal, the
markdown equal; the inference loop's warm-up, timing and padding."""

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from self6dpp_tpu.data import loader as jloader
from self6dpp_tpu.data.ref import get_meta
from self6dpp_tpu.engine import evaluator as JE
from self6dpp_tpu.ops import fps as jfps
from self6dpp_tpu_torch import config as tc
from self6dpp_tpu_torch.data import bop as tbop
from self6dpp_tpu_torch.data import loader as tloader
from self6dpp_tpu_torch.data import ref as tref
from self6dpp_tpu_torch.data.meshes import make_cube, make_icosphere
from self6dpp_tpu_torch.engine import evaluator as TE

# percentages of counts: equal; means of errors: within 1e-5 relative
RECALL_KEYS = ("ad_", "rete_", "re_", "te_", "proj_", "ar_", "bop19_ar", "n")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    from tools.make_synthetic_bop import generate
    split = generate(str(tmp_path_factory.mktemp("bop")), n_scenes=1,
                     n_images=4)
    v1, f1 = make_cube(size=0.12)
    v2, f2 = make_icosphere(radius=0.07, subdivisions=2)
    meshes = [{"verts": v1, "faces": f1}, {"verts": v2, "faces": f2}]
    kw = dict(n_regions=8, n_points=64, max_sym=4, sym_names=("can",))
    jfps._lib, lib = False, jfps._lib
    jm = jloader.ObjectModels.from_meshes(["ape", "can"], meshes, **kw)
    jfps._lib = lib
    tm = tloader.ObjectModels.from_meshes(["ape", "can"], meshes, **kw)
    cfg = tc.Config(model=tc.PoseNetConfig(num_classes=2, input_res=32,
                                           output_res=8),
                    data=tc.DataConfig(model_points=64, max_sym_rots=4))
    ds = tloader.GDRNDataset(cfg, tbop.load_bop_split(split), tm,
                             tref.get_meta("synthetic"), device="cpu", impl="plain")
    batches = list(ds.batches(3, num_workers=0))
    return jm, tm, batches


def predictions(batches, seed=0):
    """GT poses perturbed (5 deg, 1 cm), every third left exact."""
    rng = np.random.default_rng(seed)
    outs = []
    for b in batches:
        n = len(b["gt_rot"])
        dR = Rotation.from_euler("xyz", rng.normal(0, 5, (n, 3)),
                                 degrees=True).as_matrix()
        rot = (dR @ b["gt_rot"]).astype(np.float32)
        trans = (b["gt_trans"] + rng.normal(0, 0.01, (n, 3))).astype(np.float32)
        rot[::3], trans[::3] = b["gt_rot"][::3], b["gt_trans"][::3]
        outs.append({"rot": rot, "trans": trans, "time": 0.25})
    return outs


def assert_tables_equal(j, t):
    assert list(j) == list(t)
    for name in j:
        assert set(j[name]) == set(t[name]), name
        for k, x in j[name].items():
            if k.startswith(RECALL_KEYS):
                assert t[name][k] == x, (name, k, x, t[name][k])
            else:
                np.testing.assert_allclose(t[name][k], x, rtol=1e-5,
                                           err_msg=f"{name}.{k}")


def test_tables_and_csv_match_jax(data):
    jm, tm, batches = data
    je = JE.PoseEvaluator(jm, get_meta("synthetic"))
    te = TE.PoseEvaluator(tm, tref.get_meta("synthetic"), device="cpu",
                          impl="plain")
    for b, out in zip(batches, predictions(batches)):
        je.process(b, out)
        te.process(b, {"rot": torch.as_tensor(out["rot"]),
                       "trans": torch.as_tensor(out["trans"]), "time": 0.25})
    jt = je.evaluate(bop19=True, vsd_chunk=3)
    tt = te.evaluate(bop19=True, vsd_chunk=3)
    assert_tables_equal(jt, tt)
    assert tt["avg"]["n"] == 4 and 0 < tt["avg"]["ad_10"] < 100
    assert 0 < tt["avg"]["bop19_ar"] < 100
    assert TE.table_to_markdown(tt) == JE.table_to_markdown(jt)
    assert_tables_equal(je.evaluate(), te.evaluate())
    rows = te.results_for_csv()
    assert TE.bop_csv_rows(rows) == JE.bop_csv_rows(je.results_for_csv())


def test_csv_roundtrip_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    rows = [{"scene_id": 1, "im_id": i, "obj_id": 2, "score": 0.5,
             "R": Rotation.random(random_state=i).as_matrix(),
             "t": rng.normal(0, 0.1, 3), "time": 0.01} for i in range(3)]
    rows.append({"scene_id": 2, "im_id": 0, "obj_id": 1, "R": np.eye(3),
                 "t": np.zeros(3)})
    p = str(tmp_path / "sub" / "r.csv")
    TE.save_bop_csv(p, rows)
    assert open(p).read() == JE.bop_csv_rows(rows)
    for a, b in zip(JE.load_bop_csv(p), TE.load_bop_csv(p)):
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(a[k], b[k]), k


def test_run_inference_warms_up_and_times(data):
    jm, tm, batches = data
    calls = []

    def eval_fn(db):
        calls.append(db["roi_img"].shape[0])
        assert "full_depth" not in db and "_valid" not in db
        return {"rot": db["gt_rot"], "trans": db["gt_trans"]}

    ev = TE.PoseEvaluator(tm, tref.get_meta("synthetic"), device="cpu")
    TE.run_inference(eval_fn, iter(batches), ev, device="cpu")
    assert len(calls) == len(batches) + 1            # one untimed warm-up
    assert len(ev.timings) == len(batches)
    n_valid = sum(int(b["_valid"].sum()) for b in batches)
    assert n_valid < len(batches) * 3                # the last one padded
    assert sum(len(p) for p in ev.preds.values()) == n_valid
    assert all(p["time"] >= 0 for p in ev.results_for_csv())
    t = ev.evaluate()
    assert t["avg"]["ad_2"] == 100.0 and t["avg"]["re_2"] == 100.0


def test_resize_depth_nearest_matches_jax():
    d = np.random.default_rng(2).random((48, 64)).astype(np.float32)
    assert np.array_equal(TE._resize_depth_nearest(d, 24, 32),
                          JE._resize_depth_nearest(d, 24, 32))
    assert TE.HOST_ONLY_KEYS == JE.HOST_ONLY_KEYS
