"""The port's loader against the JAX package's on the CPU, on the JAX
generator's miniature BOP set (1 scene, 3 images, 2 objects): every batch
equal key for key, roi_img and roi_coord_2d within 1e-5, masks and regions
equal, gt_xyz within one float16 step of the label cache. Eval batches,
and train batches from every sampler with colour, depth and background
augmentation and the DZI jitter, drawn from one seed. The JAX loader
renders its labels through its XLA rasterizer; the port's through its
plain fine stage on the CPU (kernel B1 on the card)."""

import dataclasses
import itertools

import numpy as np
import pytest

from self6dpp_tpu.config import base as jc
from self6dpp_tpu.data import bop as jbop
from self6dpp_tpu.data import loader as jloader
from self6dpp_tpu.data.meshes import make_cube, make_icosphere
from self6dpp_tpu.data.ref import get_meta
from self6dpp_tpu.ops import fps as jfps
from self6dpp_tpu_torch import config as tc
from self6dpp_tpu_torch.data import bop as tbop
from self6dpp_tpu_torch.data import loader as tloader
from self6dpp_tpu_torch.data import ref as tref

EXACT = ("gt_mask_visib", "gt_mask_full", "gt_mask_obj", "gt_mask_trunc",
         "gt_region", "gt_xyz_bin", "roi_cls", "_valid", "roi_depth",
         "full_depth")


@pytest.fixture(scope="module")
def bop_split(tmp_path_factory):
    from tools.make_synthetic_bop import generate
    return generate(str(tmp_path_factory.mktemp("bop")), n_scenes=1,
                    n_images=3)


@pytest.fixture(scope="module")
def meshes():
    v1, f1 = make_cube(size=0.12)
    v2, f2 = make_icosphere(radius=0.07, subdivisions=2)
    return [{"verts": v1, "faces": f1}, {"verts": v2, "faces": f2}]


def configs(with_vf_norm=False, **data):
    """The JAX and port configs at test size (2 classes, 64² -> 16², 8
    regions), with the same data settings."""
    gh = dict(feat_dim=16, num_gn_groups=4, num_regions=8)
    if with_vf_norm:
        gh.update(xyz_bin=1, num_masks=2, with_vf=True, with_norm=True,
                  num_vf_points=4)
    out = []
    for m in (jc, tc):
        model = m.PoseNetConfig(
            num_classes=2, input_res=64, output_res=16,
            backbone=m.BackboneConfig(name="resnet18"),
            geo_head=m.GeoHeadConfig(**gh),
            pnp_net=m.PnPNetConfig(featdim=16, num_gn_groups=4))
        out.append(m.Config(model=model,
                            data=m.DataConfig(model_points=64, max_sym_rots=4,
                                              **data)))
    return out


def assert_batches_equal(jb, tb):
    assert len(jb) == len(tb) and len(jb) > 0
    for a, b in zip(jb, tb):
        assert set(a) == set(b), set(a) ^ set(b)
        for k in a:
            x, y = a[k], b[k]
            assert x.shape == y.shape and x.dtype == y.dtype, k
            if k in ("roi_img", "roi_coord_2d"):
                np.testing.assert_allclose(y, x, rtol=0, atol=1e-5, err_msg=k)
            elif k == "gt_xyz":
                # one float16 step of the cached object-frame xyz, normalised
                ext = a["roi_extent"][:, None, None]
                step = np.spacing(np.abs((x - 0.5) * ext).astype(np.float16)
                                  ).astype(np.float32) / ext
                assert (np.abs(y - x) <= step * 1.0001 + 1e-7).all()
            elif k == "gt_norm":
                np.testing.assert_allclose(y, x, rtol=0, atol=2e-3, err_msg=k)
            elif k in EXACT or x.dtype != np.float32:
                assert np.array_equal(x, y), k
            else:
                np.testing.assert_allclose(y, x, rtol=1e-6, atol=1e-6,
                                           err_msg=k)


def run_both(bop_split, meshes, monkeypatch, cfgs, batch_size=3,
             det=None, train=False, n_batches=None, bg_images=None,
             **batch_kw):
    monkeypatch.setattr(jfps, "_lib", False)
    jcfg, tcfg = cfgs
    kw = dict(n_regions=8, n_points=64, max_sym=4)
    jm = jloader.ObjectModels.from_meshes(["ape", "can"], meshes, **kw)
    tm = tloader.ObjectModels.from_meshes(["ape", "can"], meshes, **kw)
    jr, tr = jbop.load_bop_split(bop_split), tbop.load_bop_split(bop_split)
    if det is not None:
        jr = jbop.inject_detections(jr, det)
        tr = tbop.inject_detections(tr, det)
    jd = jloader.GDRNDataset(jcfg, jr, jm, get_meta("lm"), train=train,
                             seed=5, bg_images=bg_images)
    td = tloader.GDRNDataset(tcfg, tr, tm, tref.get_meta("lm"), train=train,
                             seed=5, device="cpu", impl="plain",
                             bg_images=bg_images)
    jb = list(itertools.islice(jd.batches(batch_size, **batch_kw), n_batches))
    tb = list(itertools.islice(td.batches(batch_size, **batch_kw), n_batches))
    return jb, tb, td


@pytest.mark.parametrize("label_cache", [True, False])
def test_eval_batches_match_jax(bop_split, meshes, monkeypatch, label_cache):
    """6 instances in batches of 4: the second padded, with _valid; the
    observed full-frame depth emitted for VSD."""
    jb, tb, td = run_both(bop_split, meshes, monkeypatch,
                          configs(label_cache=label_cache), batch_size=4,
                          num_workers=0)
    assert_batches_equal(jb, tb)
    assert [b["_valid"].tolist() for b in tb] == [[1] * 4, [1, 1, 0, 0]]
    assert "full_depth" in tb[0] and tb[0]["gt_mask_obj"].sum() > 0
    assert len(td.timings) == 2 and td.timings[0]["label_render_s"] > 0


def test_eval_batches_depth_vf_norm_workers_match_jax(bop_split, meshes,
                                                      monkeypatch):
    """roi_depth crops, the MaskNormVF labels (vector fields, normals from
    the 6-channel cache), the thread pool and the prefetch thread."""
    jb, tb, _ = run_both(bop_split, meshes, monkeypatch,
                         configs(with_vf_norm=True, with_depth=True),
                         num_workers=2, prefetch=1)
    assert_batches_equal(jb, tb)
    assert {"roi_depth", "gt_vf_vis", "gt_vf_full", "gt_norm"} <= set(tb[0])


def test_eval_batches_with_detections_match_jax(bop_split, meshes,
                                                monkeypatch):
    """Detected boxes and initial poses injected from a detection json."""
    rng = np.random.default_rng(0)
    det = {r.scene_im_id: [
        {"obj_id": i.obj_id, "score": 0.9,
         "bbox_est": [float(i.bbox_visib[0]) + 2, float(i.bbox_visib[1]) - 1,
                      float(i.bbox_visib[2] - i.bbox_visib[0]),
                      float(i.bbox_visib[3] - i.bbox_visib[1]) + 3],
         "pose_est": rng.random(12).tolist()} for i in r.instances]
        for r in tbop.load_bop_split(bop_split)}
    jb, tb, _ = run_both(bop_split, meshes, monkeypatch, configs(),
                         det=det, num_workers=0)
    assert_batches_equal(jb, tb)
    assert "pose_est_rot" in tb[0]


@pytest.mark.parametrize("sampler,workers", [
    ("training", 0), ("repeat_factor", 2), ("inf_subset", 0)])
def test_train_batches_match_jax(bop_split, meshes, monkeypatch, sampler,
                                 workers):
    """3 sampled batches of 4 (the stream wraps the 6 instances): colour
    augmentation and depth noise on every sample, the uniform DZI jitter;
    with workers, the thread pool's child generators and the prefetch
    thread."""
    cfgs = configs(sampler=sampler, color_aug_prob=1.0, with_depth=True,
                   depth_aug_prob=1.0, repeat_thresh=0.9, subset_ratio=0.5)
    jb, tb, td = run_both(bop_split, meshes, monkeypatch, cfgs, batch_size=4,
                          train=True, n_batches=3, num_workers=workers,
                          prefetch=1)
    assert_batches_equal(jb, tb)
    assert "_valid" not in tb[0] and "full_depth" not in tb[0]
    assert len(td.timings) >= 3


def test_train_batches_with_background_match_jax(bop_split, meshes,
                                                 monkeypatch):
    """Background replacement at probability 1 with the foreground cut
    (truncate_fg), from backgrounds of another size (resized as
    cv2.resize does) and of the frame's."""
    rng = np.random.default_rng(3)
    bgs = [rng.random((50, 70, 3)).astype(np.float32),
           rng.random((120, 160, 3)).astype(np.float32)]
    cfgs = configs(bg_replace_prob=1.0, truncate_fg=True,
                   color_aug_prob=0.5)
    jb, tb, _ = run_both(bop_split, meshes, monkeypatch, cfgs, batch_size=3,
                         train=True, n_batches=2, bg_images=bgs,
                         num_workers=0)
    assert_batches_equal(jb, tb)


def test_loader_refuses_the_training_mode(bop_split, meshes):
    """The training mode refuses a sampler it does not have, as the JAX
    package's does."""
    _, cfg = configs(sampler="nope")
    tm = tloader.ObjectModels.from_meshes(["ape", "can"], meshes, n_regions=8,
                                          n_points=64, max_sym=4)
    recs = tbop.load_bop_split(bop_split)
    ds = tloader.GDRNDataset(cfg, recs, tm, tref.get_meta("lm"), train=True,
                             device="cpu")
    with pytest.raises(ValueError, match="unknown sampler"):
        next(ds.batches(2, num_workers=0))


def test_prefetch_raises_the_producers_error():
    def produce():
        yield 1
        raise ValueError("render failed")
    it = tloader._prefetch_iterator(produce(), 2)
    assert next(it) == 1
    with pytest.raises(ValueError, match="render failed"):
        next(it)


def test_compute_vf_np_matches_jax():
    rng = np.random.default_rng(1)
    kp = rng.random((5, 4, 3)).astype(np.float32) * 0.1
    K = np.broadcast_to(np.array([[160.0, 0, 80], [0, 160, 60], [0, 0, 1]],
                                 np.float32), (5, 3, 3))
    from scipy.spatial.transform import Rotation
    R = Rotation.random(5, random_state=2).as_matrix().astype(np.float32)
    t = np.array([0, 0, 0.7], np.float32) + rng.random((5, 3)) * 0.05
    c = rng.uniform(60, 100, (5, 2)).astype(np.float32)
    s = rng.uniform(40, 80, 5).astype(np.float32)
    m = (rng.random((5, 16, 16)) > 0.4).astype(np.float32)
    np.testing.assert_array_equal(
        tloader.compute_vf_np_batch(kp, K, R, t, c, s, 16, m),
        jloader.compute_vf_np_batch(kp, K, R, t, c, s, 16, m))
    np.testing.assert_array_equal(
        tloader.compute_vf_np(kp[0], K[0], R[0], t[0], c[0], s[0], 16, m[0]),
        jloader.compute_vf_np(kp[0], K[0], R[0], t[0], c[0], s[0], 16, m[0]))
