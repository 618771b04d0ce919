"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Imports neither JAX nor the JAX package, so it runs on a machine with a
card and no JAX:

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -q

Without a CUDA device every test here skips.
"""

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from self6dpp_tpu_torch.data.meshes import make_icosphere
from self6dpp_tpu_torch.ops import lab_cuda as LC
from self6dpp_tpu_torch.ops import raster_cuda as RC
from self6dpp_tpu_torch.ops import rasterizer as TR
from self6dpp_tpu_torch.ops import sign_cuda as SC


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def sphere_inputs(dev, height, width, tile_px, n_attr=3):
    verts, faces = make_icosphere(radius=0.2, subdivisions=3)
    colors = (verts[:, :n_attr] / 0.4 + 0.5).astype(np.float32)
    K = np.array([[300.0, 0, 100.0], [0, 300.0, 90.0], [0, 0, 1.0]],
                 np.float32)
    R = Rotation.random(3, random_state=4).as_matrix()
    t = np.array([[0.0, 0.0, 1.0], [0.05, -0.03, 1.2], [-0.1, 0.0, 0.9]])
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    return TR.raster_inputs(f32(verts), torch.as_tensor(faces, device=dev),
                            f32(colors), f32(K), f32(R), f32(t), height,
                            width, tile_px, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("with_prob,persp,tile_px,n_attr", [
    (False, True, 16, 3), (True, True, 16, 3), (False, False, 16, 3),
    (True, False, 16, 3), (True, True, 8, 1), (False, True, 32, 2)])
def test_fine_raster_matches_plain(cuda_device, with_prob, persp, tile_px,
                                   n_attr):
    """Built with --fmad=false, the kernel's edge tests round as the plain
    version's: mask and face_id agree exactly (ragged 190x200 image); the
    rest within 1e-5 (the silhouette product is taken in another order)."""
    ftab, cand = sphere_inputs(cuda_device, 190, 200, tile_px, n_attr)
    before = RC.fine_raster.launches
    call = (ftab, cand, 190, 200, tile_px, 1.0, with_prob, persp)
    got = RC.fine_raster(*call)
    torch.cuda.synchronize()
    assert RC.fine_raster.launches == before + 1
    ref = RC.fine_raster_plain(*call)
    assert torch.equal(got.mask, ref.mask)
    assert torch.equal(got.face_id, ref.face_id)
    assert ref.mask.sum() > 0
    for name in ("prob", "depth", "attr", "bary"):
        torch.testing.assert_close(getattr(got, name), getattr(ref, name),
                                   rtol=0, atol=1e-5, msg=name)


def eval_inputs(dev, which):
    """Face tables and candidates at the eval slice's two B1 shapes:
    'label_cache', the loader's ground-truth renders (24 instances of a
    2-subdivision icosphere in their cache frames, 128², tile 8, K 64);
    'vsd', the evaluator's depth renders (8 poses of a 5120-face icosphere
    in LM's 480x640 frame, tile 16, K 128, zero attributes)."""
    from self6dpp_tpu_torch.ops.zoom import zoom_K
    rng = np.random.default_rng(5)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    if which == "label_cache":
        b, res, tile, k = 24, 128, 8, 64
        verts, faces = make_icosphere(radius=0.07, subdivisions=2)
        attrs = verts
        K = np.array([[160.0, 0, 80], [0, 160, 60], [0, 0, 1]], np.float32)
        t = np.stack([rng.uniform(-0.1, 0.1, b), rng.uniform(-0.08, 0.08, b),
                      rng.uniform(0.6, 0.9, b)], 1)
        c = t[:, :2] / t[:, 2:] * 160 + [80, 60]          # projected centre
        side = 2 * 0.07 * 160 / t[:, 2] * 2.0             # covers the crops
        boxes = np.concatenate([c - side[:, None] / 2, c + side[:, None] / 2], 1)
        K = zoom_K(f32(K), f32(boxes), (res, res))
        h = w = res
    else:
        b, h, w, tile, k = 8, 480, 640, 16, 128
        verts, faces = make_icosphere(radius=0.08, subdivisions=4)
        attrs = np.zeros_like(verts)
        K = f32(np.broadcast_to([[572.4114, 0, 325.2611],
                                 [0, 573.57043, 242.04899], [0, 0, 1]],
                                (b, 3, 3)))
        z = rng.uniform(0.6, 1.2, b)
        uv = rng.uniform([100, 80], [540, 400], (b, 2))
        t = np.stack([(uv[:, 0] - 325.26) / 572.41 * z,
                      (uv[:, 1] - 242.05) / 573.57 * z, z], 1)
    R = Rotation.random(b, random_state=6).as_matrix()
    ftab, cand = TR.raster_inputs(f32(verts), torch.as_tensor(faces, device=dev),
                                  f32(attrs), K, f32(R), f32(t), h, w, tile, k)
    return (ftab, cand, h, w, tile, 1.0, False, True)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["label_cache", "vsd"])
def test_fine_raster_eval_shapes_match_plain(cuda_device, which):
    """B1 at the loader's label renders and the evaluator's VSD renders
    (hard, perspective z) against its plain version: mask and face_id bit
    for bit, depth and attributes within 1e-5."""
    call = eval_inputs(cuda_device, which)
    assert RC.cand_depth_sorted(call[0], call[1])
    before = RC.fine_raster.launches
    got = RC.fine_raster(*call)
    torch.cuda.synchronize()
    assert RC.fine_raster.launches == before + 1
    ref = RC.fine_raster_plain(*call)
    assert torch.equal(got.mask, ref.mask)
    assert torch.equal(got.face_id, ref.face_id)
    assert (ref.mask.flatten(1).sum(1) > 0).all()
    for name in ("depth", "attr", "bary"):
        torch.testing.assert_close(getattr(got, name), getattr(ref, name),
                                   rtol=0, atol=1e-5, msg=name)


@pytest.mark.cuda
def test_fine_raster_rejects_bad_inputs(cuda_device):
    ftab, cand = sphere_inputs(cuda_device, 64, 64, 16)
    with pytest.raises(ValueError, match="tiles"):
        RC.fine_raster(ftab, cand, 64, 80, 16, 1.0, False, True)
    with pytest.raises(TypeError):
        RC.fine_raster(ftab, cand.long(), 64, 64, 16, 1.0, False, True)
    with pytest.raises(ValueError, match="CUDA device"):
        RC.fine_raster(ftab, cand.cpu(), 64, 64, 16, 1.0, False, True)
    ftab4, cand4 = sphere_inputs(cuda_device, 64, 64, 4)
    with pytest.raises(ValueError, match="multiple of 8"):
        RC.fine_raster(ftab4, cand4, 64, 64, 4, 1.0, False, True)
    cts = cotangents(cuda_device, 64, 64, 3)
    with pytest.raises(ValueError, match="face_id"):
        RC.fine_raster_bwd(ftab, cand, *cts, 64, 64, 16, 1.0, True, True,
                           None)


def cotangents(dev, height, width, n_attr, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    shapes = ((3, height, width), (3, height, width), (3, height, width, n_attr))
    return [torch.randn(s, generator=g).to(dev) for s in shapes]


@pytest.mark.cuda
@pytest.mark.parametrize("with_prob,persp,tile_px,n_attr", [
    (True, True, 16, 3), (True, False, 16, 3), (False, True, 32, 3),
    (True, True, 32, 2), (True, True, 8, 1)])
def test_fine_raster_bwd_matches_plain(cuda_device, with_prob, persp, tile_px,
                                       n_attr):
    """Kernel B2, fed B1's saved face_id and keep, against
    fine_raster_bwd_plain, which recomputes them, on a ragged 190x200
    image: d ftab within 1e-4 of its largest magnitude (global atomics sum
    in another order)."""
    ftab, cand = sphere_inputs(cuda_device, 190, 200, tile_px, n_attr)
    dprob, ddepth, dattr = cotangents(cuda_device, 190, 200, n_attr)
    call = (ftab, cand, dprob, ddepth, dattr, 190, 200, tile_px, 1.5,
            with_prob, persp)
    out, keep = RC._fine(ftab, cand, 190, 200, tile_px, 1.5, with_prob,
                         persp, True)
    before = RC.fine_raster_bwd.launches
    got = RC.fine_raster_bwd(*call, (out.face_id, keep))
    torch.cuda.synchronize()
    assert RC.fine_raster_bwd.launches == before + 1
    ref = RC.fine_raster_bwd_plain(*call)
    scale = ref.abs().max().item()
    assert scale > 0
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-4 * scale)
    assert not got[..., 7].any()                       # `valid` gets nothing


@pytest.mark.cuda
@pytest.mark.parametrize("tile_px", [16, 32])
def test_saved_keep_matches_slot_order_product(cuda_device, tile_px):
    """B1's saved keep equals, bit for bit, prod(1 - p) multiplied slot by
    slot with plain operations on the card (the old backward's recompute):
    culled faces multiply by exactly 1 and a covered pixel's product is
    exactly 0. The same product on the CPU (another exp) agrees within
    1e-6; prob is 1 - keep."""
    ftab, cand = sphere_inputs(cuda_device, 190, 200, tile_px)
    assert RC.cand_depth_sorted(ftab, cand)
    out, keep = RC._fine(ftab, cand, 190, 200, tile_px, 1.5, True, True, True)
    ref = RC.keep_slot_order_plain(ftab, cand, 190, 200, tile_px, 1.5)
    assert torch.equal(keep.view(torch.int32), ref.view(torch.int32))
    assert torch.equal(1.0 - keep, out.prob)
    assert (keep[out.mask > 0] == 0).all() and ((keep > 0) & (keep < 1)).any()
    cpu = RC.keep_slot_order_plain(ftab.cpu(), cand.cpu(), 190, 200, tile_px,
                                   1.5)
    torch.testing.assert_close(keep.cpu(), cpu, rtol=0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("persp", [True, False])
@pytest.mark.parametrize("sigma", [1.0, 1.5])
def test_culling_is_exact_on_scattered_faces(cuda_device, persp, sigma):
    """On raster_cuda.scattered_faces both kernels' cutoffs fall inside
    tiles: B1's mask and face_id equal the plain version's bitwise (floats
    within 1e-5), B2 on cotangents that cover some warps' pixels only (and
    no pixel of each image's first tile) within 1e-4 of its largest
    magnitude, and zero cotangents give a zero d ftab."""
    ftab, cand, cts = RC.scattered_faces(cuda_device)
    call = (ftab, cand, 70, 100, 32, sigma, True, persp)
    out, keep = RC._fine(*call, True)
    torch.cuda.synchronize()
    ref = RC.fine_raster_plain(*call)
    assert torch.equal(out.mask, ref.mask)
    assert torch.equal(out.face_id, ref.face_id)
    assert ref.mask.sum() > 0
    for name in ("prob", "depth", "attr", "bary"):
        torch.testing.assert_close(getattr(out, name), getattr(ref, name),
                                   rtol=0, atol=1e-5, msg=name)
    bcall = (ftab, cand, *cts, 70, 100, 32, sigma, True, persp)
    got = RC.fine_raster_bwd(*bcall, (out.face_id, keep))
    want = RC.fine_raster_bwd_plain(*bcall)
    scale = want.abs().max().item()
    assert scale > 0
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * scale)
    zero = [torch.zeros_like(c) for c in cts]
    assert not RC.fine_raster_bwd(ftab, cand, *zero, 70, 100, 32, sigma,
                                  True, persp, (out.face_id, keep)).any()


@pytest.mark.cuda
def test_kernel_backward_skips_the_scatter(cuda_device, monkeypatch):
    """FineRaster's kernel path launches B1 and B2 once each and never runs
    scatter_to_faces, the plain backward's sum into d ftab."""
    def no_scatter(*args):
        raise AssertionError("scatter_to_faces on the kernel path")
    monkeypatch.setattr(RC, "scatter_to_faces", no_scatter)
    ftab, cand = sphere_inputs(cuda_device, 128, 96, 32)
    ftab.requires_grad_(True)
    before = (RC.fine_raster.launches, RC.fine_raster_bwd.launches)
    out = RC.FineRaster.apply(ftab, cand, 128, 96, 32, 1.5, True, True,
                              "kernel")
    (g,) = torch.autograd.grad(out[1].sum() + out[3].sum(), ftab)
    torch.cuda.synchronize()
    assert (RC.fine_raster.launches - before[0],
            RC.fine_raster_bwd.launches - before[1]) == (1, 1)
    assert g.abs().max() > 0


@pytest.mark.cuda
def test_rasterize_batch_gradient_through_kernels(cuda_device):
    """Autograd through FineRaster: B1 forward and B2 backward on CUDA
    tensors give the pose and colour gradients of the plain versions."""
    verts, faces = make_icosphere(radius=0.2, subdivisions=3)
    colors = (verts / 0.4 + 0.5).astype(np.float32)
    K = np.array([[300.0, 0, 64.0], [0, 300.0, 60.0], [0, 0, 1.0]], np.float32)
    R = Rotation.random(2, random_state=5).as_matrix().astype(np.float32)
    t = np.array([[0.01, -0.02, 1.0], [0.03, 0.0, 1.1]], np.float32)
    grads = {}
    for impl in ("kernel", "plain"):
        args = [torch.tensor(x, device=cuda_device, requires_grad=True)
                for x in (t, R, colors)]
        before = (RC.fine_raster.launches, RC.fine_raster_bwd.launches)
        out = TR.rasterize_batch(verts, faces, args[2], K, args[1], args[0],
                                 height=128, width=120, tile_px=32,
                                 faces_per_tile=128, sigma_px=1.5,
                                 impl=impl, device=cuda_device)
        (out.prob.sum() * 1e-2 + (out.attr ** 2).sum()
         + out.depth.sum()).backward()
        torch.cuda.synchronize()
        launched = (RC.fine_raster.launches - before[0],
                    RC.fine_raster_bwd.launches - before[1])
        assert launched == ((1, 1) if impl == "kernel" else (0, 0))
        grads[impl] = [a.grad for a in args]
    for name, a, b in zip(("t", "R", "colors"), grads["kernel"], grads["plain"]):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-4 * b.abs().max().item(), msg=name)


@pytest.mark.cuda
def test_fine_raster_at_the_normal_render_shape(cuda_device):
    """B1 as the MaskNormVF pose step launches it for the normal-map
    pseudo label (stage2_masknormvf, 8 ROIs): 64² output, 32 px tiles,
    K = 128, the three camera-frame normal channels, no silhouette; its
    candidates depth-sorted; mask and face_id bit for bit, the rest within
    1e-4 of the plain version, one launch."""
    from self6dpp_tpu_torch.config import stage2_masknormvf
    from self6dpp_tpu_torch.engine import self_engine as SE
    cfg = stage2_masknormvf()
    b = SE.stage2_batch(cfg, 8, cuda_device)
    args, kw = SE.normal_render_args(cfg, b, b["gt_rot"], b["gt_trans"])
    assert (kw["height"], kw["tile_px"], kw["faces_per_tile"]) == (64, 32, 128)
    assert not kw["with_prob"] and args[2].shape[-1] == 3
    o, tp = kw["height"], kw["tile_px"]
    ftab, cand = TR.raster_inputs(*args, o, o, tp, kw["faces_per_tile"])
    assert RC.cand_depth_sorted(ftab, cand)
    call = (ftab, cand, o, o, tp, 1.0, False, True)
    before = RC.fine_raster.launches
    got = RC.fine_raster(*call)
    torch.cuda.synchronize()
    assert RC.fine_raster.launches == before + 1
    ref = RC.fine_raster_plain(*call)
    assert torch.equal(got.mask, ref.mask)
    assert torch.equal(got.face_id, ref.face_id)
    assert (ref.mask.flatten(1).sum(1) > 0).all()
    for name in ("depth", "attr", "bary"):
        torch.testing.assert_close(getattr(got, name), getattr(ref, name),
                                   rtol=0, atol=1e-4, msg=name)


@pytest.mark.cuda
def test_fine_raster_at_the_deepim_train_shape(cuda_device):
    """B1 as the DeepIM train step launches it for the ground-truth render
    (lm_flownet): 8 ROIs of a 5120-face icosphere, the 512² zoomed frame
    of a perturbed pose, 16 px tiles, K = 128, hard; candidates
    depth-sorted; mask and face_id bit for bit, depth and attr within 1e-4
    of the plain version, one launch."""
    from self6dpp_tpu_torch.config import lm_flownet
    from self6dpp_tpu_torch.ops.zoom import (bboxes_from_pose,
                                             centers_2d_from_pose,
                                             deepim_boxes, zoom_K)
    cfg = lm_flownet()
    d, r = cfg.deepim, cfg.renderer
    verts, faces = make_icosphere(radius=0.07, subdivisions=4)
    rng = np.random.default_rng(0)
    b = 8
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=cuda_device)
    K = f32(np.broadcast_to([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1]],
                            (b, 3, 3)))
    R = f32(Rotation.random(b, random_state=1).as_matrix())
    t = f32(np.stack([rng.uniform(-0.1, 0.1, b), rng.uniform(-0.1, 0.1, b),
                      rng.uniform(0.6, 1.4, b)], 1))
    R0 = f32(Rotation.from_euler("xyz", rng.normal(0, 15, (b, 3)),
                                 degrees=True).as_matrix()) @ R
    t0 = t + f32(rng.normal(0, [0.01, 0.01, 0.05], (b, 3)))
    V = f32(verts).expand(b, -1, -1)
    boxes, _ = deepim_boxes(bboxes_from_pose(V, K, R0, t0),
                            centers_2d_from_pose(K, R0, t0),
                            obs_boxes=bboxes_from_pose(V, K, R, t),
                            lamb=d.zoom_lamb, out_hw=(d.input_h, d.input_w))
    Kz = zoom_K(K, boxes, (d.input_h, d.input_w))
    ftab, cand = TR.raster_inputs(V, torch.as_tensor(faces, device=cuda_device),
                                  V, Kz, R, t, d.input_h, d.input_w,
                                  r.tile_px, r.faces_per_tile)
    assert RC.cand_depth_sorted(ftab, cand)
    call = (ftab, cand, d.input_h, d.input_w, r.tile_px, 1.0, False, True)
    before = RC.fine_raster.launches
    got = RC.fine_raster(*call)
    torch.cuda.synchronize()
    assert RC.fine_raster.launches == before + 1
    ref = RC.fine_raster_plain(*call)
    assert torch.equal(got.mask, ref.mask)
    assert torch.equal(got.face_id, ref.face_id)
    assert (ref.mask.flatten(1).sum(1) > 0).all()
    for name in ("depth", "attr", "bary"):
        torch.testing.assert_close(getattr(got, name), getattr(ref, name),
                                   rtol=0, atol=1e-4, msg=name)


@pytest.mark.cuda
def test_fine_raster_at_the_repj_shape(cuda_device):
    """B1 and B2 as the RepjRefiner weak loss launches them
    (stage2_refined_flagship, 8 ROIs): the reprojected student poses at
    each scale in a 64² frame, 16 px tiles, K = 64, the silhouette at
    sigma 1.5; candidates depth-sorted; B1's mask and face_id bit for bit
    and its saved keep as the slot-order product; B2, fed that state, on
    seeded prob and attr cotangents (no depth one, as the losses send)
    within 1e-4 of its largest magnitude."""
    from self6dpp_tpu_torch.config import stage2_refined_flagship
    from self6dpp_tpu_torch.engine import self_engine as SE
    from self6dpp_tpu_torch.models import repj_refiner as RR
    cfg = stage2_refined_flagship()
    b = SE.stage2_batch(cfg, 8, cuda_device)
    cls = b["roi_cls"].long()
    g = torch.Generator(device="cpu").manual_seed(0)
    prob = torch.rand((8, 64, 64), generator=g).to(cuda_device)
    turn = torch.as_tensor(Rotation.from_euler(
        "xyz", np.random.default_rng(1).normal(0, 5, (8, 3)),
        degrees=True).as_matrix(), dtype=torch.float32, device=cuda_device)
    rot, trans = turn @ b["gt_rot"], b["gt_trans"] * 1.02
    args = (b["mesh_verts"][cls], b["mesh_faces"][cls], b["mesh_colors"][cls])
    _, anchor, (repR, rept, Ks_rep) = RR.repj_inputs(
        rot, trans, prob, prob, b["gt_rot"], b["gt_trans"], *args,
        b["roi_cam"], cfg.self_sup.repj_render_res)
    kw = RR.RASTER_KW
    n = cfg.self_sup.repj_render_res
    for s in (1, 2, 4):
        ftab, cand = TR.raster_inputs(*args, Ks_rep, repR, rept / s, n, n,
                                      kw["tile_px"], kw["faces_per_tile"])
        assert RC.cand_depth_sorted(ftab, cand)
        call = (ftab, cand, n, n, kw["tile_px"], kw["sigma_px"], True, True)
        out, keep = RC._fine(*call, True)
        torch.cuda.synchronize()
        ref = RC.fine_raster_plain(*call)
        assert torch.equal(out.mask, ref.mask) and ref.mask.sum() > 0, s
        assert torch.equal(out.face_id, ref.face_id), s
        want_keep = RC.keep_slot_order_plain(ftab, cand, n, n, kw["tile_px"],
                                             kw["sigma_px"])
        assert torch.equal(keep.view(torch.int32), want_keep.view(torch.int32))
        dprob, _, dattr = cotangents(cuda_device, n, n, 3, seed=s)
        dprob, dattr = dprob[:1].expand(8, -1, -1), dattr[:1].expand(8, -1, -1, -1)
        bcall = (ftab, cand, dprob.contiguous(), torch.zeros_like(dprob),
                 dattr.contiguous(), n, n, kw["tile_px"], kw["sigma_px"], True,
                 True)
        before = RC.fine_raster_bwd.launches
        got = RC.fine_raster_bwd(*bcall, (out.face_id, keep))
        torch.cuda.synchronize()
        assert RC.fine_raster_bwd.launches == before + 1
        want = RC.fine_raster_bwd_plain(*bcall)
        scale = want.abs().max().item()
        assert scale > 0
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * scale)


def _lab_inputs(dev, b, s, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    pred = torch.rand((b, s, s, 3), generator=g).to(dev)
    gt = torch.rand((b, s, s, 3), generator=g).to(dev)
    mask = (torch.rand((b, s, s), generator=g) > 0.4).float().to(dev)
    return pred, gt, mask


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,no_l,empty", [(2, 64, True, False),
                                            (3, 37, False, False),
                                            (2, 16, True, True)])
def test_lab_value_grad_matches_plain(cuda_device, b, s, no_l, empty):
    """Kernel B3 against lab_value_grad_plain: value rtol 1e-5, gradient
    within 1e-6 of its largest magnitude (Newton-refined roots against
    torch's pow); the value is the same bitwise from run to run (no float
    atomics)."""
    pred, gt, mask = _lab_inputs(cuda_device, b, s, b * 100 + s)
    if empty:
        mask.zero_()
    before = LC.lab_value_grad.launches
    val, grad = LC.lab_value_grad(pred, gt, mask, no_l)
    val2, _ = LC.lab_value_grad(pred, gt, mask, no_l)
    torch.cuda.synchronize()
    assert LC.lab_value_grad.launches == before + 2   # one launch per call
    assert torch.equal(val, val2)
    rv, rg = LC.lab_value_grad_plain(pred, gt, mask, no_l)
    torch.testing.assert_close(val, rv, rtol=1e-5, atol=0)
    torch.testing.assert_close(grad, rg, rtol=1e-5,
                               atol=1e-6 * rg.abs().max().item())
    if empty:
        assert val.item() == 0 and not grad.any()
    else:
        assert val.item() > 1


@pytest.mark.cuda
def test_lab_value_grad_rejects_bad_inputs(cuda_device):
    x = torch.rand((2, 8, 8, 3), device=cuda_device)
    m = torch.ones((2, 8, 8), device=cuda_device)
    with pytest.raises(TypeError):
        LC.lab_value_grad(x.double(), x.double(), m.double())
    with pytest.raises(ValueError, match="CUDA device"):
        LC.lab_value_grad(x, x.cpu(), m)
    with pytest.raises(ValueError, match="need pred"):
        LC.lab_value_grad(x, x, m[:, :4])
    # a view that starts one float into its storage: not 16-byte aligned
    buf = torch.rand(2 * 8 * 8 * 3 + 1, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte"):
        LC.lab_value_grad_scaled(buf[1:].view(2, 8, 8, 3), x, m)
    mbuf = torch.ones(2 * 8 * 8 + 1, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte"):
        LC.lab_value_grad(x, x, mbuf[1:].view(2, 8, 8))


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,no_l,empty", [(3, 7, True, False),
                                            (2, 45, False, False),
                                            (8, 256, True, False),
                                            (3, 7, False, True)])
def test_lab_value_grad_scaled_one_launch_and_replays(cuda_device, b, s,
                                                      no_l, empty):
    """The scaled entry: one launch per call; (value, g_raw, scale) against
    lab_value_grad_scaled_plain (value and scale rtol 1e-5, g_raw within
    1e-6 of its largest magnitude) on ragged pixel counts (3 x 7^2 = 147,
    2 x 45^2 = 4,050: not multiples of 4 or of a warp's 128 pixels), the
    step's size and an all-zero mask; the value and scale the same bits over
    repeated calls and over 10 CUDA-graph replays (each launch zeroes its
    own block ticket)."""
    pred, gt, mask = _lab_inputs(cuda_device, b, s, b * 100 + s)
    if empty:
        mask.zero_()
    before = LC.lab_value_grad.launches
    v, g_raw, scale = LC.lab_value_grad_scaled(pred, gt, mask, no_l, 0.2)
    torch.cuda.synchronize()
    assert LC.lab_value_grad.launches == before + 1
    rv, rg, rs = LC.lab_value_grad_scaled_plain(pred, gt, mask, no_l, 0.2)
    torch.testing.assert_close(v, rv, rtol=1e-5, atol=0)
    torch.testing.assert_close(scale, rs, rtol=1e-5, atol=0)
    torch.testing.assert_close(g_raw, rg, rtol=1e-5,
                               atol=1e-6 * rg.abs().max().item())
    if empty:
        assert v.item() == 0 and not g_raw.any() and scale.item() > 0
    for _ in range(3):
        v2, g2, s2 = LC.lab_value_grad_scaled(pred, gt, mask, no_l, 0.2)
        assert torch.equal(v2, v) and torch.equal(s2, scale)
        assert torch.equal(g2, g_raw)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        LC.lab_value_grad_scaled(pred, gt, mask, no_l, 0.2)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = LC.lab_value_grad_scaled(pred, gt, mask, no_l, 0.2)
    for _ in range(10):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out[0], v) and torch.equal(out[2], scale)
        assert torch.equal(out[1], g_raw)


@pytest.mark.cuda
def test_lab_value_grad_scaled_on_two_streams(cuda_device):
    """Launches that run side by side on two streams, eager and as two CUDA
    graphs replayed together, give the same bits as one at a time: no two
    launches share a block ticket. Both streams wait for one sleep on the
    card (~50 ms) while their launches queue up, then start together; the
    two inputs are of one size (2 x 64^2 pixels: grids of 8 blocks, which
    fit on the card together), so the streams' launches stay in step and
    take their tickets at the same moments."""
    sets = [_lab_inputs(cuda_device, 2, 64, 1), _lab_inputs(cuda_device, 2, 64, 2)]
    ref = [LC.lab_value_grad_scaled(*x, True, 0.2) for x in sets]
    torch.cuda.synchronize()
    gate, streams = torch.cuda.Stream(), [torch.cuda.Stream(), torch.cuda.Stream()]

    def hold():
        """Both streams wait for a sleep on the gate stream."""
        with torch.cuda.stream(gate):
            torch.cuda._sleep(100_000_000)
            done = torch.cuda.Event()
            done.record()
        for st in streams:
            st.wait_event(done)

    def check(outs):
        torch.cuda.synchronize()
        for k in range(2):
            for v, g_raw, scale in outs[k]:
                assert torch.equal(v, ref[k][0])
                assert torch.equal(scale, ref[k][2])
                assert torch.equal(g_raw, ref[k][1])

    outs = [[], []]
    hold()
    for _ in range(100):
        for k, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[k].append(LC.lab_value_grad_scaled(*sets[k], True, 0.2))
    check(outs)
    graphs, gouts = [], [[], []]
    for k, x in enumerate(sets):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(50):
                gouts[k].append(LC.lab_value_grad_scaled(*x, True, 0.2))
        graphs.append(graph)
    for _ in range(3):
        hold()
        for graph, st in zip(graphs, streams):
            with torch.cuda.stream(st):
                graph.replay()
        check(gouts)


def sign_inputs(dev, b, n, seed):
    """r, i (b, n) float32 with ties, NaN, -0.0 - +0.0 and infinities."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    r = torch.rand((b, n), generator=g)
    i = torch.rand((b, n), generator=g)
    m = b * n // 10
    k = torch.randperm(b * n, generator=g)[: 5 * m].view(5, m)
    r.view(-1)[k[0]] = i.view(-1)[k[0]]
    r.view(-1)[k[1]] = float("nan")
    i.view(-1)[k[2]] = float("nan")
    r.view(-1)[k[3]], i.view(-1)[k[3]] = -0.0, 0.0
    r.view(-1)[k[4]] = float("inf")
    return r.to(dev), i.to(dev)


def same_bits(a, b):
    """Bitwise equal where b is a number, NaN exactly where b is NaN."""
    nan = b.isnan()
    return torch.equal(a.isnan(), nan) and torch.equal(
        a.view(torch.int32)[~nan], b.view(torch.int32)[~nan])


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(8, 256 * 256 * 3), (3, 1001)])
def test_sign_g_matches_plain_bitwise(cuda_device, b, n):
    """Kernel P1 against sign_g_plain, bitwise (the sign of zero and the NaN
    positions included), one launch per call."""
    r, i = sign_inputs(cuda_device, b, n, seed=n)
    before = SC.sign_g.launches
    got = SC.sign_g(r, i)
    torch.cuda.synchronize()
    assert SC.sign_g.launches == before + 1
    ref = SC.sign_g_plain(r, i)
    assert same_bits(got, ref)
    assert got.signbit()[(r - i) == 0].any() and got.isnan().any()


@pytest.mark.cuda
@pytest.mark.parametrize("b,s", [(8, 256), (2, 37)])
def test_sign_g_split_matches_plain_bitwise(cuda_device, b, s):
    """Kernel P2 on the channel views of NHWC tensors (element stride 3)
    against sign_g_split_plain, bitwise, and against P1 on each plane."""
    r, i = sign_inputs(cuda_device, b, s * s * 3, seed=s)
    r, i = r.view(b, s, s, 3), i.view(b, s, s, 3)
    rp = tuple(r[..., k].reshape(b, s * s) for k in range(3))
    ip = tuple(i[..., k].reshape(b, s * s) for k in range(3))
    assert rp[2].stride() == (3 * s * s, 3)
    before = SC.sign_g_split.launches
    got = SC.sign_g_split(rp, ip)
    torch.cuda.synchronize()
    assert SC.sign_g_split.launches == before + 1
    for k, ref in enumerate(SC.sign_g_split_plain(rp, ip)):
        assert same_bits(got[k], ref), k
        assert same_bits(got[k], SC.sign_g(rp[k].contiguous(),
                                           ip[k].contiguous())), k


@pytest.mark.cuda
def test_sign_g_rejects_bad_inputs(cuda_device):
    x = torch.rand((2, 12), device=cuda_device)
    with pytest.raises(TypeError):
        SC.sign_g(x.double(), x.double())
    with pytest.raises(ValueError, match="CUDA device"):
        SC.sign_g(x, x.cpu())
    with pytest.raises(ValueError, match="one shape"):
        SC.sign_g(x, x[:, :6])
    with pytest.raises(ValueError, match="one shape"):
        SC.sign_g_split((x, x, x[:1]), (x, x, x))


def test_build_names_nvcc_when_missing(monkeypatch):
    """Without nvcc the build says so; nothing is built at import."""
    from self6dpp_tpu_torch.kernels import build
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os, "access", lambda path, mode: False)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_all(["fine_raster_fwd"])
    path = build._lib_path("fine_raster_fwd")
    assert path.parent == build.BUILD_DIR
    assert path == build._lib_path("fine_raster_fwd")   # content-keyed
