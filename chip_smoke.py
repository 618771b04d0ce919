#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card, over its paths:

  * DeepIM render-and-compare refinement at lm_flownet width (FlowNetS,
    512x512 zoom, 8 ROIs, 13 classes, 4 iterations, 5120-face meshes,
    480x640 frames);
  * the stage-II self-supervised pose step at stage2_pose_flagship (GDRN
    with resnest50d, 256² ROI, 64² output, 13 classes, 8 ROIs, 1280-face
    icospheres, 32 px tiles with K = 128, bf16 compute, the whole loss suite
    with LPIPS, MS-SSIM and depth chamfer, Ranger, EMA), and the LAB opaque
    probe on it;
  * the stage-I GDR-Net train step at gdrn_flagship (bench.py's
    bench_gdrn_train: resnest50d, 256² -> 64², 13 classes, BN in train
    mode, 24 images, bf16) and at gdrn_lm_masknormvf;
  * the stage-II pose step of the MaskNormVF variant (stage2_masknormvf:
    vf/norm heads and pseudo labels, the normal map rendered through B1),
    and the geo-mode and synsup steps at stage2_pose_flagship widths;
  * the DeepIM train step at lm_flownet (train_deepim.sh: FlowNetS, 512²
    zoom, 4 iterations, 8 ROIs, Ranger; flow and mask labels from a second
    render at the GT pose) and the stage-II pose step with the in-step
    refiners at stage2_refined_flagship (the pseudo pose refined by the
    lm_flownet DeepIM, the RepjRefiner weak loss on 64² renders);
  * evaluation on BOP data (test_gdrn.sh, test_deepim.sh): the synthetic
    BOP set written by the port, the GDRN eval CLI at lm_base width and
    the DeepIM one at lm_flownet on it (the eval loader's label renders,
    the evaluator's VSD renders), and the evaluator at LM's 480x640 frame;
  * training through the CLIs (train_gdrn.sh, train_deepim.sh,
    train_self6dpp.sh) on that set: lm_base, lm_flownet and lm_ss at full
    width, the loader in train mode, checkpoints, resume, warm start;
  * the YOLOv4 detector (train_yolov4.sh) at lm_base's detector widths:
    training, resume, --eval-only with its detections json, and the GDRN
    eval CLI reading that json;
  * the slice of every shipped config on its own data: JPEG decoding (the
    *_pbr sets' frames), the textured stage-II step at ycbv_ss (YCB-V's
    atlases, the UVs through B1 and B2), tools/gen_pseudo_poses with the
    DeepIM refiner, and the CLIs' --dist-* flags;
  * every GDR-Net architecture the JAX package builds: the Darknet-53,
    PVNet and FPN variants in stage I, the PVNet one as the stage-II
    student and through train_gdrn by --opts, and the test-time PnP.

    python3 chip_smoke.py [--record FILE]

Weights are random, drawn from a seed. Phases (each checks; a failure
exits non-zero):
  1. build every CUDA kernel in csrc/ from the sources in the checkout;
  2. hold the fine-raster forward (B1) against its plain PyTorch version at
     the DeepIM shapes and time both (CUDA events; see cuda_ms);
  3. run the DeepIM eval path in float32 with TF32 off, once through the
     kernel and once through the plain fine stage: the refined poses agree,
     while a spoilt render moves them by more than the tolerance;
  4. serve DeepIM requests in the configured bf16: finite, orthonormal
     poses, and B1 launched once per refine iteration;
  5. hold B1 (with the soft silhouette and its saved keep, bit for bit),
     the fine-raster backward (B2, fed that state, without the scatter)
     and the LAB value-and-gradient (B3, its normalised and its scaled
     entry) against their plain versions on one stage-II step's own
     inputs (B3 also against the same chain in float64), time all three
     and the parts of each (lab_parts_ms for B3: its launch alone, the
     normalised call and the call as the step makes it, to the cotangent),
     and hold B1 and B2 on a scene whose faces cross both culling cutoffs
     inside tiles;
  6. run two float32 stage-II steps through the kernels and two through
     the plain versions: losses and parameters agree, the parameters moved
     well past the tolerance, and a step without the losses that read the
     render ends elsewhere;
  7. time bf16 stage-II steps, with one launch each of B1, B2 and B3 per
     step (and 4 of the upsample's forward, 2 of its backward), and hold
     their first losses against the float32 step's; time the partial step
     (LPIPS, MS-SSIM, chamfer at weight 0) beside it;
  8. hold the probe kernels P1 and P2 bitwise against their plain versions
     on the step's masked render and image and on a seeded input with ties,
     NaN and -0.0, and time both;
  9. run the LAB opaque probe (A, J, J2, A', taking turns step by step) on
     the bf16 step, with one launch of P1 per J step and of P2 per J2 step;
 10. run two float32 stage-I steps of masknormvf_tiny on the card and on
     the CPU (losses, parameters and BN running statistics agree), then
     time bf16 stage-I steps at gdrn_flagship (ms per step, images/s, CUDA
     event phases, peak memory; no kernel launched; BN statistics moved)
     and two at gdrn_lm_masknormvf (its vf/norm terms finite);
 11. hold B1 at the normal-map pseudo label's shape against its plain
     version (mask and face_id bit for bit; candidates depth-sorted; filled
     slots and overlapping faces per tile beside K), run two float32
     MaskNormVF pose steps through the kernels and two through the plain
     versions (phase 6's checks, with loss_vf and loss_norm), and time bf16
     steps with two B1, one B2 and one B3 launch each (one B1 from the
     normal render);
 12. time the geo-mode and synsup steps at stage2_pose_flagship widths: no
     kernel launched, every loss finite;
 13. run two float32 DeepIM train steps through B1 and two through the
     plain fine stage (losses and parameters agree; the parameters moved;
     a black render ends elsewhere), hold B1 at the GT render's shape
     against its plain version (mask and face_id bit for bit), and time
     bf16 train steps (CUDA-event phases: render, flow label, network
     forward, loss, backward, solver + EMA) with 8 B1 and 0 B2 launches
     each, all at the 512² zoom;
 14. hold B1 and B2 at the repj renders' shape (64², 16 px tiles, K = 64,
     the silhouette) against their plain versions on one refined step's
     inputs, B2 on the cotangents the repj losses send; run phase 6's
     float32 checks on the refined step (with the refiner, the loss_repj_*
     terms); time bf16 refined steps (with the refine and repj spans),
     with 11 B1 (1 student, 4 refiner, 6 repj), 4 B2 (1 student, 3 repj)
     and 1 B3 launch each;
 15. run two float32 DeepIM train steps (64² zoom, 2 iterations, 2 ROIs)
     on the card and on the CPU: losses and parameters agree;
 16. write the synthetic BOP set (48 images, 2 objects, 160x120; PNG
     rows filtered as libpng chooses) with B1 and with the plain fine
     stage: JSON, PLY and masks equal, RGB and depth within 1 unit, one B1
     launch per object and image; time the PNG decode of an LM-sized
     frame (RGB with Paeth rows and adaptive rows, a mask, a 16-bit depth);
 17. run the GDRN eval CLI (test_gdrn) at lm_base width on that set
     through the kernels and through the plain fine stage, cuDNN
     deterministic: recall and BOP19 tables and CSV rows equal; hold B1 at
     the label cache's shape (24 x 128², tile 8, K 64) on the run's own
     inputs (mask and face_id bit for bit) and time it; then time the CLI
     through the kernels as a user runs it (cuDNN's default algorithms),
     with and without loader threads: images/s and, per batch, the host
     load, the label render and the eval step, and the evaluate time;
 18. run the DeepIM eval CLI (test_deepim) at lm_flownet on the same set
     (tables and poses kernel vs plain equal, then timed as in 17: ms per
     batch), then the
     evaluator with bop19 at LM's frame (13 objects, 5120-face meshes, 8
     noisy predictions each, a synthetic observed depth; tables equal)
     and hold B1 at its VSD renders (8 x 480x640, tile 16, K 128);
 19. run the GDRN training CLI (train_gdrn) at lm_base width on the set's
     train split, colour augmentation on every image, 4 iterations, then
     resumed to 6: finite losses, each iteration once in metrics.json,
     the checkpoints; hold B1 at the train labels' cache; ms per
     iteration, images/s, the loader's wait;
 20. run the DeepIM training CLI (train_deepim) at lm_flownet, 3
     iterations: finite losses, 8 B1 launches a step at 512²;
 21. run the stage-II CLI (train_self6dpp) at lm_ss, warm-started from
     phase 19's step (aimed as phase 5's model) with perturbed GT pseudo
     poses: 3 fp32 iterations through the kernels and the plain versions
     (losses, student and teacher agree), B1, B2 and B3 held on the kernel
     run's last step (B3's gradient away from Lab ties), 6 bf16
     iterations with one B1, B2 and B3 launch each, and 4 iterations of
     configs/self6dpp/synthetic_smoke.py (geo, synsup, pose with the
     refiner and repj);
 22. run two float32 YOLOv4 train steps at a tiny width (128², width
     0.125, depth 0.33, 2 images of the set through the detector's loader)
     on the card and on the CPU (losses and decoded predictions agree; NMS
     on both), then the detector CLI (train_yolov4) at lm_base's widths
     (640², width and depth 1.0, 6 images, float32, cuDNN's TF32 at
     PyTorch's default) on the train split, 6 iterations, resumed to 8,
     --eval-only over the test split writing the detections json, and the
     GDRN eval CLI at lm_base reading that json: finite losses, each
     iteration once, no kernel launched by the detector; ms per
     iteration, images/s, the loader's share, the step's CUDA-event phases
     (forward, loss, backward, solver), peak memory, inference ms per
     image, NMS ms, the AP table and its seconds;
 23. decode the committed JPEG fixture (a 480x640 4:2:0 frame at quality
     95 and a 237x317 4:2:2 file with restart markers) through the host C
     decoder built here, colour and gray, bit for bit against cv2's decode
     stored beside it; the frame's decode timed (median of 20);
 24. run the textured stage-II pose step at ycbv_ss (resnest50d, 256² ->
     64², 21 classes, 8 ROIs, 5120-face icospheres with spherical UVs, one
     2048² RGB atlas a class, lm_ss's loss family with LAB 0.2): B1 and B2
     at D = 2 (the UVs) and B3 against their plain versions on one step's
     inputs, the fp32 steps through the kernels and the plain versions
     (phase 6's checks), then bf16 steps timed per phase with one B1, B2
     and B3 launch each, and peak memory;
 25. run tools/gen_pseudo_poses on the synthetic set at phase 19's
     checkpoint with --deepim-config lm_flownet (weights of unit gain, in
     a port step directory), float32, through the kernels and the plain
     versions: the same records, poses within phase 3's tolerance, the
     refiner moving them, B1 launched 4 times a batch at 512²; B1 held at
     its first refine inputs;
 26. run train_gdrn at lm_base for one iteration with --dist-coordinator,
     --dist-nprocs 1 and --dist-rank 0 and without them: the same losses,
     no process group joined;
 27. for each GDR-Net variant the JAX GDRN builds beyond the shipped
     configs, at gdrn_flagship's widths (256² -> 64², 13 classes): V1
     darknet53_topdown (Darknet-53, a 4x4 deconv and split out layers,
     ConvPnPNet with the mask concatenated, the extent embedding, DropBlock
     0.2, centroid_z_abs), V2 pvnet_conv_point (pvnet_resnet18_8s at stride
     4, the conv head, SimplePointPnPNet, trans), V3 resnet34_fpn (stages
     1-4, the FPN neck and head): two float32 stage-I steps on the card
     and on the CPU (2 images, DropBlock fed one seeded mask: losses,
     parameters and BN statistics agree), then bf16 steps at 24 images
     timed per phase, with peak memory;
 28. the stage-II pose step at stage2_pose_flagship with V2 as the student
     and its EMA teacher: phase 24's checks (B1, B2, B3 against their
     plain versions on one step's inputs; the fp32 steps through the
     kernels and the plain versions; bf16 steps timed per phase, one
     launch each a step);
 29. train_gdrn with --opts selecting V2 on lm_base, 2 iterations on the
     synthetic set, then --eval-only over its 96 test ROIs; the test-time
     PnP (evaluator.pnp_from_xyz_mask, RANSAC and iterative) on the eval
     loader's ground-truth labels, held against the ground-truth pose,
     and on the trained model's predicted maps, host ms per ROI.
 30. the native FPS (csrc/fps.c) against fps_numpy bit for bit on the
     icosphere of 163,842 vertices, the synthetic set's meshes and a
     random cloud at k 64 and 512, both timed, with the thread count;
 31. the golden fixtures through the port's checkpoint converter,
     loaded by load_params_npz, run on the card in float32 against the
     reference outputs (TOL_CONVERT);
 32. the flagship stage-II step in lab_impl surrogate, split_grad and
     pixel_split against pallas from one state in float32 (phase 6's
     tolerances), then bf16 steps in each mode timed;
 33. one flagship bf16 stage-II step under utils.profiling.trace: the
     trace names B1, B2 and B3; its size, the step inside and outside;
 34. the sharded (fsdp) code path at the grid (1, 1): three stage-I steps
     at gdrn_flagship through shard_state(force=True) bit for bit with
     the unsharded steps (the multi-rank path is the CPU test's);
 35. the geo head's align-corners 2x upsample (csrc/upsample2x.cu): its
     forward bitwise against the plain function and its gather-form
     backward against the plain twin and float64, at the stage-II step's
     two shapes at 128 ROIs and at odd and banded sizes; both timed beside
     the plain path and F.interpolate, with their byte bounds.
Every face table and candidate list rasterized outside the timed phases is
held to the fine-raster kernels' precondition (depth-sorted candidates).
Prints a `record` line with every measurement, a `kernels` line, a `path`
line and the card's name and power limit, then {"ok": true, "device": ...}
as the last line. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

SEED = 0
N_CLASSES = 13
REQUESTS = 5                      # after one warm-up request
LM_K = np.array([[572.4114, 0, 325.2611], [0, 573.57043, 242.04899],
                 [0, 0, 1]], np.float32)        # LINEMOD intrinsics
FRAME_HW = (480, 640)
# the plain fine-raster passes take 40-150 ms a call: one call per timing,
# median of three after one warm-up call
PLAIN_TIMING = {"reps": 1, "trials": 3}
TOL_KERNEL = 1e-4                 # float outputs where mask/face_id agree
TOL_MISMATCH = 1e-4               # share of pixels whose mask/face_id differ
TOL_PATH = 1e-3                   # fp32 refined pose, kernel vs plain
TOL_BF16 = 2e-2                   # bf16 vs fp32 refined pose: 3x the 6.3e-3
                                  # it reads on an H100, half what a black
                                  # render moves the fp32 pose (phase 4)
HEAD_STD = 0.3                    # pose-output weights (see unit_gain_)
# spoilt renders of phase 3 -> must each move the pose by more than
# TOL_PATH? A one-pixel shift of a 512² render moves it by less (4.7e-4 on
# an H100), so it is only reported: phase 2 holds the kernel bitwise.
PERTURB = {"attr zeroed": True, "attr shifted 1 px": False}
# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s, f32 FLOP/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# the special-function units (reciprocal, log2, exp2): 16 results a clock
# per SM on compute capability 9.0 (CUDA C++ Programming Guide, arithmetic
# instruction throughput), x 132 SMs x 1.98 GHz, the clock that the f32 peak
# (132 x 128 lanes x 2 x 1.98e9) implies
PEAK_SFU = 132 * 16 * 1.98e9
# f32 operations that the functions need, counted from the kernels'
# sources (a comparison, a transcendental or a division counts as one).
# Per (pixel, valid candidate): the edge functions (6 offsets, 4 products,
# 2 differences), the barycentrics (4) and the inside and z tests (4).
OPS_TEST = 20
# Per (occupied tile, valid candidate), once: the signed area and its
# inverse (9), each edge's vector, squared length and floor (3 x 6).
OPS_CAND = 27
# Per (uncovered pixel, valid candidate), for the soft silhouette (a covered
# pixel's prob is exactly 1): each edge's offset, foot parameter, residual
# and squared length (3 x 15), their minimum (2), exponent and exponential
# (3), 1 - p and the product (2).
OPS_SEG = 52
# B1, per covered pixel: clip, renormalise (12), perspective weights and
# depth (10), attributes (5 per channel, D = 3)
OPS_WIN_FWD = 37
# B2, per covered pixel with a depth or attr cotangent: the forward's
# winner again (22), the attribute and perspective chain (62), the clip,
# renormalise, edge-function and area chain to the six vertex coordinates
# (69). Per (uncovered pixel with a prob cotangent, valid candidate), on top
# of OPS_SEG: the leave-one-out factor (2), d(d^2) (4), the choice of the
# nearest edge (4), its gradient from the foot and residual already formed
# (8) and the sum over pixels (4).
OPS_WIN_BWD = 153
OPS_SEG_BWD = 22
# B3 per pixel, counted from csrc/lab_value_grad.cu in f32 operations (a
# fused multiply-add counts two, as the f32 peak does). Always: the branch
# tests (12), the two XYZ mixes (2 x 17), the a, b differences (8), |.| and
# their sum (3), the signs (6), d/d(fx, fy, fz) (5), d/d(x, y, z) (5), the
# gradient's mix, dlin and mask (21), the value and mask sums (3); with L,
# its difference, |.|, sign and terms (9). Per channel on the power branch
# (t^2.4 = u t^2, u = t^0.4 from log2, exp2 and one Newton step with a
# reciprocal): pred 13 and gt 11, and 3 at the SFU; on the linear branch 1.
# Per XYZ value on the cube-root branch (an inverse cube root from log2,
# exp2 and one Newton step, then one step on the root): pred 17 with df,
# gt 16, and 2 at the SFU; on the linear branch 2. The data decides the
# branches (lab_ops).
OPS_LAB, OPS_LAB_L = 97, 9
OPS_LAB_POW = {"pred": (13, 3), "gt": (11, 3)}       # (f32, SFU)
OPS_LAB_CUBE = {"pred": (17, 2), "gt": (16, 2)}

# stage-II (phases 5-9)
S2_BATCH = 8                      # ROIs per step (bench.py::build_stage2)
# the partial step: the whole suite without these
S2_PARTIAL = ("perceptual_lw", "ms_ssim_lw", "depth_chamfer_lw")
# the losses that read the render: the control of phase 6 zeroes them all
S2_RENDER_LOSSES = ("mask_lw", "lab_lw") + S2_PARTIAL
PROBE_STEPS = 10                  # timed rounds of the probe's four variants
OPS_SIGN = 4                      # P1/P2 per element: difference, 2 tests, scale
S2_SIGMA = 1.5                    # soft-silhouette sigma of the student render
S2_TIMED_STEPS = 20               # bf16 steps timed after one warm-up step
S2_PARTIAL_STEPS = 5              # the partial step's, for its median
# kernel launches per step
S2_LAUNCHES = {"fine_raster_fwd": 1, "fine_raster_bwd": 1, "lab_value_grad": 1}
# the geo head's two bilinear up-blocks: student and teacher forwards, the
# student's backward
S2_UPSAMPLE_LAUNCHES = {"upsample2x": 4, "upsample2x_bwd": 2}
S2_LR = 1e-3                      # phase 6: no warm-up and a visible lr
TOL_B2 = 1e-4                     # d ftab, of its largest magnitude
TOL_B3_VALUE = 1e-5               # LAB value, relative
TOL_B3_GRAD = 1e-6                # LAB gradient, of its largest magnitude
TOL_S2_LOSS = 1e-4                # fp32 step losses, kernel vs plain, relative
# fp32 params after each of 2 steps, kernel vs plain, each step from one
# state (check_stage2_fp32: chained steps amplify rounding through the
# teacher-student L1 signs, so their params are recorded, not held)
TOL_S2_PARAMS = 1e-4
S2_MOVED = 20                     # the steps move the params > 20x the tolerance
TOL_S2_BF16 = 2e-3                # bf16 vs fp32 losses of the first step:
                                  # 13x the 1.55e-4 read on an H100 for the
                                  # partial suite, 4x the 4.96e-4 read for
                                  # the whole one (LPIPS, MS-SSIM, chamfer)


def require(ok, *what) -> None:
    """A check that python -O cannot strip."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


@contextlib.contextmanager
def cand_order_checked(counts):
    """While active, every face table and candidate list that
    rasterizer.raster_inputs makes (so every render of the paths) is held to
    the fine-raster kernels' precondition, raster_cuda.cand_depth_sorted
    (B1 stops a covered pixel at its first inside face); counts["inputs"]
    counts them."""
    from self6dpp_tpu_torch.ops import raster_cuda as RC
    from self6dpp_tpu_torch.ops import rasterizer as R
    inner = R.raster_inputs

    def checked(*args, **kw):
        ftab, cand = inner(*args, **kw)
        require(RC.cand_depth_sorted(ftab, cand), "cand not depth-sorted")
        counts["inputs"] += 1
        return ftab, cand
    R.raster_inputs = checked
    try:
        yield
    finally:
        R.raster_inputs = inner


@contextlib.contextmanager
def scatter_counted():
    """Counts calls of raster_cuda.scatter_to_faces while active (the plain
    backward's sum into d ftab; B2's kernel path must not call it)."""
    from self6dpp_tpu_torch.ops import raster_cuda as RC
    inner = RC.scatter_to_faces
    calls = {"n": 0}

    def counted(*args):
        calls["n"] += 1
        return inner(*args)
    RC.scatter_to_faces = counted
    try:
        yield calls
    finally:
        RC.scatter_to_faces = inner


@contextlib.contextmanager
def cull_at(b1=None, b2=None):
    """While active, the fine-raster kernels cull from these squared
    distances instead of their exact cutoffs (0: every face; a huge value:
    none): only for timing what the culling saves."""
    from self6dpp_tpu_torch.ops import raster_cuda as RC
    inner = RC.b1_cull_d2, RC.b2_cull_d2
    if b1 is not None:
        RC.b1_cull_d2 = lambda *args: b1
    if b2 is not None:
        RC.b2_cull_d2 = lambda *args: b2
    try:
        yield
    finally:
        RC.b1_cull_d2, RC.b2_cull_d2 = inner


def cuda_ms(fn, reps=10, trials=5) -> float:
    """Device time of one fn() in ms: CUDA events around `reps` calls in a
    row (so the host's launch gaps hide behind queued work), median of
    `trials` such runs, after one warm-up run."""
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


def graph_ms(fn, reps=10, trials=5) -> float:
    """Device time of one fn() in ms without the host's launch gaps: `reps`
    calls captured in one CUDA graph (after warm-up calls on a side
    stream), the graph replayed between CUDA events, median of `trials`.
    For calls whose wrapper costs the host about as long as the kernel
    runs, where cuda_ms measures the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


def make_meshes(subdivisions=4):
    """13 icospheres (5120 faces at 4 subdivisions), radius 0.04-0.10 m by
    class, per-vertex colours from the normal tinted by class."""
    from self6dpp_tpu_torch.data.meshes import make_icosphere
    unit, faces = make_icosphere(1.0, subdivisions)
    radii = np.linspace(0.04, 0.10, N_CLASSES, dtype=np.float32)
    tint = np.random.default_rng(SEED).uniform(0.2, 1.0, (N_CLASSES, 1, 3))
    verts = radii[:, None, None] * unit[None]
    colors = (0.5 * (unit[None] + 1.0) * tint).astype(np.float32)
    return verts.astype(np.float32), faces, colors


def make_request(seed, meshes, cfg, device, b):
    """One request: b ROIs with GT poses drawn as data/synthetic.py draws
    them, the observation rendered by the port at the GT pose in the full
    frame, and the initial pose = GT + noise (15 deg, (1,1,5) cm std)."""
    from scipy.spatial.transform import Rotation
    from self6dpp_tpu_torch.ops.rasterizer import rasterize_batch
    from self6dpp_tpu_torch.ops.zoom import bboxes_from_pose
    rng = np.random.default_rng(seed)
    verts, faces, colors = meshes
    cls = rng.integers(0, N_CLASSES, b)
    roi_center = rng.uniform(200, 440, (b, 2)).astype(np.float32)
    z = rng.uniform(0.6, 1.4, (b,)).astype(np.float32)
    gt_trans = np.stack([(roi_center[:, 0] - LM_K[0, 2]) / LM_K[0, 0] * z,
                         (roi_center[:, 1] - LM_K[1, 2]) / LM_K[1, 1] * z,
                         z], 1).astype(np.float32)
    gt_rot = Rotation.random(b, random_state=seed).as_matrix().astype(np.float32)
    dR = Rotation.from_euler("xyz", rng.normal(0, 15, (b, 3)),
                             degrees=True).as_matrix()
    K = np.broadcast_to(LM_K, (b, 3, 3)).copy()
    t = lambda x, dt=torch.float32: torch.as_tensor(x, dtype=dt, device=device)
    batch = {"K": t(K), "verts": t(verts[cls]), "faces": t(faces, torch.int32),
             "colors": t(colors[cls]), "roi_cls": t(cls, torch.int64),
             "gt_rot": t(gt_rot), "gt_trans": t(gt_trans),
             "init_rot": t((dR @ gt_rot).astype(np.float32)),
             "init_trans": t(gt_trans + rng.normal(0, [0.01, 0.01, 0.05],
                                                   (b, 3)).astype(np.float32))}
    obs = rasterize_batch(batch["verts"], batch["faces"], batch["colors"],
                          batch["K"], batch["gt_rot"], batch["gt_trans"],
                          height=FRAME_HW[0], width=FRAME_HW[1],
                          tile_px=cfg.renderer.tile_px,
                          faces_per_tile=cfg.renderer.faces_per_tile,
                          with_prob=False, device=device)
    batch["obs_img"] = obs.attr
    batch["obs_box"] = bboxes_from_pose(batch["verts"], batch["K"],
                                        batch["gt_rot"], batch["gt_trans"])
    require((obs.mask.flatten(1).sum(1) > 0).all(), "an ROI left the frame")
    return batch


def zoom_frame(cfg, batch):
    """Crop boxes and zoomed intrinsics of the first refine iteration (as
    deepim_engine._render_inputs computes them)."""
    from self6dpp_tpu_torch.ops.zoom import (bboxes_from_pose,
                                             centers_2d_from_pose,
                                             deepim_boxes, zoom_K)
    d = cfg.deepim
    rot, trans = batch["init_rot"], batch["init_trans"]
    boxes, _ = deepim_boxes(
        bboxes_from_pose(batch["verts"], batch["K"], rot, trans),
        centers_2d_from_pose(batch["K"], rot, trans),
        obs_boxes=batch["obs_box"], lamb=d.zoom_lamb,
        out_hw=(d.input_h, d.input_w))
    return boxes, zoom_K(batch["K"], boxes, (d.input_h, d.input_w))


def compare_raster(got, ref, key):
    """Mask and face_id mismatch shares, and the largest float error where
    both agree; checks them against TOL_MISMATCH and TOL_KERNEL."""
    mis_mask = (got.mask != ref.mask).float().mean().item()
    mis_face = (got.face_id != ref.face_id).float().mean().item()
    agree = (got.mask == ref.mask) & (got.face_id == ref.face_id)
    errs = {}
    for name in ("prob", "depth", "attr", "bary"):
        diff = (getattr(got, name) - getattr(ref, name)).abs()
        if diff.ndim == 4:
            diff = diff.amax(-1)
        errs[name] = diff[agree].max().item()
    require(ref.mask.sum() > 0, key, "the render is empty")
    require(mis_mask <= TOL_MISMATCH and mis_face <= TOL_MISMATCH, key,
            mis_mask, mis_face)
    require(max(errs.values()) <= TOL_KERNEL, key, errs)
    return {"mask_mismatch": mis_mask, "face_id_mismatch": mis_face,
            "max_abs_err": errs}


def check_kernel(cfg, batch):
    """Phase 2: the fine-raster kernel against its plain version on the
    first iteration's render inputs, for with_prob x persp."""
    from self6dpp_tpu_torch.ops import raster_cuda as RC
    from self6dpp_tpu_torch.ops import rasterizer as R
    d, r = cfg.deepim, cfg.renderer
    h, w = d.input_h, d.input_w
    _, Kz = zoom_frame(cfg, batch)
    args = (batch["verts"], batch["faces"], batch["colors"], Kz,
            batch["init_rot"], batch["init_trans"])
    ftab, cand = R.raster_inputs(*args, h, w, r.tile_px, r.faces_per_tile)
    require(RC.cand_depth_sorted(ftab, cand), "DeepIM cand not depth-sorted")
    variants, masks, max_err = {}, {}, 0.0
    for with_prob in (False, True):
        for persp in (True, False):
            call = (ftab, cand, h, w, r.tile_px, 1.0, with_prob, persp)
            got = RC.fine_raster(*call)
            torch.cuda.synchronize()
            ref = RC.fine_raster_plain(*call)
            key = f"prob={with_prob},persp={persp}"
            v = compare_raster(got, ref, key)
            masks[key] = ref.mask
            v["ms"] = cuda_ms(lambda: RC.fine_raster(*call))
            v["graph_ms"] = graph_ms(lambda: RC.fine_raster(*call))
            v["plain_ms"] = cuda_ms(lambda: RC.fine_raster_plain(*call),
                                    **PLAIN_TIMING)
            variants[key] = v
            max_err = max(max_err, *v["max_abs_err"].values())

    # least time for the main path's variant (no silhouette, persp): each
    # input read once (the candidate lists, and of the face table only the
    # rows they name: binning leaves culled faces out), each output written
    # once; f32 work of the valid candidates this data has
    B, F, C = ftab.shape
    D = (C - RC._GEO) // 3
    n = raster_counts(ftab, cand, masks["prob=False,persp=True"], r.tile_px,
                      h, w)
    bytes_moved = (n["face_rows_read"] * C * 4 + cand.numel() * 4
                   + B * h * w * (4 + D + 3) * 4)
    ops = b1_ops(n, with_prob=False)
    lim = bound(bytes_moved, ops)
    main = variants["prob=False,persp=True"]
    fd = R.face_data(*args)
    timing = {
        "face_data_ms": cuda_ms(lambda: R.face_data(*args)),
        "bin_ms": cuda_ms(lambda: R._bin_faces(
            fd[0], fd[4], h, w, r.tile_px, r.faces_per_tile, fd[1])),
        "raster_inputs_ms": cuda_ms(
            lambda: R.raster_inputs(*args, h, w, r.tile_px, r.faces_per_tile)),
    }
    # the same call with every tile empty: the cost of the output bytes
    empty = torch.full_like(cand, -1)
    timing["graph_ms_all_tiles_empty"] = graph_ms(lambda: RC.fine_raster(
        ftab, empty, h, w, r.tile_px, 1.0, False, True))
    kernel = {
        "name": "fine_raster_fwd", "route": "cuda",
        "source": "self6dpp_tpu_torch/csrc/fine_raster_fwd.cu",
        "replaces": "self6dpp_tpu/ops/raster_pallas.py:420",
        "launches": None, "max_abs_err": max_err, "ms": main["ms"],
        "graph_ms": main["graph_ms"],
        "plain_ms": main["plain_ms"], "bound_ms": lim["bound_ms"],
        "bound_by": lim["bound_by"], "library_ms": None}
    counts = {k: v for k, v in n.items() if not k.startswith("_")}
    detail = {"variants": variants, "bytes": bytes_moved, "f32_ops": ops,
              **counts, **timing}
    return kernel, detail


@torch.no_grad()
def unit_gain_(model, seed) -> None:
    """Weights of unit gain, drawn in float32 from `seed` whatever the
    model's dtype: N(0, fan_in^-1/2) for every conv and dense layer,
    N(0, HEAD_STD) for the pose outputs, zero biases, identity-biased pose
    heads. Under the JAX initialisers (hidden dense 0.001, pose outputs
    0.01) the refined pose hardly depends on the render, and the path
    checks of phases 3 and 4 could not see a wrong one."""
    g = torch.Generator().manual_seed(seed)
    for name, m in model.named_modules():
        if isinstance(m, torch.nn.Linear):
            fan_in = m.in_features
        elif isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            fan_in = m.in_channels * int(np.prod(m.kernel_size))
        else:
            continue
        std = HEAD_STD if name.startswith("pose_head.fc_") else fan_in ** -0.5
        m.weight.copy_(torch.empty(m.weight.shape).normal_(0, std, generator=g))
        if m.bias is not None:
            m.bias.zero_()
    model.init_identity_heads_()


def build_model(cfg, device, dtype_name):
    from self6dpp_tpu_torch.engine import deepim_engine as de
    cfg = dataclasses.replace(cfg, dist=dataclasses.replace(
        cfg.dist, compute_dtype=dtype_name))
    model = de.build_deepim(cfg, device=device)
    unit_gain_(model, SEED)
    return cfg, model


def pose_err(a, b):
    return max((a["rot"] - b["rot"]).abs().max().item(),
               (a["trans"] - b["trans"]).abs().max().item())


def _perturbed_plain(how):
    """The plain fine stage with its output spoilt: `how` is 'attr zeroed'
    (a black render) or 'attr shifted 1 px' (the render one pixel right)."""
    from self6dpp_tpu_torch.ops import raster_cuda as RC
    plain = RC.fine_raster_plain

    def run(*args):
        out = plain(*args)
        attr = (torch.zeros_like(out.attr) if how == "attr zeroed"
                else out.attr.roll(1, dims=2))
        return out._replace(attr=attr)
    return run


def check_path_fp32(cfg, device, batch):
    """Phase 3: the whole eval path in float32, TF32 off, through the kernel
    and through the plain fine stage: they agree within TOL_PATH. The check
    can fail: the refined pose moves from the initial one by more than
    TOL_PATH, and so does it under a black render (PERTURB)."""
    from self6dpp_tpu_torch.engine import deepim_engine as de
    from self6dpp_tpu_torch.ops import raster_cuda as RC
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32, model = build_model(cfg, device, "float32")
    via_kernel = de.make_eval_step(cfg32, model, device=device)(batch)
    plain_step = de.make_eval_step(cfg32, model, device=device,
                                   raster_kw={"impl": "plain"})
    via_plain = plain_step(batch)
    torch.cuda.synchronize()
    err = pose_err(via_kernel, via_plain)
    require(err <= TOL_PATH, "fp32 path, kernel vs plain", err)
    moved = pose_err(via_kernel, {"rot": batch["init_rot"],
                                  "trans": batch["init_trans"]})
    require(moved > TOL_PATH, "the refine left the pose where it was", moved)
    spoilt = {}
    plain = RC.fine_raster_plain
    for how, must_show in PERTURB.items():
        RC.fine_raster_plain = _perturbed_plain(how)
        try:
            spoilt[how] = pose_err(via_plain, plain_step(batch))
        finally:
            RC.fine_raster_plain = plain
        require(spoilt[how] > TOL_PATH or not must_show,
                "a spoilt render passed", how, spoilt[how])
    return via_kernel, {"kernel_vs_plain_max_abs": err,
                        "moved_from_init_max_abs": moved,
                        "spoilt_render_vs_plain_max_abs": spoilt}


def serve(cfg, device, requests, ref32):
    """Phase 4: requests in the configured compute dtype. The warm-up
    request's poses are held against the fp32 run of phase 3 (the same
    weights, rounded) within TOL_BF16."""
    from self6dpp_tpu_torch.engine import deepim_engine as de
    from self6dpp_tpu_torch.ops import raster_cuda as RC
    from self6dpp_tpu_torch.ops.rasterizer import rasterize_batch
    from self6dpp_tpu_torch.ops.zoom import crop_resize
    cfgc, model = build_model(cfg, device, cfg.dist.compute_dtype)
    step = de.make_eval_step(cfgc, model, device=device)
    warm = step(requests[0])
    torch.cuda.synchronize()
    bf16_err = pose_err(warm, ref32)
    require(bf16_err <= TOL_BF16, "bf16 vs fp32 poses", bf16_err)

    RC.fine_raster.launches = 0
    times, outs = [], []
    for batch in requests[1:]:
        t0 = time.perf_counter()
        out = step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
    launches = RC.fine_raster.launches
    n_iter = cfg.deepim.n_iter_test
    require(launches == n_iter * len(outs), "launches", launches, n_iter,
            len(outs))

    ortho = 0.0
    for out in outs:
        rot, trans = out["rot"], out["trans"]
        require(rot.shape == (len(requests[1]["init_rot"]), 3, 3)
                and trans.shape == (len(rot), 3), "shapes", rot.shape,
                trans.shape)
        require(torch.isfinite(rot).all() and torch.isfinite(trans).all(),
                "non-finite pose")
        eye = torch.eye(3, device=rot.device)
        ortho = max(ortho, (rot.transpose(1, 2) @ rot - eye).abs().max().item())
        require((torch.linalg.det(rot) > 0).all(), "improper rotation")
        require((trans[:, 2] > 0).all(), "object behind the camera")
    require(ortho < 1e-4, "rotations not orthonormal", ortho)

    # rendering share of a request: n_iter renders of one request's shapes
    d, r = cfg.deepim, cfg.renderer
    b = requests[1]
    boxes, Kz = zoom_frame(cfg, b)
    render_ms = cuda_ms(lambda: rasterize_batch(
        b["verts"], b["faces"], b["colors"], Kz, b["init_rot"],
        b["init_trans"], height=d.input_h, width=d.input_w,
        tile_px=r.tile_px, faces_per_tile=r.faces_per_tile, with_prob=False,
        device=device), reps=4)
    x = torch.rand(len(b["init_rot"]), d.input_h, d.input_w, d.in_channels,
                   device=device)

    def net():
        with torch.inference_mode():
            model(x, b["init_rot"], b["init_trans"], Kz, b["roi_cls"])
    net_ms = cuda_ms(net, reps=4)
    crop_ms = cuda_ms(lambda: crop_resize(b["obs_img"], boxes, d.input_h,
                                          d.input_w), reps=4)
    ms = float(np.median(times))
    return launches, {
        "requests": len(outs), "ms_per_request": ms, "request_ms": times,
        "render_ms_per_iter": render_ms, "net_ms_per_iter": net_ms,
        "crop_ms_per_iter": crop_ms,
        "render_share": n_iter * render_ms / ms,
        "bf16_vs_fp32_max_abs": bf16_err, "max_orthonormal_err": ortho}


# ---- stage-II pose step (phases 5-7) -------------------------------------

def stage2_cfg(dtype_name, lr=None, base=None):
    """stage2_pose_flagship (or `base`) in the given compute dtype; with
    `lr`, no warm-up and that base learning rate."""
    from self6dpp_tpu_torch.config import stage2_pose_flagship
    cfg = base if base is not None else stage2_pose_flagship()
    if lr is not None:
        cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
            cfg.solver, base_lr=lr, warmup_iters=0))
    return dataclasses.replace(cfg, dist=dataclasses.replace(
        cfg.dist, compute_dtype=dtype_name))


def stage2_inputs(cfg, state, batch, lpips):
    """One forward and backward of the stage-II step at `state` (which it
    leaves as it was): the face table and candidates of the student's pose,
    the cotangents the losses send to the render's prob, depth and attr
    (zero where no loss reads one; a textured render's attributes are its
    UVs), and LAB's inputs (masked render, masked image, pseudo mask)."""
    from self6dpp_tpu_torch.engine import self_engine as se
    from self6dpp_tpu_torch.engine.gdrn_engine import model_inputs
    from self6dpp_tpu_torch.ops import rasterizer as R
    ld, ren, pseudo = se.forward_losses(cfg, state, batch, lpips=lpips)
    # a textured render's attributes are its UVs (phase 24)
    textured = "uv" in ren
    outs = [ren["prob"], ren["depth"], ren["uv" if textured else "color"]]
    grads = torch.autograd.grad(sum(ld.values()), outs, allow_unused=True)
    cts = [torch.zeros_like(o) if g is None else g.contiguous()
           for o, g in zip(outs, grads)]
    with torch.no_grad():
        out = state.model(*model_inputs(batch))
    cls = batch["roi_cls"].long()
    s, r = cfg.model.input_res, cfg.renderer
    ftab, cand = R.raster_inputs(
        batch["mesh_verts"][cls], batch["mesh_faces"][cls],
        batch["mesh_uv" if textured else "mesh_colors"][cls],
        batch["roi_zoom_K"], out["rot"].float(), out["trans"].float(), s, s,
        r.tile_px, r.faces_per_tile)
    vis = pseudo["vis_mask"].contiguous()
    lab = ((ren["color"].detach() * vis[..., None]).contiguous(),
           (batch["roi_img"] * vis[..., None]).contiguous(), vis)
    return ftab, cand, cts, lab


def raster_counts(ftab, cand, mask, tile_px, height, width, cts=None):
    """What this render's data makes the fine stage do: face rows the
    candidate lists name, valid candidate slots per tile, occupied tiles (a
    valid candidate), boundary tiles (occupied, not fully covered), covered
    pixels and, per tile, the in-image and the uncovered pixels. With the
    cotangents cts = (dprob, ddepth, dattr), per tile the pixels with any
    cotangent, the covered ones with a depth or attr cotangent and the
    uncovered ones with a prob cotangent: the pixels B2 needs."""
    from self6dpp_tpu_torch.ops import raster_cuda as RC
    B, F, _ = ftab.shape
    T = cand.shape[0]
    th, tw = -(-height // tile_px), -(-width // tile_px)
    b_of_t = torch.arange(T, device=cand.device) // (T // B)
    valid = (cand >= 0) & (ftab[b_of_t[:, None], cand.long().clamp_min(0), 7] > 0.5)
    n_valid = valid.sum(1).float()                                    # (T,)

    def tiles(x):                       # (T, P), 0 past the ragged edge
        return RC._tile_pixels(x.float(), tile_px, th * tw, tw)
    covered = tiles(mask) > 0.5
    uncovered = tiles(1.0 - mask) > 0.5
    occupied = n_valid > 0
    boundary = occupied & uncovered.any(1)
    ids = cand.view(B, -1)
    face_rows = sum(int(torch.unique(ids[i][ids[i] >= 0]).numel())
                    for i in range(B))
    out = {"face_rows_read": face_rows, "face_rows": B * F, "tiles": T,
           "valid_candidate_slots": int(n_valid.sum().item()),
           "occupied_tiles": int(occupied.sum().item()),
           "boundary_tiles": int(boundary.sum().item()),
           "covered_pixels": int(mask.sum().item()),
           "uncovered_pixels_of_occupied_tiles":
               int(uncovered.sum(1)[occupied].sum().item()),
           "_n_valid": n_valid,
           "_pixels": tiles(torch.ones_like(mask)).sum(1),
           "_uncovered": uncovered.sum(1).float()}
    if cts is not None:
        dprob, ddepth, dattr = (c != 0 for c in cts)
        win = covered & (tiles(ddepth | dattr.any(-1)) > 0.5)
        sil = uncovered & (tiles(dprob) > 0.5)
        out.update({
            "covered_pixels_with_depth_or_attr_cotangent": int(win.sum()),
            "covered_pixels_with_attr_cotangent":
                int((covered & (tiles(dattr.any(-1)) > 0.5)).sum()),
            "covered_pixels_with_depth_cotangent":
                int((covered & (tiles(ddepth) > 0.5)).sum()),
            "uncovered_pixels_with_prob_cotangent": int(sil.sum()),
            "_active": tiles(dprob | ddepth | dattr.any(-1)).sum(1),
            "_win": win.sum(1).float(), "_sil": sil.sum(1).float()})
    return out


def b1_ops(n, with_prob=True):
    """f32 operations of the fine forward (raster_counts' n)."""
    nv = n["_n_valid"]
    return (float((nv * n["_pixels"]).sum()) * OPS_TEST
            + float(nv.sum()) * OPS_CAND
            + n["covered_pixels"] * OPS_WIN_FWD
            + with_prob * float((nv * n["_uncovered"]).sum()) * OPS_SEG)


def b2_ops(n):
    """f32 operations of the fine backward on the cotangents counted in n
    (raster_counts with cts): the winner or the coverage of every pixel
    with a cotangent, the winner's chain where depth or attr has one, the
    silhouette product and its gradient where prob has one."""
    nv = n["_n_valid"]
    return (float((nv * n["_active"]).sum()) * OPS_TEST
            + float(nv.sum()) * OPS_CAND
            + float(n["_win"].sum()) * OPS_WIN_BWD
            + float((nv * n["_sil"]).sum()) * (OPS_SEG + OPS_SEG_BWD))


def bound(bytes_moved, ops, sfu_ops=0.0):
    """The least time for the work: bytes at the HBM rate, f32 operations
    at the f32 rate, special-function operations at the SFU rate; the
    largest of the three, and what set it ("operations" for either rate,
    the unit in bound_unit)."""
    t = {"bytes": bytes_moved / PEAK_BYTES * 1e3,
         "f32": ops / PEAK_F32 * 1e3, "sfu": sfu_ops / PEAK_SFU * 1e3}
    unit = max(t, key=t.get)
    return {"bytes": bytes_moved, "f32_ops": ops, "sfu_ops": sfu_ops,
            "bound_ms": t[unit], "bound_unit": unit,
            "bound_by": "bytes" if unit == "bytes" else "operations"}


def lab_ops(pred, gt, no_l=True):
    """(f32 operations, SFU operations) that B3's arithmetic needs on these
    inputs (OPS_LAB's derivation): the power and cube-root branches as the
    data takes them."""
    from self6dpp_tpu_torch.ops.color import FT, RGB2XYZ, SRGB_T, XYZ_REF
    ops = pred[..., 0].numel() * (OPS_LAB + (0 if no_l else OPS_LAB_L))
    sfu = 0
    for side, rgb in (("pred", pred), ("gt", gt)):
        powb = rgb > SRGB_T
        lin = torch.where(powb, ((rgb + 0.055) / 1.055) ** 2.4, rgb / 12.92)
        xyz = torch.stack([sum(RGB2XYZ[i][j] * lin[..., j] for j in range(3))
                           / XYZ_REF[i] for i in range(3)], -1)
        n_pow, n_cube = int(powb.sum()), int((xyz > FT).sum())
        (pf, ps), (cf, cs) = OPS_LAB_POW[side], OPS_LAB_CUBE[side]
        ops += (n_pow * pf + (powb.numel() - n_pow)
                + n_cube * cf + (xyz.numel() - n_cube) * 2)
        sfu += n_pow * ps + n_cube * cs
    return float(ops), float(sfu)


def lab_ties(pred, gt, band):
    """(B,S,S) True where the a or b channel of pred and gt (in float64)
    differ by less than `band` Lab units: there the L1's subgradient is the
    sign of a rounding error (a grey pixel's a and b are rounding-level
    numbers; colour augmentation's grayscale blend makes such pixels)."""
    from self6dpp_tpu_torch.ops.color import _lab_channels
    _, ap, bp = _lab_channels(pred.double())
    _, ag, bg = _lab_channels(gt.double())
    return ((ap - ag).abs() < band) | ((bp - bg).abs() < band)


def check_stage2_kernels(cfg, inputs, tie_band=None):
    """Phase 5: B1 with the soft silhouette, B2 and B3 against their plain
    versions on one stage-II step's inputs (stage2_inputs), timed, with
    their bounds. B2 is held twice: on the cotangents the whole loss suite
    sends (prob's from the mask loss; attr's from LPIPS and MS-SSIM, which
    read the masked render after LAB's gradient is injected into it;
    depth's from the chamfer) and on seeded random ones. With tie_band
    (phase 21, on colour-augmented images), B3's gradient is held at the
    pixels outside lab_ties(tie_band) (their count is recorded); its value
    everywhere."""
    from self6dpp_tpu_torch.ops import lab_cuda as LC
    from self6dpp_tpu_torch.ops import raster_cuda as RC
    ftab, cand, cts, lab = inputs
    device = ftab.device
    s, tp = cfg.model.input_res, cfg.renderer.tile_px
    B, F, C = ftab.shape
    D = (C - RC._GEO) // 3
    P = tp * tp
    fwd_call = (ftab, cand, s, s, tp, S2_SIGMA, True, True)
    got, keep = RC._fine(*fwd_call, True)     # as FineRaster runs it
    torch.cuda.synchronize()
    ref = RC.fine_raster_plain(*fwd_call)
    b1 = compare_raster(got, ref, "stage-II B1")
    # the saved state: keep bit for bit as B1's slot loop and the old
    # backward's recompute multiply it, prob = 1 - keep
    keep_ref = RC.keep_slot_order_plain(ftab, cand, s, s, tp, S2_SIGMA)
    b1["keep_same_bits"] = bool(torch.equal(keep.view(torch.int32),
                                            keep_ref.view(torch.int32)))
    b1["keep_max_abs_err"] = (keep - keep_ref).abs().max().item()
    require(b1["keep_same_bits"], "B1's saved keep", b1["keep_max_abs_err"])
    require(torch.equal(1.0 - keep, got.prob), "B1: prob != 1 - keep")
    n = raster_counts(ftab, cand, ref.mask, tp, s, s, cts)
    # timed as the step runs it: with the saved keep written
    b1["ms"] = cuda_ms(lambda: RC._fine(*fwd_call, True))
    b1["graph_ms"] = graph_ms(lambda: RC._fine(*fwd_call, True))
    b1["plain_ms"] = cuda_ms(lambda: RC.fine_raster_plain(*fwd_call),
                             **PLAIN_TIMING)
    b1.update(bound(
        n["face_rows_read"] * C * 4 + cand.numel() * 4
        + B * s * s * (4 + D + 3) * 4, b1_ops(n)))

    g = torch.Generator(device="cpu").manual_seed(SEED)
    rand_cts = [torch.randn(c.shape, generator=g).to(device) for c in cts]
    b2 = {}
    saved = (got.face_id, keep)
    for name, c in (("loss", cts), ("random", rand_cts)):
        call = (ftab, cand, *c, s, s, tp, S2_SIGMA, True, True)
        with scatter_counted() as scatters:
            got2 = RC.fine_raster_bwd(*call, saved)
            torch.cuda.synchronize()
        require(scatters["n"] == 0, "B2's kernel path ran the scatter")
        ref2 = RC.fine_raster_bwd_plain(*call)          # recomputes the state
        scale = ref2.abs().max().item()
        err = (got2 - ref2).abs().max().item() / max(scale, 1e-30)
        require(scale > 0, "B2: zero gradient", name)
        require(err <= TOL_B2, "B2 vs plain", name, err)
        b2[name] = {"rel_err": err, "max_abs": scale}
    call = (ftab, cand, *cts, s, s, tp, S2_SIGMA, True, True)
    b2["ms"] = cuda_ms(lambda: RC.fine_raster_bwd(*call, saved))
    b2["graph_ms"] = graph_ms(lambda: RC.fine_raster_bwd(*call, saved))
    b1["graph_ms_parts"], b2["graph_ms_parts"] = raster_parts_ms(
        fwd_call, call, saved)
    b2["plain_ms"] = cuda_ms(lambda: RC.fine_raster_bwd_plain(*call),
                             **PLAIN_TIMING)
    b2.update(bound(
        n["face_rows_read"] * C * 4 + cand.numel() * 4
        + n["occupied_tiles"] * P * (2 + D) * 4 + B * F * C * 4, b2_ops(n)))

    # B3: the normalised entry against its plain version, and the scaled
    # entry the step calls (one launch each) against its plain twin
    w = cfg.self_sup.lab_lw
    before = LC.lab_value_grad.launches
    val, grad = LC.lab_value_grad(*lab, True)
    val2, _ = LC.lab_value_grad(*lab, True)
    sval, g_raw, sscale = LC.lab_value_grad_scaled(*lab, True, w)
    torch.cuda.synchronize()
    require(LC.lab_value_grad.launches
            == before + 3 * S2_LAUNCHES["lab_value_grad"], "B3 launches")
    rval, rgrad = LC.lab_value_grad_plain(*lab, True)
    rsval, rg_raw, rscale = LC.lab_value_grad_scaled_plain(*lab, True, w)
    # the same chain in float64 (the plain version on float64 copies)
    fval, fgrad = LC.lab_value_grad_plain(*(x.double() for x in lab), True)
    ties = 0
    if tie_band is not None:
        keep = (~lab_ties(*lab[:2], tie_band))[..., None]
        ties = int((~keep).sum())
        grad, rgrad, fgrad, g_raw, rg_raw = (
            x * keep for x in (grad, rgrad, fgrad, g_raw, rg_raw))
    scale, ftop = rgrad.abs().max().item(), fgrad.abs().max().item()
    gerr = (grad - rgrad).abs().max().item()
    g_raw_err = (g_raw - rg_raw).abs().max().item()
    b3 = {"value": val.item(), "plain_value": rval.item(),
          "value_rel_err": abs(val.item() - rval.item()) / abs(rval.item()),
          "grad_max_abs_err": gerr, "grad_err": gerr / scale,
          "g_raw_err": g_raw_err / rg_raw.abs().max().item(),
          "scale_rel_err": abs(sscale.item() - rscale.item()) / rscale.item(),
          # the scaled entry's (the timed call's) outputs
          "scaled_max_abs_err": max(g_raw_err, abs(sval.item() - rsval.item()),
                                    abs(sscale.item() - rscale.item())),
          "value_rel_err_vs_f64": abs(val.item() - fval.item())
          / abs(fval.item()),
          "grad_err_vs_f64": (grad.double() - fgrad).abs().max().item() / ftop,
          "plain_grad_err_vs_f64":
              (rgrad.double() - fgrad).abs().max().item() / ftop,
          "same_bits_twice": bool(torch.equal(val, val2)
                                  and torch.equal(val, sval)),
          "mask_pixels": lab[2].sum().item(), "tie_pixels": ties}
    require(rval.item() > 0 and scale > 0, "B3: empty LAB input")
    require(b3["same_bits_twice"], "B3 value differs between runs")
    require(b3["value_rel_err"] <= TOL_B3_VALUE
            and b3["scale_rel_err"] <= TOL_B3_VALUE, "B3 value", b3)
    require(b3["grad_err"] <= TOL_B3_GRAD and b3["g_raw_err"] <= TOL_B3_GRAD,
            "B3 gradient", b3)
    require(b3["value_rel_err_vs_f64"] <= TOL_B3_VALUE
            and b3["grad_err_vs_f64"] <= TOL_B3_GRAD, "B3 against float64", b3)
    # timed as the step calls it: the scaled entry, one launch
    step_call = lambda: LC.lab_value_grad_scaled(*lab, True, w)
    b3["ms"] = cuda_ms(step_call)
    b3["plain_ms"] = cuda_ms(lambda: LC.lab_value_grad_scaled_plain(
        *lab, True, w))
    b3["graph_ms"] = graph_ms(step_call)
    npix = lab[2].numel()
    b3.update(bound(npix * (3 + 3 + 1 + 3) * 4, *lab_ops(*lab[:2])))
    b3["graph_ms_parts"] = lab_parts_ms(lab, w)

    counts = {k: v for k, v in n.items() if not k.startswith("_")}
    return {"B1": b1, "B2": b2, "B3": b3, "counts": counts}


def lab_parts_ms(lab, weight):
    """Where B3's device time goes (graph_ms): the scaled entry's launch
    alone (its ticket's memset and the kernel); the normalised call,
    lab_value_grad with g_raw * scale; and the call as the step makes it,
    from the launch until the weighted gradient is in the masked render's
    cotangent (a seeded `ct`: InjectGrad's addcmul)."""
    from self6dpp_tpu_torch.ops import lab_cuda as LC
    pred, gt, mask = lab
    g = torch.Generator(device="cpu").manual_seed(SEED)
    ct = torch.randn(pred.shape, generator=g).to(pred.device)
    launch = lambda: LC.lab_value_grad_scaled(pred, gt, mask, True, weight)

    def step_call():
        _, g_raw, scale = launch()
        return torch.addcmul(ct, g_raw, scale)
    return {"launch": graph_ms(launch),
            "normalised_call": graph_ms(lambda: LC.lab_value_grad(
                pred, gt, mask, True)),
            "step_call": graph_ms(step_call)}


def raster_parts_ms(fwd_call, bwd_call, saved):
    """Where B1's and B2's device time goes (graph_ms of the same calls
    with parts of the work taken away): B1 with every tile empty (the
    output bytes), with every face culled (the slot walk), without culling,
    without the silhouette; B2 with zero cotangents (the prologue), with the
    winner chain's or the silhouette's cotangents alone, without culling."""
    from self6dpp_tpu_torch.ops import raster_cuda as RC
    ftab, cand, *rest = fwd_call
    dprob, ddepth, dattr = bwd_call[2:5]
    tail = bwd_call[5:]
    zero = [torch.zeros_like(x) for x in (dprob, ddepth, dattr)]
    b1 = {"all_tiles_empty": graph_ms(lambda: RC._fine(
        ftab, torch.full_like(cand, -1), *rest, True))}
    with cull_at(b1=0.0):
        b1["every_face_culled"] = graph_ms(lambda: RC._fine(*fwd_call, True))
    with cull_at(b1=3e38):
        b1["no_culling"] = graph_ms(lambda: RC._fine(*fwd_call, True))
    no_prob = list(fwd_call)
    no_prob[6] = False
    b1["no_silhouette"] = graph_ms(lambda: RC._fine(*no_prob, False))
    bwd = lambda *cts: RC.fine_raster_bwd(ftab, cand, *cts, *tail, saved)
    b2 = {"zero_cotangents": graph_ms(lambda: bwd(*zero)),
          "winner_chain_only": graph_ms(lambda: bwd(zero[0], ddepth, dattr)),
          "silhouette_only": graph_ms(lambda: bwd(dprob, zero[1], zero[2]))}
    with cull_at(b2=3e38):
        b2["no_culling"] = graph_ms(lambda: bwd(dprob, ddepth, dattr))
    return b1, b2


def check_cull_scene(device):
    """Phase 5, the culling: B1 and B2 against their plain versions on
    raster_cuda.scattered_faces (faces 0 to ~45 px from a tile's pixels, so
    both cutoffs fall inside tiles; cotangents on some 8 x 4 pixel blocks
    only and on none of each image's first tile), for persp x sigma in
    (1.0, 1.5): mask and face_id bitwise equal, the other fields within
    TOL_KERNEL, d ftab within TOL_B2."""
    from self6dpp_tpu_torch.ops import raster_cuda as RC
    ftab, cand, cts = RC.scattered_faces(device)
    h, w, tp = 70, 100, 32
    require(RC.cand_depth_sorted(ftab, cand), "cull scene: cand order")
    out = {}
    for persp in (True, False):
        for sigma in (1.0, 1.5):
            call = (ftab, cand, h, w, tp, sigma, True, persp)
            got, keep = RC._fine(*call, True)
            torch.cuda.synchronize()
            ref = RC.fine_raster_plain(*call)
            key = f"persp={persp},sigma={sigma}"
            v = compare_raster(got, ref, key)
            require(torch.equal(got.mask, ref.mask)
                    and torch.equal(got.face_id, ref.face_id), key)
            bcall = (ftab, cand, *cts, h, w, tp, sigma, True, persp)
            g = RC.fine_raster_bwd(*bcall, (got.face_id, keep))
            torch.cuda.synchronize()
            r = RC.fine_raster_bwd_plain(*bcall)
            scale = r.abs().max().item()
            v["b2_rel_err"] = (g - r).abs().max().item() / max(scale, 1e-30)
            require(scale > 0 and v["b2_rel_err"] <= TOL_B2, key, v)
            out[key] = v
    return out


def params_of(model):
    return {k: p.detach().clone() for k, p in model.named_parameters()}


def max_abs_diff(a, b):
    return max((a[k] - b[k]).abs().max().item() for k in a)


def snapshot(state):
    """A copy of a TrainState's student, teacher, solver state and step."""
    return copy.deepcopy({
        "step": state.step, "model": state.model.state_dict(),
        "teacher": (None if state.teacher is None
                    else state.teacher.state_dict()),
        "opt": state.opt.state_dict()})


def restore(state, snap) -> None:
    """Puts `snapshot`'s copy back into a state of the same build."""
    state.model.load_state_dict(snap["model"])
    if state.teacher is not None:
        state.teacher.load_state_dict(snap["teacher"])
    state.opt.load_state_dict(snap["opt"])
    state.step = snap["step"]


def run_steps(cfg, device, batch_size, n, impl="kernel", built=None,
              refiner=None, starts=None, build=None):
    """n stage-II steps from the seeded weights (`built`, build(cfg,
    batch_size, device, seed=SEED)'s result, build defaulting to
    build_stage2, or a new one), with the DeepIM refiner `refiner` when
    given; step i starts from the snapshot starts[i] where `starts` has one,
    else from where step i - 1 left: (initial params, metrics per step,
    params after each step, snapshot after each step)."""
    from self6dpp_tpu_torch.engine import self_engine as se
    build = build or se.build_stage2
    model, state, batch, lpips = built or build(
        cfg, batch_size, device, seed=SEED)
    init = params_of(model)
    step = se.make_self_train_step(cfg, model, lpips, impl=impl,
                                   refiner=refiner)
    metrics, params, snaps = [], [], []
    for i in range(n):
        if starts and i in starts:
            restore(state, starts[i])
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
        params.append(params_of(model))
        snaps.append(snapshot(state))
    torch.cuda.synchronize()
    return init, metrics, params, snaps


def loss_err(a, b):
    """Largest relative difference of two steps' loss terms. A term below
    1e-3 of the total loss is measured against 1e-3 of the total instead of
    against itself: the teacher-student terms are differences of nearly
    equal numbers while the teacher is still close to the student (0 at
    the first step, where it is the student's copy)."""
    require(set(a) == set(b), "loss keys", sorted(a), sorted(b))
    floor = 1e-3 * abs(b["total_loss"])
    return max(abs(a[k] - b[k]) / max(abs(b[k]), floor) for k in a)


def check_stage2_fp32(cfg32, device, batch_size, built, refiner=None,
                      build=None):
    """Phase 6: float32 steps through the kernels (on `built`, the untouched
    build_stage2 result phase 5 read its inputs from) and through the plain
    versions, from the same weights and batch (and the refiner, when
    given), with TF32 off and cuDNN deterministic. Two plain steps; the
    kernels' first step from the seeded weights and their second from the
    plain run's state after its first, so each step is held from one
    state: losses within TOL_S2_LOSS, parameters after each step within
    TOL_S2_PARAMS. Two steps chained through the kernels are held beside
    the plain ones on their losses (TOL_S2_LOSS) and their parameters are
    recorded, not held: from the second step on the mean teacher (EMA
    decay 5e-4 at step 1) is within rounding of the student, the
    teacher-student L1 terms take their signs from the last bits, and B2's
    atomics (fine_raster_bwd.cu) vary those bits from run to run, so the
    chained parameters part by an amount that varies from run to run and
    has no bearing on the kernels. The check can fail: the parameters
    moved more than S2_MOVED x TOL_S2_PARAMS, and two steps with every loss
    that reads the render at weight 0 (S2_RENDER_LOSSES) end more than
    TOL_S2_PARAMS away. build: the builder of `built` (build_stage2 by
    default; phase 24's textured_stage2)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        init, mk, pk, _ = run_steps(cfg32, device, batch_size, 2, "kernel",
                                    built, refiner, build=build)
        _, mp, pp, sp = run_steps(cfg32, device, batch_size, 2, "plain",
                                  refiner=refiner, build=build)
        _, mk2, pk2, _ = run_steps(cfg32, device, batch_size, 1, "kernel",
                                   refiner=refiner, starts={0: sp[0]},
                                   build=build)
        ctrl = dataclasses.replace(cfg32, self_sup=dataclasses.replace(
            cfg32.self_sup, **{k: 0.0 for k in S2_RENDER_LOSSES}))
        _, mc, pc, _ = run_steps(ctrl, device, batch_size, 2, "kernel",
                                 refiner=refiner, build=build)
    finally:
        torch.backends.cudnn.deterministic = det
    for m in mk + mk2:
        require(all(np.isfinite(v) for v in m.values()), "non-finite loss", m)
    held = [mk[0], mk2[0]]
    detail = {
        "losses_kernel": held, "losses_plain": mp, "losses_control": mc,
        "loss_rel_err": max(loss_err(a, b) for a, b in zip(held, mp)),
        "params_kernel_vs_plain_max_abs": max(
            max_abs_diff(pk[0], pp[0]), max_abs_diff(pk2[0], pp[1])),
        "params_by_step_kernel_vs_plain_max_abs": [
            max_abs_diff(pk[0], pp[0]), max_abs_diff(pk2[0], pp[1])],
        "chained_losses_kernel": mk,
        "chained_loss_rel_err": max(loss_err(a, b) for a, b in zip(mk, mp)),
        "chained_params_kernel_vs_plain_max_abs": max_abs_diff(pk[1], pp[1]),
        "params_moved_max_abs": max_abs_diff(pk[1], init),
        "params_vs_control_max_abs": max_abs_diff(pk[1], pc[1]),
        "lr": cfg32.solver.base_lr}
    require(detail["loss_rel_err"] <= TOL_S2_LOSS, "fp32 step losses",
            detail["loss_rel_err"])
    require(detail["chained_loss_rel_err"] <= TOL_S2_LOSS,
            "fp32 chained step losses", detail["chained_loss_rel_err"])
    require(detail["params_kernel_vs_plain_max_abs"] <= TOL_S2_PARAMS,
            "fp32 step params",
            detail["params_by_step_kernel_vs_plain_max_abs"])
    require(detail["params_moved_max_abs"] > S2_MOVED * TOL_S2_PARAMS,
            "the steps left the params where they were",
            detail["params_moved_max_abs"])
    require(detail["params_vs_control_max_abs"] > TOL_S2_PARAMS,
            "the render's gradient did not reach the params",
            detail["params_vs_control_max_abs"])
    return mk[0], detail


def timed_steps(step, state, batch, steps):
    """`steps` steps (host clock around each, ending in a synchronize) with
    CUDA events at the step's phase boundaries: (times, phases, metrics).
    A phase marked more than once in a step (the DeepIM refine loop's, once
    per iteration) sums its spans."""
    from self6dpp_tpu_torch.engine.gdrn_engine import event_marker
    times, phases, metrics = [], [], []
    for _ in range(steps):
        marks = []
        mark = event_marker(marks)
        t0 = time.perf_counter()
        mark("start")
        state, m = step(state, batch, mark)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        spans = {}
        for a, b in zip(marks, marks[1:]):
            spans[b[0]] = spans.get(b[0], 0.0) + a[1].elapsed_time(b[1])
        phases.append(spans)
        metrics.append(m)
    return times, phases, metrics


def summary(times, phases):
    phase_ms = {k: float(np.median([p[k] for p in phases])) for k in phases[0]}
    return {"steps": len(times), "ms_per_step": float(np.median(times)),
            "step_ms": times, "phase_ms_median": phase_ms,
            "phase_ms_sum": float(sum(phase_ms.values()))}


def loss_parts_ms(cfg, state, batch, lpips):
    """Forward + backward time of each loss the whole suite adds to the
    partial step, on this step's render (CUDA events, cuda_ms): LPIPS (float32),
    MS-SSIM and the depth chamfer with its backprojection."""
    from self6dpp_tpu_torch.engine import self_engine as se
    from self6dpp_tpu_torch.losses import self_loss as sl
    with torch.no_grad():
        _, ren, pseudo = se.forward_losses(cfg, state, batch, lpips=lpips)
    vis = pseudo["vis_mask"][..., None]
    color = ren["color"].detach().requires_grad_(True)
    depth = ren["depth"].detach().requires_grad_(True)
    img_m = batch["roi_img"] * vis
    only = {k: 0.0 for k in S2_RENDER_LOSSES + ("pseudo_pm_lw",
                                                 "pseudo_trans_lw")}

    def run(**w):
        ss = dataclasses.replace(cfg.self_sup, **{**only, **w})
        ld = sl.compute_self_loss_pose(ss, {"color": color, "depth": depth,
                                            "prob": ren["prob"]}, {}, pseudo,
                                       batch, lpips_fn=lpips)
        sum(ld.values()).backward()
    ss = cfg.self_sup
    return {"lpips": cuda_ms(lambda: run(perceptual_lw=ss.perceptual_lw), reps=4),
            "ms_ssim": cuda_ms(lambda: run(ms_ssim_lw=ss.ms_ssim_lw), reps=4),
            "chamfer": cuda_ms(lambda: run(depth_chamfer_lw=ss.depth_chamfer_lw),
                               reps=4)}


def kernel_launches():
    from self6dpp_tpu_torch.ops import lab_cuda as LC
    from self6dpp_tpu_torch.ops import raster_cuda as RC
    return {"fine_raster_fwd": RC.fine_raster.launches,
            "fine_raster_bwd": RC.fine_raster_bwd.launches,
            "lab_value_grad": LC.lab_value_grad.launches}


def zero_kernel_launches():
    from self6dpp_tpu_torch.ops import lab_cuda as LC
    from self6dpp_tpu_torch.ops import raster_cuda as RC
    from self6dpp_tpu_torch.ops import upsample_cuda as UC
    RC.fine_raster.launches = 0
    RC.fine_raster_bwd.launches = 0
    LC.lab_value_grad.launches = 0
    UC.upsample2x.launches = 0
    UC.upsample2x_bwd.launches = 0


def upsample_launches():
    from self6dpp_tpu_torch.ops import upsample_cuda as UC
    return {"upsample2x": UC.upsample2x.launches,
            "upsample2x_bwd": UC.upsample2x_bwd.launches}


def time_stage2(cfg, device, batch_size, ref32, steps=S2_TIMED_STEPS,
                partial_steps=S2_PARTIAL_STEPS):
    """Phase 7: stage-II steps in the configured compute dtype. One
    warm-up step, whose losses are held against the float32 step's (the
    same weights and batch) within TOL_S2_BF16; then `steps` timed steps
    (timed_steps), the launch counts set to 0 just before and read just
    after; the time of each loss the whole suite adds (loss_parts_ms); and
    `partial_steps` steps of the partial step (S2_PARTIAL at weight 0) from
    the same weights, timed the same way."""
    from self6dpp_tpu_torch.engine import self_engine as se
    model, state, batch, lpips = se.build_stage2(cfg, batch_size, device,
                                                 seed=SEED)
    step = se.make_self_train_step(cfg, model, lpips)
    state, warm = step(state, batch)
    torch.cuda.synchronize()
    warm = {k: float(v) for k, v in warm.items()}
    bf16_err = loss_err(warm, ref32)
    require(bf16_err <= TOL_S2_BF16, "bf16 vs fp32 losses", warm, ref32)

    torch.cuda.reset_peak_memory_stats()
    zero_kernel_launches()
    with scatter_counted() as scatters:
        times, phases, metrics = timed_steps(step, state, batch, steps)
    require(scatters["n"] == 0, "the step's B2 ran the scatter", scatters)
    launches = kernel_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for name, k in launches.items():
        require(k == S2_LAUNCHES[name] * steps, "launches per step", name, k,
                steps)
    for name, k in upsample_launches().items():
        require(k == S2_UPSAMPLE_LAUNCHES[name] * steps,
                "upsample launches per step", name, k, steps)
        launches[name] = k
    for m in metrics:
        require(all(torch.isfinite(v).item() for v in m.values()),
                "non-finite loss", m)
    require(all(torch.isfinite(p).all().item() for p in model.parameters()),
            "non-finite parameters")
    require(set(metrics[-1]) == set(ref32), "loss keys")
    require({"loss_percep_obj", "loss_ms_ssim", "loss_chamfer"}
            <= set(metrics[-1]), "the whole suite", sorted(metrics[-1]))
    parts = loss_parts_ms(cfg, state, batch, lpips)
    whole = {**summary(times, phases), "peak_mem_gib": peak,
             "bf16_vs_fp32_loss_rel_err": bf16_err, "first_losses_bf16": warm,
             "last_losses": {k: float(v) for k, v in metrics[-1].items()},
             "loss_parts_fwd_bwd_ms": parts}
    del model, state, step

    pcfg = dataclasses.replace(cfg, self_sup=dataclasses.replace(
        cfg.self_sup, **{k: 0.0 for k in S2_PARTIAL}))
    model, state, batch, _ = se.build_stage2(pcfg, batch_size, device,
                                             seed=SEED)
    step = se.make_self_train_step(pcfg, model)
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, phases, metrics = timed_steps(step, state, batch, partial_steps)
    partial = {**summary(times, phases),
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "last_losses": {k: float(v) for k, v in metrics[-1].items()}}
    return launches, whole, partial


def masked_pair_inputs(lab):
    """P1's and P2's inputs from the step's masked render and image (B, S,
    S, 3): the flattened (B, S²·3) pair and the channel planes (B, S²)."""
    r, i = lab[0], lab[1]
    b, s = r.shape[:2]
    flat = (r.reshape(b, -1), i.reshape(b, -1))
    planes = (tuple(r[..., k].reshape(b, s * s) for k in range(3)),
              tuple(i[..., k].reshape(b, s * s) for k in range(3)))
    return flat, planes


def forced_pair(shape, device):
    """A seeded (B, S, S, 3) pair with ties (r == i), NaN on either side,
    -0.0 - +0.0 and infinities among uniform values."""
    g = torch.Generator(device="cpu").manual_seed(SEED)
    r = torch.rand(shape, generator=g)
    i = torch.rand(shape, generator=g)
    n = r.numel() // 10
    k = torch.randperm(r.numel(), generator=g)[: 5 * n].view(5, n)
    rf, i_f = r.view(-1), i.view(-1)
    rf[k[0]] = i_f[k[0]]
    rf[k[1]] = float("nan")
    i_f[k[2]] = float("nan")
    rf[k[3]], i_f[k[3]] = -0.0, 0.0
    rf[k[4]] = float("inf")
    return r.to(device), i.to(device)


def same_bits(a, b):
    """Bitwise equal where b is a number, NaN exactly where b is NaN
    (torch.equal alone would call NaN unequal to itself)."""
    nan = b.isnan()
    return bool(torch.equal(a.isnan(), nan) and torch.equal(
        a.view(torch.int32)[~nan], b.view(torch.int32)[~nan]))


def max_abs_off_nan(a, b):
    """Largest |a - b| where b is a number (0 where b is NaN throughout)."""
    keep = ~b.isnan()
    return float((a - b).abs()[keep].max()) if bool(keep.any()) else 0.0


def check_sign_kernels(lab):
    """Phase 8: P1 and P2 against their plain versions, bitwise, on the
    whole step's masked render and image and on forced_pair at the same
    shape; timed on the former (cuda_ms, and graph_ms: the wrapper's host
    work takes about as long as the kernel), with their bounds (two inputs
    read, one output written; OPS_SIGN per element)."""
    from self6dpp_tpu_torch.ops import sign_cuda as SC
    out = {}
    forced = forced_pair(tuple(lab[0].shape), lab[0].device)
    for name, pair in (("step", lab[:2]), ("forced", forced)):
        (fr, fi), (rp, ip) = masked_pair_inputs(pair)
        g1 = SC.sign_g(fr, fi)
        g2 = SC.sign_g_split(rp, ip)
        torch.cuda.synchronize()
        p1 = SC.sign_g_plain(fr, fi)
        p2 = SC.sign_g_split_plain(rp, ip)
        v = {"P1_max_abs_err": max_abs_off_nan(g1, p1),
             "P2_max_abs_err": max(max_abs_off_nan(a, b)
                                   for a, b in zip(g2, p2)),
             "P1_same_bits": same_bits(g1, p1),
             "P2_same_bits": all(same_bits(a, b) for a, b in zip(g2, p2)),
             "P2_equals_P1": same_bits(
                 torch.stack([x.view(pair[0].shape[:3]) for x in g2], -1),
                 g1.view(pair[0].shape)),
             "nonzero": int((g1 != 0).sum()), "nan": int(g1.isnan().sum()),
             "negative_zero": int((g1.signbit() & (g1 == 0)).sum())}
        require(v["P1_same_bits"] and v["P2_same_bits"] and v["P2_equals_P1"],
                "P1/P2 vs plain", name, v)
        require(v["nonzero"] > 0, "P1: all zero", name)
        if name == "forced":
            require(v["nan"] > 0 and v["negative_zero"] > 0,
                    "forced input lacks NaN or -0.0", v)
        out[name] = v
    (fr, fi), (rp, ip) = masked_pair_inputs(lab[:2])
    n = fr.numel()
    lim = bound(3 * n * 4, n * OPS_SIGN)
    for key, fn, plain, args in (
            ("P1", SC.sign_g, SC.sign_g_plain, (fr, fi)),
            ("P2", SC.sign_g_split, SC.sign_g_split_plain, (rp, ip))):
        out[key] = {"ms": cuda_ms(lambda: fn(*args)),
                    "plain_ms": cuda_ms(lambda: plain(*args)),
                    "graph_ms": graph_ms(lambda: fn(*args)),
                    "plain_graph_ms": graph_ms(lambda: plain(*args)), **lim}
    for key in ("P1", "P2"):
        out[key]["max_abs_err"] = max(out[k][f"{key}_max_abs_err"]
                                      for k in ("step", "forced"))
    out["elements"] = n
    return out


def run_lab_probe(steps=PROBE_STEPS):
    """Phase 9: the LAB opaque probe's variants A, J, J2, A' on the bf16
    flagship step (probes/lab_opaque_probe.py::run_probe: the variants take
    turns, WARMUP rounds untimed, then `steps` timed), the launch counts of
    P1 and P2 set to 0 just before and read just after: one P1 launch per J
    step and one P2 launch per J2 step (warm-up rounds included), none in A
    or A'."""
    from self6dpp_tpu_torch.ops import sign_cuda as SC
    from self6dpp_tpu_torch.probes.lab_opaque_probe import WARMUP, run_probe
    SC.sign_g.launches = 0
    SC.sign_g_split.launches = 0
    res = run_probe(steps)
    n = steps + WARMUP
    launches = {"sign_g": SC.sign_g.launches,
                "sign_g_split": SC.sign_g_split.launches}
    per = {k: (v["sign_g_launches"], v["sign_g_split_launches"])
           for k, v in res.items()}
    require(per == {"A": (0, 0), "J": (n, 0), "J2": (0, n), "A'": (0, 0)},
            "probe launches", per)
    require(launches == {"sign_g": n, "sign_g_split": n}, "probe launches",
            launches)
    for k, v in res.items():
        require(np.isfinite(v["total_loss"]), "probe: non-finite loss", k)
    return launches, res


def stage2_kernel_lines(k5, launches, k8, probe_launches):
    """The `kernels` entries of B1 (stage-II variant), B2, B3, P1 and P2."""
    rows = [("fine_raster_fwd[stage2]", "fine_raster_fwd.cu",
             "self6dpp_tpu/ops/raster_pallas.py:420", "B1",
             "fine_raster_fwd",
             max(k5["B1"]["max_abs_err"].values())),
            ("fine_raster_bwd", "fine_raster_bwd.cu",
             "self6dpp_tpu/ops/raster_pallas.py:459", "B2",
             "fine_raster_bwd", k5["B2"]["loss"]["rel_err"]
             * k5["B2"]["loss"]["max_abs"]),
            ("lab_value_grad", "lab_value_grad.cu",
             "self6dpp_tpu/ops/lab_pallas.py:171", "B3", "lab_value_grad",
             k5["B3"]["scaled_max_abs_err"])]
    out = []
    for name, src, replaces, key, count, err in rows:
        d = k5[key]
        out.append({
            "name": name, "route": "cuda",
            "source": f"self6dpp_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": launches[count], "max_abs_err": err, "ms": d["ms"],
            "graph_ms": d["graph_ms"],
            "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
            "bound_by": d["bound_by"], "library_ms": None})
    for key, name, call in (("P1", "sign_g", 68), ("P2", "sign_g_split", 110)):
        d = k8[key]
        out.append({
            "name": name, "route": "cuda",
            "source": "self6dpp_tpu_torch/csrc/sign_g.cu",
            "replaces": f"tools/probes/lab_opaque_probe.py:{call}",
            "launches": probe_launches[name],
            "max_abs_err": d["max_abs_err"], "ms": d["ms"],
            "graph_ms": d["graph_ms"], "plain_ms": d["plain_ms"],
            "bound_ms": d["bound_ms"],
            "bound_by": d["bound_by"], "library_ms": None})
    return out


# ---- stage I, the MaskNormVF pose step, geo and synsup (phases 10-12) ----

S1_BATCH = 24                     # bench.py::bench_gdrn_train's batch
S1_TIMED_STEPS = 20               # bf16 stage-I steps after one warm-up
S1_VF_STEPS = 2                   # timed steps at gdrn_lm_masknormvf
TOL_S1_LOSS = 1e-4                # fp32 card vs CPU losses, relative
TOL_S1_PARAMS = 1e-4              # fp32 card vs CPU params and BN stats
S3_TIMED_STEPS = 10               # bf16 MaskNormVF pose steps
# kernel launches per MaskNormVF pose step: the student render and the
# normal-map pseudo label (B1), the render's backward (B2), LAB (B3)
S3_LAUNCHES = {"fine_raster_fwd": 2, "fine_raster_bwd": 1,
               "lab_value_grad": 1}
GEO_TIMED_STEPS = 10              # each of the geo and synsup steps


def bn_stats_of(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def run_stage1(cfg, device, steps):
    """`steps` stage-I steps from the seeded weights on batches of seeds 0
    and 1 in turn: (initial params, initial BN stats, losses per step,
    final params, final BN stats), all on the CPU."""
    from self6dpp_tpu_torch.data.synthetic import make_gdrn_batch
    from self6dpp_tpu_torch.engine import gdrn_engine as ge
    from self6dpp_tpu_torch.engine.deepim_engine import to_device
    model = ge.build_gdrn(cfg, device=device, seed=SEED)
    state = ge.init_state(cfg, model)
    step = ge.make_train_step(cfg, model)
    batches = [to_device(make_gdrn_batch(cfg, cfg.solver.ims_per_batch,
                                         seed=s), device) for s in (0, 1)]
    cpu = lambda d: {k: v.cpu() for k, v in d.items()}
    init, init_bn = cpu(params_of(model)), cpu(bn_stats_of(model))
    metrics = []
    for i in range(steps):
        state, m = step(state, batches[i % 2])
        metrics.append({k: float(v) for k, v in m.items()})
    return init, init_bn, metrics, cpu(params_of(model)), cpu(bn_stats_of(model))


def check_stage1_card_vs_cpu(device):
    """Phase 10, first part: two float32 stage-I steps of
    config.masknormvf_tiny (BN in train mode, the vf/norm terms) on the
    card (TF32 off, cuDNN deterministic) and on the CPU (one thread): losses
    within TOL_S1_LOSS, parameters and BN running statistics within
    TOL_S1_PARAMS; the statistics and parameters moved past 10x it."""
    from self6dpp_tpu_torch.config import masknormvf_tiny
    cfg = masknormvf_tiny()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        init, init_bn, mg, pg, bg = run_stage1(cfg, device, 2)
    finally:
        torch.backends.cudnn.deterministic = det
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _, _, mc, pc, bc = run_stage1(cfg, torch.device("cpu"), 2)
    finally:
        torch.set_num_threads(threads)
    out = {"config": cfg.exp_name, "losses_card": mg, "losses_cpu": mc,
           "loss_rel_err": max(loss_err(a, b) for a, b in zip(mg, mc)),
           "params_card_vs_cpu_max_abs": max_abs_diff(pg, pc),
           "bn_stats_card_vs_cpu_max_abs": max_abs_diff(bg, bc),
           "params_moved_max_abs": max_abs_diff(pg, init),
           "bn_stats_moved_max_abs": max_abs_diff(bg, init_bn)}
    require({"loss_vf_vis", "loss_vf_full", "loss_norm"} <= set(mg[0]),
            "stage-I vf/norm terms", sorted(mg[0]))
    require(out["loss_rel_err"] <= TOL_S1_LOSS, "stage-I fp32 losses", out)
    require(out["params_card_vs_cpu_max_abs"] <= TOL_S1_PARAMS
            and out["bn_stats_card_vs_cpu_max_abs"] <= TOL_S1_PARAMS,
            "stage-I fp32 params / BN stats", out)
    require(out["params_moved_max_abs"] > 10 * TOL_S1_PARAMS
            and out["bn_stats_moved_max_abs"] > 10 * TOL_S1_PARAMS,
            "stage-I steps left params or BN stats where they were", out)
    return out


def time_stage1(cfg, device, batch_size, steps):
    """Phase 10: stage-I steps at `cfg` in its compute dtype on one seeded
    batch: one warm-up step, then `steps` timed (timed_steps: host clock
    and CUDA events at forward, loss, backward, optimizer + EMA), with the
    kernel launch counts set to 0 just before and read just after (the step
    runs no kernel). Every loss finite, the BN running statistics moved."""
    from self6dpp_tpu_torch.data.synthetic import make_gdrn_batch
    from self6dpp_tpu_torch.engine import gdrn_engine as ge
    from self6dpp_tpu_torch.engine.deepim_engine import to_device
    model = ge.build_gdrn(cfg, device=device, seed=SEED)
    state = ge.init_state(cfg, model)
    step = ge.make_train_step(cfg, model)
    batch = to_device(make_gdrn_batch(cfg, batch_size, seed=SEED), device)
    bn0 = bn_stats_of(model)
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_kernel_launches()
    times, phases, metrics = timed_steps(step, state, batch, steps)
    launches = kernel_launches()
    require(not any(launches.values()), "stage I launched a kernel", launches)
    for m in metrics:
        require(all(torch.isfinite(v).item() for v in m.values()),
                "non-finite stage-I loss", m)
    moved = max_abs_diff(bn_stats_of(model), bn0)
    require(moved > 0, "stage I left the BN statistics where they were")
    ms = float(np.median(times))
    out = {**summary(times, phases), "config": cfg.exp_name,
           "batch": batch_size, "compute_dtype": cfg.dist.compute_dtype,
           "ms_range": [min(times), max(times)],
           "images_per_s": batch_size / ms * 1e3,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "bn_stats_moved_max_abs": moved,
           "last_losses": {k: float(v) for k, v in metrics[-1].items()}}
    del model, state, step
    torch.cuda.empty_cache()
    return out


def check_normal_render(cfg, built):
    """Phase 11: B1 at the normal-map pseudo label's shape (output_res²,
    tiles of min(tile_px, output_res), K, three normal channels, no
    silhouette) on the pose the step takes (the teacher's), against its
    plain version: mask and face_id bit for bit, the rest within
    TOL_KERNEL; its candidates depth-sorted; the largest count of filled
    slots and of overlapping faces per tile beside K; timed, with its
    bound."""
    from self6dpp_tpu_torch.engine import self_engine as se
    from self6dpp_tpu_torch.engine.gdrn_engine import model_inputs
    from self6dpp_tpu_torch.ops import raster_cuda as RC
    from self6dpp_tpu_torch.ops import rasterizer as R
    _, state, batch, _ = built
    with torch.no_grad():
        tout = state.teacher(*model_inputs(batch))
    rot, trans = se.select_pseudo_pose(cfg.self_sup, batch, tout)
    args, kw = se.normal_render_args(cfg, batch, rot.float(), trans.float())
    o, tp, K = kw["height"], kw["tile_px"], kw["faces_per_tile"]
    ftab, cand = R.raster_inputs(*args, o, o, tp, K)
    require(RC.cand_depth_sorted(ftab, cand), "normal render: cand order")
    call = (ftab, cand, o, o, tp, 1.0, False, True)
    got = RC.fine_raster(*call)
    torch.cuda.synchronize()
    ref = RC.fine_raster_plain(*call)
    v = compare_raster(got, ref, "normal render B1")
    require(torch.equal(got.mask, ref.mask)
            and torch.equal(got.face_id, ref.face_id),
            "normal render: mask/face_id not bit for bit")
    B, F, C = ftab.shape
    fd = R.face_data(*args)
    every = R._bin_faces(fd[0], fd[4], o, o, tp, F, fd[1])
    overlap = (every >= 0).sum(-1)
    v.update({"shape": {"batch": B, "out_res": o, "tile_px": tp, "K": K,
                        "channels": (C - RC._GEO) // 3, "faces": F},
              "max_filled_slots_per_tile": int((cand >= 0).sum(1).max()),
              "max_overlapping_faces_per_tile": int(overlap.max()),
              "tiles_over_K": int((overlap > K).sum()),
              "tiles": int(overlap.numel())})
    v["ms"] = cuda_ms(lambda: RC.fine_raster(*call))
    v["graph_ms"] = graph_ms(lambda: RC.fine_raster(*call))
    v["plain_ms"] = cuda_ms(lambda: RC.fine_raster_plain(*call),
                            **PLAIN_TIMING)
    n = raster_counts(ftab, cand, ref.mask, tp, o, o)
    D = (C - RC._GEO) // 3
    v.update(bound(n["face_rows_read"] * C * 4 + cand.numel() * 4
                   + B * o * o * (4 + D + 3) * 4, b1_ops(n, with_prob=False)))
    v["counts"] = {k: x for k, x in n.items() if not k.startswith("_")}
    return v


@contextlib.contextmanager
def normal_launches_counted():
    """Counts the B1 launches that the normal-map pseudo label makes while
    active (fine_raster.launches across self_engine.render_pseudo_normals)."""
    from self6dpp_tpu_torch.engine import self_engine as se
    from self6dpp_tpu_torch.ops import raster_cuda as RC
    inner = se.render_pseudo_normals
    n = {"launches": 0, "calls": 0}

    def counted(*args, **kw):
        before = RC.fine_raster.launches
        out = inner(*args, **kw)
        n["launches"] += RC.fine_raster.launches - before
        n["calls"] += 1
        return out
    se.render_pseudo_normals = counted
    try:
        yield n
    finally:
        se.render_pseudo_normals = inner


def time_masknormvf(cfg, device, batch_size, steps):
    """Phase 11: MaskNormVF pose steps in the configured compute dtype:
    one warm-up step, then `steps` timed (timed_steps), the launch counts
    set to 0 just before and read just after: S3_LAUNCHES per step, one
    B1 launch per step from the normal render; loss_vf and loss_norm
    present, every loss finite."""
    from self6dpp_tpu_torch.engine import self_engine as se
    model, state, batch, lpips = se.build_stage2(cfg, batch_size, device,
                                                 seed=SEED)
    step = se.make_self_train_step(cfg, model, lpips)
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_kernel_launches()
    with normal_launches_counted() as normals, scatter_counted() as scatters:
        times, phases, metrics = timed_steps(step, state, batch, steps)
    launches = kernel_launches()
    require(scatters["n"] == 0, "the step's B2 ran the scatter", scatters)
    for name, k in launches.items():
        require(k == S3_LAUNCHES[name] * steps, "MaskNormVF launches", name,
                k, steps)
    require(normals["launches"] == normals["calls"] == steps,
            "normal render launches", normals)
    for m in metrics:
        require(all(torch.isfinite(v).item() for v in m.values()),
                "non-finite MaskNormVF loss", m)
    require({"loss_vf", "loss_norm"} <= set(metrics[-1]), "vf/norm terms",
            sorted(metrics[-1]))
    out = {**summary(times, phases), "config": cfg.exp_name,
           "batch": batch_size, "compute_dtype": cfg.dist.compute_dtype,
           "launches": launches, "normal_render_launches": normals["launches"],
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "last_losses": {k: float(v) for k, v in metrics[-1].items()}}
    del model, state, step
    torch.cuda.empty_cache()
    return out


def time_geo_synsup(cfg, device, batch_size, steps):
    """Phase 12: the geo-mode step (its warp and jitter drawn each step
    from a seeded torch.Generator, inside the timed step) and the synsup
    step at `cfg`'s widths: one warm-up step each, then `steps` timed, the
    launch counts set to 0 before each and read after: no kernel launch;
    every loss finite."""
    from self6dpp_tpu_torch.engine import self_engine as se
    model, state, batch, _ = se.build_stage2(cfg, batch_size, device,
                                             seed=SEED)
    gen = torch.Generator().manual_seed(SEED)
    geo = se.make_self_geo_train_step(cfg, model)
    steps_of = {
        "geo": lambda st, b, mark=None: geo(st, b, se.draw_geo_aug(cfg, b, gen),
                                            mark),
        "synsup": se.make_synsup_train_step(cfg, model)}
    out = {}
    for name, step in steps_of.items():
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        zero_kernel_launches()
        times, phases, metrics = timed_steps(step, state, batch, steps)
        launches = kernel_launches()
        require(not any(launches.values()), name, "launched a kernel",
                launches)
        for m in metrics:
            require(all(torch.isfinite(v).item() for v in m.values()),
                    "non-finite loss", name, m)
        out[name] = {**summary(times, phases), "launches": launches,
                     "last_losses": {k: float(v)
                                     for k, v in metrics[-1].items()}}
    out.update(config=cfg.exp_name, batch=batch_size,
               compute_dtype=cfg.dist.compute_dtype)
    del model, state
    torch.cuda.empty_cache()
    return out


def normal_render_kernel_line(nr, s3):
    """The `kernels` entry of B1 at the normal render's shape."""
    return {"name": "fine_raster_fwd[normals]", "route": "cuda",
            "source": "self6dpp_tpu_torch/csrc/fine_raster_fwd.cu",
            "replaces": "self6dpp_tpu/ops/raster_pallas.py:420",
            "launches": s3["normal_render_launches"],
            "max_abs_err": max(nr["max_abs_err"].values()), "ms": nr["ms"],
            "graph_ms": nr["graph_ms"], "plain_ms": nr["plain_ms"],
            "bound_ms": nr["bound_ms"], "bound_by": nr["bound_by"],
            "library_ms": None}


# ---- DeepIM training, the refined stage-II step, card vs CPU (13-15) -----

DI_TIMED_STEPS = 10               # bf16 DeepIM train steps after one warm-up
# per DeepIM train step at n_iter_train 4: the estimate's and the ground
# truth's render per iteration (B1), no backward through a render
DI_LAUNCHES = {"fine_raster_fwd": 8, "fine_raster_bwd": 0, "lab_value_grad": 0}
DI_LR = 1e-3                      # phase 13's fp32 steps: full lr, no warm-up
TOL_DI_LOSS = 1e-4                # fp32 DeepIM train losses, kernel vs plain
TOL_DI_PARAMS = 1e-5              # fp32 params after 2 steps, kernel vs plain
DI_MOVED = 20                     # the steps move the params > 20x that
TOL_DI_CPU = 1e-4                 # phase 15: card vs CPU losses (relative)
TOL_DI_CPU_PARAMS = 1e-5          # and params
S4_TIMED_STEPS = 10               # bf16 refined stage-II steps
# per refined stage-II step: the student render (B1, B2), the refiner's 4
# iterations (B1 at 512²), the repj renders: 3 anchors and 3 reprojections
# (B1 at 64², B2 on the reprojections), LAB (B3)
S4_LAUNCHES = {"fine_raster_fwd": 11, "fine_raster_bwd": 4,
               "lab_value_grad": 1}


@contextlib.contextmanager
def launches_by_height():
    """While active, tallies B1 and B2 launches by the image height of the
    call ({kernel: {height: n}}): 512 (DeepIM), 256 (the student render)
    and 64 (repj) tell the shapes of one step apart. Calls are serialised
    by a lock, so that renders from the eval loader's thread and the main
    thread are each tallied at their own height."""
    import threading
    from self6dpp_tpu_torch.ops import raster_cuda as RC
    tally = {"fine_raster_fwd": {}, "fine_raster_bwd": {}}
    fine, bwd = RC._fine, RC.fine_raster_bwd
    lock = threading.Lock()

    def add(kernel, height, n):
        t = tally[kernel]
        t[height] = t.get(height, 0) + n

    def fine_counted(ftab, cand, height, *args):
        with lock:
            before = RC.fine_raster.launches
            out = fine(ftab, cand, height, *args)
            add("fine_raster_fwd", height, RC.fine_raster.launches - before)
        return out

    # the wrapper takes the counter's place (the kernel's wrapper adds to
    # the module attribute it is named by) and hands it back after
    def bwd_counted(*args):
        with lock:
            before = bwd_counted.launches
            out = bwd(*args)
            add("fine_raster_bwd", args[5], bwd_counted.launches - before)
        return out
    bwd_counted.launches = bwd.launches
    RC._fine, RC.fine_raster_bwd = fine_counted, bwd_counted
    try:
        yield tally
    finally:
        bwd.launches = bwd_counted.launches
        RC._fine, RC.fine_raster_bwd = fine, bwd


def deepim_train_batch(request):
    """A DeepIM training batch from a request (make_request: the GT poses
    the observation was rendered at, perturbed initial poses): PM points
    (every 5th vertex, up to 512), extents and no symmetry."""
    verts = request["verts"]
    b = verts.shape[0]
    eye = torch.eye(3, device=verts.device)
    return dict(request, gt_points=verts[:, ::5][:, :512].contiguous(),
                roi_extent=verts.amax(1) - verts.amin(1),
                sym_rots=eye.expand(b, 1, 3, 3).contiguous(),
                sym_valid=torch.ones((b, 1), dtype=torch.bool,
                                     device=verts.device))


def deepim_train_cfg(cfg, dtype_name, lr=None):
    """cfg in the given compute dtype; with `lr`, that base rate from the
    first step (no warm-up)."""
    cfg = dataclasses.replace(cfg, dist=dataclasses.replace(
        cfg.dist, compute_dtype=dtype_name))
    if lr is not None:
        cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
            cfg.solver, base_lr=lr, warmup_method="none"))
    return cfg


def run_deepim_train(cfg, device, batch, n, raster_kw=None):
    """n DeepIM train steps of the seeded model (the JAX initialisers from
    SEED, identity-biased pose heads) on `batch`: (initial params, losses
    per step, final params), all on the CPU."""
    from self6dpp_tpu_torch.engine import deepim_engine as de
    model = de.build_deepim(cfg, device=device,
                            generator=torch.Generator().manual_seed(SEED),
                            train=True)
    model.init_identity_heads_()
    state = de.init_state(cfg, model)
    step = de.make_train_step(cfg, model, device=device, raster_kw=raster_kw)
    cpu = lambda d: {k: v.cpu() for k, v in d.items()}
    init = cpu(params_of(model))
    metrics = []
    for _ in range(n):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return init, metrics, cpu(params_of(model))


def check_deepim_train_fp32(cfg, device, batch):
    """Phase 13: two float32 DeepIM train steps (TF32 off, cuDNN
    deterministic) through kernel B1 and two through the plain fine stage:
    losses within TOL_DI_LOSS, parameters within TOL_DI_PARAMS. The check
    can fail: the steps move the parameters more than DI_MOVED x
    TOL_DI_PARAMS, and the same steps on a black render (the plain fine
    stage with its attributes zeroed) end more than TOL_DI_PARAMS away."""
    from self6dpp_tpu_torch.ops import raster_cuda as RC
    cfg32 = deepim_train_cfg(cfg, "float32", DI_LR)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    plain = RC.fine_raster_plain
    try:
        init, mk, pk = run_deepim_train(cfg32, device, batch, 2)
        _, mp, pp = run_deepim_train(cfg32, device, batch, 2,
                                     {"impl": "plain"})
        RC.fine_raster_plain = _perturbed_plain("attr zeroed")
        _, mc, pc = run_deepim_train(cfg32, device, batch, 2,
                                     {"impl": "plain"})
    finally:
        RC.fine_raster_plain = plain
        torch.backends.cudnn.deterministic = det
    for m in mk:
        require(all(np.isfinite(v) for v in m.values()), "non-finite loss", m)
    out = {"losses_kernel": mk, "losses_plain": mp, "losses_control": mc,
           "loss_rel_err": max(loss_err(a, b) for a, b in zip(mk, mp)),
           "params_kernel_vs_plain_max_abs": max_abs_diff(pk, pp),
           "params_moved_max_abs": max_abs_diff(pk, init),
           "params_vs_control_max_abs": max_abs_diff(pk, pc), "lr": DI_LR}
    require({"loss_flow", "loss_mask", "loss_PM_R", "loss_trans_z"}
            <= set(mk[0]), "DeepIM train terms", sorted(mk[0]))
    require(out["loss_rel_err"] <= TOL_DI_LOSS, "DeepIM fp32 losses", out)
    require(out["params_kernel_vs_plain_max_abs"] <= TOL_DI_PARAMS,
            "DeepIM fp32 params", out)
    require(out["params_moved_max_abs"] > DI_MOVED * TOL_DI_PARAMS,
            "DeepIM steps left the params where they were", out)
    require(out["params_vs_control_max_abs"] > TOL_DI_PARAMS,
            "a black render did not move the DeepIM step", out)
    return out


def b1_row(name, d, launches):
    """A `kernels` entry of B1 at one of its shapes."""
    return {"name": name, "route": "cuda",
            "source": "self6dpp_tpu_torch/csrc/fine_raster_fwd.cu",
            "replaces": "self6dpp_tpu/ops/raster_pallas.py:420",
            "launches": launches, "max_abs_err": d["max_abs_err_all"],
            "ms": d["ms"], "graph_ms": d["graph_ms"],
            "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
            "bound_by": d["bound_by"], "library_ms": None}


def check_deepim_gt_render(cfg, batch):
    """Phase 13: B1 at the DeepIM train step's ground-truth render (the
    first iteration's zoomed frame, the GT pose, hard, 16 px tiles, K =
    128) against its plain version: mask and face_id bit for bit, the rest
    within TOL_KERNEL; candidates depth-sorted; timed, with its bound."""
    from self6dpp_tpu_torch.ops import raster_cuda as RC
    from self6dpp_tpu_torch.ops import rasterizer as R
    d, r = cfg.deepim, cfg.renderer
    h, w = d.input_h, d.input_w
    _, Kz = zoom_frame(cfg, batch)
    args = (batch["verts"], batch["faces"], batch["colors"], Kz,
            batch["gt_rot"], batch["gt_trans"])
    ftab, cand = R.raster_inputs(*args, h, w, r.tile_px, r.faces_per_tile)
    require(RC.cand_depth_sorted(ftab, cand), "GT render: cand order")
    call = (ftab, cand, h, w, r.tile_px, 1.0, False, True)
    got = RC.fine_raster(*call)
    torch.cuda.synchronize()
    ref = RC.fine_raster_plain(*call)
    v = compare_raster(got, ref, "DeepIM GT render B1")
    require(torch.equal(got.mask, ref.mask)
            and torch.equal(got.face_id, ref.face_id),
            "GT render: mask/face_id not bit for bit")
    v["max_abs_err_all"] = max(v["max_abs_err"].values())
    v["ms"] = cuda_ms(lambda: RC.fine_raster(*call))
    v["graph_ms"] = graph_ms(lambda: RC.fine_raster(*call))
    v["plain_ms"] = cuda_ms(lambda: RC.fine_raster_plain(*call),
                            **PLAIN_TIMING)
    B, F, C = ftab.shape
    D = (C - RC._GEO) // 3
    n = raster_counts(ftab, cand, ref.mask, r.tile_px, h, w)
    v.update(bound(n["face_rows_read"] * C * 4 + cand.numel() * 4
                   + B * h * w * (4 + D + 3) * 4, b1_ops(n, with_prob=False)))
    v["counts"] = {k: x for k, x in n.items() if not k.startswith("_")}
    return v


def time_deepim_train(cfg, device, batch, steps=DI_TIMED_STEPS):
    """Phase 13: DeepIM train steps in the configured compute dtype: one
    warm-up step, then `steps` timed (timed_steps: CUDA events at each
    iteration's render, flow label, network forward and loss, then the
    backward and the solver + EMA), the launch counts set to 0 just before
    and read just after: DI_LAUNCHES per step, every B1 at the 512² zoom;
    every loss finite."""
    from self6dpp_tpu_torch.engine import deepim_engine as de
    cfg = deepim_train_cfg(cfg, cfg.dist.compute_dtype)
    model = de.build_deepim(cfg, device=device,
                            generator=torch.Generator().manual_seed(SEED),
                            train=True)
    model.init_identity_heads_()
    state = de.init_state(cfg, model)
    step = de.make_train_step(cfg, model, device=device)
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_kernel_launches()
    with launches_by_height() as tally:
        times, phases, metrics = timed_steps(step, state, batch, steps)
    launches = kernel_launches()
    for name, k in launches.items():
        require(k == DI_LAUNCHES[name] * steps, "DeepIM train launches",
                name, k, steps)
    require(tally["fine_raster_fwd"] == {cfg.deepim.input_h: 8 * steps},
            "DeepIM train B1 shapes", tally)
    for m in metrics:
        require(all(torch.isfinite(v).item() for v in m.values()),
                "non-finite DeepIM loss", m)
    out = {**summary(times, phases), "config": cfg.exp_name,
           "batch": len(batch["init_rot"]),
           "compute_dtype": cfg.dist.compute_dtype,
           "iterations": cfg.deepim.n_iter_train,
           "ms_range": [min(times), max(times)], "launches": launches,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "last_losses": {k: float(v) for k, v in metrics[-1].items()}}
    del model, state, step
    torch.cuda.empty_cache()
    return out


def build_refiner(device, dtype_name):
    """The stage-II step's DeepIM refiner: lm_flownet() in the given
    compute dtype, its weights the JAX initialisers' from SEED + 2 with
    identity-biased pose heads, in eval mode: (model, its Config)."""
    from self6dpp_tpu_torch.config import lm_flownet
    from self6dpp_tpu_torch.engine import deepim_engine as de
    rcfg = deepim_train_cfg(lm_flownet(), dtype_name)
    model = de.build_deepim(rcfg, device=device,
                            generator=torch.Generator().manual_seed(SEED + 2))
    model.init_identity_heads_()
    return model, rcfg


def check_repj_kernels(cfg, built):
    """Phase 14: B1 and B2 at the repj renders' shape on the step's own
    inputs: the student's forward on `built` (build_stage2's), the repj
    weak loss (self_engine.repj_terms) with its six renders recorded, the
    cotangents the loss sends to the three reprojected renders. B1 against
    its plain version on all six (mask and face_id bit for bit; the
    reprojections' saved keep bit for bit against the slot-order product),
    B2 on the reprojections with those cotangents within TOL_B2; the
    reprojections' B1 (with keep) and B2 timed per scale, with bounds."""
    from self6dpp_tpu_torch.engine import self_engine as se
    from self6dpp_tpu_torch.engine.gdrn_engine import autocast, model_inputs
    from self6dpp_tpu_torch.models import repj_refiner as RR
    from self6dpp_tpu_torch.ops import raster_cuda as RC
    from self6dpp_tpu_torch.ops import rasterizer as R
    _, state, batch, _ = built
    net = state.model.eval()
    with autocast(cfg, batch["roi_img"].device):
        out = net(*model_inputs(batch))
    out = {k: v.float() for k, v in out.items()}
    records, inner = [], RR.rasterize_batch

    def recorded(*args, **kw):
        res = inner(*args, **kw)
        records.append((args, kw, res))
        return res
    RR.rasterize_batch = recorded
    try:
        ld = se.repj_terms(cfg, batch, out)
    finally:
        RR.rasterize_batch = inner
    require(len(records) == 6, "repj renders", len(records))
    reps = [r for r in records if r[2].prob.requires_grad]
    require(len(reps) == 3, "repj reprojected renders", len(reps))
    outs = [x for _, _, res in reps for x in (res.prob, res.depth, res.attr)]
    grads = torch.autograd.grad(sum(ld.values()), outs, allow_unused=True)
    grads = [torch.zeros_like(o) if g is None else g.contiguous()
             for o, g in zip(outs, grads)]
    kw0 = records[0][1]
    n, tp, K, sigma = (kw0["height"], kw0["tile_px"], kw0["faces_per_tile"],
                       kw0["sigma_px"])
    f32 = lambda x: torch.as_tensor(x).detach().float()
    per_call, errs = [], {"b1": 0.0, "b2_rel": 0.0}
    for i, (args, _, res) in enumerate(records):
        ftab, cand = R.raster_inputs(*(f32(a) if j != 1 else a
                                       for j, a in enumerate(args)),
                                     n, n, tp, K)
        require(RC.cand_depth_sorted(ftab, cand), "repj: cand order", i)
        call = (ftab, cand, n, n, tp, sigma, True, True)
        got, keep = RC._fine(*call, True)
        torch.cuda.synchronize()
        ref = RC.fine_raster_plain(*call)
        v = compare_raster(got, ref, f"repj B1 {i}")
        require(torch.equal(got.mask, ref.mask)
                and torch.equal(got.face_id, ref.face_id), "repj B1 bits", i)
        errs["b1"] = max(errs["b1"], *v["max_abs_err"].values())
        if not res.prob.requires_grad:
            continue
        keep_ref = RC.keep_slot_order_plain(ftab, cand, n, n, tp, sigma)
        require(torch.equal(keep.view(torch.int32),
                            keep_ref.view(torch.int32)), "repj keep bits", i)
        k = len(per_call)
        cts = grads[3 * k:3 * k + 3]
        bcall = (ftab, cand, *cts, n, n, tp, sigma, True, True)
        saved = (got.face_id, keep)
        with scatter_counted() as scatters:
            g2 = RC.fine_raster_bwd(*bcall, saved)
            torch.cuda.synchronize()
        require(scatters["n"] == 0, "repj B2 ran the scatter")
        r2 = RC.fine_raster_bwd_plain(*bcall)
        scale = r2.abs().max().item()
        require(scale > 0, "repj B2: zero gradient", i)
        errs["b2_rel"] = max(errs["b2_rel"],
                             (g2 - r2).abs().max().item() / scale)
        errs["b2_abs"] = max(errs.get("b2_abs", 0.0),
                             (g2 - r2).abs().max().item())
        B, F, C = ftab.shape
        D = (C - RC._GEO) // 3
        cnt = raster_counts(ftab, cand, ref.mask, tp, n, n, cts)
        b1 = bound(cnt["face_rows_read"] * C * 4 + cand.numel() * 4
                   + B * n * n * (4 + D + 3) * 4, b1_ops(cnt))
        b2 = bound(cnt["face_rows_read"] * C * 4 + cand.numel() * 4
                   + cnt["occupied_tiles"] * tp * tp * (2 + D) * 4
                   + B * F * C * 4, b2_ops(cnt))
        per_call.append({
            "B1": {"ms": cuda_ms(lambda: RC._fine(*call, True)),
                   "graph_ms": graph_ms(lambda: RC._fine(*call, True)),
                   "plain_ms": cuda_ms(lambda: RC.fine_raster_plain(*call),
                                       **PLAIN_TIMING), **b1},
            "B2": {"ms": cuda_ms(lambda: RC.fine_raster_bwd(*bcall, saved)),
                   "graph_ms": graph_ms(lambda: RC.fine_raster_bwd(
                       *bcall, saved)),
                   "plain_ms": cuda_ms(lambda: RC.fine_raster_bwd_plain(
                       *bcall), **PLAIN_TIMING), **b2},
            "counts": {k2: x for k2, x in cnt.items()
                       if not k2.startswith("_")}})
    require(errs["b1"] <= TOL_KERNEL and errs["b2_rel"] <= TOL_B2,
            "repj kernels vs plain", errs)
    mean = lambda kern, key: float(np.mean([c[kern][key] for c in per_call]))
    rows = {kern: {key: mean(kern, key) for key in
                   ("ms", "graph_ms", "plain_ms", "bound_ms")}
            for kern in ("B1", "B2")}
    for kern in ("B1", "B2"):
        rows[kern]["bound_by"] = per_call[-1][kern]["bound_by"]
    rows["B1"]["max_abs_err_all"] = errs["b1"]
    rows["B2"]["max_abs_err_all"] = errs["b2_abs"]
    return {"shape": {"batch": len(out["rot"]), "res": n, "tile_px": tp,
                      "K": K, "sigma_px": sigma},
            "per_scale": per_call, "errors": errs, "mean_per_call": rows,
            "losses": {k: float(v.detach()) for k, v in ld.items()}}


def time_stage2_refined(cfg, device, batch_size, steps=S4_TIMED_STEPS):
    """Phase 14: refined stage-II steps (the DeepIM refiner in the compute
    dtype, the repj weak loss) in the configured compute dtype: one warm-up
    step, then `steps` timed (timed_steps, with the refine and repj spans),
    the launch counts set to 0 just before and read just after:
    S4_LAUNCHES per step, by shape 1 student, 4 refiner and 6 repj B1
    launches and 1 student and 3 repj B2 launches; every loss finite."""
    from self6dpp_tpu_torch.engine import self_engine as se
    model, state, batch, lpips = se.build_stage2(cfg, batch_size, device,
                                                 seed=SEED)
    refiner = build_refiner(device, cfg.dist.compute_dtype)
    step = se.make_self_train_step(cfg, model, lpips, refiner=refiner)
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_kernel_launches()
    with launches_by_height() as tally, scatter_counted() as scatters:
        times, phases, metrics = timed_steps(step, state, batch, steps)
    launches = kernel_launches()
    require(scatters["n"] == 0, "the step's B2 ran the scatter", scatters)
    for name, k in launches.items():
        require(k == S4_LAUNCHES[name] * steps, "refined step launches",
                name, k, steps)
    d = refiner[1].deepim
    want = {"fine_raster_fwd": {}, "fine_raster_bwd": {}}
    for kern, height, per_step in (
            ("fine_raster_fwd", cfg.model.input_res, 1),
            ("fine_raster_fwd", d.input_h, d.n_iter_test),
            ("fine_raster_fwd", cfg.self_sup.repj_render_res, 6),
            ("fine_raster_bwd", cfg.model.input_res, 1),
            ("fine_raster_bwd", cfg.self_sup.repj_render_res, 3)):
        want[kern][height] = want[kern].get(height, 0) + per_step * steps
    require(tally == want, "refined step launches by shape", tally, want)
    for m in metrics:
        require(all(torch.isfinite(v).item() for v in m.values()),
                "non-finite refined-step loss", m)
    require({"loss_repj_miou_1", "loss_PM_R_repj"} <= set(metrics[-1]),
            "repj terms", sorted(metrics[-1]))
    out = {**summary(times, phases), "config": cfg.exp_name,
           "batch": batch_size, "compute_dtype": cfg.dist.compute_dtype,
           "ms_range": [min(times), max(times)], "launches": launches,
           "launches_by_height": tally,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "last_losses": {k: float(v) for k, v in metrics[-1].items()}}
    del model, state, step, refiner
    torch.cuda.empty_cache()
    return out


def check_deepim_card_vs_cpu(cfg, device, request):
    """Phase 15: two float32 DeepIM train steps of `cfg` cut to a 64² zoom,
    2 iterations and 2 ROIs (FlowNetS at full widths) on the card (TF32
    off, cuDNN deterministic) and on the CPU (one thread), from the same
    seeded weights and batch: losses within TOL_DI_CPU, parameters within
    TOL_DI_CPU_PARAMS, and the parameters moved past 10x that."""
    small = dataclasses.replace(cfg, deepim=dataclasses.replace(
        cfg.deepim, input_h=64, input_w=64, n_iter_train=2))
    small = deepim_train_cfg(small, "float32", DI_LR)
    batch = deepim_train_batch({k: v[:2] if k not in ("faces",) else v
                                for k, v in request.items()})
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        init, mg, pg = run_deepim_train(small, device, batch, 2)
    finally:
        torch.backends.cudnn.deterministic = det
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cpu = torch.device("cpu")
        _, mc, pc = run_deepim_train(
            small, cpu, {k: v.to(cpu) for k, v in batch.items()}, 2)
    finally:
        torch.set_num_threads(threads)
    out = {"input_hw": [64, 64], "iterations": 2, "batch": 2,
           "losses_card": mg, "losses_cpu": mc,
           "loss_rel_err": max(loss_err(a, b) for a, b in zip(mg, mc)),
           "params_card_vs_cpu_max_abs": max_abs_diff(pg, pc),
           "params_moved_max_abs": max_abs_diff(pg, init)}
    require(out["loss_rel_err"] <= TOL_DI_CPU, "DeepIM card vs CPU losses",
            out)
    require(out["params_card_vs_cpu_max_abs"] <= TOL_DI_CPU_PARAMS,
            "DeepIM card vs CPU params", out)
    require(out["params_moved_max_abs"] > 10 * TOL_DI_CPU_PARAMS,
            "DeepIM card vs CPU: the params did not move", out)
    return out


# ---------------------------------------------------------------- eval slice
SYN_IMAGES = 48                   # phase 16: > 2 GDRN batches of 24 ROIs
SYN_DIR = os.path.join(HERE, "_smoke_data")   # git-ignored, made anew
LABEL_RES = 128                   # the label cache: 2 x lm_base's 64² output
SYN_HW = (120, 160)               # the 'synthetic' meta's frame
VSD_PER_OBJECT = 8                # phase 18b: noisy predictions per object
# the eval CLIs' runs (phases 17, 18a): (name, impl, extra opts, cuDNN
# deterministic). Through the kernels and through the plain fine stage with
# deterministic cuDNN, for the equal tables; then timed as a user runs the
# CLI (cuDNN's default algorithms), with the loader's threads and without
# them (the step alone on the host: the control for their contention)
RUNS = (("kernel", "kernel", (), True), ("plain", "plain", (), True),
        ("timed", "kernel", (), False),
        ("serial", "kernel", ("data.num_workers=0",), False))
PNG_FRAME_HW = (480, 640)         # phase 16: decode times at LM's frame
PNG_READS = 10


@contextlib.contextmanager
def first_inputs_at(heights):
    """While active, records the first face table and candidate list that
    rasterizer.raster_inputs makes at each image height in `heights`, with
    the call's shape: {height: (ftab, cand, height, width, tile_px)}."""
    from self6dpp_tpu_torch.ops import rasterizer as R
    inner = R.raster_inputs
    seen = {}

    def recorded(verts, faces, attrs, K, R_, t, height, width,
                 tile_px=16, faces_per_tile=128, cull_backfaces=True):
        ftab, cand = inner(verts, faces, attrs, K, R_, t, height, width,
                           tile_px, faces_per_tile, cull_backfaces)
        if height in heights and height not in seen:
            seen[height] = (ftab.clone(), cand.clone(), height, width, tile_px)
        return ftab, cand
    R.raster_inputs = recorded
    try:
        yield seen
    finally:
        R.raster_inputs = inner


def b1_at(inputs, key):
    """B1 on recorded main-path inputs (first_inputs_at; hard, perspective
    z) against its plain version: mask and face_id bit for bit, the rest
    within TOL_KERNEL; candidates depth-sorted; timed (graph, eager,
    plain) with its bound (bytes or f32 operations, as check_kernel)."""
    from self6dpp_tpu_torch.ops import raster_cuda as RC
    ftab, cand, h, w, tile = inputs
    require(RC.cand_depth_sorted(ftab, cand), key, "cand order")
    call = (ftab, cand, h, w, tile, 1.0, False, True)
    got = RC.fine_raster(*call)
    torch.cuda.synchronize()
    ref = RC.fine_raster_plain(*call)
    v = compare_raster(got, ref, key)
    require(torch.equal(got.mask, ref.mask)
            and torch.equal(got.face_id, ref.face_id),
            key, "mask/face_id not bit for bit")
    v["max_abs_err_all"] = max(v["max_abs_err"].values())
    v["ms"] = cuda_ms(lambda: RC.fine_raster(*call))
    v["graph_ms"] = graph_ms(lambda: RC.fine_raster(*call))
    v["plain_ms"] = cuda_ms(lambda: RC.fine_raster_plain(*call),
                            **PLAIN_TIMING)
    B, F, C = ftab.shape
    D = (C - RC._GEO) // 3
    n = raster_counts(ftab, cand, ref.mask, tile, h, w)
    v.update(bound(n["face_rows_read"] * C * 4 + cand.numel() * 4
                   + B * h * w * (4 + D + 3) * 4, b1_ops(n, with_prob=False)))
    v["shape"] = {"batch": B, "height": h, "width": w, "tile_px": tile,
                  "faces_per_tile": int(cand.shape[1]), "faces": F,
                  "attr_dim": D}
    v["counts"] = {k: x for k, x in n.items() if not k.startswith("_")}
    return v


def _read_tree(root):
    """{relative path: decoded PNG array or parsed JSON} under root."""
    from self6dpp_tpu_torch.data.image_io import imread
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, root)
            if name.endswith(".png"):
                out[rel] = imread(path)
            elif name.endswith(".json"):
                with open(path) as f:
                    out[rel] = json.load(f)
            elif name.endswith(".ply"):
                with open(path, "rb") as f:
                    out[rel] = f.read()
    return out


def png_row_filters(path):
    """{filter type: rows} of a non-interlaced 8-bit gray/RGB or 16-bit
    gray PNG."""
    import struct
    import zlib
    with open(path, "rb") as f:
        data = f.read()
    pos, idat = 8, b""
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", data[pos + 8:pos + 18])
        elif kind == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    stride = w * (3 if ctype == 2 else 1) * depth // 8
    types = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, stride + 1)[:, 0]
    return {int(k): int(v) for k, v in zip(*np.unique(types,
                                                      return_counts=True))}


def time_png_decode():
    """Phase 16: read_png of one LM-sized frame (PNG_FRAME_HW) on the host:
    a smooth RGB image with camera noise written with Paeth on every row
    and with the adaptive choice, a binary mask and a 16-bit depth map
    (adaptive), each read back bit for bit; median ms of PNG_READS reads,
    the first (which builds the unfilter routine) left out. Returns the
    record, with the decode of one ROI of the loader (image, two masks,
    depth)."""
    from self6dpp_tpu_torch.data.image_io import read_png, write_png
    rng = np.random.default_rng(SEED + 16)
    h, w = PNG_FRAME_HW
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    rgb = np.stack([xx * 0.3 + yy * 0.1, (xx - yy) * 0.2 + 128, yy * 0.4], -1)
    rgb = np.clip(rgb + rng.normal(0, 4, rgb.shape), 0, 255).astype(np.uint8)
    mask = (((xx - w / 2) ** 2 + (yy - h / 2) ** 2) < (h / 3) ** 2
            ).astype(np.uint8) * 255
    depth = (600 + xx + 2 * yy + rng.integers(0, 3, (h, w))).astype(np.uint16)
    d = os.path.join(SYN_DIR, "png")
    os.makedirs(d, exist_ok=True)
    out = {"frame_hw": [h, w], "reads": PNG_READS}
    for name, img, ftype in (("rgb_paeth", rgb, 4), ("rgb", rgb, None),
                             ("mask", mask, None), ("depth16", depth, None)):
        path = os.path.join(d, f"{name}.png")
        write_png(path, img, filter_type=ftype)
        require(np.array_equal(read_png(path), img), "PNG round trip", name)
        ts = []
        for _ in range(PNG_READS + 1):
            t0 = time.perf_counter()
            read_png(path)
            ts.append(time.perf_counter() - t0)
        out[name] = {"ms": float(np.median(ts[1:]) * 1e3),
                     "bytes": os.path.getsize(path),
                     "row_filters": png_row_filters(path)}
    out["roi_decode_ms"] = (out["rgb"]["ms"] + 2 * out["mask"]["ms"]
                            + out["depth16"]["ms"])
    return out


def make_synthetic_sets(device):
    """Phase 16: the port's generate_full writes the synthetic BOP set
    (SYN_IMAGES images, 2 objects, 160x120) with B1 and again with the
    plain fine stage: JSON, PLY and mask PNGs equal, RGB and depth PNGs
    within 1 unit; one B1 launch per object and image (tile 8, K 64).
    Returns (the kernel set's root, the phase's record)."""
    import shutil
    from self6dpp_tpu_torch.data.synthetic_bop import generate_full
    shutil.rmtree(SYN_DIR, ignore_errors=True)
    roots, secs = {}, {}
    for impl in ("kernel", "plain"):
        roots[impl] = os.path.join(SYN_DIR, impl)
        zero_kernel_launches()
        t0 = time.perf_counter()
        with launches_by_height() as tally:
            generate_full(roots[impl], n_images=SYN_IMAGES, seed=SEED,
                          device=device, impl=impl)
        secs[impl] = time.perf_counter() - t0
        if impl == "kernel":
            launches = kernel_launches()
            by_h = tally["fine_raster_fwd"]
    require(launches["fine_raster_fwd"] == 2 * SYN_IMAGES
            and by_h == {SYN_HW[0]: 2 * SYN_IMAGES},
            "synthetic set: one B1 per object and image", launches, by_h)
    a, b = _read_tree(roots["kernel"]), _read_tree(roots["plain"])
    require(a.keys() == b.keys() and len(a) > 6 * SYN_IMAGES,
            "synthetic set: files", len(a), len(b))
    worst = {"rgb": 0, "depth": 0}
    differ = {"rgb": 0, "depth": 0}
    for rel, x in a.items():
        y = b[rel]
        kind = rel.split(os.sep)[-2] if rel.endswith(".png") else "other"
        if kind in worst:
            require(x.shape == y.shape and x.dtype == y.dtype, rel)
            d = int(np.abs(x.astype(np.int64) - y).max())
            worst[kind] = max(worst[kind], d)
            differ[kind] += int((x != y).sum())
            require(d <= 1, "synthetic set: more than 1 unit", rel, d)
        else:
            same = np.array_equal(x, y) if isinstance(x, np.ndarray) \
                else x == y
            require(same, "synthetic set: not equal", rel)
    filters = {}
    for kind in ("rgb", "depth", "mask_visib"):
        path = os.path.join(roots["kernel"], "lm", "test", "000000", kind,
                            "000000.png" if kind != "mask_visib"
                            else "000000_000000.png")
        filters[kind] = png_row_filters(path)
    return roots["kernel"], {
        "images": SYN_IMAGES, "objects": 2, "frame_hw": list(SYN_HW),
        "row_filters_of_first_image": filters,
        "files": len(a), "b1_launches": launches["fine_raster_fwd"],
        "seconds": secs, "max_unit_diff": worst, "values_differing": differ}


def run_cli(main, argv, device, impl="kernel", deterministic=None,
            heights=()):
    """One in-process run of a CLI (the port's tools.*.main), cuDNN
    deterministic or not (None: as the CLI leaves it), the launch counts
    set to 0 just before and read just after, B1 and B2 launches tallied
    by height, and the first render inputs at `heights` recorded. Returns
    (result, launches, {kernel: {height: n}}, inputs, wall seconds)."""
    det = torch.backends.cudnn.deterministic
    if deterministic is not None:
        torch.backends.cudnn.deterministic = deterministic
    zero_kernel_launches()
    t0 = time.perf_counter()
    try:
        with launches_by_height() as tally, first_inputs_at(heights) as seen:
            res = main(argv, device=device, impl=impl)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = det
    return (res, kernel_launches(), {k: dict(v) for k, v in tally.items()},
            seen, time.perf_counter() - t0)


def rows_equal(a, b):
    """The CSV rows of two runs without their clock field ('time')."""
    key = lambda r: {k: (np.asarray(v).tolist() if isinstance(
        v, np.ndarray) else v) for k, v in r.items()
        if k not in ("time", "depth_obs")}
    return [key(r) for r in a] == [key(r) for r in b]


def per_batch(timings, valid_rois):
    """The CLI's per-batch timings: medians of host load, label render,
    wait and step seconds in ms; ROIs (images) per second of the step
    alone and of the inference loop (waits and steps, the warm-up call
    left out)."""
    med = lambda k: float(np.median([t[k] for t in timings]) * 1e3)
    step_s = sum(t["step_s"] for t in timings)
    loop_s = step_s + sum(t["wait_s"] for t in timings)
    return {"batches": len(timings), "host_load_ms": med("host_s"),
            "loop_images_per_s": valid_rois / loop_s,
            "label_render_ms": med("label_render_s"),
            "wait_ms": med("wait_s"), "eval_step_ms": med("step_s"),
            "eval_step_ms_range": [min(t["step_s"] for t in timings) * 1e3,
                                   max(t["step_s"] for t in timings) * 1e3],
            "images_per_s": valid_rois / step_s}


def pose_gap(a, b):
    """The largest difference of R or t between two runs' result rows."""
    return max(float(np.abs(np.asarray(x[k]) - np.asarray(y[k])).max())
               for x, y in zip(a, b) for k in ("R", "t"))


def check_timed_runs(runs, name, n):
    """The timed runs (cuDNN's default algorithms) score every ROI with
    finite tables; their largest pose difference from the deterministic
    kernel run, for the record."""
    gaps = {}
    for run in ("timed", "serial"):
        res = runs[run][0]
        t = res["tables"]
        require(len(res["results"]) == n and all(
            np.isfinite(list(v.values())).all() for v in t.values()),
            name, run, "run: every ROI scored, finite tables")
        gaps[run] = pose_gap(runs["kernel"][0]["results"], res["results"])
    return gaps


def run_test_gdrn(root, device):
    """Phase 17: test_gdrn at lm_base width (resnest50d, 256² -> 64², the
    TopDown head, ConvPnPNet, 24 ROIs a batch, bf16) on the synthetic set,
    2 classes, seeded weights (RUNS): through the kernels and through the
    plain fine stage, deterministic, the recall tables (bop19 columns too)
    and the CSV rows equal; timed through the kernels as the CLI runs, with
    and without loader threads. B1 runs at the label cache (24 x 128², tile
    8, K 64) and at the VSD renders of the synthetic frame (120x160, tile
    16, K 128)."""
    from self6dpp_tpu_torch.tools import train_gdrn
    out = os.path.join(SYN_DIR, "out")
    runs = {}
    for run, impl, extra, det in RUNS:
        argv = ["--config", "configs/gdrn/lm_base.py", "--eval-only",
                "--opts", f"data.dataset_root={root}",
                "data.test_datasets=synthetic", "model.num_classes=2",
                f"output_dir={os.path.join(out, run)}", *extra]
        runs[run] = run_cli(train_gdrn.main, argv, device, impl, det,
                            heights=(LABEL_RES,))
    res, launches, tally, seen, _ = runs["kernel"]
    by_h = tally["fine_raster_fwd"]
    plain, timed = runs["plain"], runs["timed"]
    require(res["tables"] == plain[0]["tables"],
            "test_gdrn tables: kernel vs plain")
    require(rows_equal(res["results"], plain[0]["results"]),
            "test_gdrn CSV rows: kernel vs plain")
    with open(res["csv"]) as f:
        n_rows = len(f.readlines()) - 1
    t = res["tables"]
    n = int(sum(v["n"] for k, v in t.items() if k != "avg"))
    require(n == 2 * SYN_IMAGES and n_rows == n and "bop19_ar" in t["avg"],
            "test_gdrn: every ROI scored", n, n_rows)
    require(all(np.isfinite(list(v.values())).all() for v in t.values()),
            "test_gdrn: non-finite table", t)
    gaps = check_timed_runs(runs, "test_gdrn", n)
    n_batches = -(-n // 24)
    require(by_h.get(LABEL_RES) == n_batches and launches[
        "fine_raster_bwd"] == 0, "test_gdrn B1 launches", by_h, launches)
    return seen[LABEL_RES], {
        "config": "gdrn_lm_base", "rois": n, "batch": 24,
        "compute_dtype": "bfloat16", "timed_cudnn_deterministic": False,
        "wall_s": timed[4], "wall_s_plain": plain[4],
        "evaluate_s": timed[0]["evaluate_s"],
        "evaluate_s_plain": plain[0]["evaluate_s"],
        "b1_launches_by_height": by_h, "avg": t["avg"],
        "avg_timed": timed[0]["tables"]["avg"],
        "timed_vs_deterministic_pose_max_abs": gaps,
        **per_batch(timed[0]["timings"], n),
        "serial": {"wall_s": runs["serial"][4],
                   **per_batch(runs["serial"][0]["timings"], n)}}


def run_test_deepim(root, device):
    """Phase 18a: test_deepim at lm_flownet (FlowNetS, 512² zoom, 4 test
    iterations, 8 ROIs a batch, bf16), 2 classes, on the synthetic set
    (RUNS): through the kernels and the plain fine stage, deterministic,
    tables and result rows equal; timed through the kernels as the CLI
    runs, with and without loader threads. B1 4 times a batch at 512² (and
    once at the label cache)."""
    from self6dpp_tpu_torch.tools import train_deepim
    runs = {}
    for run, impl, extra, det in RUNS:
        argv = ["--config", "configs/deepim/lm_flownet.py", "--eval-only",
                "--opts", f"data.dataset_root={root}",
                "data.test_datasets=synthetic", "model.num_classes=2",
                "deepim.num_classes=2",
                f"output_dir={os.path.join(SYN_DIR, 'out', run)}", *extra]
        runs[run] = run_cli(train_deepim.main, argv, device, impl, det)
    res, launches, tally, _, _ = runs["kernel"]
    by_h = tally["fine_raster_fwd"]
    plain, timed = runs["plain"], runs["timed"]
    gap = pose_gap(res["results"], plain[0]["results"])
    same_tables = res["tables"] == plain[0]["tables"]
    same_rows = rows_equal(res["results"], plain[0]["results"])
    require(same_tables and same_rows, "test_deepim: kernel vs plain",
            same_tables, same_rows, gap)
    n = len(res["results"])
    gaps = check_timed_runs(runs, "test_deepim", n)
    n_batches = -(-n // 8)
    require(n == 2 * SYN_IMAGES and by_h == {
        512: 4 * (n_batches + 1), LABEL_RES: n_batches},
        "test_deepim B1 launches", n, by_h)
    return {"config": "deepim_lm_flownet512", "rois": n, "batch": 8,
            "iterations": 4, "compute_dtype": "bfloat16",
            "timed_cudnn_deterministic": False, "wall_s": timed[4],
            "wall_s_plain": plain[4], "evaluate_s": timed[0]["evaluate_s"],
            "b1_launches_by_height": by_h,
            "kernel_vs_plain_pose_max_abs": gap,
            "timed_vs_deterministic_pose_max_abs": gaps,
            "avg": res["tables"]["avg"],
            "avg_timed": timed[0]["tables"]["avg"],
            "ms_per_batch": float(np.median([t["step_s"] for t in
                                             timed[0]["timings"]]) * 1e3),
            **per_batch(timed[0]["timings"], n),
            "serial": {"wall_s": runs["serial"][4],
                       **per_batch(runs["serial"][0]["timings"], n)}}


def lm_predictions(meshes, device):
    """Phase 18b's inputs: VSD_PER_OBJECT noisy predictions for each of
    LM's 13 objects as evaluator batches (GT poses inside the 480x640
    frame, estimates 5 deg / 1 cm off, every fourth exact) with a
    synthetic observed depth: a plane at 0.9 m over the left half of the
    frame (an occluder for the farther poses), no depth on the right."""
    from scipy.spatial.transform import Rotation
    rng = np.random.default_rng(SEED + 18)
    obs = np.zeros(FRAME_HW, np.float32)
    obs[:, : FRAME_HW[1] // 2] = 0.9
    batches, outs = [], []
    b = VSD_PER_OBJECT
    for c in range(N_CLASSES):
        z = rng.uniform(0.6, 1.2, b)
        uv = rng.uniform([120, 100], [520, 380], (b, 2))
        t = np.stack([(uv[:, 0] - LM_K[0, 2]) / LM_K[0, 0] * z,
                      (uv[:, 1] - LM_K[1, 2]) / LM_K[1, 1] * z, z], 1)
        R = Rotation.random(b, random_state=SEED + c).as_matrix()
        dR = Rotation.from_euler("xyz", rng.normal(0, 5, (b, 3)),
                                 degrees=True).as_matrix()
        est_R, est_t = dR @ R, t + rng.normal(0, 0.01, (b, 3))
        est_R[::4], est_t[::4] = R[::4], t[::4]
        f32 = lambda x: np.asarray(x, np.float32)
        batches.append({"roi_cls": np.full(b, c, np.int32),
                        "gt_rot": f32(R), "gt_trans": f32(t),
                        "roi_cam": f32(np.broadcast_to(LM_K, (b, 3, 3))),
                        "obj_id": np.full(b, c + 1, np.int32),
                        "full_depth": np.broadcast_to(obs, (b,) + FRAME_HW)})
        outs.append({"rot": torch.as_tensor(f32(est_R), device=device),
                     "trans": torch.as_tensor(f32(est_t), device=device)})
    return batches, outs


def run_lm_evaluator(meshes, device):
    """Phase 18b: PoseEvaluator(bop19=True) with LM's meta (13 objects,
    480x640) and ObjectModels.from_meshes of the 5120-face icospheres,
    through the kernels and through the plain fine stage: tables equal;
    B1 twice per object (estimate, ground truth) at 8 x 480x640, tile 16,
    K 128, hard. Returns (B1's first inputs there, the record)."""
    from self6dpp_tpu_torch.data.loader import ObjectModels
    from self6dpp_tpu_torch.data.ref import get_meta
    from self6dpp_tpu_torch.engine.evaluator import PoseEvaluator
    meta = get_meta("lm")
    verts, faces, colors = meshes
    models = ObjectModels.from_meshes(
        meta.objects, [{"verts": verts[c], "faces": faces, "colors": colors[c]}
                       for c in range(N_CLASSES)],
        sym_names=meta.sym_objects)
    batches, outs = lm_predictions(meshes, device)
    res = {}
    for impl in ("kernel", "plain"):
        ev = PoseEvaluator(models, meta, device=device, impl=impl)
        for b, o in zip(batches, outs):
            ev.process(b, o)
        zero_kernel_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with launches_by_height() as tally, \
                first_inputs_at((FRAME_HW[0],)) as seen:
            tables = ev.evaluate(bop19=True)
        torch.cuda.synchronize()
        res[impl] = (tables, time.perf_counter() - t0, kernel_launches(),
                     dict(tally["fine_raster_fwd"]), seen)
    tables, secs, launches, by_h, seen = res["kernel"]
    require(tables == res["plain"][0], "LM evaluator: kernel vs plain")
    require(by_h == {FRAME_HW[0]: 2 * N_CLASSES}
            and launches["fine_raster_fwd"] == 2 * N_CLASSES,
            "LM evaluator B1 launches", by_h)
    avg = tables["avg"]
    require(0 < avg["bop19_ar"] < 100 and avg["n"] == VSD_PER_OBJECT,
            "LM evaluator: bop19 scores", avg)
    return seen[FRAME_HW[0]], {
        "meta": "lm", "objects": N_CLASSES, "frame_hw": list(FRAME_HW),
        "predictions": N_CLASSES * VSD_PER_OBJECT,
        "faces": int(faces.shape[0]), "evaluate_s": secs,
        "evaluate_s_plain": res["plain"][1], "b1_launches_by_height": by_h,
        "avg": avg}


# ---------------------------------------------------------- training slice
TRAIN_ITERS = 4                   # phase 19: iterations of the first run
RESUME_ITERS = 6                  # and the total of the resumed run
DI_TRAIN_ITERS = 3                # phase 20
S2_CLI_ITERS = 3                  # phase 21: fp32 runs, kernel vs plain
S2_CLI_TIMED = 6                  # phase 21: the bf16 run as users run it
SMOKE_ITERS = 4                   # phase 21: synthetic_smoke (geo, synsup
                                  # twice, pose with the seed's draws)
TRAIN_DIR = os.path.join(SYN_DIR, "train")
# phase 21: B3's gradient is held away from pixels whose a or b differ by
# less than this (Lab units; ~1e-3 of a just-noticeable difference): lm_ss
# augments colour, and a grey pixel's a and b are rounding-level numbers,
# so there the L1's sign is a rounding error's (an H100 run read 5598
# such gradient entries, 1866 pixels of 524288, black render against grey
# ROI pixels, the plain float32 chain as far from float64 there as B3)
LAB_TIE_BAND = 1e-3


def read_metrics(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def loss_rows(rows):
    """metrics.json rows as {loss term: value}, the clock left out."""
    return [{k: v for k, v in r.items() if k.startswith(("loss", "total"))}
            for r in rows]


def check_finite_losses(rows, name, n):
    require([r["iteration"] for r in rows] == list(range(1, n + 1)), name,
            "iterations", [r["iteration"] for r in rows])
    for r in loss_rows(rows):
        require(r and all(np.isfinite(v) for v in r.values()), name,
                "non-finite loss", r)


def loop_split(res, batch, rows):
    """ms per iteration of the training loop (metrics.json's time_per_iter:
    log_period 1 copies each step's metrics to the host, so it holds the
    step's device time) and its split: the wait for the loader's batch on
    the device and the rest (the step); the first iteration (warm-up) left
    out; the loader's host and label-render ms per batch; images/s."""
    it = [r["time_per_iter"] for r in rows[1:]]
    waits = [t["wait_s"] for t in res["timings"][1:]]
    lt = res.get("loader_timings") or res["timings"]
    per_iter = float(np.median(it) * 1e3)
    wait = float(np.median(waits) * 1e3)
    return {"iterations_timed": len(it), "ms_per_iter": per_iter,
            "ms_per_iter_range": [min(it) * 1e3, max(it) * 1e3],
            "loader_wait_ms": wait, "step_ms": per_iter - wait,
            "loader_wait_share": wait / per_iter,
            "images_per_s": batch / (per_iter / 1e3),
            "loader_host_ms": float(np.median(
                [t["host_s"] for t in lt[1:]]) * 1e3),
            "loader_label_render_ms": float(np.median(
                [t["label_render_s"] for t in lt[1:]]) * 1e3)}


def syn_opts(root, out, *extra):
    return ["--opts", f"data.dataset_root={root}",
            "data.train_datasets=synthetic", "data.test_datasets=synthetic",
            "model.num_classes=2", f"output_dir={out}", "log_period=1",
            *extra]


def run_train_gdrn(root, device):
    """Phase 19: train_gdrn at lm_base width (resnest50d, 256² -> 64², 24
    ROIs a batch, bf16, Ranger) on the synthetic set's train split, 2
    classes, colour augmentation on every image (the blur runs where
    drawn), TRAIN_ITERS iterations with a checkpoint every TRAIN_ITERS;
    then again with --resume to RESUME_ITERS (its last step saved by the
    forced final save): metrics.json holds every iteration once, the
    resumed run takes the remaining ones, both steps are kept. B1
    renders the train labels' cache (24 x 128², tile 8, K 64). Returns
    (the checkpoint directory, B1's first label-cache inputs, the
    record)."""
    from self6dpp_tpu_torch.tools import train_gdrn
    out = os.path.join(TRAIN_DIR, "gdrn")
    argv = ["--config", "configs/gdrn/lm_base.py"] + syn_opts(
        root, out, f"ckpt_period={TRAIN_ITERS}", "data.color_aug_prob=1")
    res, launches, by_h, seen, wall = run_cli(
        train_gdrn.main, argv + [f"solver.total_iters={TRAIN_ITERS}"],
        device, heights=(LABEL_RES,))
    rows = read_metrics(res["metrics"])
    check_finite_losses(rows, "train_gdrn", TRAIN_ITERS)
    ckpt = os.path.join(os.path.dirname(res["metrics"]), "ckpt")
    from self6dpp_tpu_torch.engine.checkpoint import step_dirs
    require(step_dirs(ckpt) == ([TRAIN_ITERS], []), "train_gdrn steps",
            step_dirs(ckpt))
    require(by_h["fine_raster_fwd"].get(LABEL_RES, 0) > 0
            and launches["fine_raster_bwd"] == 0, "train_gdrn B1 launches",
            by_h)
    res2, _, _, _, wall2 = run_cli(
        train_gdrn.main, argv[:2] + ["--resume"] + argv[2:]
        + [f"solver.total_iters={RESUME_ITERS}"], device)
    rows2 = read_metrics(res2["metrics"])
    check_finite_losses(rows2, "train_gdrn resumed", RESUME_ITERS)
    require(rows2[:TRAIN_ITERS] == rows and res2["state"].step == RESUME_ITERS
            and len(res2["timings"]) == RESUME_ITERS - TRAIN_ITERS,
            "train_gdrn resume redid iterations", len(res2["timings"]))
    require(step_dirs(ckpt) == ([TRAIN_ITERS, RESUME_ITERS], []),
            "train_gdrn steps after resume", step_dirs(ckpt))
    return ckpt, seen[LABEL_RES], {
        "config": "gdrn_lm_base", "batch": 24, "compute_dtype": "bfloat16",
        "iterations": TRAIN_ITERS, "resumed_to": RESUME_ITERS,
        "wall_s": wall, "wall_s_resumed": wall2,
        "b1_launches_by_height": by_h["fine_raster_fwd"],
        "last_losses": loss_rows(rows2)[-1],
        **loop_split(res, 24, rows)}


def run_train_deepim(root, device):
    """Phase 20: train_deepim at lm_flownet (FlowNetS, 512² zoom, 4 train
    iterations, 8 ROIs a batch, bf16) on the train split, 2 classes,
    DI_TRAIN_ITERS iterations: finite losses; B1 8 times a step at 512²
    (DI_LAUNCHES) and at the label cache, no B2."""
    from self6dpp_tpu_torch.tools import train_deepim
    argv = ["--config", "configs/deepim/lm_flownet.py"] + syn_opts(
        root, os.path.join(TRAIN_DIR, "deepim"), "deepim.num_classes=2",
        f"solver.total_iters={DI_TRAIN_ITERS}", "ckpt_period=0")
    res, launches, by_h, _, wall = run_cli(train_deepim.main, argv, device)
    rows = read_metrics(res["metrics"])
    check_finite_losses(rows, "train_deepim", DI_TRAIN_ITERS)
    fwd = by_h["fine_raster_fwd"]
    require(fwd.get(512) == DI_LAUNCHES["fine_raster_fwd"] * DI_TRAIN_ITERS
            and fwd.get(LABEL_RES, 0) > 0
            and launches["fine_raster_bwd"] == 0, "train_deepim B1 launches",
            by_h)
    return {"config": "deepim_lm_flownet512", "batch": 8, "iterations": 4,
            "compute_dtype": "bfloat16", "wall_s": wall,
            "b1_launches_by_height": fwd, "last_losses": loss_rows(rows)[-1],
            **loop_split(res, 8, rows)}


def write_pseudo_dets(root):
    """Phase 21's --det-file for the train split: each instance's box, and
    as pose_est and pose_refine its GT pose perturbed (5 and 2 deg, (5, 5,
    10) and (2, 2, 4) mm std) from a fixed seed."""
    from scipy.spatial.transform import Rotation
    from self6dpp_tpu_torch.data.bop import load_bop_split, save_detections
    from self6dpp_tpu_torch.data.ref import get_meta
    rng = np.random.default_rng(SEED + 21)
    dets = {}
    split = os.path.join(root, get_meta("synthetic").name, "train")
    for rec in load_bop_split(split):
        out = []
        for inst in rec.instances:
            poses = []
            for deg, mm in ((5, (5, 5, 10)), (2, (2, 2, 4))):
                dR = Rotation.from_euler("xyz", rng.normal(0, deg, 3),
                                         degrees=True).as_matrix()
                t = inst.t + rng.normal(0, np.asarray(mm) * 1e-3)
                poses.append(np.concatenate([dR @ inst.R, t[:, None]], 1))
            x1, y1, x2, y2 = inst.bbox_visib
            out.append({"obj_id": inst.obj_id, "score": 1.0,
                        "bbox_est": [x1, y1, x2 - x1, y2 - y1],
                        "pose_est": poses[0].reshape(-1),
                        "pose_refine": poses[1].reshape(-1)})
        dets[rec.scene_im_id] = out
    path = os.path.join(TRAIN_DIR, "pseudo_dets.json")
    save_detections(path, dets)
    return path


def aim_checkpoint(ckpt, root, cfg):
    """Phase 21's warm start: TRAIN_ITERS stage-I iterations from random
    weights (at the warm-up's learning rate) predict no usable pose, so the
    student render would be empty. The latest step's student and teacher
    are aimed as phase 5 aims its model (self_engine.aim_heads_: identity
    rotation, the train split's median relative depth, a mask logit of 10)
    and written back."""
    from self6dpp_tpu_torch.data.bop import load_bop_split
    from self6dpp_tpu_torch.data.ref import get_meta
    from self6dpp_tpu_torch.engine import self_engine as se
    from self6dpp_tpu_torch.engine.checkpoint import (load_params_npz,
                                                      save_params_npz,
                                                      step_dirs)
    from self6dpp_tpu_torch.engine.gdrn_engine import build_gdrn
    recs = load_bop_split(os.path.join(root, get_meta("synthetic").name,
                                       "train"))
    insts = [i for r in recs for i in r.instances]
    side = np.asarray([max(i.bbox_visib[2] - i.bbox_visib[0],
                           i.bbox_visib[3] - i.bbox_visib[1])
                       for i in insts]) * cfg.data.dzi.pad_scale
    batch = {"gt_trans": torch.as_tensor(np.stack([i.t for i in insts])),
             "resize_ratio": torch.as_tensor(cfg.model.output_res / side)}
    step = os.path.join(ckpt, str(step_dirs(ckpt)[0][-1]))
    for name in ("model.npz", "ema.npz"):
        model = load_params_npz(os.path.join(step, name),
                                build_gdrn(cfg, "cpu"))
        se.aim_heads_(model, batch)
        save_params_npz(os.path.join(step, name), model)


@contextlib.contextmanager
def pose_step_recorded():
    """While active, the stage-II CLI's pose step records its config and
    LPIPS, and the state and device batch of its last call."""
    from self6dpp_tpu_torch.engine import self_engine as se
    inner = se.make_self_train_step
    rec = {}

    def make(cfg, model, lpips=None, *a, **kw):
        step = inner(cfg, model, lpips, *a, **kw)
        rec.update(cfg=cfg, lpips=lpips)

        def run(state, batch, *a2, **kw2):
            rec.update(state=state, batch=batch)
            return step(state, batch, *a2, **kw2)
        return run
    se.make_self_train_step = make
    try:
        yield rec
    finally:
        se.make_self_train_step = inner


def run_train_self6dpp(root, ckpt, device):
    """Phase 21: train_self6dpp at lm_ss (resnest50d, 256² ROI, batch 8,
    Ranger, LAB 0.2, MS-SSIM, LPIPS from its seeded init, student render
    at 16 px tiles with K 128), 2 classes, warm-started with --weights from
    phase 19's checkpoint, the pseudo poses from write_pseudo_dets:
      a. S2_CLI_ITERS iterations in float32 through the kernels and through
         the plain versions (TF32 off, cuDNN deterministic, lr 1e-3 with no
         warm-up): every logged loss within TOL_S2_LOSS, the student's and
         the teacher's parameters within TOL_S2_PARAMS, the student moved;
         B1 (soft), B2 and B3 held against their plain versions on the
         kernel run's last step (phase 5's check_stage2_kernels);
      b. S2_CLI_TIMED iterations in bf16 as users run it, the launch counts
         of B1, B2 and B3 (each > 0, one of each per step), ms per
         iteration and the loader's share;
      c. SMOKE_ITERS iterations of configs/self6dpp/synthetic_smoke.py (its
         micro GDRN from the seed): the geo, synsup and pose modes, the
         DeepIM refiner in the loop and the repj loss on the same CLI.
    The checkpoint is aimed first (aim_checkpoint)."""
    from self6dpp_tpu_torch.config import apply_overrides, load_config
    from self6dpp_tpu_torch.engine.checkpoint import load_params_npz
    from self6dpp_tpu_torch.engine.gdrn_engine import build_gdrn
    from self6dpp_tpu_torch.tools import train_self6dpp
    from self6dpp_tpu_torch.engine.checkpoint import step_dirs
    cfg = apply_overrides(load_config("configs/self6dpp/lm_ss.py"),
                          ["model.num_classes=2"])
    aim_checkpoint(ckpt, root, cfg)
    dets = write_pseudo_dets(root)
    head = ["--config", "configs/self6dpp/lm_ss.py", "--weights", ckpt,
            "--det-file", dets]
    fp32 = ("dist.compute_dtype=float32", f"solver.total_iters={S2_CLI_ITERS}",
            "solver.base_lr=1e-3", "solver.warmup_iters=0", "ckpt_period=0")
    runs = {}
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for impl in ("kernel", "plain"):
            out = os.path.join(TRAIN_DIR, f"self6dpp_{impl}")
            with pose_step_recorded() as rec:
                runs[impl] = run_cli(train_self6dpp.main, head + syn_opts(
                    root, out, *fp32), device, impl, deterministic=True)
            if impl == "kernel":
                k21 = check_stage2_kernels(rec["cfg"], stage2_inputs(
                    rec["cfg"], rec["state"], rec["batch"], rec["lpips"]),
                    tie_band=LAB_TIE_BAND)
                del rec
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    (rk, lk, _, _, _), (rp, _, _, _, _) = runs["kernel"], runs["plain"]
    mk, mp = (loss_rows(read_metrics(r["metrics"])) for r in (rk, rp))
    check_finite_losses(read_metrics(rk["metrics"]), "train_self6dpp fp32",
                        S2_CLI_ITERS)
    require({"loss_mask_self", "loss_color_ab_obj", "loss_percep_obj",
             "loss_ms_ssim"} <= set(mk[-1]), "lm_ss loss terms",
            sorted(mk[-1]))
    init = load_params_npz(os.path.join(ckpt, str(step_dirs(ckpt)[0][-1]),
                                        "model.npz"), build_gdrn(cfg, device))
    init = params_of(init)
    fp = {"losses_kernel": mk, "losses_plain": mp,
          "loss_rel_err": max(loss_err(a, b) for a, b in zip(mk, mp)),
          "student_kernel_vs_plain_max_abs": max_abs_diff(
              params_of(rk["state"].model), params_of(rp["state"].model)),
          "teacher_kernel_vs_plain_max_abs": max_abs_diff(
              params_of(rk["state"].teacher), params_of(rp["state"].teacher)),
          "student_moved_max_abs": max_abs_diff(
              params_of(rk["state"].model), init),
          "launches_kernel_run": lk, "modes": rk["modes"]}
    require(fp["loss_rel_err"] <= TOL_S2_LOSS, "lm_ss CLI losses", fp)
    require(fp["student_kernel_vs_plain_max_abs"] <= TOL_S2_PARAMS
            and fp["teacher_kernel_vs_plain_max_abs"] <= TOL_S2_PARAMS,
            "lm_ss CLI params", fp)
    require(fp["student_moved_max_abs"] > S2_MOVED * TOL_S2_PARAMS,
            "lm_ss CLI: the student did not move", fp)

    out = os.path.join(TRAIN_DIR, "self6dpp_timed")
    res, launches, by_h, _, wall = run_cli(
        train_self6dpp.main, head + syn_opts(
            root, out, f"solver.total_iters={S2_CLI_TIMED}", "ckpt_period=0"),
        device)
    rows = read_metrics(res["metrics"])
    check_finite_losses(rows, "train_self6dpp bf16", S2_CLI_TIMED)
    s = cfg.model.input_res
    require(res["modes"] == ["pose"] * S2_CLI_TIMED
            and by_h["fine_raster_fwd"].get(s) == S2_CLI_TIMED
            and by_h["fine_raster_bwd"].get(s) == S2_CLI_TIMED
            and launches["lab_value_grad"] == S2_CLI_TIMED
            and by_h["fine_raster_fwd"].get(LABEL_RES, 0) > 0,
            "train_self6dpp launches", launches, by_h)
    timed = {"config": "self6dpp_lm_ss", "batch": 8,
             "compute_dtype": "bfloat16", "student_render_res": s,
             "wall_s": wall,
             "launches": launches, "launches_by_height": by_h,
             "last_losses": loss_rows(rows)[-1],
             **loop_split(res, 8, rows)}

    out = os.path.join(TRAIN_DIR, "self6dpp_smoke")
    res, sl, sby_h, _, swall = run_cli(train_self6dpp.main, [
        "--config", "configs/self6dpp/synthetic_smoke.py", "--opts",
        f"data.dataset_root={root}", f"output_dir={out}", "log_period=1",
        f"solver.total_iters={SMOKE_ITERS}", f"ckpt_period={SMOKE_ITERS}"],
        device)
    rows = read_metrics(res["metrics"])
    check_finite_losses(rows, "synthetic_smoke", SMOKE_ITERS)
    require(set(res["modes"]) == {"pose", "geo", "synsup"}
            and {"loss_repj_miou_1", "loss_PM_R_repj"} <= set(rows[-1]),
            "synthetic_smoke modes and repj terms", res["modes"],
            sorted(rows[-1]))
    smoke = {"modes": res["modes"], "wall_s": swall, "launches": sl,
             "launches_by_height": sby_h, "last_losses": loss_rows(rows)[-1]}
    return k21, {"fp32_kernel_vs_plain": fp, "timed": timed,
                 "synthetic_smoke": smoke}


def train_kernel_lines(k21, timed, b1_label, label_launches):
    """The `kernels` entries of the training path: B1 at the train labels'
    cache (phase 19), and B1, B2 and B3 at lm_ss's step (phase 21, held on
    the fp32 run's inputs; launches of the bf16 run at the student
    render's height)."""
    s = timed["student_render_res"]
    launches = {"fine_raster_fwd": timed["launches_by_height"][
                    "fine_raster_fwd"][s],
                "fine_raster_bwd": timed["launches_by_height"][
                    "fine_raster_bwd"][s],
                "lab_value_grad": timed["launches"]["lab_value_grad"]}
    rows = [b1_row("fine_raster_fwd[train_label_cache]", b1_label,
                   label_launches)]
    for name, src, replaces, key, count, err in (
            ("fine_raster_fwd[lm_ss]", "fine_raster_fwd.cu",
             "self6dpp_tpu/ops/raster_pallas.py:420", "B1",
             "fine_raster_fwd", max(k21["B1"]["max_abs_err"].values())),
            ("fine_raster_bwd[lm_ss]", "fine_raster_bwd.cu",
             "self6dpp_tpu/ops/raster_pallas.py:459", "B2",
             "fine_raster_bwd", k21["B2"]["loss"]["rel_err"]
             * k21["B2"]["loss"]["max_abs"]),
            ("lab_value_grad[lm_ss]", "lab_value_grad.cu",
             "self6dpp_tpu/ops/lab_pallas.py:171", "B3", "lab_value_grad",
             k21["B3"]["scaled_max_abs_err"])):
        d = k21[key]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"self6dpp_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": launches[count], "max_abs_err": err, "ms": d["ms"],
            "graph_ms": d["graph_ms"], "plain_ms": d["plain_ms"],
            "bound_ms": d["bound_ms"], "bound_by": d["bound_by"],
            "library_ms": None})
    return rows


# ---------------------------------------------------------------- detector
YOLO_TINY = dict(input_size=128, width_multiple=0.125, depth_multiple=0.33)
YOLO_CPU_BATCH = 2                # phase 22a: images a batch
YOLO_LR = 1e-3                    # phase 22a: constant, no warm-up
TOL_YOLO_CPU = 1e-4               # phase 22a: card vs CPU losses (relative)
TOL_YOLO_CPU_PRED = 1e-4          # and the decoded predictions after two
                                  # steps: |card - cpu| / max(|cpu|, 1)
                                  # (boxes in px reach ~10³)
YOLO_ITERS = 6                    # phase 22b: iterations of the first run
YOLO_RESUME_ITERS = 8             # and the total of the resumed run
YOLO_DIR = os.path.join(TRAIN_DIR, "yolo")


def synthetic_classes():
    """class_of_obj_id of the 'synthetic' meta, as the detector CLI maps
    object ids to classes."""
    from self6dpp_tpu_torch.data.ref import get_meta
    meta = get_meta("synthetic")
    return lambda oid: meta.objects.index(meta.id2obj[oid])


def check_yolo_card_vs_cpu(root, device):
    """Phase 22a: two float32 train steps of YOLOv4 at the tiny width
    (YOLO_TINY, 2 classes, Ranger at a constant YOLO_LR, clip 35) on two
    batches of YOLO_CPU_BATCH train images through the detector's loader,
    on the card (TF32 off, cuDNN deterministic) and on the CPU (torch on
    one thread), from the same seeded weights: losses within TOL_YOLO_CPU;
    then one eval batch decoded by both models within TOL_YOLO_CPU_PRED,
    and NMS run on both decoded arrays."""
    from self6dpp_tpu_torch.config import DetConfig, gdrn_lm_base
    from self6dpp_tpu_torch.convert import param_kinds
    from self6dpp_tpu_torch.data.bop import load_bop_split
    from self6dpp_tpu_torch.data.det_loader import DetDataset
    from self6dpp_tpu_torch.engine.optim import build_optimizer
    from self6dpp_tpu_torch.engine.train_state import create_train_state
    from self6dpp_tpu_torch.models.yolo import (YoloConfig, build_yolo,
                                                decode_predictions,
                                                non_max_suppression)
    from self6dpp_tpu_torch.tools.train_yolov4 import (make_train_step,
                                                       to_device)
    ycfg = YoloConfig(num_classes=2, **YOLO_TINY)
    det = DetConfig(input_size=ycfg.input_size)
    cls_of = synthetic_classes()
    lm = os.path.join(root, "lm")
    batches = DetDataset(load_bop_split(os.path.join(lm, "train")), det,
                         cls_of, train=True, seed=SEED
                         ).train_batches(YOLO_CPU_BATCH)
    train = [next(batches) for _ in range(2)]
    test = next(DetDataset(load_bop_split(os.path.join(lm, "test")), det,
                           cls_of, train=False).eval_batches(YOLO_CPU_BATCH))
    solver = dataclasses.replace(gdrn_lm_base().solver, base_lr=YOLO_LR,
                                 lr_sched="constant")

    def run(dev):
        model = build_yolo(ycfg, dev, seed=SEED)
        init = {n: p.detach().cpu().clone()
                for n, p in model.named_parameters()}
        opt = build_optimizer(solver, model.parameters(),
                              kinds=list(param_kinds(model).values()))
        st = create_train_state(model, opt, with_ema=False)
        step = make_train_step(ycfg)
        losses = []
        for b in train:
            st, m = step(st, to_device(b, dev))
            losses.append({k: float(v) for k, v in m.items()})
        with torch.no_grad():
            x = torch.from_numpy(test[0]).to(dev).permute(0, 3, 1, 2)
            pred = decode_predictions(model.eval()(x.contiguous()),
                                      ycfg).cpu().numpy()
        return losses, pred, init, {n: p.detach().cpu()
                                    for n, p in model.named_parameters()}

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    det_flag = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        lg, pg, init, wg = run(device)
    finally:
        torch.backends.cudnn.deterministic = det_flag
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        lc, pc, _, wc = run(torch.device("cpu"))
    finally:
        torch.set_num_threads(threads)
    t0 = time.perf_counter()
    ng = non_max_suppression(pg, 0.001, 0.65)
    nms_ms = (time.perf_counter() - t0) * 1e3
    nc = non_max_suppression(pc, 0.001, 0.65)
    top = [float(np.abs(a[0] - b[0]).max()) if len(a) and len(b) else None
           for a, b in zip(ng, nc)]
    out = {"input_size": ycfg.input_size, "batch": YOLO_CPU_BATCH,
           "width_multiple": ycfg.width_multiple,
           "depth_multiple": ycfg.depth_multiple, "steps": 2,
           "losses_card": lg, "losses_cpu": lc,
           "loss_rel_err": max(loss_err(a, b) for a, b in zip(lg, lc)),
           "pred_shape": list(pg.shape),
           "pred_max_abs_err": float(np.abs(pg - pc).max()),
           "pred_max_rel_err": float((np.abs(pg - pc)
                                      / np.maximum(np.abs(pc), 1)).max()),
           "params_card_vs_cpu_max_abs": max_abs_diff(wg, wc),
           "params_moved_max_abs": max_abs_diff(wg, init),
           "nms_kept_card": [len(a) for a in ng],
           "nms_kept_cpu": [len(a) for a in nc],
           "nms_top_max_abs_err": top, "nms_ms": nms_ms}
    require(out["loss_rel_err"] <= TOL_YOLO_CPU, "YOLOv4 card vs CPU losses",
            out)
    require(out["pred_max_rel_err"] <= TOL_YOLO_CPU_PRED,
            "YOLOv4 card vs CPU decoded predictions", out)
    require(out["params_moved_max_abs"] > 10 * out[
        "params_card_vs_cpu_max_abs"], "YOLOv4: the params did not move", out)
    return out


@contextlib.contextmanager
def yolo_step_marks(marks):
    """While active, the detector CLI's train steps record CUDA events at
    the start and after the forward, the loss, the backward and the solver:
    one list of (name, event) per step appended to `marks`."""
    from self6dpp_tpu_torch.engine.gdrn_engine import event_marker
    from self6dpp_tpu_torch.tools import train_yolov4 as ty
    inner = ty.make_train_step

    def marked(ycfg):
        step = inner(ycfg)

        def run(state, batch):
            m = []
            mark = event_marker(m)
            mark("start")
            out = step(state, batch, mark)
            marks.append(m)
            return out
        return run
    ty.make_train_step = marked
    try:
        yield marks
    finally:
        ty.make_train_step = inner


def run_detector_cli(argv, device):
    """One in-process run of the detector CLI with the kernel launch counts
    set to 0 just before and read just after. Returns (result, launches,
    wall seconds)."""
    from self6dpp_tpu_torch.tools import train_yolov4
    zero_kernel_launches()
    t0 = time.perf_counter()
    res = train_yolov4.main(argv, device=device)
    torch.cuda.synchronize()
    return res, kernel_launches(), time.perf_counter() - t0


def yolo_loop_split(res, rows, marks, batch):
    """ms per iteration (metrics.json's time_per_iter: log_period 1 copies
    each step's metrics to the host), the loader's wait and host ms per
    batch, the step's phases by CUDA events, images/s; the first iteration
    (warm-up) left out."""
    it = [r["time_per_iter"] for r in rows[1:]]
    med = lambda xs: float(np.median(xs) * 1e3)
    phases = {}
    for m in marks[1:]:
        for (_, a), (name, b) in zip(m, m[1:]):
            phases.setdefault(name, []).append(a.elapsed_time(b))
    per_iter = med(it)
    return {"iterations_timed": len(it), "ms_per_iter": per_iter,
            "ms_per_iter_range": [min(it) * 1e3, max(it) * 1e3],
            "images_per_s": batch / (per_iter / 1e3),
            "loader_wait_ms": med([t["wait_s"] for t in res["timings"][1:]]),
            "loader_host_ms": med([t["host_s"] for t in res["timings"][1:]]),
            "loader_share": float(np.median(
                [t["host_s"] for t in res["timings"][1:]]) * 1e3 / per_iter),
            "step_phase_ms_median": {
                ("solver" if k == "optimizer_ema" else k): float(np.median(v))
                for k, v in phases.items()},
            "step_phase_ms_sum": float(sum(np.median(v)
                                           for v in phases.values()))}


def run_detector(root, device):
    """Phase 22b: the detector CLI at lm_base's widths (YOLOv4 at 640²,
    width and depth 1.0, 6 images a batch, float32, Ranger) on the
    synthetic set's train split, 2 classes, YOLO_ITERS iterations with a
    checkpoint at the last, then --resume to YOLO_RESUME_ITERS; cuDNN's
    TF32 at PyTorch's default (on), as the CLI leaves it. Then --eval-only
    over the test split writing the detections json, and train_gdrn
    --eval-only --det-file at lm_base on that json (phase 19's GDRN). The
    detector path launches no kernel."""
    from self6dpp_tpu_torch.engine.checkpoint import step_dirs
    from self6dpp_tpu_torch.tools import train_gdrn
    argv = ["--config", "configs/gdrn/lm_base.py"] + syn_opts(
        root, YOLO_DIR, f"ckpt_period={YOLO_ITERS}")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        torch.cuda.reset_peak_memory_stats()
        with yolo_step_marks([]) as marks:
            res, launches, wall = run_detector_cli(
                argv + [f"solver.total_iters={YOLO_ITERS}"], device)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        rows = read_metrics(res["metrics"])
        check_finite_losses(rows, "train_yolov4", YOLO_ITERS)
        require(sum(launches.values()) == 0, "train_yolov4 launched kernels",
                launches)
        ckpt = os.path.join(os.path.dirname(res["metrics"]), "ckpt")
        require(step_dirs(ckpt) == ([YOLO_ITERS], []), "train_yolov4 steps",
                step_dirs(ckpt))
        res2, _, wall2 = run_detector_cli(
            argv[:2] + ["--resume"] + argv[2:]
            + [f"solver.total_iters={YOLO_RESUME_ITERS}"], device)
        rows2 = read_metrics(res2["metrics"])
        check_finite_losses(rows2, "train_yolov4 resumed", YOLO_RESUME_ITERS)
        require(rows2[:YOLO_ITERS] == rows
                and res2["state"].step == YOLO_RESUME_ITERS
                and len(res2["timings"]) == YOLO_RESUME_ITERS - YOLO_ITERS,
                "train_yolov4 resume redid iterations", len(res2["timings"]))
        require(step_dirs(ckpt) == ([YOLO_ITERS, YOLO_RESUME_ITERS], []),
                "train_yolov4 steps after resume", step_dirs(ckpt))
        dets_path = os.path.join(YOLO_DIR, "dets.json")
        ev, ev_launches, ev_wall = run_detector_cli(
            argv[:2] + ["--eval-only", "--out-det", dets_path] + argv[2:],
            device)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    require(sum(ev_launches.values()) == 0, "detector eval launched kernels",
            ev_launches)
    with open(dets_path) as f:
        dets = json.load(f)
    n_test = len(os.listdir(os.path.join(root, "lm", "test", "000000",
                                         "rgb")))
    require(len(dets) == n_test and all(
        {"obj_id", "bbox_est", "score", "time"} == set(d)
        and len(d["bbox_est"]) == 4 and np.isfinite(d["score"])
        for rows_ in dets.values() for d in rows_),
        "detections json", len(dets), n_test)
    per_img = [t["infer_s"] / t["images"] for t in ev["timings"][1:]]
    g, g_launches, _, _, g_wall = run_cli(
        train_gdrn.main, ["--config", "configs/gdrn/lm_base.py",
                          "--eval-only", "--det-file", dets_path]
        + syn_opts(root, os.path.join(TRAIN_DIR, "gdrn")), device)
    require(len(g["results"]) > 0, "train_gdrn --det-file: no results")
    return {"config": "gdrn_lm_base", "input_size": 640,
            "width_multiple": 1.0, "depth_multiple": 1.0, "batch": 6,
            "classes": 2, "compute_dtype": "float32",
            "cudnn_allow_tf32": True, "iterations": YOLO_ITERS,
            "resumed_to": YOLO_RESUME_ITERS, "wall_s": wall,
            "wall_s_resumed": wall2, "peak_mem_gib": peak,
            "last_losses": loss_rows(rows2)[-1],
            **yolo_loop_split(res, rows, marks, 6),
            "eval": {"images": n_test, "wall_s": ev_wall,
                     "infer_ms_per_image": float(np.median(per_img) * 1e3),
                     "nms_ms_per_batch": float(np.median(
                         [t["nms_s"] for t in ev["timings"]]) * 1e3),
                     "loader_host_ms_per_batch": float(np.median(
                         [t["host_s"] for t in ev["loader_timings"]]) * 1e3),
                     "evaluate_s": ev["evaluate_s"], "eval_s": ev["eval_s"],
                     "ap": ev["ap"],
                     "detections": sum(len(v) for v in dets.values())},
            "gdrn_det_file": {"wall_s": g_wall, "results": len(g["results"]),
                              "b1_launches": g_launches["fine_raster_fwd"],
                              "avg": g["tables"].get("avg", {})}}


# ------------------------------------------------- slice 11 (phases 23-26)
JPEG_DIR = os.path.join(HERE, "self6dpp_tpu_torch", "fixtures", "jpeg")
JPEG_FIXTURES = ("frame_420_q95", "odd_422_rst")
JPEG_READS = 20                   # phase 23: median of 20 decodes
YCBV_SUBDIV = 4                   # phase 24: 5120-face icospheres
ATLAS_SIDE = 2048                 # YCB-V's atlas: one 2048² RGB a class
ATLAS_CELLS = 64                  # the atlas's seeded field, upsampled
S5_TIMED_STEPS = 10               # phase 24: timed bf16 textured steps
DEEPIM_ZOOM = 512                 # phase 25: lm_flownet's refine renders
TOL_DIST_FLAGS = 1e-6             # phase 26: loss with and without the flags


def check_jpeg():
    """Phase 23: the committed fixture (self6dpp_tpu_torch/fixtures/jpeg: a
    480x640 4:2:0 frame at quality 95, a 237x317 4:2:2 file with restart
    markers) through imread on this machine's build of csrc/jpeg_decode.c,
    colour and gray, bit for bit against cv2's decode stored beside it;
    each imread('color') timed on the host, median of JPEG_READS after one
    untimed read."""
    from self6dpp_tpu_torch.data.image_io import imread
    ref = np.load(os.path.join(JPEG_DIR, "decoded.npz"))
    out = {"reads": JPEG_READS}
    for name in JPEG_FIXTURES:
        path = os.path.join(JPEG_DIR, f"{name}.jpg")
        rgb, gray = imread(path, "color"), imread(path, "gray")
        require(np.array_equal(rgb, ref[f"{name}_rgb"])
                and np.array_equal(gray, ref[f"{name}_gray"]),
                "JPEG decode not bit for bit", name, int(np.abs(
                    rgb.astype(int) - ref[f"{name}_rgb"]).max()))
        ts = []
        for _ in range(JPEG_READS + 1):
            t0 = time.perf_counter()
            imread(path, "color")
            ts.append(time.perf_counter() - t0)
        out[name] = {"hw": list(rgb.shape[:2]),
                     "bytes": os.path.getsize(path),
                     "ms": float(np.median(ts[1:]) * 1e3)}
    return out


def ycbv_cfg(dtype_name, lr=None):
    """configs/self6dpp/ycbv_ss.py's Config (resnest50d, 256² -> 64², 21
    classes, lm_ss's loss family with LAB 0.2, Ranger, 8 ROIs) in the given
    compute dtype; with lr, no warm-up and that learning rate."""
    from self6dpp_tpu_torch.config import self6dpp_ycbv_ss
    return stage2_cfg(dtype_name, lr=lr, base=self6dpp_ycbv_ss())


def textured_stage2(cfg, batch_size, device, seed=SEED):
    """build_stage2 with YCB-V-shaped textured models: every class a
    5120-face icosphere of radius 0.06 with spherical UVs (mesh_uv) and one
    ATLAS_SIDE² RGB atlas (mesh_texture), a seeded ATLAS_CELLS² field
    upsampled bilinearly; the heads aimed (aim_heads_) before the teacher
    and the solver copy them. Returns (model, state, batch, lpips)."""
    import torch.nn.functional as Fnn
    from self6dpp_tpu_torch.data.meshes import make_icosphere
    from self6dpp_tpu_torch.engine import self_engine as se
    from self6dpp_tpu_torch.engine.gdrn_engine import build_gdrn, init_state
    from self6dpp_tpu_torch.models.lpips import build_lpips
    v, f = make_icosphere(0.06, YCBV_SUBDIV)
    model = build_gdrn(cfg, device=device, seed=seed)
    batch = se.stage2_batch(cfg, batch_size, device, seed=seed, mesh=(v, f))
    n = v / np.linalg.norm(v, axis=1, keepdims=True)
    uv = np.stack([0.5 + np.arctan2(n[:, 2], n[:, 0]) / (2 * np.pi),
                   0.5 + np.arcsin(np.clip(n[:, 1], -1, 1)) / np.pi], 1)
    C = cfg.model.num_classes
    batch["mesh_uv"] = torch.as_tensor(uv, dtype=torch.float32,
                                       device=device).expand(C, -1, -1)
    g = torch.Generator().manual_seed(seed + 24)
    field = torch.rand((C, 3, ATLAS_CELLS, ATLAS_CELLS), generator=g)
    batch["mesh_texture"] = Fnn.interpolate(
        field.to(device), size=(ATLAS_SIDE, ATLAS_SIDE), mode="bilinear",
        align_corners=False).permute(0, 2, 3, 1).contiguous()
    se.aim_heads_(model, batch)
    return model, init_state(cfg, model), batch, build_lpips(device,
                                                             seed + 1)


def run_textured_stage2(device, cand_checks):
    """Phase 24: the textured stage-II pose step at ycbv_ss (ycbv_cfg,
    textured_stage2: 21 classes, 8 ROIs, 5120-face meshes, 2048² atlases)
    through run_stage2_checked (B1 on the UVs, D = 2, with the soft
    silhouette and its saved keep; B2 on the cotangents the losses send to
    prob, depth and the UVs through the atlas's bilinear sample), with
    lm_ss's loss family."""
    from self6dpp_tpu_torch.ops import raster_cuda as RC
    cfg, cfg32 = ycbv_cfg("bfloat16"), ycbv_cfg("float32", lr=S2_LR)

    def two_attributes(inputs):
        D = (inputs[0].shape[-1] - RC._GEO) // 3
        require(D == 2, "textured render: attribute channels", D)
    k24, fp32, timed, batch, last = run_stage2_checked(
        cfg, cfg32, textured_stage2, device, cand_checks, "textured",
        two_attributes)
    require({"loss_color_ab_obj", "loss_percep_obj", "loss_ms_ssim",
             "loss_mask_self"} <= set(last), "ycbv_ss loss terms",
            sorted(last))
    timed.update(atlas=[ATLAS_SIDE, ATLAS_SIDE, 3],
                 atlas_gib=batch["mesh_texture"].numel() * 4 / 2 ** 30)
    return k24, {"fp32": fp32, "timed": timed}


def stage2_kernel_rows(k, timed, label, lab_label):
    """The `kernels` entries of a stage-II step's B1, B2 and B3 (names
    fine_raster_fwd[label], fine_raster_bwd[label],
    lab_value_grad[lab_label]), the launches of its timed bf16 run."""
    rows = []
    for name, src, replaces, key, err in (
            (f"fine_raster_fwd[{label}]", "fine_raster_fwd.cu",
             "self6dpp_tpu/ops/raster_pallas.py:420", "B1",
             max(k["B1"]["max_abs_err"].values())),
            (f"fine_raster_bwd[{label}]", "fine_raster_bwd.cu",
             "self6dpp_tpu/ops/raster_pallas.py:459", "B2",
             k["B2"]["loss"]["rel_err"] * k["B2"]["loss"]["max_abs"]),
            (f"lab_value_grad[{lab_label}]", "lab_value_grad.cu",
             "self6dpp_tpu/ops/lab_pallas.py:171", "B3",
             k["B3"]["scaled_max_abs_err"])):
        d = k[key]
        count = {"B1": "fine_raster_fwd", "B2": "fine_raster_bwd",
                 "B3": "lab_value_grad"}[key]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"self6dpp_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": timed["launches"][count], "max_abs_err": err,
            "ms": d["ms"], "graph_ms": d["graph_ms"],
            "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
            "bound_by": d["bound_by"], "library_ms": None})
    return rows


@contextlib.contextmanager
def deepim_config_float32():
    """While active, the port's load_config gives lm_flownet in float32
    (gen_pseudo_poses applies no --opts to --deepim-config)."""
    from self6dpp_tpu_torch import config as C
    load = C.load_config

    def fp32(path):
        cfg = load(path)
        if path.endswith("configs/deepim/lm_flownet.py"):
            cfg = dataclasses.replace(cfg, dist=dataclasses.replace(
                cfg.dist, compute_dtype="float32"))
        return cfg
    C.load_config = fp32
    try:
        yield
    finally:
        C.load_config = load


def run_gen_pseudo_poses(root, ckpt, device):
    """Phase 25: tools/gen_pseudo_poses on the synthetic set's test split
    with its GT-box detections, --config lm_base (2 classes, float32) at
    phase 19's checkpoint (as phase 21 aimed it), --deepim-config
    lm_flownet (FlowNetS, 512² zoom, 4 iterations, float32) at a port step
    directory of weights of unit gain (unit_gain_: the refined pose
    depends on the render), TF32 off and cuDNN deterministic, once through
    the kernels and once through the plain versions: the same records,
    boxes, scores and pose_est, pose_refine within TOL_PATH (phase 3's),
    the refiner moved the poses by more than TOL_PATH, n_iter_test B1
    launches at 512² a batch; wall seconds; B1 held at its first 512²
    inputs (b1_at)."""
    import shutil
    from self6dpp_tpu_torch.config import gdrn_lm_base, lm_flownet
    from self6dpp_tpu_torch.engine import deepim_engine as de
    from self6dpp_tpu_torch.engine.checkpoint import CheckpointManager
    from self6dpp_tpu_torch.tools import gen_pseudo_poses
    out = os.path.join(TRAIN_DIR, "pseudo")
    shutil.rmtree(out, ignore_errors=True)
    dcfg = lm_flownet()
    dmodel = de.build_deepim(dcfg, device, train=True)
    with torch.no_grad():
        unit_gain_(dmodel, SEED)
    dckpt = os.path.join(out, "deepim_ckpt")
    CheckpointManager(dckpt).save(de.init_state(dcfg, dmodel), step=1,
                                  force=True)
    del dmodel
    argv = ["--config", "configs/gdrn/lm_base.py", "--gdrn-ckpt", ckpt,
            "--det-file", os.path.join(root, "lm", "gt_dets.json"),
            "--deepim-config", "configs/deepim/lm_flownet.py",
            "--deepim-ckpt", dckpt, "--opts", f"data.dataset_root={root}",
            "data.test_datasets=synthetic", "model.num_classes=2",
            "dist.compute_dtype=float32"]
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = {}
    try:
        with deepim_config_float32():
            for impl in ("kernel", "plain"):
                runs[impl] = run_cli(
                    gen_pseudo_poses.main, argv + [
                        "--out", os.path.join(out, f"pseudo_{impl}.json")],
                    device, impl, deterministic=True, heights=(DEEPIM_ZOOM,))
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    (rk, lk, bk, seen, wk), (rp, _, bp, _, wp) = runs["kernel"], runs["plain"]
    dk, dp = rk["dets"], rp["dets"]
    require(list(dk) == list(dp) and rk["n_rois"] == rp["n_rois"] > 0,
            "gen_pseudo_poses records", rk["n_rois"], rp["n_rois"])
    est_err = refine_err = moved = 0.0
    for key in dk:
        for a, b in zip(dk[key], dp[key], strict=True):
            require((a["obj_id"], a["bbox_est"], a["score"])
                    == (b["obj_id"], b["bbox_est"], b["score"]),
                    "gen_pseudo_poses entries", key)
            est_err = max(est_err, float(np.abs(np.subtract(
                a["pose_est"], b["pose_est"])).max()))
            refine_err = max(refine_err, float(np.abs(np.subtract(
                a["pose_refine"], b["pose_refine"])).max()))
            moved = max(moved, float(np.abs(np.subtract(
                a["pose_refine"], a["pose_est"])).max()))
    n_batches = -(-rk["n_rois"] // gdrn_lm_base().solver.ims_per_batch)
    n_iter = lm_flownet().deepim.n_iter_test
    require(est_err <= TOL_PATH and refine_err <= TOL_PATH,
            "gen_pseudo_poses kernel vs plain", est_err, refine_err)
    require(moved > TOL_PATH, "gen_pseudo_poses: the refiner left the "
            "poses where they were", moved)
    require(bk["fine_raster_fwd"].get(DEEPIM_ZOOM) == n_iter * n_batches
            and DEEPIM_ZOOM not in bp["fine_raster_fwd"],
            "gen_pseudo_poses B1 launches", bk, bp)
    b1 = b1_at(seen[DEEPIM_ZOOM], "gen_pseudo_poses refine B1")
    return b1, {"rois": rk["n_rois"], "batches": n_batches,
                "refine_iterations": n_iter, "wall_s_kernel": wk,
                "wall_s_plain": wp, "launches": lk,
                "b1_launches_by_height": bk["fine_raster_fwd"],
                "pose_est_kernel_vs_plain_max_abs": est_err,
                "pose_refine_kernel_vs_plain_max_abs": refine_err,
                "refine_moved_max_abs": moved}


def gen_pseudo_kernel_line(b1, pseudo):
    """B1 (i): the refine renders of gen_pseudo_poses (phase 25)."""
    return b1_row("fine_raster_fwd[gen_pseudo_poses]", b1,
                  pseudo["b1_launches_by_height"][DEEPIM_ZOOM])


def run_dist_flags(root, device):
    """Phase 26: train_gdrn at lm_base (2 classes, float32, TF32 off, cuDNN
    deterministic) for one iteration with --dist-coordinator localhost:PORT
    --dist-nprocs 1 --dist-rank 0 and once without the flags: the flags
    are taken, one process joins no group (as the JAX CLI's), and the
    iteration's losses agree within TOL_DIST_FLAGS. One card cannot hold
    two NCCL ranks: the two-rank path is held on the CPU
    (tests/test_torch_dist.py, gloo)."""
    import socket
    from self6dpp_tpu_torch.parallel import dist
    from self6dpp_tpu_torch.tools import train_gdrn
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    flags = ["--dist-coordinator", f"localhost:{port}", "--dist-nprocs",
             "1", "--dist-rank", "0"]
    losses, walls = {}, {}
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for name, extra in (("flags", flags), ("plain", [])):
            argv = ["--config", "configs/gdrn/lm_base.py"] + extra + \
                syn_opts(root, os.path.join(TRAIN_DIR, f"dist_{name}"),
                         "solver.total_iters=1", "ckpt_period=0",
                         "dist.compute_dtype=float32")
            res, _, _, _, walls[name] = run_cli(train_gdrn.main, argv, device,
                                                deterministic=True)
            rows = read_metrics(res["metrics"])
            check_finite_losses(rows, f"train_gdrn {name}", 1)
            losses[name] = loss_rows(rows)[-1]
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    require(dist.world_size() == 1, "--dist-nprocs 1 joined a group")
    err = loss_err(losses["flags"], losses["plain"])
    require(err <= TOL_DIST_FLAGS, "train_gdrn with --dist-* flags", losses)
    return {"loss_rel_err": err, "losses": losses, "wall_s": walls,
            "world_size": dist.world_size()}


# ---- every GDR-Net architecture and the test-time PnP (phases 27-29) ------

VARIANTS = ("darknet53_topdown", "pvnet_conv_point", "resnet34_fpn")
VARIANT_STEPS = 10                # phase 27: bf16 stage-I steps timed
VARIANT_CPU_BATCH = 2             # phase 27: fp32 card vs CPU, images a step
VARIANT_LR = 1e-3                 # and its Ranger lr (no warm-up), as phase 10
TOL_V_LOSS = 1e-4                 # phase 27: card vs CPU losses, relative
TOL_V_PARAMS = 1e-4               # and parameters and BN statistics
V2_TRAIN_ITERS = 2                # phase 29: train_gdrn iterations at V2
PNP_PRED_ROIS = 8                 # phase 29: ROIs of the PnP on predictions
# phase 29: --opts that select V2 on a config (variant_model's V2)
V2_OPTS = ("model.backbone.name=pvnet_resnet18_8s",
           "model.geo_head.name=ConvMaskXyzRegionHead",
           "model.geo_head.num_feat_layers=2",
           "model.pnp_net.name=SimplePointPnPNet",
           "model.pnp_net.mask_attention=mul",
           "model.pnp_net.trans_type=trans")
# phase 29: PnP on the eval loader's ground-truth labels, held against the
# ground-truth pose. The labels are a nearest-neighbour warp of a 128²
# render of the crop: each object point lies up to one output pixel (s/o,
# 0.6-1.3 frame pixels on the synthetic set) from the pixel centre PnP
# pairs it with, so the ground-truth pose itself reprojects them ~0.5-1 px
# off. The pose must fit the labels at least as well as the ground truth
# does (reprojection RMS; PNP_FIT_SLACK for EPnP, which is not the
# least-squares fit). One pixel at the rim of the set's objects (~20 px in
# radius) is atan(1/20) = 2.9 degrees of rotation and 1/20 of the depth;
# the ~1000 points of a mask average the independent part of the error
# down, not the half-pixel part every point shares: the limits are a third
# of those, PNP_MAX_DEG and PNP_MAX_T_REL (of the depth, for the
# translation's norm). Crops under PNP_MIN_SIDE frame pixels (3 of the 96:
# objects cut by the frame's edge) see a near-planar patch of the surface,
# where the iterative solve can settle on a pose far from the truth that
# fits the labels within a fraction of a pixel, as the reference's
# cv2.solvePnP does on such patches (tests/test_torch_pnp.py::
# test_small_crop_iterative: over 45 degrees off in both on five of sixteen
# 7.5-px rim crops). They are reported, not held.
PNP_MIN_SIDE = 24.0
PNP_MAX_DEG = 1.0
PNP_MAX_T_REL = 0.015
PNP_FIT_SLACK = 1.05


def variant_model(m, name):
    """V1-V3 on the PoseNetConfig m (its widths, classes and the rest of
    its heads): V1 darknet53_topdown (Darknet-53, the TopDown head with a
    4x4 deconv and split out layers, ConvPnPNet with the mask concatenated,
    the extent embedding and DropBlock 0.2, centroid_z_abs); V2
    pvnet_conv_point (pvnet_resnet18_8s stopped at output_res, the conv
    head with 2 layers, SimplePointPnPNet with the mask multiplied, trans);
    V3 resnet34_fpn (resnet34 stages 1-4, the FPN neck at 256 channels, the
    FPN head, ConvPnPNet)."""
    r = dataclasses.replace
    if name == "darknet53_topdown":
        return r(m, backbone=r(m.backbone, name="darknet53"),
                 geo_head=r(m.geo_head, deconv_kernel_size=4,
                            out_layer_shared=False),
                 pnp_net=r(m.pnp_net, mask_attention="concat",
                           with_extent_feat=True, drop_prob=0.2,
                           trans_type="centroid_z_abs"))
    if name == "pvnet_conv_point":
        return r(m, backbone=r(m.backbone, name="pvnet_resnet18_8s"),
                 geo_head=r(m.geo_head, name="ConvMaskXyzRegionHead",
                            num_feat_layers=2),
                 pnp_net=r(m.pnp_net, name="SimplePointPnPNet",
                           mask_attention="mul", trans_type="trans"))
    if name == "resnet34_fpn":
        return r(m, backbone=r(m.backbone, name="resnet34",
                               out_indices=(1, 2, 3, 4)),
                 neck="fpn", neck_out_channels=256,
                 geo_head=r(m.geo_head, name="FPNMaskXyzRegionHead"))
    raise ValueError(name)


def variant_stage1_cfg(name, fp32=False):
    """gdrn_flagship (256² -> 64², 13 classes, 24 images, Ranger, bf16)
    with the variant's model; fp32: float32, VARIANT_CPU_BATCH images and
    Ranger at VARIANT_LR without warm-up (phase 27's card vs CPU check)."""
    from self6dpp_tpu_torch.config import gdrn_flagship
    f = gdrn_flagship()
    cfg = dataclasses.replace(f, exp_name=f"gdrn_{name}",
                              model=variant_model(f.model, name))
    if not fp32:
        return cfg
    return dataclasses.replace(
        cfg, solver=dataclasses.replace(
            cfg.solver, ims_per_batch=VARIANT_CPU_BATCH,
            reference_bs=VARIANT_CPU_BATCH, base_lr=VARIANT_LR,
            warmup_iters=0),
        dist=dataclasses.replace(cfg.dist, compute_dtype="float32"))


@contextlib.contextmanager
def fixed_dropblock_seed():
    """While active, every DropBlock draw is one seeded mask, made on the
    CPU at the asked shape and moved to the asked device: the card and the
    CPU drop the same blocks. Yields the count of draws."""
    from self6dpp_tpu_torch.models import layers
    draw = layers.dropblock_seed
    calls = {"n": 0}

    def fixed(generator, shape, gamma, dtype, device):
        calls["n"] += 1
        g = torch.Generator().manual_seed(SEED)
        return draw(g, shape, gamma, dtype, torch.device("cpu")).to(device)
    layers.dropblock_seed = fixed
    try:
        yield calls
    finally:
        layers.dropblock_seed = draw


def check_variant_card_vs_cpu(name, device):
    """Phase 27, first part: two float32 stage-I steps of the variant at
    full width (variant_stage1_cfg(fp32=True): VARIANT_CPU_BATCH images,
    BN in train mode) on the card (TF32 off, cuDNN deterministic) and on
    the CPU (one thread), from one seeded start state, DropBlock fed one
    seeded mask on both (fixed_dropblock_seed): losses within TOL_V_LOSS,
    parameters and BN running statistics within TOL_V_PARAMS; both moved
    past 10x it."""
    cfg = variant_stage1_cfg(name, fp32=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    threads = torch.get_num_threads()
    try:
        with fixed_dropblock_seed() as drew:
            init, init_bn, mg, pg, bg = run_stage1(cfg, device, 2)
            torch.set_num_threads(1)
            _, _, mc, pc, bc = run_stage1(cfg, torch.device("cpu"), 2)
    finally:
        torch.backends.cudnn.deterministic = det
        torch.set_num_threads(threads)
    out = {"config": cfg.exp_name, "batch": VARIANT_CPU_BATCH,
           "dropblock_draws": drew["n"], "losses_card": mg,
           "losses_cpu": mc,
           "loss_rel_err": max(loss_err(a, b) for a, b in zip(mg, mc)),
           "params_card_vs_cpu_max_abs": max_abs_diff(pg, pc),
           "bn_stats_card_vs_cpu_max_abs": max_abs_diff(bg, bc),
           "params_moved_max_abs": max_abs_diff(pg, init),
           "bn_stats_moved_max_abs": max_abs_diff(bg, init_bn)}
    require(drew["n"] == (4 if cfg.model.pnp_net.drop_prob > 0 else 0),
            f"{name}: DropBlock draws", drew["n"])
    require(out["loss_rel_err"] <= TOL_V_LOSS, f"{name} fp32 losses", out)
    require(out["params_card_vs_cpu_max_abs"] <= TOL_V_PARAMS
            and out["bn_stats_card_vs_cpu_max_abs"] <= TOL_V_PARAMS,
            f"{name} fp32 params / BN stats", out)
    require(out["params_moved_max_abs"] > 10 * TOL_V_PARAMS
            and out["bn_stats_moved_max_abs"] > 10 * TOL_V_PARAMS,
            f"{name}: the steps left params or BN stats where they were",
            out)
    return out


def run_variants_stage1(device):
    """Phase 27: for V1-V3, check_variant_card_vs_cpu, then time_stage1 at
    full width (24 images, bf16): ms per step with the forward, loss,
    backward and optimizer_ema spans, images/s, peak memory; no kernel
    launched, BN statistics moved."""
    out = {}
    for name in VARIANTS:
        cpu = check_variant_card_vs_cpu(name, device)
        timed = time_stage1(variant_stage1_cfg(name), device, S1_BATCH,
                            VARIANT_STEPS)
        out[name] = {"card_vs_cpu": cpu, "timed": timed}
        print(f"stage-I {name}: {json.dumps(out[name])}", flush=True)
    return out


def variant_stage2_cfg(dtype_name, lr=None):
    """stage2_pose_flagship with V2 (pvnet_conv_point) as the student and
    its EMA teacher (stage2_cfg's dtype and lr)."""
    from self6dpp_tpu_torch.config import stage2_pose_flagship
    f = stage2_pose_flagship()
    base = dataclasses.replace(f, exp_name="stage2_pvnet_conv_point",
                               model=variant_model(f.model,
                                                   "pvnet_conv_point"))
    return stage2_cfg(dtype_name, lr=lr, base=base)


def run_stage2_checked(cfg, cfg32, build, device, cand_checks, name,
                       check_inputs=None):
    """Phases 24 and 28: a stage-II pose step (build(cfg, S2_BATCH,
    device, seed=SEED) builds it) with
      a. B1, B2 and B3 against their plain versions on one float32 step's
         inputs (check_stage2_kernels), timed, with their bounds;
      b. phase 6's fp32 checks (check_stage2_fp32);
      c. one bf16 warm-up step held against the fp32 step's losses
         (TOL_S2_BF16), then S5_TIMED_STEPS timed steps (time_stage2's
         CUDA-event spans), the launch counts of B1, B2 and B3 set to 0
         just before and read just after (one each a step), peak memory.
    check_inputs, when given, is called on a's inputs. Returns (a's
    record, b's record, c's record, the bf16 batch, the last step's
    metrics)."""
    from self6dpp_tpu_torch.engine import self_engine as se
    built = build(cfg32, S2_BATCH, device)
    with cand_order_checked(cand_checks):
        inputs = stage2_inputs(cfg32, *built[1:])
        if check_inputs is not None:
            check_inputs(inputs)
        kernels = check_stage2_kernels(cfg32, inputs)
        del inputs
        ref32, fp32 = check_stage2_fp32(cfg32, device, S2_BATCH, built,
                                        build=build)
    del built
    model, state, batch, lpips = build(cfg, S2_BATCH, device)
    step = se.make_self_train_step(cfg, model, lpips)
    state, warm = step(state, batch)
    torch.cuda.synchronize()
    warm = {k: float(v) for k, v in warm.items()}
    bf16_err = loss_err(warm, ref32)
    require(bf16_err <= TOL_S2_BF16, f"{name} bf16 vs fp32 losses", warm,
            ref32)
    torch.cuda.reset_peak_memory_stats()
    zero_kernel_launches()
    with scatter_counted() as scatters:
        times, phases, metrics = timed_steps(step, state, batch,
                                             S5_TIMED_STEPS)
    launches = kernel_launches()
    require(scatters["n"] == 0, f"the {name} step's B2 ran the scatter")
    for kname, k in launches.items():
        require(k == S2_LAUNCHES[kname] * S5_TIMED_STEPS,
                f"{name} launches per step", kname, k)
    for m in metrics:
        require(all(torch.isfinite(v).item() for v in m.values()),
                f"{name}: non-finite loss", m)
    timed = {**summary(times, phases), "config": cfg.exp_name,
             "batch": S2_BATCH, "classes": cfg.model.num_classes,
             "faces": int(batch["mesh_faces"].shape[1]),
             "compute_dtype": cfg.dist.compute_dtype,
             "tile_px": cfg.renderer.tile_px,
             "faces_per_tile": cfg.renderer.faces_per_tile,
             "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
             "launches": launches, "bf16_vs_fp32_loss_rel_err": bf16_err,
             "last_losses": {k: float(v) for k, v in metrics[-1].items()}}
    return kernels, fp32, timed, batch, metrics[-1]


def run_variant_stage2(device, cand_checks):
    """Phase 28: the stage-II pose step at stage2_pose_flagship (8 ROIs,
    1280-face meshes, the whole loss suite, Ranger) with V2
    (pvnet_conv_point) as the student and its EMA teacher
    (run_stage2_checked)."""
    from self6dpp_tpu_torch.engine import self_engine as se
    cfg = variant_stage2_cfg("bfloat16")
    cfg32 = variant_stage2_cfg("float32", lr=S2_LR)
    k28, fp32, timed, _, last = run_stage2_checked(
        cfg, cfg32, se.build_stage2, device, cand_checks, "V2 stage-II")
    require({"loss_percep_obj", "loss_ms_ssim", "loss_chamfer"} <= set(last),
            "V2 stage-II: the whole suite", sorted(last))
    return k28, {"fp32": fp32, "timed": timed}


def pnp_fit_rms(coor, mask, extent, center, side, K, R, t):
    """The reprojection RMS (frame pixels) of pose (R, t) over the
    correspondences pnp_from_xyz_mask builds from the map and mask."""
    from self6dpp_tpu_torch.ops import pnp as P
    o = coor.shape[0]
    ys, xs = np.nonzero(mask > 0.5)
    obj = (coor[ys, xs] - 0.5) * extent
    img = np.stack([center[0] - side / 2 + (xs + 0.5) * side / o,
                    center[1] - side / 2 + (ys + 0.5) * side / o], 1)
    d = P.project(obj.astype(np.float64), np.asarray(R, np.float64),
                  np.asarray(t, np.float64), np.asarray(K, np.float64)) - img
    return float(np.sqrt((d ** 2).sum(1).mean()))


def rot_err_deg(a, b):
    c = (np.trace(np.asarray(a, np.float64).T @ b) - 1) / 2
    return float(np.degrees(np.arccos(np.clip(c, -1, 1))))


def run_variant_cli(root, device):
    """Phase 29: the normal entry points with V2 (pvnet_conv_point) picked
    by --opts (V2_OPTS on lm_base: 256² -> 64², 24 ROIs a batch, bf16, 2
    classes of the synthetic set):
      a. train_gdrn, V2_TRAIN_ITERS iterations on the train split (finite
         losses, a checkpoint), then --eval-only over the test split's 96
         ROIs from that checkpoint (every ROI scored, finite tables);
      b. evaluator.pnp_from_xyz_mask, RANSAC and iterative, on every valid
         ROI's ground-truth xyz and object-mask labels from the eval
         loader: the pose fits the labels as well as the ground truth
         does (PNP_FIT_SLACK), within PNP_MAX_DEG and PNP_MAX_T_REL of it,
         on every crop of PNP_MIN_SIDE pixels or more (the smaller ones
         recorded); host ms per ROI;
      c. the same calls on the checkpoint's predicted maps (coor and the
         mask probability) of the first eval batch's first PNP_PRED_ROIS
         ROIs, timed, None counted (two iterations leave the mask probability near 0.5 over
         the whole map: every pixel a correspondence, every RANSAC
         iteration run)."""
    from self6dpp_tpu_torch.config import (apply_overrides, gdrn_lm_base,
                                           load_config)
    from self6dpp_tpu_torch.engine import gdrn_engine as ge
    from self6dpp_tpu_torch.engine.evaluator import (pnp_from_xyz_mask,
                                                     to_device)
    from self6dpp_tpu_torch.losses.mask_losses import get_mask_prob
    from self6dpp_tpu_torch.tools import train_gdrn
    base = gdrn_lm_base()
    require(apply_overrides(base, list(V2_OPTS)).model
            == variant_model(base.model, "pvnet_conv_point"),
            "V2_OPTS select V2")
    out = os.path.join(TRAIN_DIR, "gdrn_v2")
    opts = syn_opts(root, out, *V2_OPTS)
    argv = ["--config", "configs/gdrn/lm_base.py"] + opts + [
        f"solver.total_iters={V2_TRAIN_ITERS}",
        f"ckpt_period={V2_TRAIN_ITERS}"]
    res, launches, by_h, _, wall = run_cli(train_gdrn.main, argv, device)
    rows = read_metrics(res["metrics"])
    check_finite_losses(rows, "train_gdrn V2", V2_TRAIN_ITERS)
    require(type(res["state"].model.backbone).__name__ == "PVNetResNet8s"
            and type(res["state"].model.pnp_net).__name__
            == "SimplePointPnPNet", "train_gdrn --opts built V2")
    ev, _, _, _, ev_wall = run_cli(
        train_gdrn.main, ["--config", "configs/gdrn/lm_base.py",
                          "--eval-only"] + opts, device)
    t = ev["tables"]
    n = int(sum(v["n"] for k, v in t.items() if k != "avg"))
    require(n == 2 * SYN_IMAGES, "V2 test_gdrn: every ROI scored", n)
    require(all(np.isfinite(list(v.values())).all() for v in t.values()),
            "V2 test_gdrn: non-finite table", t)

    cfg = apply_overrides(load_config("configs/gdrn/lm_base.py"), opts[1:])
    ds, _, _ = train_gdrn.build_dataset(cfg, train=False, device=device)
    model = ge.build_gdrn(cfg, device, seed=cfg.seed)
    require(train_gdrn.load_latest_weights(train_gdrn.ckpt_dir(cfg), model),
            "V2 checkpoint")
    o = cfg.model.output_res
    gt = {"ransac": [], "iterative": []}
    pred = {"ransac": [], "iterative": []}
    worst = {"rot_deg": 0.0, "t_rel": 0.0, "fit_ratio": 0.0}
    small = []
    for bi, batch in enumerate(ds.batches(cfg.solver.ims_per_batch)):
        if bi == 0:
            with torch.no_grad(), ge.autocast(cfg, device):
                maps = model(*ge.model_inputs(to_device(batch, device)),
                             forward_mode="geo")
            coor = maps["coor"].float().cpu().numpy()
            prob = get_mask_prob(maps["mask_logits"].float(),
                                 cfg.model.loss.mask_loss_type)[..., 0]
            prob = prob.cpu().numpy()
        for i in np.nonzero(batch["_valid"])[0]:
            side = o / float(batch["resize_ratio"][i])
            args = (batch["roi_extent"][i], batch["roi_center"][i], side,
                    batch["roi_cam"][i])
            Rg, tg = batch["gt_rot"][i], batch["gt_trans"][i]
            for kind, ransac in (("ransac", True), ("iterative", False)):
                t0 = time.perf_counter()
                res_gt = pnp_from_xyz_mask(batch["gt_xyz"][i],
                                           batch["gt_mask_obj"][i], *args,
                                           ransac=ransac)
                gt[kind].append(time.perf_counter() - t0)
                require(res_gt is not None, "PnP on GT labels: no pose", i)
                R, tv = res_gt
                fit = pnp_fit_rms(batch["gt_xyz"][i], batch["gt_mask_obj"][i],
                                  *args, R, tv)
                fit_gt = pnp_fit_rms(batch["gt_xyz"][i],
                                     batch["gt_mask_obj"][i], *args, Rg, tg)
                e_rot = rot_err_deg(R, Rg)
                e_t = float(np.linalg.norm(tv - tg) / tg[2])
                if side < PNP_MIN_SIDE:
                    small.append({"side_px": side, "solver": kind,
                                  "rot_deg": e_rot, "t_rel": e_t,
                                  "fit_px": fit, "fit_gt_px": fit_gt})
                else:
                    worst["rot_deg"] = max(worst["rot_deg"], e_rot)
                    worst["t_rel"] = max(worst["t_rel"], e_t)
                    worst["fit_ratio"] = max(worst["fit_ratio"],
                                             fit / fit_gt)
                    require(fit <= PNP_FIT_SLACK * fit_gt
                            and e_rot <= PNP_MAX_DEG
                            and e_t <= PNP_MAX_T_REL, "PnP on GT labels",
                            kind, i, fit, fit_gt, e_rot, e_t)
                if bi or i >= PNP_PRED_ROIS:
                    continue
                t0 = time.perf_counter()
                res_p = pnp_from_xyz_mask(coor[i], prob[i], *args,
                                          ransac=ransac)
                pred[kind].append((time.perf_counter() - t0, res_p is None))
                require(res_p is None or (np.isfinite(res_p[0]).all()
                                          and np.isfinite(res_p[1]).all()),
                        "PnP on predicted maps: non-finite pose", kind, i)
    n_gt = len(gt["ransac"])
    require(n_gt == 2 * SYN_IMAGES, "PnP on GT labels: ROIs", n_gt)
    ms = lambda v: float(np.median(v) * 1e3)
    return {"config": "gdrn_lm_base + V2_OPTS", "opts": list(V2_OPTS),
            "batch": 24, "iterations": V2_TRAIN_ITERS, "train_wall_s": wall,
            "last_losses": loss_rows(rows)[-1],
            **{f"train_{k}": v for k, v in loop_split(res, 24, rows).items()},
            "eval_rois": n, "eval_wall_s": ev_wall, "avg": t["avg"],
            **{f"eval_{k}": v for k, v in per_batch(ev["timings"], n).items()},
            "pnp_gt_rois": n_gt, "pnp_gt_worst": worst,
            "pnp_gt_small_crops": small,
            "pnp_gt_ms_per_roi": {k: ms(v) for k, v in gt.items()},
            "pnp_pred_ms_per_roi": {k: ms([a for a, _ in v])
                                    for k, v in pred.items()},
            "pnp_pred_none": {k: int(sum(b for _, b in v))
                              for k, v in pred.items()},
            "pnp_limits": {"rot_deg": PNP_MAX_DEG, "t_rel": PNP_MAX_T_REL,
                           "fit_slack": PNP_FIT_SLACK}}


# ---------------------------------------------------------------------------
# phases 30-34: the native FPS, the checkpoint converter, the LAB modes, a
# traced step, the sharded path on one card (PR 13)
# ---------------------------------------------------------------------------

FPS_KS = (64, 512)                # the loader's n_regions and n_points
FPS_SUBDIV = 7                    # icosphere of 163,842 vertices
FPS_CLOUD = 50000                 # random cloud (no ties)
TOL_CONVERT = 1e-5                # converted fixtures on the card, fp32, TF32
                                  # off, vs the reference PyTorch outputs:
                                  # of each output's largest magnitude (at
                                  # least 1; FlowNetS' reach 230)
MICRO_FLOWNET = (8, 12, 16, 16, 16, 24)   # the golden fixture's widths
LAB_MODES = ("surrogate", "split_grad", "pixel_split")
LAB_TIMED_STEPS = 5               # bf16 steps timed in each LAB mode
TRACE_DIR = os.path.join(SYN_DIR, "trace")
FSDP_BATCH = 4                    # stage-I images of the sharded-path check
FSDP_STEPS = 3                    # the first untimed


def run_fps(root):
    """Phase 30: the native FPS (csrc/fps.c, one thread) against fps_numpy, bit
    for bit, on the icosphere at subdivision FPS_SUBDIV, the synthetic
    set's meshes (phase 16) and a random cloud, at k in FPS_KS, from the
    centroid; both timed on the host (ms, one call each after a warm
    call)."""
    import glob
    from self6dpp_tpu_torch.data.meshes import load_ply, make_icosphere
    from self6dpp_tpu_torch.ops import fps
    clouds = {f"icosphere{FPS_SUBDIV}": make_icosphere(
        subdivisions=FPS_SUBDIV)[0]}
    for path in sorted(glob.glob(os.path.join(root, "lm", "models",
                                              "*.ply"))):
        clouds[os.path.basename(path)] = load_ply(path)["verts"]
    clouds[f"cloud{FPS_CLOUD}"] = np.random.default_rng(SEED).standard_normal(
        (FPS_CLOUD, 3)).astype(np.float32)
    require(len(clouds) >= 4, "FPS: the synthetic set's meshes", sorted(clouds))
    fps.farthest_point_sampling(clouds[f"cloud{FPS_CLOUD}"], 8)
    out = {"cases": {}}
    for name, pts in clouds.items():
        pts = np.ascontiguousarray(pts, np.float32)
        for k in FPS_KS:
            t0 = time.perf_counter()
            got = fps.farthest_point_sampling(pts, k)
            t1 = time.perf_counter()
            want = fps.fps_numpy(pts, k)
            t2 = time.perf_counter()
            require(np.array_equal(got, want), "FPS native vs numpy", name, k)
            out["cases"][f"{name}/k{k}"] = {
                "points": len(pts), "native_ms": (t1 - t0) * 1e3,
                "numpy_ms": (t2 - t1) * 1e3}
    return out


def run_converter(device):
    """Phase 31: the three golden fixtures (reference state dicts in the
    reference's layout) through the port's converter into .npz, loaded by
    load_params_npz into the port's modules on the card, run in float32
    with TF32 off: every reference output within TOL_CONVERT of its
    largest magnitude."""
    from self6dpp_tpu_torch import config as tc
    from self6dpp_tpu_torch.engine.checkpoint import load_params_npz
    from self6dpp_tpu_torch.models.backbones.flownet import FlowNetS
    from self6dpp_tpu_torch.models.backbones.resnet import ResNetBackbone
    from self6dpp_tpu_torch.models.heads.conv_pnp_net import ConvPnPNet
    from self6dpp_tpu_torch.models.heads.top_down_head import TopDownGeoHead
    from self6dpp_tpu_torch.tools import convert_torch_weights as tool
    fix = os.path.join(HERE, "tests", "fixtures")
    out_dir = os.path.join(SYN_DIR, "convert")
    os.makedirs(out_dir, exist_ok=True)

    def raw(name, scope=""):
        f = np.load(os.path.join(fix, f"golden_{name}.npz"))
        return f, {scope + k[4:]: torch.from_numpy(f[k]) for k in f.files
                   if k.startswith("raw.")}

    def convert(name, sd, *argv):
        src, dst = (os.path.join(out_dir, f"{name}{e}") for e in (".pth",
                                                                  ".npz"))
        torch.save(sd, src)
        require(tool.main(["--src", src, "--out", dst, *argv]) == 0,
                "converter", name)
        return dst

    def nchw(a):
        return torch.from_numpy(a).permute(0, 3, 1, 2).to(device)

    def err(got, want, nhwc=True):
        """max |got - want| over max(max |want|, 1)"""
        g = got.permute(0, 2, 3, 1) if nhwc else got
        d = np.abs(g.float().cpu().numpy() - want).max()
        return float(d / max(np.abs(want).max(), 1.0))

    errs = {}
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        f, sd = raw("micro_resnet")
        net = load_params_npz(convert("micro_resnet", sd, "--kind", "resnet",
                                      "--arch", "micro"),
                              ResNetBackbone("micro")).to(device).eval()
        with torch.no_grad():
            errs["expected"] = err(net(nchw(f["input"])), f["expected"])
        f, sd = raw("micro_flownet")
        net = load_params_npz(
            convert("micro_flownet", sd, "--kind", "flownet"),
            FlowNetS(widths=MICRO_FLOWNET, out_flow_level="flow4"))
        with torch.no_grad():
            outs = net.to(device).eval()(nchw(f["input"]))
        for key, got in zip(("expected_out6", "expected_concat4",
                             "expected_flow4"), outs):
            errs[key] = err(got, f[key])
        f, sd = raw("geo_pnp")
        _, bb = raw("micro_resnet", "backbone.")
        path = convert("gdrn", {**bb, **sd}, "--kind", "gdrn", "--arch",
                       "micro")
        geo = TopDownGeoHead(tc.GeoHeadConfig(feat_dim=16, num_gn_groups=4,
                                              num_regions=4, xyz_bin=1),
                             in_channels=24)
        pnp = ConvPnPNet(tc.PnPNetConfig(featdim=16, num_gn_groups=4,
                                         denormalize_by_extent=False),
                         in_channels=8, in_res=16)
        load_params_npz(path, geo, prefix="geo_head")
        load_params_npz(path, pnp, prefix="pnp_net")
        xp = torch.from_numpy(f["input_pnp"]).to(device)
        with torch.no_grad():
            maps = geo.to(device).eval()(nchw(f["input_geo"]))
            rot, t = pnp.to(device).eval()(xp[..., :3], xp[..., 3:])
        got = torch.cat([maps[k] for k in ("mask", "xyz", "region")], -1)
        errs["expected_geo"] = err(got, f["expected_geo"], nhwc=False)
        errs["expected_rot"] = err(rot, f["expected_rot"], nhwc=False)
        errs["expected_t"] = err(t, f["expected_t"], nhwc=False)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    require(len(errs) == 7 and max(errs.values()) <= TOL_CONVERT,
            "converted fixtures on the card", errs)
    return {"max_err_of_scale": errs, "tol": TOL_CONVERT}


def lab_mode_step(cfg, mode, built):
    """build_self_train_step for lab_impl `mode` on `built`'s model."""
    from self6dpp_tpu_torch.engine import self_engine as se
    mcfg = dataclasses.replace(cfg, self_sup=dataclasses.replace(
        cfg.self_sup, lab_impl=mode))
    return se.build_self_train_step(mcfg, built[0], built[3])


def run_lab_modes(device):
    """Phase 32: the flagship stage-II step (build_stage2, 8 ROIs) in
    float32 (TF32 off, cuDNN deterministic) in lab_impl 'pallas' and in
    each of LAB_MODES from one state (after one 'pallas' step from the
    seeded weights): losses within TOL_S2_LOSS and parameters within
    TOL_S2_PARAMS of the 'pallas' step's, the LAB term among them, the
    step moving the parameters past S2_MOVED x TOL_S2_PARAMS; then
    LAB_TIMED_STEPS bf16 steps in each mode and in 'pallas' after a
    warm-up, timed (timed_steps), with their launches."""
    from self6dpp_tpu_torch.engine import self_engine as se
    cfg32 = stage2_cfg("float32", lr=S2_LR)
    require(cfg32.self_sup.lab_lw > 0 and cfg32.self_sup.lab_impl == "pallas",
            "the flagship's LAB term", cfg32.self_sup)
    built = se.build_stage2(cfg32, S2_BATCH, device, seed=SEED)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = {}
    try:
        # the held step is the second: the first moves the parameters
        # little (the teacher is the student), as in phase 6
        lab_mode_step(cfg32, "pallas", built)(built[1], built[2])
        torch.cuda.synchronize()
        snap = snapshot(built[1])
        for mode in ("pallas",) + LAB_MODES:
            # a copy: the solver's load_state_dict keeps the tensors it is
            # given, and the step updates its moments in place
            restore(built[1], copy.deepcopy(snap))
            _, m = lab_mode_step(cfg32, mode, built)(built[1], built[2])
            torch.cuda.synchronize()
            runs[mode] = ({k: float(v) for k, v in m.items()},
                          params_of(built[0]))
    finally:
        torch.backends.cudnn.deterministic = det
    ref_m, ref_p = runs["pallas"]
    init = snap["model"]
    out = {"fp32": {}, "bf16": {}}
    for mode in LAB_MODES:
        m, p = runs[mode]
        d = {"loss_rel_err": loss_err(m, ref_m),
             "params_max_abs": max_abs_diff(p, ref_p),
             "loss_color_ab_obj": m["loss_color_ab_obj"]}
        require(set(m) == set(ref_m) and d["loss_rel_err"] <= TOL_S2_LOSS
                and d["params_max_abs"] <= TOL_S2_PARAMS,
                "LAB mode vs pallas, fp32", mode, d)
        out["fp32"][mode] = d
    moved = max((ref_p[k] - init[k]).abs().max().item() for k in ref_p)
    require(moved > S2_MOVED * TOL_S2_PARAMS, "the LAB-mode steps moved",
            moved)
    out["fp32_params_moved_max_abs"] = moved
    del built, snap, runs
    cfg = stage2_cfg("bfloat16")
    built = se.build_stage2(cfg, S2_BATCH, device, seed=SEED)
    snap = snapshot(built[1])
    for mode in ("pallas",) + LAB_MODES:
        restore(built[1], copy.deepcopy(snap))
        step = lab_mode_step(cfg, mode, built)
        step(built[1], built[2])
        torch.cuda.synchronize()
        zero_kernel_launches()
        times, phases, metrics = timed_steps(step, built[1], built[2],
                                             LAB_TIMED_STEPS)
        launches = kernel_launches()
        for m in metrics:
            require(all(torch.isfinite(v).item() for v in m.values()),
                    "non-finite LAB-mode loss", mode, m)
        out["bf16"][mode] = {"ms_per_step": float(np.median(times)),
                             "ms_range": [min(times), max(times)],
                             "launches_per_step": {
                                 k: v / LAB_TIMED_STEPS
                                 for k, v in launches.items()}}
    del built, snap
    torch.cuda.empty_cache()
    return out


def kernel_symbols():
    """{B1, B2, B3: their CUDA kernels' names} from the built libraries'
    ptxas logs."""
    from self6dpp_tpu_torch.kernels import build
    return {b: sorted(build.resources(src)) for b, src in (
        ("B1", "fine_raster_fwd"), ("B2", "fine_raster_bwd"),
        ("B3", "lab_value_grad"))}


def run_trace(device):
    """Phase 33: one flagship bf16 stage-II step under utils.profiling.
    trace into TRACE_DIR (git-ignored): the trace file names the kernels of
    B1, B2 and B3 among its device events; its size, and the step's ms
    inside and outside the trace (host clock, after a synchronize)."""
    import glob
    import shutil
    from self6dpp_tpu_torch.engine import self_engine as se
    from self6dpp_tpu_torch.utils import profiling
    cfg = stage2_cfg("bfloat16")
    model, state, batch, lpips = se.build_stage2(cfg, S2_BATCH, device,
                                                 seed=SEED)
    step = se.make_self_train_step(cfg, model, lpips)
    outside = []
    for _ in range(4):
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        outside.append((time.perf_counter() - t0) * 1e3)
    shutil.rmtree(TRACE_DIR, ignore_errors=True)
    zero_kernel_launches()
    t0 = time.perf_counter()
    with profiling.trace(TRACE_DIR) as prof:
        with profiling.span("stage2_step"):
            step(state, batch)
        torch.cuda.synchronize()
    inside = (time.perf_counter() - t0) * 1e3
    launches = kernel_launches()
    files = glob.glob(os.path.join(TRACE_DIR, "*.pt.trace.json"))
    require(len(files) == 1, "one trace file", files)
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events
             if e.get("cat") in ("kernel", "Kernel")}
    found = {b: [k for k in ks if any(k in n for n in names)]
             for b, ks in kernel_symbols().items()}
    require(all(found.values()), "the trace names B1, B2 and B3", found,
            sorted(names)[:20])
    require(launches == S2_LAUNCHES, "one B1, B2, B3 launch in the traced step",
            launches)
    device_ms = sum(e.get("dur", 0) for e in events
                    if e.get("cat") in ("kernel", "Kernel")) / 1e3
    del model, state, step
    torch.cuda.empty_cache()
    return {"trace_bytes": os.path.getsize(files[0]),
            "kernel_events": sum(1 for e in events
                                 if e.get("cat") in ("kernel", "Kernel")),
            "kernels_named": found, "device_kernel_ms": device_ms,
            "step_ms_traced": inside,
            "step_ms_untraced": float(np.median(outside[1:])),
            "profiler_rows": len(prof.key_averages())}


def run_fsdp_one_card(device):
    """Phase 34: the sharded code path at the grid (1, 1) on one card:
    FSDP_STEPS float32 stage-I steps (the last ones timed) at gdrn_flagship (FSDP_BATCH images,
    BN in train mode, Ranger, the EMA; TF32 off, cuDNN deterministic),
    unsharded and through parallel/mesh.py::shard_state(force=True) (every
    leaf of 2^16 elements or more held as a one-rank shard, gathered by
    the forward hook, its gradient reduced to the shard, the solver on
    the shards): parameters, EMA and solver state bit for bit. One card
    cannot host two NCCL ranks; the multi-rank path is held on the CPU
    (tests/test_torch_fsdp.py, gloo)."""
    from self6dpp_tpu_torch.config import gdrn_flagship
    from self6dpp_tpu_torch.data.synthetic import make_gdrn_batch
    from self6dpp_tpu_torch.engine import gdrn_engine as ge
    from self6dpp_tpu_torch.engine.deepim_engine import to_device
    from self6dpp_tpu_torch.parallel import mesh
    cfg = gdrn_flagship()
    cfg = dataclasses.replace(
        cfg, dist=dataclasses.replace(cfg.dist, compute_dtype="float32"),
        solver=dataclasses.replace(cfg.solver, ims_per_batch=FSDP_BATCH,
                                   reference_bs=FSDP_BATCH))
    batch = to_device(make_gdrn_batch(cfg, FSDP_BATCH, seed=SEED), device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs, info = [], {}
    try:
        for sharded in (False, True):
            model = ge.build_gdrn(cfg, device, seed=SEED)
            state = ge.init_state(cfg, model)
            if sharded:
                grid = mesh.make_mesh(cfg.dist)
                mesh.shard_state(state, grid, force=True)
                fs = state.fsdp
                info.update(grid=list(grid.shape),
                            sharded_leaves=len(fs.student.entries),
                            leaves=len(list(model.parameters())),
                            released=all(p.numel() == 0 for p, _, _ in
                                         fs.student.entries.values()))
            step = ge.make_train_step(cfg, model)
            step(state, batch)             # untimed: cuDNN's first calls
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(FSDP_STEPS - 1):
                step(state, batch)
            torch.cuda.synchronize()
            info[f"ms_per_step_{'sharded' if sharded else 'plain'}"] = (
                time.perf_counter() - t0) * 1e3 / (FSDP_STEPS - 1)
            with mesh.gathered(state):
                snap = {"model": params_of(model),
                        "teacher": params_of(state.teacher)}
            snap["opt"] = state.opt.state_dict()["state"]
            runs.append(snap)
            del model, state, step
    finally:
        torch.backends.cudnn.deterministic = det
    require(info["sharded_leaves"] > 0 and info["released"],
            "the sharded branch was taken", info)
    a, b = runs
    diff = {"model": max_abs_diff(a["model"], b["model"]),
            "teacher": max_abs_diff(a["teacher"], b["teacher"]),
            "opt": max((a["opt"][i][k] - b["opt"][i][k]).abs().max().item()
                       for i in a["opt"] for k in a["opt"][i]
                       if torch.is_tensor(a["opt"][i][k])
                       and a["opt"][i][k].ndim)}
    require(all(v == 0 for v in diff.values()),
            "sharded path at (1, 1) vs unsharded, bit for bit", diff)
    torch.cuda.empty_cache()
    return {**info, "max_abs_diff": diff, "steps": FSDP_STEPS,
            "batch": FSDP_BATCH}


# ---- phase 35: the geo head's align-corners 2x upsample ----

# (N, C, h, w): the stage-II step's two bilinear up-blocks at 128 ROIs and
# feat_dim 256 (timed), then odd sizes (scalar stores) and a plane cut into
# bands (checked only)
UPSAMPLE_TIMED = ((128, 256, 16, 16), (128, 256, 32, 32))
UPSAMPLE_CHECKED = ((2, 3, 5, 7), (3, 4, 16, 32), (2, 3, 40, 72))
UPSAMPLE_BF16_REL = 2.0 ** -8     # backward: one bf16 rounding of the f64 sums
UPSAMPLE_SUM_REL = 2.0 ** -16     # plus float32's sums, of sum |terms|
OPS_UP_FWD = 9                    # per output: 6 products, 3 sums
OPS_UP_BWD = 6                    # per output: 3 products, 3 sums


def check_upsample(shape, dtype, device, seed=SEED):
    """The kernels at one shape and dtype against the plain versions on the
    card: the forward bit for bit (also through the dispatcher), the
    backward equal to the plain twin and within one rounding of the same
    sums in float64 (the tolerance of tests/test_torch_upsample.py), and
    its largest gap to autograd of the plain forward."""
    from self6dpp_tpu_torch.models import layers as L
    from self6dpp_tpu_torch.ops import upsample_cuda as UC
    n, c, h, w = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(shape, generator=gen, device=device).to(dtype)
    g = torch.randn((n, c, 2 * h, 2 * w), generator=gen,
                    device=device).to(dtype)
    tab = L.upsample_tables(h, w, dtype, device)
    y = UC.upsample2x(x, tab)
    gin = UC.upsample2x_bwd(g, tab)
    xr = x.clone().requires_grad_(True)
    yp = L.upsample2x_align_corners_plain(xr)
    yp.backward(g, retain_graph=True)   # kept for phase 35's timing
    torch.cuda.synchronize()
    ref = L.upsample2x_align_corners_bwd_plain(g.double(), tab)
    mag = L.upsample2x_align_corners_bwd_plain(g.double().abs(), tab)
    rel = UPSAMPLE_BF16_REL if dtype == torch.bfloat16 else 2.0 ** -24
    err = (gin.double() - ref).abs()
    v = {"fwd_same_bits": same_bits(y.float(), yp.detach().float()),
         "dispatcher_same_bits": bool(torch.equal(
             L.upsample2x_align_corners(x), y)),
         "bwd_equals_plain_twin": bool(torch.equal(
             gin, L.upsample2x_align_corners_bwd_plain(g, tab))),
         "bwd_within_rounding": bool((err <= rel * ref.abs()
                                      + UPSAMPLE_SUM_REL * mag).all()),
         "bwd_max_abs_err_vs_f64": float(err.max()),
         "bwd_max_rel_err_vs_f64": float((err / ref.abs().clamp_min(
             1e-30)).max()),
         "bwd_max_abs_diff_vs_plain_autograd": float(
             (gin.double() - xr.grad.double()).abs().max()),
         "plain_autograd_max_abs_err_vs_f64": float(
             (xr.grad.double() - ref).abs().max())}
    require(v["fwd_same_bits"] and v["dispatcher_same_bits"],
            "upsample forward vs plain, bit for bit", shape, dtype, v)
    require(v["bwd_equals_plain_twin"] and v["bwd_within_rounding"],
            "upsample backward vs its twin and float64", shape, dtype, v)
    return v, (x, g, xr, yp, tab)


def check_upsample_kernels(device):
    """Phase 35: check_upsample at UPSAMPLE_TIMED and UPSAMPLE_CHECKED in
    bf16 and float32; at UPSAMPLE_TIMED each kernel timed (cuda_ms,
    graph_ms) beside the plain path (the forward; autograd's backward of
    it) and F.interpolate(..., align_corners=True) (library_ms: the port
    never calls it), with its byte bound (one read, one write)."""
    import torch.nn.functional as F
    from self6dpp_tpu_torch.kernels import build
    from self6dpp_tpu_torch.models import layers as L
    from self6dpp_tpu_torch.ops import upsample_cuda as UC
    out = {"resources": build.resources("upsample2x")}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        for shape in UPSAMPLE_CHECKED:
            v, _ = check_upsample(shape, dtype, device)
            out[f"{dname}_{'x'.join(map(str, shape))}"] = v
        for shape in UPSAMPLE_TIMED:
            v, (x, g, xr, yp, tab) = check_upsample(shape, dtype, device)
            n_in, n_out = x.numel(), g.numel()
            nbytes = (n_in + n_out) * x.element_size()
            xl = x.clone().requires_grad_(True)
            yl = F.interpolate(xl, scale_factor=2, mode="bilinear",
                               align_corners=True)

            def plain_fwd():
                with torch.no_grad():
                    L.upsample2x_align_corners_plain(x)

            def lib_fwd():
                with torch.no_grad():
                    F.interpolate(x, scale_factor=2, mode="bilinear",
                                  align_corners=True)
            rows = {
                "fwd": {"ms": cuda_ms(lambda: UC.upsample2x(x, tab)),
                        "graph_ms": graph_ms(lambda: UC.upsample2x(x, tab)),
                        "plain_ms": cuda_ms(plain_fwd, **PLAIN_TIMING),
                        "library_ms": cuda_ms(lib_fwd),
                        "max_abs_err": 0.0 if v["fwd_same_bits"] else None,
                        **bound(nbytes, OPS_UP_FWD * n_out)},
                "bwd": {"ms": cuda_ms(lambda: UC.upsample2x_bwd(g, tab)),
                        "graph_ms": graph_ms(
                            lambda: UC.upsample2x_bwd(g, tab)),
                        "plain_ms": cuda_ms(lambda: torch.autograd.grad(
                            yp, xr, g, retain_graph=True), **PLAIN_TIMING),
                        "library_ms": cuda_ms(lambda: torch.autograd.grad(
                            yl, xl, g, retain_graph=True)),
                        "max_abs_err": v["bwd_max_abs_diff_vs_plain_autograd"],
                        **bound(nbytes, OPS_UP_BWD * n_out)}}
            for r in rows.values():
                r["graph_over_bound"] = r["graph_ms"] / r["bound_ms"]
            out[f"{dname}_{'x'.join(map(str, shape))}"] = {**v, **rows}
            del x, g, xr, yp, xl, yl
            torch.cuda.empty_cache()
    return out


def upsample_kernel_lines(k35, launches):
    """The `kernels` entries of the upsample's forward and backward at the
    stage-II step's shapes, launches from phase 7's steps."""
    out = []
    for key, name in (("fwd", "upsample2x"), ("bwd", "upsample2x_bwd")):
        for dname in ("bfloat16", "float32"):
            for shape in UPSAMPLE_TIMED:
                d = k35[f"{dname}_{'x'.join(map(str, shape))}"][key]
                out.append({
                    "name": f"{name}[{dname},{shape[2]}x{shape[3]}]",
                    "route": "cuda",
                    "source": "self6dpp_tpu_torch/csrc/upsample2x.cu",
                    "replaces": None, "launches": launches[name],
                    "max_abs_err": d["max_abs_err"], "ms": d["ms"],
                    "graph_ms": d["graph_ms"], "plain_ms": d["plain_ms"],
                    "bound_ms": d["bound_ms"], "bound_by": d["bound_by"],
                    "library_ms": d["library_ms"]})
    return out


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def main(record_path: str = "") -> int:
    """Runs every phase; record_path, when given, also gets the `record`
    line's JSON (the line is longer than a terminal's tail keeps)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from self6dpp_tpu_torch.config import lm_flownet
    from self6dpp_tpu_torch.engine import self_engine as se
    from self6dpp_tpu_torch.kernels import build
    from self6dpp_tpu_torch.ops import raster_cuda as RC

    device = torch.device("cuda")
    cfg = lm_flownet()
    cand_checks = {"inputs": 0}
    card = card_line()
    t_start = t0 = time.perf_counter()
    libs = build.build_all()
    build_s = time.perf_counter() - t0
    print(f"build: {sorted(libs)} in {build_s:.2f} s", flush=True)
    resources = {n: build.resources(n) for n in libs}
    K = cfg.renderer.faces_per_tile
    resources["fine_raster_fwd"]["dynamic_smem_bytes"] = RC.fwd_smem_bytes(K)
    resources["fine_raster_bwd"]["dynamic_smem_bytes"] = (
        RC.bwd_smem_bytes(K) - RC.bwd_smem_bytes(0))
    print(f"kernel resources (ptxas): {json.dumps(resources)}", flush=True)

    meshes = make_meshes()
    b = cfg.solver.ims_per_batch
    with cand_order_checked(cand_checks):
        requests = [make_request(SEED + i, meshes, cfg, device, b)
                    for i in range(1 + REQUESTS)]
    torch.cuda.synchronize()

    clock = {}
    t0 = time.perf_counter()
    kernel, kdetail = check_kernel(cfg, requests[0])
    print(f"kernel vs plain: {json.dumps(kdetail['variants'])}", flush=True)
    with cand_order_checked(cand_checks):
        ref32, pdetail = check_path_fp32(cfg, device, requests[0])
    print(f"fp32 path: {json.dumps(pdetail)}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    launches, sdetail = serve(cfg, device, requests, ref32)
    kernel["launches"] = launches
    d = cfg.deepim
    deepim_path = {
        "config": cfg.exp_name, "batch": b,
        "input_hw": [d.input_h, d.input_w], "frame_hw": list(FRAME_HW),
        "faces": int(meshes[1].shape[0]), "iterations": d.n_iter_test,
        "compute_dtype": cfg.dist.compute_dtype,
        "requests": sdetail["requests"],
        "ms_per_request": sdetail["ms_per_request"],
        "render_share": sdetail["render_share"],
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    clock["deepim_phases_2_4_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    s2 = stage2_cfg("bfloat16")
    cfg32 = stage2_cfg("float32", lr=S2_LR, base=s2)
    s2_built = se.build_stage2(cfg32, S2_BATCH, device, seed=SEED)
    with cand_order_checked(cand_checks):
        s2_inputs = stage2_inputs(cfg32, *s2_built[1:])
    torch.cuda.synchronize()
    clock["stage2_phase5_build_and_inputs_s"] = time.perf_counter() - t0
    k5 = check_stage2_kernels(cfg32, s2_inputs)
    k5["cull_scene"] = check_cull_scene(device)
    print("stage-II kernels vs plain: " + json.dumps(
        {k: v for k, v in k5.items()}), flush=True)
    lab = s2_inputs[3]          # the masked render and image, for phase 8
    del s2_inputs
    clock["stage2_phase5_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with cand_order_checked(cand_checks):
        s2_ref32, s2_fp32 = check_stage2_fp32(cfg32, device, S2_BATCH,
                                              s2_built)
    del s2_built
    print(f"stage-II fp32 steps: {json.dumps(s2_fp32)}", flush=True)
    clock["stage2_phase6_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    s2_launches, s2_steps, s2_partial = time_stage2(s2, device, S2_BATCH,
                                                    s2_ref32)
    print(f"stage-II bf16 steps: {json.dumps(s2_steps)}", flush=True)
    print(f"stage-II bf16 partial steps (no LPIPS, MS-SSIM, chamfer): "
          f"{json.dumps(s2_partial)}", flush=True)
    clock["stage2_phase7_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    k8 = check_sign_kernels(lab)
    print(f"probe kernels vs plain: {json.dumps(k8)}", flush=True)
    clock["probe_kernels_phase8_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    probe_launches, probe = run_lab_probe()
    print(f"LAB opaque probe: {json.dumps(probe)}", flush=True)
    clock["probe_phase9_s"] = time.perf_counter() - t0
    stage2_path = {
        "config": s2.exp_name, "batch": S2_BATCH,
        "input_res": s2.model.input_res, "output_res": s2.model.output_res,
        "backbone": s2.model.backbone.name,
        "classes": s2.model.num_classes, "faces": 1280,
        "tile_px": s2.renderer.tile_px,
        "faces_per_tile": s2.renderer.faces_per_tile,
        "compute_dtype": s2.dist.compute_dtype,
        "steps": s2_steps["steps"], "ms_per_step": s2_steps["ms_per_step"],
        "phase_ms_median": s2_steps["phase_ms_median"],
        "launches_per_step": {k: v / s2_steps["steps"]
                              for k, v in s2_launches.items()},
        "peak_mem_gib": s2_steps["peak_mem_gib"],
        "partial_step_ms": s2_partial["ms_per_step"]}
    probe_path = {k: v["ms_per_step"] for k, v in probe.items()}

    from self6dpp_tpu_torch.config import (gdrn_flagship, gdrn_lm_masknormvf,
                                           stage2_masknormvf,
                                           stage2_refined_flagship)
    t0 = time.perf_counter()
    s1_cpu = check_stage1_card_vs_cpu(device)
    print(f"stage-I fp32 card vs CPU: {json.dumps(s1_cpu)}", flush=True)
    s1 = time_stage1(gdrn_flagship(), device, S1_BATCH, S1_TIMED_STEPS)
    print(f"stage-I bf16 steps: {json.dumps(s1)}", flush=True)
    s1_vf = time_stage1(gdrn_lm_masknormvf(), device, S1_BATCH, S1_VF_STEPS)
    require({"loss_vf_vis", "loss_vf_full", "loss_norm"}
            <= set(s1_vf["last_losses"]), "gdrn_lm_masknormvf vf/norm terms",
            sorted(s1_vf["last_losses"]))
    print(f"stage-I MaskNormVF bf16 steps: {json.dumps(s1_vf)}", flush=True)
    clock["stage1_phase10_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    s3 = stage2_cfg("bfloat16", base=stage2_masknormvf())
    s3_32 = stage2_cfg("float32", lr=S2_LR, base=s3)
    s3_built = se.build_stage2(s3_32, S2_BATCH, device, seed=SEED)
    with cand_order_checked(cand_checks):
        nr = check_normal_render(s3_32, s3_built)
        print(f"normal render B1 vs plain: {json.dumps(nr)}", flush=True)
        _, s3_fp32 = check_stage2_fp32(s3_32, device, S2_BATCH, s3_built)
    del s3_built
    require({"loss_vf", "loss_norm"} <= set(s3_fp32["losses_kernel"][0])
            and {"loss_vf", "loss_norm"} <= set(s3_fp32["losses_plain"][0]),
            "MaskNormVF fp32 steps: vf/norm terms")
    print(f"MaskNormVF fp32 steps: {json.dumps(s3_fp32)}", flush=True)
    s3_steps = time_masknormvf(s3, device, S2_BATCH, S3_TIMED_STEPS)
    print(f"MaskNormVF bf16 steps: {json.dumps(s3_steps)}", flush=True)
    clock["masknormvf_phase11_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    gs = time_geo_synsup(s2, device, S2_BATCH, GEO_TIMED_STEPS)
    print(f"geo and synsup steps: {json.dumps(gs)}", flush=True)
    clock["geo_synsup_phase12_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    di_batch = deepim_train_batch(requests[0])
    with cand_order_checked(cand_checks):
        di_fp32 = check_deepim_train_fp32(cfg, device, di_batch)
        print(f"DeepIM train fp32 steps: {json.dumps(di_fp32)}", flush=True)
        di_gt = check_deepim_gt_render(cfg, di_batch)
        print(f"DeepIM GT render B1 vs plain: {json.dumps(di_gt)}", flush=True)
    di_steps = time_deepim_train(cfg, device, di_batch)
    print(f"DeepIM train bf16 steps: {json.dumps(di_steps)}", flush=True)
    clock["deepim_train_phase13_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    s4 = stage2_cfg("bfloat16", base=stage2_refined_flagship())
    s4_32 = stage2_cfg("float32", lr=S2_LR, base=s4)
    s4_built = se.build_stage2(s4_32, S2_BATCH, device, seed=SEED)
    with cand_order_checked(cand_checks):
        repj = check_repj_kernels(s4_32, s4_built)
        print(f"repj B1/B2 vs plain: {json.dumps(repj)}", flush=True)
        _, s4_fp32 = check_stage2_fp32(s4_32, device, S2_BATCH, s4_built,
                                       build_refiner(device, "float32"))
    del s4_built
    require(all({"loss_repj_miou_1", "loss_PM_T_repj"} <= set(m)
                for m in s4_fp32["losses_kernel"] + s4_fp32["losses_plain"]),
            "refined fp32 steps: repj terms")
    print(f"refined stage-II fp32 steps: {json.dumps(s4_fp32)}", flush=True)
    s4_steps = time_stage2_refined(s4, device, S2_BATCH)
    print(f"refined stage-II bf16 steps: {json.dumps(s4_steps)}", flush=True)
    clock["stage2_refined_phase14_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    di_cpu = check_deepim_card_vs_cpu(cfg, device, requests[1])
    print(f"DeepIM train fp32 card vs CPU: {json.dumps(di_cpu)}", flush=True)
    clock["deepim_card_vs_cpu_phase15_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    syn_root, syn = make_synthetic_sets(device)
    print(f"synthetic BOP set: {json.dumps(syn)}", flush=True)
    png = time_png_decode()
    print(f"PNG decode at LM's frame: {json.dumps(png)}", flush=True)
    clock["synthetic_set_phase16_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    label_inputs, gdrn_test = run_test_gdrn(syn_root, device)
    b1_label = b1_at(label_inputs, "label cache B1")
    del label_inputs
    print(f"test_gdrn: {json.dumps(gdrn_test)}", flush=True)
    print(f"label cache B1 vs plain: {json.dumps(b1_label)}", flush=True)
    clock["test_gdrn_phase17_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    deepim_test = run_test_deepim(syn_root, device)
    print(f"test_deepim: {json.dumps(deepim_test)}", flush=True)
    clock["test_deepim_phase18a_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    vsd_inputs, lm_eval = run_lm_evaluator(meshes, device)
    b1_vsd = b1_at(vsd_inputs, "VSD B1")
    del vsd_inputs
    print(f"LM evaluator: {json.dumps(lm_eval)}", flush=True)
    print(f"VSD B1 vs plain: {json.dumps(b1_vsd)}", flush=True)
    clock["lm_evaluator_phase18b_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ckpt19, train_label_inputs, gdrn_train = run_train_gdrn(syn_root, device)
    b1_train_label = b1_at(train_label_inputs, "train label cache B1")
    del train_label_inputs
    print(f"train_gdrn: {json.dumps(gdrn_train)}", flush=True)
    print(f"train label cache B1 vs plain: {json.dumps(b1_train_label)}",
          flush=True)
    clock["train_gdrn_phase19_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    deepim_train = run_train_deepim(syn_root, device)
    print(f"train_deepim: {json.dumps(deepim_train)}", flush=True)
    clock["train_deepim_phase20_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    k21, self_train = run_train_self6dpp(syn_root, ckpt19, device)
    print(f"train_self6dpp: {json.dumps(self_train)}", flush=True)
    print(f"lm_ss kernels vs plain: {json.dumps(k21)}", flush=True)
    clock["train_self6dpp_phase21_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    yolo_cpu = check_yolo_card_vs_cpu(syn_root, device)
    print(f"YOLOv4 fp32 card vs CPU: {json.dumps(yolo_cpu)}", flush=True)
    yolo = run_detector(syn_root, device)
    print(f"train_yolov4: {json.dumps(yolo)}", flush=True)
    clock["yolov4_phase22_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    jpeg = check_jpeg()
    print(f"JPEG decode: {json.dumps(jpeg)}", flush=True)
    clock["jpeg_phase23_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    k24, textured = run_textured_stage2(device, cand_checks)
    print(f"ycbv_ss textured kernels vs plain: {json.dumps(k24)}", flush=True)
    print(f"ycbv_ss textured steps: {json.dumps(textured)}", flush=True)
    clock["textured_phase24_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    b1_pseudo, pseudo = run_gen_pseudo_poses(syn_root, ckpt19, device)
    print(f"gen_pseudo_poses: {json.dumps(pseudo)}", flush=True)
    print(f"gen_pseudo_poses B1 vs plain: {json.dumps(b1_pseudo)}",
          flush=True)
    clock["gen_pseudo_poses_phase25_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dist_flags = run_dist_flags(syn_root, device)
    print(f"train_gdrn --dist-*: {json.dumps(dist_flags)}", flush=True)
    clock["dist_flags_phase26_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    variants = run_variants_stage1(device)
    clock["variants_stage1_phase27_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    k28, v2_stage2 = run_variant_stage2(device, cand_checks)
    print(f"V2 stage-II kernels vs plain: {json.dumps(k28)}", flush=True)
    print(f"V2 stage-II steps: {json.dumps(v2_stage2)}", flush=True)
    clock["variant_stage2_phase28_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    v2_cli = run_variant_cli(syn_root, device)
    print(f"train_gdrn V2 and PnP: {json.dumps(v2_cli)}", flush=True)
    clock["variant_cli_pnp_phase29_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fps30 = run_fps(syn_root)
    print(f"native FPS vs numpy: {json.dumps(fps30)}", flush=True)
    clock["fps_phase30_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    conv31 = run_converter(device)
    print(f"converted fixtures: {json.dumps(conv31)}", flush=True)
    clock["converter_phase31_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lab32 = run_lab_modes(device)
    print(f"LAB modes: {json.dumps(lab32)}", flush=True)
    clock["lab_modes_phase32_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    trace33 = run_trace(device)
    print(f"traced step: {json.dumps(trace33)}", flush=True)
    clock["trace_phase33_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fsdp34 = run_fsdp_one_card(device)
    print(f"fsdp at (1, 1): {json.dumps(fsdp34)}", flush=True)
    clock["fsdp_phase34_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    k35 = check_upsample_kernels(device)
    print(f"upsample kernels vs plain: {json.dumps(k35)}", flush=True)
    clock["upsample_phase35_s"] = time.perf_counter() - t0
    clock["total_s"] = time.perf_counter() - t_start

    record = {"kernel_detail": kdetail, "serve": sdetail, "fp32_path": pdetail,
              "stage2_kernels": k5, "stage2_fp32": s2_fp32,
              "stage2_steps": s2_steps, "stage2_partial_steps": s2_partial,
              "probe_kernels": k8, "lab_opaque_probe": probe,
              "stage1_card_vs_cpu": s1_cpu, "stage1_steps": s1,
              "stage1_masknormvf_steps": s1_vf, "normal_render": nr,
              "masknormvf_fp32": s3_fp32, "masknormvf_steps": s3_steps,
              "geo_synsup_steps": gs, "deepim_train_fp32": di_fp32,
              "deepim_gt_render": di_gt, "deepim_train_steps": di_steps,
              "repj_kernels": repj, "stage2_refined_fp32": s4_fp32,
              "stage2_refined_steps": s4_steps,
              "deepim_train_card_vs_cpu": di_cpu,
              "synthetic_set": syn, "png_decode": png, "test_gdrn": gdrn_test,
              "label_cache_b1": b1_label, "test_deepim": deepim_test,
              "lm_evaluator": lm_eval, "vsd_b1": b1_vsd,
              "train_gdrn": gdrn_train, "train_label_cache_b1": b1_train_label,
              "train_deepim": deepim_train, "train_self6dpp": self_train,
              "lm_ss_kernels": k21, "yolov4_card_vs_cpu": yolo_cpu,
              "train_yolov4": yolo, "jpeg_decode": jpeg,
              "ycbv_ss_textured_kernels": k24, "ycbv_ss_textured": textured,
              "gen_pseudo_poses": pseudo, "gen_pseudo_poses_b1": b1_pseudo,
              "dist_flags": dist_flags, "variants_stage1": variants,
              "variant_stage2_kernels": k28, "variant_stage2": v2_stage2,
              "variant_cli_pnp": v2_cli, "fps": fps30,
              "converter": conv31, "lab_modes": lab32, "trace": trace33,
              "fsdp_one_card": fsdp34, "upsample_kernels": k35,
              "clock": clock,
              "build_s": build_s, "resources": resources,
              "cand_order_checks": cand_checks["inputs"],
              "torch": torch.__version__, "cuda": torch.version.cuda}
    print("record " + json.dumps(record))
    if record_path:
        os.makedirs(os.path.dirname(os.path.abspath(record_path)),
                    exist_ok=True)
        with open(record_path, "w") as f:
            json.dump(record, f)
    kernels = [kernel] + stage2_kernel_lines(k5, s2_launches, k8,
                                             probe_launches)
    kernels.append(normal_render_kernel_line(nr, s3_steps))
    by_h = s4_steps["launches_by_height"]
    n4 = s4.self_sup.repj_render_res
    kernels.append(b1_row("fine_raster_fwd[deepim_train]", di_gt,
                          di_steps["launches"]["fine_raster_fwd"]))
    kernels.append(b1_row("fine_raster_fwd[repj]", repj["mean_per_call"]["B1"],
                          by_h["fine_raster_fwd"][n4]))
    kernels.append({**b1_row("fine_raster_bwd[repj]",
                             repj["mean_per_call"]["B2"],
                             by_h["fine_raster_bwd"][n4]),
                    "source": "self6dpp_tpu_torch/csrc/fine_raster_bwd.cu",
                    "replaces": "self6dpp_tpu/ops/raster_pallas.py:459"})
    kernels.append(b1_row("fine_raster_fwd[label_cache]", b1_label,
                          gdrn_test["b1_launches_by_height"][LABEL_RES]))
    kernels.append(b1_row("fine_raster_fwd[vsd]", b1_vsd,
                          lm_eval["b1_launches_by_height"][FRAME_HW[0]]))
    kernels += train_kernel_lines(
        k21, self_train["timed"], b1_train_label,
        gdrn_train["b1_launches_by_height"][LABEL_RES])
    kernels += stage2_kernel_rows(k24, textured["timed"], "ycbv_ss_textured",
                                  "ycbv_ss")
    kernels.append(gen_pseudo_kernel_line(b1_pseudo, pseudo))
    kernels += stage2_kernel_rows(k28, v2_stage2["timed"],
                                  "stage2_pvnet_conv_point",
                                  "stage2_pvnet_conv_point")
    kernels += upsample_kernel_lines(k35, s2_launches)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"path": {"deepim_eval": deepim_path,
                               "stage2_step": stage2_path,
                               "lab_opaque_probe_ms_per_step": probe_path,
                               "stage1_step": {
                                   k: s1[k] for k in (
                                       "config", "batch", "compute_dtype",
                                       "ms_per_step", "ms_range",
                                       "images_per_s", "phase_ms_median",
                                       "peak_mem_gib")},
                               "masknormvf_pose_step": {
                                   k: s3_steps[k] for k in (
                                       "config", "batch", "ms_per_step",
                                       "phase_ms_median", "launches",
                                       "peak_mem_gib")},
                               "geo_step_ms": gs["geo"]["ms_per_step"],
                               "synsup_step_ms": gs["synsup"]["ms_per_step"],
                               "deepim_train_step": {
                                   k: di_steps[k] for k in (
                                       "config", "batch", "iterations",
                                       "compute_dtype", "ms_per_step",
                                       "ms_range", "phase_ms_median",
                                       "launches", "peak_mem_gib")},
                               "stage2_refined_step": {
                                   k: s4_steps[k] for k in (
                                       "config", "batch", "compute_dtype",
                                       "ms_per_step", "ms_range",
                                       "phase_ms_median", "launches",
                                       "launches_by_height",
                                       "peak_mem_gib")},
                               "gdrn_test": {
                                   k: gdrn_test[k] for k in (
                                       "config", "rois", "batch",
                                       "compute_dtype", "images_per_s",
                                       "loop_images_per_s",
                                       "host_load_ms", "label_render_ms",
                                       "eval_step_ms", "evaluate_s",
                                       "wall_s", "b1_launches_by_height")},
                               "deepim_test": {
                                   k: deepim_test[k] for k in (
                                       "config", "rois", "batch",
                                       "iterations", "compute_dtype",
                                       "ms_per_batch", "host_load_ms",
                                       "label_render_ms", "evaluate_s",
                                       "wall_s", "b1_launches_by_height")},
                               "lm_evaluate_s": lm_eval["evaluate_s"],
                               "train_gdrn": {
                                   k: gdrn_train[k] for k in (
                                       "config", "batch", "ms_per_iter",
                                       "step_ms", "loader_wait_ms",
                                       "images_per_s")},
                               "train_deepim": {
                                   k: deepim_train[k] for k in (
                                       "config", "batch", "ms_per_iter",
                                       "step_ms", "loader_wait_ms",
                                       "images_per_s")},
                               "train_self6dpp": {
                                   k: self_train["timed"][k] for k in (
                                       "config", "batch", "ms_per_iter",
                                       "step_ms", "loader_wait_ms",
                                       "images_per_s", "launches")},
                               "train_yolov4": {
                                   k: yolo[k] for k in (
                                       "config", "batch", "input_size",
                                       "ms_per_iter", "images_per_s",
                                       "loader_host_ms", "loader_wait_ms",
                                       "step_phase_ms_median",
                                       "peak_mem_gib")},
                               "yolov4_eval": {
                                   k: yolo["eval"][k] for k in (
                                       "infer_ms_per_image",
                                       "nms_ms_per_batch", "evaluate_s",
                                       "ap")},
                               "png_decode_ms_lm_frame": {
                                   k: png[k]["ms"] for k in (
                                       "rgb_paeth", "rgb", "mask",
                                       "depth16")},
                               "jpeg_decode_ms": {
                                   k: jpeg[k]["ms"] for k in JPEG_FIXTURES},
                               "ycbv_ss_textured_step": {
                                   k: textured["timed"][k] for k in (
                                       "config", "batch", "classes",
                                       "faces", "atlas", "compute_dtype",
                                       "ms_per_step", "phase_ms_median",
                                       "launches", "peak_mem_gib")},
                               "gen_pseudo_poses": {
                                   k: pseudo[k] for k in (
                                       "rois", "batches", "wall_s_kernel",
                                       "b1_launches_by_height")},
                               "variant_stage1_steps": {
                                   name: {k: v["timed"][k] for k in (
                                       "config", "batch", "ms_per_step",
                                       "ms_range", "images_per_s",
                                       "phase_ms_median", "peak_mem_gib")}
                                   for name, v in variants.items()},
                               "variant_stage2_step": {
                                   k: v2_stage2["timed"][k] for k in (
                                       "config", "batch", "ms_per_step",
                                       "phase_ms_median", "launches",
                                       "peak_mem_gib")},
                               "variant_cli_pnp": {
                                   k: v2_cli[k] for k in (
                                       "train_ms_per_iter", "eval_rois",
                                       "eval_images_per_s", "pnp_gt_worst",
                                       "pnp_gt_ms_per_roi",
                                       "pnp_pred_ms_per_roi")},
                               "fps_ms": {
                                   k: [v["native_ms"], v["numpy_ms"]]
                                   for k, v in fps30["cases"].items()},
                               "lab_mode_ms_per_step": {
                                   k: v["ms_per_step"]
                                   for k, v in lab32["bf16"].items()},
                               "trace": {k: trace33[k] for k in (
                                   "trace_bytes", "step_ms_traced",
                                   "step_ms_untraced")},
                               "fsdp_one_card_ms_per_step": [
                                   fsdp34["ms_per_step_plain"],
                                   fsdp34["ms_per_step_sharded"]],
                               "gpu": torch.cuda.get_device_name(0),
                               "card": card}}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description="smoke run of the port on one "
                                             "CUDA card")
    ap.add_argument("--record", default="",
                    help="also write the record's JSON to this file")
    sys.exit(main(ap.parse_args().record))
