"""Configuration for the port: own copies of the JAX package's dataclasses
(self6dpp_tpu/config/base.py), with the fields the ported paths read, under
the same names and defaults. RendererConfig drops `impl`: the port's fine
stage is its CUDA kernel on the card (impl="plain" on the rasterizer and
the step is for control runs). A setting the port does not have raises
where it is given (an unknown field) or where it would take effect (a
value the port does not implement).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class BackboneConfig:
    # resnet{18,34,50,101}[d] | resnest{26,50}d | micro (only the ResNet
    # family is ported)
    name: str = "resnest50d"
    input_channels: int = 3
    out_indices: tuple[int, ...] = (4,)   # stage indices to return (4 = stride 32)


@dataclass(frozen=True)
class GeoHeadConfig:
    name: str = "TopDownMaskXyzRegionHead"
    up_types: tuple[str, ...] = ("deconv", "bilinear", "bilinear")
    deconv_kernel_size: int = 3
    num_conv_per_block: int = 2
    feat_dim: int = 256
    feat_kernel_size: int = 3
    norm: str = "GN"
    num_gn_groups: int = 32
    act: str = "gelu"
    out_kernel_size: int = 1
    out_layer_shared: bool = True
    xyz_class_aware: bool = False
    mask_class_aware: bool = False
    region_class_aware: bool = False
    num_regions: int = 64
    xyz_bin: int = 64               # > 1: binned xyz, softmax over the bins
    num_masks: int = 1              # 1 = visib; 2 = visib + full
    with_vf: bool = False           # keypoint vector-field heads
    with_norm: bool = False         # surface-normal head
    num_vf_points: int = 16         # vf channels: {u,v} x {vis,full} x points


@dataclass(frozen=True)
class PnPNetConfig:
    name: str = "ConvPnPNet"        # ConvPnPNet | ConvPnPNetMaskNormVF
    with_extent_feat: bool = False
    featdim: int = 128
    rot_type: str = "allo_rot6d"    # allo_rot6d | ego_rot6d | allo_quat | ego_quat
    trans_type: str = "centroid_z"
    z_type: str = "REL"             # REL | ABS
    num_stride2_layers: int = 3
    num_extra_layers: int = 0
    norm: str = "GN"
    num_gn_groups: int = 32
    act: str = "leakyrelu"
    drop_prob: float = 0.0
    flat_op: str = "flatten"        # flatten | avg | avg-max | avg-max-min
    denormalize_by_extent: bool = True
    with_2d_coord: bool = True
    region_attention: bool = True
    mask_attention: str = "none"    # none | mul | concat


@dataclass(frozen=True)
class LossConfig:
    """The stage-I loss block (losses/gdrn_loss.py); the stage-II steps also
    read mask_loss_type: how the mask head is trained, so how its logits
    become a probability."""
    # xyz
    xyz_loss_type: str = "L1"       # L1 | CE_coor
    xyz_loss_mask_gt: str = "visib" # trunc | visib | obj
    xyz_lw: float = 1.0
    # mask
    mask_loss_type: str = "BCE"     # L1 | BCE | RW_BCE | dice | CE
    mask_loss_gt: str = "trunc"
    mask_lw: float = 1.0
    full_mask_lw: float = 1.0       # the second mask channel (num_masks 2)
    # region
    region_loss_type: str = "CE"
    region_loss_mask_gt: str = "visib"
    region_lw: float = 1.0
    # point matching
    pm_lw: float = 1.0
    pm_loss_type: str = "L1"
    pm_smooth_l1_beta: float = 1.0
    pm_norm_by_extent: bool = False
    pm_loss_sym: bool = True
    pm_disentangle_t: bool = False
    pm_disentangle_z: bool = False
    pm_t_use_points: bool = True
    pm_r_only: bool = True
    # others
    rot_lw: float = 0.0
    rot_loss_type: str = "angular"
    centroid_lw: float = 1.0
    centroid_loss_type: str = "L1"
    z_lw: float = 1.0
    z_loss_type: str = "L1"
    trans_lw: float = 0.0
    trans_loss_type: str = "L1"
    trans_loss_disentangle: bool = True
    bind_lw: float = 0.0
    bind_loss_type: str = "L1"
    # supervised vf / normal terms (the MaskNormVF heads)
    vf_lw: float = 0.0
    norm_lw: float = 0.0


@dataclass(frozen=True)
class PoseNetConfig:
    name: str = "GDRN"
    num_classes: int = 13
    input_res: int = 256
    output_res: int = 64
    backbone: BackboneConfig = field(default_factory=BackboneConfig)
    geo_head: GeoHeadConfig = field(default_factory=GeoHeadConfig)
    pnp_net: PnPNetConfig = field(default_factory=PnPNetConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    use_mtl: bool = False           # uncertainty multi-task loss weighting
    neck: str = "none"


@dataclass(frozen=True)
class DeepIMConfig:
    """DeepIM render-and-compare refiner (core/deepim/models/DeepIM_FlowNet.py).
    The refine loop re-renders the mesh every iteration."""
    # DeepIM_FlowNet | DeepIM_Shared | DeepIM_Unshared (only FlowNet is ported)
    name: str = "DeepIM_FlowNet"
    num_classes: int = 13
    input_h: int = 512
    input_w: int = 512
    in_channels: int = 6            # 6 = rgb ren+obs; 8 adds mask channels
    backbone: str = "flownets"
    use_bn: bool = False
    flat_op: str = "avg"            # flatten | avg | avg-max | avg-max-min
    rot_type: str = "ego_rot6d"
    z_style: str = "cosypose"       # cosypose | deepim
    t_space: str = "image"
    t_weight: float = 1.0
    pose_feat_dim: int = 256
    pose_num_layers: int = 2
    with_mask_head: bool = True
    mask_class_aware: bool = False
    with_flow: bool = True          # supervise flow4
    n_iter_train: int = 4
    n_iter_train_warm_iters: int = 0
    n_iter_test: int = 4
    zoom_lamb: float = 1.4
    # losses
    pm_lw: float = 10.0
    pm_loss_sym: bool = True
    pm_r_only: bool = False
    pm_disentangle_z: bool = True
    flow_lw: float = 0.1
    mask_lw: float = 1.0
    mask_loss_type: str = "BCE"
    trans_lw: float = 1.0
    rot_lw: float = 0.0
    use_mtl: bool = False


@dataclass(frozen=True)
class RendererConfig:
    width: int = 640
    height: int = 480
    znear: float = 0.01
    zfar: float = 10.0
    sigma: float = 1.0 / 7000.0
    gamma: float = 1.0 / 7000.0
    max_faces: int = 8192
    tile_px: int = 16
    faces_per_tile: int = 128       # K candidate faces per tile


@dataclass(frozen=True)
class DistConfig:
    data_axis: str = "data"
    fsdp_axis: str = "fsdp"
    mesh_shape: tuple[int, ...] = (-1, 1)
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"


@dataclass(frozen=True)
class SolverConfig:
    optimizer: str = "ranger"       # ranger | adam (the others raise)
    base_lr: float = 1e-4
    weight_decay: float = 0.0
    momentum: float = 0.9
    lr_sched: str = "flat_and_anneal"   # flat_and_anneal | warmup_multistep
    anneal_method: str = "cosine"   # cosine | step | poly | linear
    anneal_point: float = 0.72
    warmup_iters: int = 1000
    warmup_factor: float = 0.001
    warmup_method: str = "linear"
    poly_power: float = 1.0
    step_gamma: float = 0.1
    steps: tuple[float, ...] = (0.5, 0.75)
    grad_clip_norm: float = 35.0    # 0 disables
    total_iters: int = 100_000
    ims_per_batch: int = 24
    reference_bs: int = 24          # grad accumulation target batch size
    ema_decay: float = 0.999
    ema_warmup_iters: int = 2000


@dataclass(frozen=True)
class DataConfig:
    model_points: int = 512         # PM-loss points per ROI
    max_sym_rots: int = 32          # padded symmetry rotation set


@dataclass(frozen=True)
class SelfSupConfig:
    """Stage-II self-supervised loss weights."""
    mask_lw: float = 1.0
    mask_loss_type: str = "RW_BCE"  # RW_BCE | dice | BCE
    mask_edge_reweight: bool = True
    perceptual_lw: float = 0.15
    ms_ssim_lw: float = 1.0
    lab_lw: float = 0.0
    lab_no_l: bool = True
    # "pallas" (the JAX package's kernel form: value and image gradient from
    # one kernel, the gradient injected into the render's cotangent) is the
    # port's B3 kernel; "direct" is autograd of ops/color.py::lab_loss
    lab_impl: str = "pallas"
    depth_chamfer_lw: float = 0.0
    chamfer_dist_thr: float = 0.05      # metres; farther pairs leave the mean
    chamfer_center_lw: float = 0.0
    vf_lw: float = 0.0
    norm_lw: float = 0.0
    pseudo_pm_lw: float = 10.0
    pseudo_trans_lw: float = 0.0
    ema_decay: float = 0.999
    teacher_update_freq: int = 1    # epochs between EMA teacher refreshes
    geo_mode_ratio: float = 0.0     # share of iterations in the geo mode
    mode_schedule: str = "random"   # random | alternate | fix_pose | fix_geo
    # the geo mode's pose-variated warp of the student's ROI and the
    # teacher's maps (ops/warp.py::sample_pose_variated_affines)
    geo_aug_rot_deg: float = 180.0
    geo_aug_zoom: tuple[float, float] = (0.75, 1.25)
    geo_aug_trans: tuple[float, float] = (-0.1, 0.1)
    geo_aug_crop: float = 0.1
    pseudo_pose_type: str = "pose_refine"   # pose_refine | pose_est | teacher
    refine_with_deepim: bool = False
    repj_refine: bool = False


@dataclass(frozen=True)
class Config:
    exp_name: str = "default"
    seed: int = 0
    model: PoseNetConfig = field(default_factory=PoseNetConfig)
    deepim: DeepIMConfig = field(default_factory=DeepIMConfig)
    solver: SolverConfig = field(default_factory=SolverConfig)
    data: DataConfig = field(default_factory=DataConfig)
    renderer: RendererConfig = field(default_factory=RendererConfig)
    self_sup: SelfSupConfig = field(default_factory=SelfSupConfig)
    dist: DistConfig = field(default_factory=DistConfig)


def lm_flownet() -> Config:
    """DeepIM FlowNet refiner for LINEMOD (configs/deepim/lm_flownet.py):
    512 zoom, lamb 1.5, 4 train/test iterations, 8 ROIs per batch."""
    return Config(
        exp_name="deepim_lm_flownet512",
        deepim=DeepIMConfig(
            num_classes=13, input_h=512, input_w=512, in_channels=6,
            flat_op="avg", rot_type="ego_rot6d", z_style="cosypose",
            n_iter_train=4, n_iter_test=4, zoom_lamb=1.5,
            pm_lw=10.0, flow_lw=0.1, mask_lw=1.0, trans_lw=1.0,
        ),
        solver=SolverConfig(ims_per_batch=8),
    )


def stage2_pose_flagship() -> Config:
    """The stage-II pose-mode step at the flagship width, as
    bench.py::build_stage2(8, dense=False) measures it: GDRN with a
    resnest50d backbone, 256² ROI, 64² output, 13 classes, bf16 compute;
    renderer tiles of 32 px with K = 128 (the 1280-face icosphere budget);
    Ranger at base_lr 1e-4, grad clip 35, EMA 0.999 over a 2000-iteration
    ramp, 24 images per batch (no accumulation). The whole pose-mode loss
    suite: the rendered-mask RW_BCE with edge weights (1), LAB in its
    kernel form (0.2), LPIPS (0.15), MS-SSIM (1), the depth chamfer (1),
    xyz/region init-pred and pseudo-pose PM (10) + trans (1)."""
    return Config(
        exp_name="stage2_pose_flagship",
        model=PoseNetConfig(num_classes=13, input_res=256, output_res=64),
        solver=SolverConfig(total_iters=100_000, ims_per_batch=24,
                            reference_bs=24),
        renderer=RendererConfig(tile_px=32, faces_per_tile=128),
        self_sup=SelfSupConfig(
            mask_lw=1.0, ms_ssim_lw=1.0, lab_lw=0.2,
            lab_impl="pallas", lab_no_l=True, depth_chamfer_lw=1.0,
            perceptual_lw=0.15, pseudo_pm_lw=10.0, pseudo_trans_lw=1.0),
    )


def stage2_pose_tiny() -> Config:
    """stage2_pose_flagship cut to test size, with the same loss suite:
    micro backbone, 64² ROI (so MS-SSIM keeps 3 of its 5 levels and the
    chamfer takes every pixel), 16² output, 2 classes, head width 16 with 4
    GN groups, 4 regions, 16 px tiles; fp32 compute, no LR warm-up and a
    visible base_lr."""
    f = stage2_pose_flagship()
    return dataclasses.replace(
        f, exp_name="stage2_pose_tiny",
        model=PoseNetConfig(
            num_classes=2, input_res=64, output_res=16,
            backbone=BackboneConfig(name="micro"),
            geo_head=GeoHeadConfig(feat_dim=16, num_gn_groups=4,
                                   num_regions=4),
            pnp_net=PnPNetConfig(featdim=16, num_gn_groups=4)),
        solver=SolverConfig(base_lr=1e-3, warmup_iters=0, total_iters=100,
                            ims_per_batch=2, reference_bs=2),
        renderer=RendererConfig(tile_px=16, faces_per_tile=128),
        dist=DistConfig(compute_dtype="float32"))


def gdrn_flagship() -> Config:
    """The stage-I GDR-Net train step that bench.py::bench_gdrn_train
    measures (__graft_entry__._flagship_cfg): resnest50d, 256² ROI, 64²
    output, 13 classes, the default geo head (binned xyz, 64 bins), PnP net
    and loss block; Ranger at base_lr 1e-4 over 100k iterations, 24 images
    per batch, bf16 compute."""
    return Config(
        exp_name="gdrn_flagship",
        model=PoseNetConfig(num_classes=13, input_res=256, output_res=64,
                            backbone=BackboneConfig(name="resnest50d")),
        solver=SolverConfig(total_iters=100_000, ims_per_batch=24,
                            reference_bs=24))


def masknormvf_model(m: PoseNetConfig) -> PoseNetConfig:
    """The GDRN_MaskNormVF head and PnP net of configs/gdrn/lm_masknormvf.py
    on `m`: visib + full masks, 16-point vector fields, normals, regressed
    xyz (xyz_bin 1, configs/gdrn/lm_base.py), the vf/norm maps fed to the
    PnP net."""
    return dataclasses.replace(
        m,
        geo_head=dataclasses.replace(m.geo_head, xyz_bin=1, num_masks=2,
                                     with_vf=True, with_norm=True,
                                     num_vf_points=16),
        pnp_net=dataclasses.replace(m.pnp_net, name="ConvPnPNetMaskNormVF"))


def gdrn_lm_masknormvf() -> Config:
    """Stage-I GDRN_MaskNormVF for LINEMOD: the model, loss and solver of
    configs/gdrn/lm_base.py + lm_masknormvf.py (resnest50d, 256² -> 64², 13
    classes; L1 xyz, BCE mask, CE region, rotation-only symmetric PM,
    centroid and z, vf and norm at weight 1; Ranger at 1e-4, cosine anneal
    from 0.72 of 100k iterations, 24 images per batch, clip 35)."""
    m = masknormvf_model(PoseNetConfig(
        num_classes=13, input_res=256, output_res=64,
        backbone=BackboneConfig(name="resnest50d"),
        geo_head=GeoHeadConfig(up_types=("deconv", "bilinear", "bilinear"),
                               feat_dim=256, num_regions=64),
        pnp_net=PnPNetConfig(rot_type="allo_rot6d", trans_type="centroid_z",
                             z_type="REL", region_attention=True,
                             with_2d_coord=True)))
    return Config(
        exp_name="gdrn_lm_masknormvf",
        model=dataclasses.replace(m, loss=LossConfig(
            xyz_loss_type="L1", xyz_lw=1.0, mask_loss_type="BCE", mask_lw=1.0,
            region_loss_type="CE", region_lw=1.0, pm_lw=1.0, pm_loss_sym=True,
            pm_r_only=True, centroid_lw=1.0, z_lw=1.0, vf_lw=1.0,
            norm_lw=1.0)),
        solver=SolverConfig(optimizer="ranger", base_lr=1e-4,
                            anneal_method="cosine", anneal_point=0.72,
                            total_iters=100_000, ims_per_batch=24,
                            reference_bs=24, grad_clip_norm=35.0))


def stage2_masknormvf() -> Config:
    """stage2_pose_flagship with the GDRN_MaskNormVF geo head and PnP net
    of gdrn_lm_masknormvf and the pose step's vf and norm pseudo-label
    terms at weight 1 (the weights tests/test_self_engine.py gives them;
    the JAX package publishes no stage-II value)."""
    f = stage2_pose_flagship()
    return dataclasses.replace(
        f, exp_name="stage2_masknormvf", model=masknormvf_model(f.model),
        self_sup=dataclasses.replace(f.self_sup, vf_lw=1.0, norm_lw=1.0))


def masknormvf_tiny() -> Config:
    """stage2_pose_tiny (test widths, float32, Ranger at 1e-3 without
    warm-up, 2 images per batch) with the MaskNormVF heads at 4
    vector-field points and their stage-I vf and norm terms at weight 1."""
    t = stage2_pose_tiny()
    m = masknormvf_model(t.model)
    m = dataclasses.replace(
        m, geo_head=dataclasses.replace(m.geo_head, num_vf_points=4),
        loss=dataclasses.replace(m.loss, vf_lw=1.0, norm_lw=1.0))
    return dataclasses.replace(t, exp_name="masknormvf_tiny", model=m)
