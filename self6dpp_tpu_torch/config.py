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
    # DeepIM_FlowNet | DeepIM_Shared | DeepIM_Unshared
    name: str = "DeepIM_FlowNet"
    num_classes: int = 13
    input_h: int = 512
    input_w: int = 512
    in_channels: int = 6            # 6 = rgb ren+obs; 8 adds mask channels
    # flownets, or any ResNetBackbone arch for the Shared/Unshared variants
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
    # the refine count ramps from 1 to n_iter_train over the first
    # n_iter_train_warm_iters iterations (deepim_engine.warm_n_iter); 0: off
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
class DetConfig:
    """The YOLOv4 detector: input size, widths and the train-time
    augmentation of data/det_loader.py (mosaic, random affine, HSV,
    flips). Defaults are the JAX package's."""
    input_size: int = 640
    width_multiple: float = 1.0
    depth_multiple: float = 1.0
    max_objs: int = 16              # padded targets per image
    # augmentation (train split only)
    aug_mosaic: bool = False        # 4-image mosaic
    aug_hsv_prob: float = 1.0
    hsv_h: float = 0.015            # HSV gains (fractions)
    hsv_s: float = 0.7
    hsv_v: float = 0.4
    rand_rotate_deg: float = 0.0    # random_affine knobs
    rand_translate: float = 0.0
    rand_scale: float = 0.5
    rand_shear: float = 0.0
    rand_hflip: bool = True
    rand_vflip: bool = False


@dataclass(frozen=True)
class DistConfig:
    data_axis: str = "data"
    fsdp_axis: str = "fsdp"
    mesh_shape: tuple[int, ...] = (-1, 1)
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"


@dataclass(frozen=True)
class SolverConfig:
    # ranger | radam | adam | adamw | adabelief | sgd | sgd_gc | madgrad |
    # adamp | sgdp
    optimizer: str = "ranger"
    base_lr: float = 1e-4
    weight_decay: float = 0.0
    momentum: float = 0.9
    # flat_and_anneal | warmup_multistep; any other name: base_lr throughout
    lr_sched: str = "flat_and_anneal"
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
class DZIConfig:
    """Dynamic zoom-in of the detection box (data/aug.py::aug_bbox_dzi)."""
    type: str = "uniform"           # uniform | truncnorm | none | roi10d
    pad_scale: float = 1.5
    scale_ratio: float = 0.25
    shift_ratio: float = 0.25


@dataclass(frozen=True)
class DataConfig:
    """The data pipeline (data/loader.py). The fields of the training mode
    (augmentation, background replacement, samplers) are kept under their
    names so that the repo's configs load whole; the port's loader runs
    the eval mode only and refuses train=True."""
    dataset_root: str = "datasets"
    train_datasets: tuple[str, ...] = ("lm_pbr_13_train",)
    train2_datasets: tuple[str, ...] = ()
    train2_ratio: float = 0.0
    test_datasets: tuple[str, ...] = ("lm_13_test",)
    det_files_train: tuple[str, ...] = ()
    det_files_test: tuple[str, ...] = ()
    det_topk_per_obj: int = 1
    det_thresh: float = 0.0
    input_res: int = 256
    output_res: int = 64
    dzi: DZIConfig = field(default_factory=DZIConfig)
    color_aug_prob: float = 0.0
    bg_replace_prob: float = 0.5
    bg_dir: str = ""
    num_workers: int = 4            # thread-pool size for per-sample host work
    prefetch: int = 2               # assembled batches buffered ahead
    # per-instance GT-render cache: each instance rendered once in a frame
    # that covers every crop of it, then warped per crop; res 0 = 2 *
    # output_res; entries bound host memory (float16 attributes)
    label_cache: bool = True
    label_cache_res: int = 0
    label_cache_entries: int = 20000
    sampler: str = "training"       # training | repeat_factor | inf_subset
    repeat_thresh: float = 0.01
    subset_ratio: float = 1.0
    filter_visib_thr: float = 0.0
    with_depth: bool = False        # emit roi_depth crops
    depth_aug_prob: float = 0.0
    depth_aug_level: float = 0.1
    # restrict the split to these object names; empty = all
    object_filter: tuple[str, ...] = ()
    truncate_fg: bool = False
    model_points: int = 512         # PM-loss points per ROI
    max_sym_rots: int = 32          # padded symmetry rotation set


@dataclass(frozen=True)
class TestConfig:
    eval_period: int = 0
    test_bbox_type: str = "est"     # est | gt
    # vsd/mssd/mspd among them add the BOP19 average recalls to the tables
    # (PoseEvaluator.evaluate(bop19=True)); vsd also makes the eval loader
    # emit the observed full-frame depth
    error_types: tuple[str, ...] = ("ad", "rete", "re", "te", "proj",
                                    "vsd", "mssd", "mspd")
    use_pnp: bool = False
    pnp_type: str = "ransac_pnp"
    save_results_only: bool = False


@dataclass(frozen=True)
class SelfSupConfig:
    """Stage-II self-supervised loss weights."""
    enabled: bool = False           # marks a stage-II config; read nowhere
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
    ema_teacher: bool = True        # read nowhere, as in the JAX package
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
    # the DeepIM refiner refines the pseudo pose inside the step (the step
    # takes the refiner as an argument; train_self6dpp builds it from
    # refiner_config with the weights of refiner_weights, a flat .npz)
    refine_with_deepim: bool = False
    refiner_config: str = ""
    refiner_weights: str = ""
    # RepjRefiner multi-view weak supervision of the student's pose
    # (models/repj_refiner.py::repj_weak_loss) and its term weights
    repj_refine: bool = False
    repj_iou2d3d_lw: float = 0.1
    repj_pm_lw: float = 10.0
    repj_miou_lw: float = 1.0
    repj_msssim_lw: float = 1.0
    repj_render_res: int = 64       # side of the multi-view renders


@dataclass(frozen=True)
class Config:
    exp_name: str = "default"
    output_dir: str = "output"
    seed: int = 0
    model: PoseNetConfig = field(default_factory=PoseNetConfig)
    deepim: DeepIMConfig = field(default_factory=DeepIMConfig)
    solver: SolverConfig = field(default_factory=SolverConfig)
    data: DataConfig = field(default_factory=DataConfig)
    test: TestConfig = field(default_factory=TestConfig)
    renderer: RendererConfig = field(default_factory=RendererConfig)
    self_sup: SelfSupConfig = field(default_factory=SelfSupConfig)
    det: DetConfig = field(default_factory=DetConfig)
    dist: DistConfig = field(default_factory=DistConfig)
    ckpt_period: int = 5000
    ckpt_max_to_keep: int = 2
    log_period: int = 100
    tensorboard: bool = False       # add a TensorBoard scalar writer
    vis_period: int = 0             # iterations between image grids (0: off)


def _coerce(val: str, target_type):
    if target_type is bool:
        return val.lower() in ("1", "true", "yes")
    if target_type is int:
        return int(val)
    if target_type is float:
        return float(val)
    if target_type is str:
        return val
    # tuples: comma-separated
    return tuple(v.strip() for v in val.split(","))


def apply_overrides(cfg: Config, opts: list[str]) -> Config:
    """Apply 'a.b.c=value' overrides (the --opts of the CLIs), each value
    coerced to the type of the field it replaces; tuples are
    comma-separated. Raises on an unknown key."""
    for opt in opts:
        key, _, raw = opt.partition("=")
        cfg = _replace_path(cfg, key.split("."), raw)
    return cfg


def _replace_path(obj, parts: list[str], raw: str):
    name = parts[0]
    names = {f.name for f in dataclasses.fields(obj)}
    if name not in names:
        raise KeyError(f"unknown config key: {name} on {type(obj).__name__}")
    if len(parts) == 1:
        cur = getattr(obj, name)
        return dataclasses.replace(obj, **{name: _coerce(raw, type(cur))})
    child = _replace_path(getattr(obj, name), parts[1:], raw)
    return dataclasses.replace(obj, **{name: child})


def gdrn_lm_base() -> Config:
    """GDR-Net stage I for LINEMOD (configs/gdrn/lm_base.py): resnest50d,
    256² ROI -> 64² output, 13 classes, regressed xyz (xyz_bin 1), 64
    regions, allo_rot6d with centroid_z (REL); L1 xyz, BCE mask, CE region,
    rotation-only symmetric PM, centroid and z; Ranger at 1e-4, cosine
    anneal from 0.72 of 100k iterations, 24 images per batch, clip 35;
    lm_pbr for training, lm for testing, uniform DZI (pad 1.5, scale and
    shift 0.25), estimated test boxes."""
    return Config(
        exp_name="gdrn_lm_base",
        model=PoseNetConfig(
            name="GDRN", num_classes=13, input_res=256, output_res=64,
            backbone=BackboneConfig(name="resnest50d"),
            geo_head=GeoHeadConfig(
                up_types=("deconv", "bilinear", "bilinear"),
                feat_dim=256, num_regions=64, xyz_bin=1),
            pnp_net=PnPNetConfig(
                rot_type="allo_rot6d", trans_type="centroid_z", z_type="REL",
                region_attention=True, with_2d_coord=True),
            loss=LossConfig(
                xyz_loss_type="L1", xyz_lw=1.0, mask_loss_type="BCE",
                mask_lw=1.0, region_loss_type="CE", region_lw=1.0,
                pm_lw=1.0, pm_loss_sym=True, pm_r_only=True,
                centroid_lw=1.0, z_lw=1.0)),
        solver=SolverConfig(
            optimizer="ranger", base_lr=1e-4, anneal_method="cosine",
            anneal_point=0.72, total_iters=100_000, ims_per_batch=24,
            reference_bs=24, grad_clip_norm=35.0),
        data=DataConfig(
            train_datasets=("lm_pbr",), test_datasets=("lm",),
            dzi=DZIConfig(type="uniform", pad_scale=1.5, scale_ratio=0.25,
                          shift_ratio=0.25),
            color_aug_prob=0.8, bg_replace_prob=0.5),
        test=TestConfig(test_bbox_type="est"))


def lm_flownet() -> Config:
    """DeepIM FlowNet refiner for LINEMOD (configs/deepim/lm_flownet.py,
    on gdrn_lm_base): 512 zoom, lamb 1.5, 4 train/test iterations, flow,
    mask, PM and trans losses; Ranger at 1e-4, cosine anneal from 0.72 of
    80k iterations, 8 ROIs per batch (no accumulation)."""
    return dataclasses.replace(
        gdrn_lm_base(),
        exp_name="deepim_lm_flownet512",
        deepim=DeepIMConfig(
            num_classes=13, input_h=512, input_w=512, in_channels=6,
            flat_op="avg", rot_type="ego_rot6d", z_style="cosypose",
            n_iter_train=4, n_iter_test=4, zoom_lamb=1.5,
            pm_lw=10.0, flow_lw=0.1, mask_lw=1.0, trans_lw=1.0,
        ),
        solver=SolverConfig(
            optimizer="ranger", base_lr=1e-4, anneal_method="cosine",
            anneal_point=0.72, total_iters=80_000, ims_per_batch=8,
            reference_bs=8),
    )


def gdrn_synthetic_smoke() -> Config:
    """The end-to-end smoke config on the generated synthetic BOP set
    (configs/gdrn/synthetic_smoke.py): micro backbone, 64² -> 16², 2
    classes, head width 32 with 8 GN groups and 8 regions; adam at 3e-4
    for 60 iterations (5 warm-up), 8 images per batch; 64 PM points, 4
    symmetry rotations."""
    return Config(
        exp_name="gdrn_synthetic_smoke",
        output_dir="/tmp/smoke_out",
        model=PoseNetConfig(
            num_classes=2, input_res=64, output_res=16,
            backbone=BackboneConfig(name="micro"),
            geo_head=GeoHeadConfig(feat_dim=32, num_gn_groups=8,
                                   num_regions=8),
            pnp_net=PnPNetConfig(featdim=32, num_gn_groups=8)),
        solver=SolverConfig(optimizer="adam", base_lr=3e-4, total_iters=60,
                            warmup_iters=5, ims_per_batch=8, reference_bs=8,
                            ema_decay=0.999),
        data=DataConfig(dataset_root="/tmp/bopdata",
                        train_datasets=("synthetic",),
                        test_datasets=("synthetic",),
                        model_points=64, max_sym_rots=4,
                        dzi=DZIConfig(pad_scale=1.5)),
        ckpt_period=60, log_period=20)


def deepim_synthetic_smoke() -> Config:
    """DeepIM on the synthetic BOP set (configs/deepim/synthetic_smoke.py,
    on gdrn_synthetic_smoke): 64² zoom, pose head width 32, 2 train/test
    iterations; adam at 1e-4 for 15 iterations, 4 ROIs per batch."""
    b = gdrn_synthetic_smoke()
    return dataclasses.replace(
        b, exp_name="deepim_synthetic_smoke",
        deepim=DeepIMConfig(num_classes=2, input_h=64, input_w=64,
                            pose_feat_dim=32, n_iter_train=2, n_iter_test=2,
                            flow_lw=0.1, mask_lw=1.0, pm_lw=10.0),
        solver=SolverConfig(optimizer="adam", base_lr=1e-4, total_iters=15,
                            warmup_iters=0, ims_per_batch=4, reference_bs=4),
        ckpt_period=15, log_period=5)


def self6dpp_lm_ss() -> Config:
    """Stage II for LINEMOD (configs/self6dpp/lm_ss.py, on gdrn_lm_base):
    RW_BCE mask with edge weights, LPIPS 0.15, MS-SSIM 1, LAB 0.2, pseudo
    PM 10; Ranger at 2e-5, cosine anneal from 0.72 of 3000 iterations, 8
    images per batch, clip 35; EMA teacher at 0.999; pose mode only."""
    return dataclasses.replace(
        gdrn_lm_base(),
        exp_name="self6dpp_lm_ss",
        solver=SolverConfig(
            optimizer="ranger", base_lr=2e-5, anneal_method="cosine",
            anneal_point=0.72, total_iters=3000, ims_per_batch=8,
            reference_bs=8, grad_clip_norm=35.0, ema_decay=0.999),
        self_sup=SelfSupConfig(
            enabled=True, mask_lw=1.0, mask_loss_type="RW_BCE",
            mask_edge_reweight=True, perceptual_lw=0.15, ms_ssim_lw=1.0,
            lab_lw=0.2, depth_chamfer_lw=0.0, chamfer_dist_thr=0.05,
            pseudo_pm_lw=10.0, pseudo_trans_lw=0.0, ema_teacher=True,
            ema_decay=0.999, geo_mode_ratio=0.0))


def self6dpp_synthetic_smoke() -> Config:
    """Stage II on the synthetic BOP set (configs/self6dpp/synthetic_smoke.py,
    on gdrn_synthetic_smoke): adam at 5e-5 for 20 iterations, 4 images per
    batch; the TRAIN2 interleave at 0.3, the geo mode at 0.3, the EMA
    teacher refreshed every epoch, the DeepIM refiner of
    deepim_synthetic_refiner in the loop and the RepjRefiner loss at 32²."""
    b = gdrn_synthetic_smoke()
    return dataclasses.replace(
        b,
        exp_name="self6dpp_synthetic_smoke",
        solver=SolverConfig(optimizer="adam", base_lr=5e-5, total_iters=20,
                            warmup_iters=0, ims_per_batch=4, reference_bs=4),
        data=dataclasses.replace(b.data, train2_datasets=("synthetic",),
                                 train2_ratio=0.3),
        self_sup=SelfSupConfig(
            enabled=True, mask_lw=1.0, ms_ssim_lw=1.0, perceptual_lw=0.1,
            pseudo_pm_lw=10.0, geo_mode_ratio=0.3, teacher_update_freq=1,
            refine_with_deepim=True,
            refiner_config="configs/deepim/synthetic_refiner.py",
            repj_refine=True, repj_render_res=32),
        ckpt_period=20, log_period=5)


def deepim_synthetic_refiner() -> Config:
    """The in-loop refiner of self6dpp_synthetic_smoke
    (configs/deepim/synthetic_refiner.py): 64² zoom, 8 input channels with
    the masks, 2 train/test iterations, no flow or mask head; renderer
    tiles of 16 px with K 64."""
    return Config(
        exp_name="deepim_synthetic_refiner",
        output_dir="/tmp/smoke_out",
        deepim=DeepIMConfig(
            num_classes=2, input_h=64, input_w=64, in_channels=8,
            n_iter_train=2, n_iter_test=2, with_flow=False, flow_lw=0.0,
            with_mask_head=False),
        renderer=RendererConfig(tile_px=16, faces_per_tile=64))


def lm_masknormvf() -> Config:
    """GDRN_MaskNormVF stage I for LINEMOD (configs/gdrn/lm_masknormvf.py,
    on gdrn_lm_base): visib + full masks, 16-point vector fields and
    normals, ConvPnPNetMaskNormVF, the vf and norm terms at weight 1."""
    b = gdrn_lm_base()
    m = b.model
    return dataclasses.replace(
        b, exp_name="gdrn_lm_masknormvf",
        model=dataclasses.replace(
            m,
            geo_head=dataclasses.replace(m.geo_head, num_masks=2,
                                         with_vf=True, with_norm=True,
                                         num_vf_points=16),
            pnp_net=dataclasses.replace(m.pnp_net,
                                        name="ConvPnPNetMaskNormVF"),
            loss=dataclasses.replace(m.loss, vf_lw=1.0, norm_lw=1.0)))


def lm_objects() -> Config:
    """One GDR-Net per LINEMOD object (configs/gdrn/lm_objects.py, on
    gdrn_lm_base): data.object_filter picks it, ape by default (--opts
    data.object_filter=can exp_name=gdrn_lm_can for another)."""
    b = gdrn_lm_base()
    return dataclasses.replace(
        b, exp_name="gdrn_lm_siso",
        data=dataclasses.replace(b.data, object_filter=("ape",)))


def gdrn_hb_base() -> Config:
    """Stage I for HomebrewedDB (configs/gdrn/hb_base.py, on gdrn_lm_base):
    33 classes, trained on hb_pbr (JPEG frames), tested on hb."""
    b = gdrn_lm_base()
    return dataclasses.replace(
        b, exp_name="gdrn_hb_base",
        model=dataclasses.replace(b.model, num_classes=33),
        data=DataConfig(
            train_datasets=("hb_pbr",), test_datasets=("hb",),
            dzi=DZIConfig(type="uniform", pad_scale=1.5, scale_ratio=0.25,
                          shift_ratio=0.25),
            color_aug_prob=0.8, bg_replace_prob=0.5))


def gdrn_ycbv_base() -> Config:
    """Stage I for YCB-V (configs/gdrn/ycbv_base.py, on gdrn_lm_base): 21
    classes, visib + full masks (the full mask's loss at weight 1), the
    symmetric PM loss; trained on ycbv_pbr (JPEG frames), tested on ycbv,
    instances under 10 % visible left out."""
    b = gdrn_lm_base()
    m = b.model
    return dataclasses.replace(
        b, exp_name="gdrn_ycbv_base",
        model=dataclasses.replace(
            m, num_classes=21,
            geo_head=dataclasses.replace(m.geo_head, num_masks=2),
            loss=dataclasses.replace(m.loss, pm_loss_sym=True,
                                     full_mask_lw=1.0)),
        data=dataclasses.replace(
            b.data, train_datasets=("ycbv_pbr",), test_datasets=("ycbv",),
            filter_visib_thr=0.1,
            dzi=DZIConfig(type="uniform", pad_scale=1.5, scale_ratio=0.25,
                          shift_ratio=0.25)))


def self6dpp_hb_ss() -> Config:
    """Stage II for HomebrewedDB (configs/self6dpp/hb_ss.py, on
    gdrn_hb_base): lm_ss's solver and loss family (RW_BCE mask with edge
    weights, LPIPS 0.15, MS-SSIM 1, LAB 0.2, pseudo PM 10; EMA teacher at
    0.999), the geo mode off by SelfSupConfig's default."""
    return dataclasses.replace(
        gdrn_hb_base(), exp_name="self6dpp_hb_ss",
        solver=SolverConfig(
            optimizer="ranger", base_lr=2e-5, anneal_method="cosine",
            anneal_point=0.72, total_iters=3000, ims_per_batch=8,
            reference_bs=8, grad_clip_norm=35.0, ema_decay=0.999),
        self_sup=SelfSupConfig(
            enabled=True, mask_lw=1.0, mask_loss_type="RW_BCE",
            mask_edge_reweight=True, perceptual_lw=0.15, ms_ssim_lw=1.0,
            lab_lw=0.2, pseudo_pm_lw=10.0, ema_teacher=True,
            ema_decay=0.999))


def self6dpp_ycbv_ss() -> Config:
    """Stage II for YCB-V (configs/self6dpp/ycbv_ss.py, on gdrn_ycbv_base)
    with self6dpp_lm_ss's solver and loss family. YCB-V's models are
    textured: the student render rasterises their UVs and samples the
    atlas (engine/self_engine.py::render_student_pose)."""
    ss = self6dpp_lm_ss()
    return dataclasses.replace(gdrn_ycbv_base(), exp_name="self6dpp_ycbv_ss",
                               solver=ss.solver, self_sup=ss.self_sup)


# the repo's config files (which import the JAX package) -> the port's
# functions that build the same Config
CONFIGS = {
    "configs/gdrn/lm_base.py": gdrn_lm_base,
    "configs/gdrn/lm_masknormvf.py": lm_masknormvf,
    "configs/gdrn/lm_objects.py": lm_objects,
    "configs/gdrn/hb_base.py": gdrn_hb_base,
    "configs/gdrn/ycbv_base.py": gdrn_ycbv_base,
    "configs/gdrn/synthetic_smoke.py": gdrn_synthetic_smoke,
    "configs/deepim/lm_flownet.py": lm_flownet,
    "configs/deepim/synthetic_smoke.py": deepim_synthetic_smoke,
    "configs/deepim/synthetic_refiner.py": deepim_synthetic_refiner,
    "configs/self6dpp/lm_ss.py": self6dpp_lm_ss,
    "configs/self6dpp/hb_ss.py": self6dpp_hb_ss,
    "configs/self6dpp/ycbv_ss.py": self6dpp_ycbv_ss,
    "configs/self6dpp/synthetic_smoke.py": self6dpp_synthetic_smoke,
}


def load_config(path: str) -> Config:
    """The Config of a repo config file, by its repo-relative path (a
    leading './' and an absolute path inside the repo are taken too).
    Raises for a path the port has no function for, listing those it has."""
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rel = os.path.relpath(os.path.abspath(path), root) \
        if os.path.isabs(path) else os.path.normpath(path)
    rel = rel.replace(os.sep, "/")
    if rel not in CONFIGS:
        raise KeyError(f"no port config for {path!r}; registered: "
                       f"{sorted(CONFIGS)}")
    return CONFIGS[rel]()


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
            enabled=True, mask_lw=1.0, ms_ssim_lw=1.0, lab_lw=0.2,
            lab_impl="pallas", lab_no_l=True, depth_chamfer_lw=1.0,
            perceptual_lw=0.15, pseudo_pm_lw=10.0, pseudo_trans_lw=1.0),
    )


def stage2_refined_flagship() -> Config:
    """stage2_pose_flagship with the in-step refiners that
    configs/self6dpp/synthetic_smoke.py turns on, at flagship widths: the
    pseudo pose refined by the DeepIM refiner (lm_flownet(): FlowNetS,
    512² zoom, its 4 test iterations; the step takes the refiner as an
    argument) and the RepjRefiner weak loss at the JAX package's weights
    (iou2d3d 0.1, PM 10, mask IoU 1, MS-SSIM 1) on 64² renders."""
    f = stage2_pose_flagship()
    return dataclasses.replace(
        f, exp_name="stage2_refined_flagship",
        self_sup=dataclasses.replace(f.self_sup, refine_with_deepim=True,
                                     repj_refine=True, repj_render_res=64))


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
