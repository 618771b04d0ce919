"""What the benchmark feeds both sides, made from --seed on the run's device
in a few large draws: meshes, GDR-Net batches, DeepIM requests and every
network's weights. The program and the reference get the same tensors (or
the same draws again), and neither makes any of them."""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import Tensor, nn

# LINEMOD's camera (BOP lm), the frame of every ROI and request
LM_K = ((572.4114, 0.0, 325.2611), (0.0, 573.57043, 242.04899),
        (0.0, 0.0, 1.0))


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on `device` for one named stream of a run's draws (0:
    weights, 1: inputs, ...), seeded from --seed; any seed up to 2**62."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (1 << 63))
    return g


def icosphere(subdivisions: int) -> tuple[np.ndarray, np.ndarray]:
    """The unit icosphere: 20 * 4**subdivisions faces, outward winding."""
    t = (1.0 + 5.0 ** 0.5) / 2.0
    verts = [(-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0), (0, -1, t),
             (0, 1, t), (0, -1, -t), (0, 1, -t), (t, 0, -1), (t, 0, 1),
             (-t, 0, -1), (-t, 0, 1)]
    verts = [np.array(v, dtype=np.float64) for v in verts]
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
             (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
             (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
             (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    for _ in range(subdivisions):
        mid: dict[tuple[int, int], int] = {}

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                mid[key] = len(verts)
                verts.append((verts[a] + verts[b]) / 2.0)
            return mid[key]
        new = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = new
    v = np.stack(verts)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v.astype(np.float32), np.asarray(faces, dtype=np.int32)


def class_meshes(spec: dict, num_classes: int, g: torch.Generator, device
                 ) -> dict[str, Tensor]:
    """One icosphere per class, as the configuration's `meshes` entry says:
    subdivisions, radius (one, or [lo, hi] spread over the classes) and
    colours ('position': normalised vertex positions; 'normal_tint': the
    normal in [0, 1] tinted by a per-class draw from U(0.2, 1))."""
    unit, faces = icosphere(spec["subdivisions"])
    unit_t = torch.from_numpy(unit).to(device)
    r = spec["radius"]
    radii = (torch.full((num_classes,), float(r)) if np.isscalar(r) else
             torch.linspace(float(r[0]), float(r[1]), num_classes))
    verts = radii.to(device)[:, None, None] * unit_t[None]
    if spec["colors"] == "position":
        lo, hi = unit_t.min(0).values, unit_t.max(0).values
        colors = ((unit_t - lo) / (hi - lo))[None].expand(num_classes, -1, -1)
    else:
        tint = torch.rand((num_classes, 1, 3), generator=g, device=device)
        colors = 0.5 * (unit_t[None] + 1.0) * (0.2 + 0.8 * tint)
    return {"verts": verts.contiguous(),
            "faces": torch.from_numpy(faces).to(device)[None]
            .expand(num_classes, -1, -1).contiguous(),
            "colors": colors.contiguous().float()}


def random_rotations(n: int, g: torch.Generator, device) -> Tensor:
    """n rotation matrices uniform on SO(3) (normalised Gaussian
    quaternions)."""
    q = torch.randn((n, 4), generator=g, device=device)
    w, x, y, z = (q / q.norm(dim=1, keepdim=True)).unbind(1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
        2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
        2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y),
    ], 1).view(n, 3, 3)


def axis_angle(v: Tensor) -> Tensor:
    """Rotation matrices of rotation vectors v (n, 3) (Rodrigues)."""
    th = v.norm(dim=1, keepdim=True).clamp_min(1e-12)
    k = v / th
    kx = torch.zeros((v.shape[0], 3, 3), device=v.device)
    kx[:, 0, 1], kx[:, 0, 2] = -k[:, 2], k[:, 1]
    kx[:, 1, 0], kx[:, 1, 2] = k[:, 2], -k[:, 0]
    kx[:, 2, 0], kx[:, 2, 1] = -k[:, 1], k[:, 0]
    s, c = th.sin()[..., None], th.cos()[..., None]
    return torch.eye(3, device=v.device) + s * kx + (1 - c) * kx @ kx


def _uniform(shape, lo, hi, g, device):
    return torch.rand(shape, generator=g, device=device) * (hi - lo) + lo


def zoom_K(K: Tensor, boxes: Tensor, out_hw: tuple[int, int]) -> Tensor:
    """Intrinsics of the crop `boxes` (B, 4: x1, y1, x2, y2) resized to
    out_hw."""
    sx = out_hw[1] / (boxes[:, 2] - boxes[:, 0])
    sy = out_hw[0] / (boxes[:, 3] - boxes[:, 1])
    Kz = K.clone()
    Kz[:, 0, 0] = K[:, 0, 0] * sx
    Kz[:, 0, 2] = (K[:, 0, 2] - boxes[:, 0]) * sx
    Kz[:, 1, 1] = K[:, 1, 1] * sy
    Kz[:, 1, 2] = (K[:, 1, 2] - boxes[:, 1]) * sy
    return Kz


def gdrn_batch(model_sizes: dict, rois: int, meshes: dict, g: torch.Generator,
               device, n_points: int = 512, max_sym: int = 32
               ) -> dict[str, Tensor]:
    """One GDR-Net training batch of `rois` ROIs with the port's batch
    contract (data/synthetic.py's keys and draws: consistent ground-truth
    poses in LINEMOD's frame, a noise image, random dense labels), the
    class meshes and each ROI's zoomed intrinsics (roi_zoom_K: the square
    crop of side output_res / resize_ratio around roi_center, resized to
    input_res)."""
    s, o = model_sizes["input_res"], model_sizes["output_res"]
    nc, nreg = model_sizes["num_classes"], model_sizes["num_regions"]
    b = rois
    u = lambda shape, lo=0.0, hi=1.0: _uniform(shape, lo, hi, g, device)
    K = torch.tensor(LM_K, device=device)
    roi_center = u((b, 2), 200.0, 440.0)
    roi_wh = u((b, 1), 80.0, 160.0).expand(b, 2).contiguous()
    z = u((b,), 0.6, 1.4)
    gt_trans = torch.stack([(roi_center[:, 0] - K[0, 2]) / K[0, 0] * z,
                            (roi_center[:, 1] - K[1, 2]) / K[1, 1] * z, z], 1)
    resize_ratio = o / (roi_wh[:, 0] * 1.5)
    sym_valid = torch.zeros((b, max_sym), dtype=torch.bool, device=device)
    sym_valid[:, 0] = True
    batch = {
        "roi_img": u((b, s, s, 3)),
        "roi_cls": torch.randint(0, nc, (b,), generator=g, device=device,
                                 dtype=torch.int32),
        "roi_cam": K.expand(b, 3, 3).contiguous(),
        "roi_center": roi_center, "roi_wh": roi_wh,
        "roi_extent": u((b, 3), 0.05, 0.3),
        "resize_ratio": resize_ratio,
        "roi_coord_2d": u((b, o, o, 2)),
        "gt_xyz": u((b, o, o, 3)),
        "gt_xyz_bin": torch.randint(0, 64, (b, o, o, 3), generator=g,
                                    device=device, dtype=torch.int32),
        "gt_mask_trunc": (u((b, o, o)) > 0.5).float(),
        "gt_mask_visib": (u((b, o, o)) > 0.5).float(),
        "gt_mask_obj": (u((b, o, o)) > 0.5).float(),
        "gt_mask_full": (u((b, o, o)) > 0.5).float(),
        "gt_region": torch.randint(0, nreg + 1, (b, o, o), generator=g,
                                   device=device, dtype=torch.int32),
        "gt_rot": random_rotations(b, g, device),
        "gt_trans": gt_trans,
        "gt_trans_ratio": torch.stack([torch.zeros_like(z), torch.zeros_like(z),
                                       z / resize_ratio], 1),
        "gt_points": torch.randn((b, n_points, 3), generator=g,
                                 device=device) * 0.05,
        "sym_rots": torch.eye(3, device=device).expand(b, max_sym, 3, 3)
        .contiguous(),
        "sym_valid": sym_valid,
        "mesh_verts": meshes["verts"], "mesh_faces": meshes["faces"],
        "mesh_colors": meshes["colors"],
    }
    side = o / resize_ratio
    x1 = roi_center[:, 0] - side / 2
    y1 = roi_center[:, 1] - side / 2
    boxes = torch.stack([x1, y1, x1 + side, y1 + side], 1)
    batch["roi_zoom_K"] = zoom_K(batch["roi_cam"], boxes, (s, s))
    return batch


def take_rows(batch: dict[str, Tensor], rows: slice) -> dict[str, Tensor]:
    """The batch cut to `rows` of its ROIs (per-class tables kept whole)."""
    b = batch["roi_img"].shape[0]
    return {k: v[rows] if not k.startswith("mesh_") and v.shape[:1] == (b,)
            else v for k, v in batch.items()}


# -- weights ---------------------------------------------------------------

def _linear_like(m: nn.Module) -> bool:
    return isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear))


def fan_in(m: nn.Module) -> int:
    w = m.weight
    if isinstance(m, nn.ConvTranspose2d):
        return w.shape[0] * w.shape[2] * w.shape[3]
    return math.prod(w.shape[1:])


@torch.no_grad()
def draw_weights_(model: nn.Module, g: torch.Generator, std_of) -> None:
    """Every conv, transposed conv and dense weight from one normal draw on
    the model's device, scaled by std_of(name, module) and cut at 2 std
    (a truncated normal); biases 0, norms at scale 1 and bias 0, batch-norm
    statistics (0, 1). Drawn in float32 and cast to each weight's dtype,
    so a bfloat16 and a float32 build from one seed share their weights."""
    mods = [(n, m) for n, m in model.named_modules() if _linear_like(m)]
    total = sum(m.weight.numel() for _, m in mods)
    dev = next(model.parameters()).device
    z = torch.randn(total, generator=g, device=dev)
    off = 0
    for name, m in mods:
        n = m.weight.numel()
        std = float(std_of(name, m))
        w = z[off:off + n].view(m.weight.shape) * std
        m.weight.copy_(w.clamp(-2 * std, 2 * std))
        off += n
        if m.bias is not None:
            m.bias.zero_()
    for m in model.modules():
        if isinstance(m, (nn.BatchNorm2d, nn.GroupNorm, nn.LayerNorm)) \
                and m.weight is not None:
            m.weight.fill_(1.0)
            m.bias.zero_()
        if isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.running_mean.zero_()
            m.running_var.fill_(1.0)


def gdrn_std(name: str, m: nn.Module) -> float:
    """GDR-Net: N(0, 0.01) for the geo head's output layers and the pose
    outputs, as the JAX package initialises them; LeCun normal elsewhere,
    the PnP head's hidden layers too (the JAX package draws those at
    N(0, 0.001), which leaves every ROI's pose at the output biases: with
    unit gain the pose, and so each ROI's share of the gradient, depends
    on its input)."""
    if name.startswith("geo_head_net.out_") or name in (
            "pnp_net.fc_r", "pnp_net.fc_t", "pnp_net.fc_pose"):
        return 0.01
    return fan_in(m) ** -0.5


def deepim_std(name: str, m: nn.Module) -> float:
    """Unit gain (N(0, fan_in^-1/2)) with the pose outputs at 0.3: with the
    JAX package's small head initialisers the refined pose hardly depends
    on the render, and a comparison could not see a wrong one."""
    if name.startswith("pose_head.fc_"):
        return 0.3
    return fan_in(m) ** -0.5


@torch.no_grad()
def lpips_weights_(lpips: nn.Module, g: torch.Generator) -> None:
    """LPIPS: LeCun-normal AlexNet convs, linear heads uniform in [0, 0.1)."""
    draw_weights_(lpips, g, lambda n, m: fan_in(m) ** -0.5)
    dev = next(lpips.parameters()).device
    for i in range(5):
        w = getattr(lpips, f"lin{i}")
        w.copy_(torch.rand(w.shape, generator=g, device=dev) * 0.1)


@torch.no_grad()
def offset_teacher_(params: list[Tensor], g: torch.Generator,
                    rel: float) -> None:
    """A teacher past its EMA ramp, apart from the student: each parameter
    moved by rel times its leaf's root mean square, with a sign drawn from
    the seed for each element (one draw). At the step where the teacher
    equals the student, its L1 terms sit at their kink, and their gradient
    is the sign of rounding noise; a distance drawn near 0 would do the
    same to one element."""
    total = sum(p.numel() for p in params)
    signs = torch.randint(0, 2, (total,), generator=g,
                          device=params[0].device) * 2 - 1
    off = 0
    for p in params:
        n = p.numel()
        rms = p.float().square().mean().sqrt()
        p.add_((signs[off:off + n].view(p.shape) * (rel * rms)).to(p.dtype))
        off += n


@torch.no_grad()
def aim_gdrn_(model: nn.Module, batch: dict[str, Tensor]) -> None:
    """Bias the pose and mask outputs toward a usable stage-II start (as the
    port's aim_heads_ does for allo_rot6d with a REL centroid_z): an
    identity allocentric rotation, the batch's median relative depth and
    a mask logit of 10, so that the render of the predicted pose shows the
    mesh and the teacher's pseudo mask covers the ROI."""
    t = torch.zeros(3, device=batch["gt_trans"].device)
    t[2] = (batch["gt_trans"][:, 2] / batch["resize_ratio"]).median()
    rot = torch.tensor([1.0, 0.0, 0.0, 0.0, 1.0, 0.0], device=t.device)
    pn = model.pnp_net
    if hasattr(pn, "fc_pose"):
        pn.fc_pose.bias.copy_(torch.cat([rot, t]))
    else:
        pn.fc_r.bias.copy_(rot)
        pn.fc_t.bias.copy_(t)
    gh = model.geo_head_net
    out = gh.out_layer if hasattr(gh, "out_layer") else gh.out_mask
    out.bias[0] = 10.0
