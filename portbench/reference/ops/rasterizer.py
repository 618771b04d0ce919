"""Batched tile-binned rasterizer (port of self6dpp_tpu/ops/rasterizer.py).

Two stages, as in the JAX package:
  1. bin: for every image tile (tile_px²), keep the K faces nearest the
     camera among those whose screen bbox overlaps the tile;
  2. fine: per tile × pixel × candidate, the edge tests, the z-test on
     face-mean depth, the winner's interpolated attributes and depth, and
     optionally the DIB-R soft silhouette (ops/raster_cuda.py: a CUDA kernel
     on the card, its plain PyTorch version on the CPU).

Conventions: pixel centres at integer coordinates (u right, v down), the
camera looks down +z, depth is camera-space z. Faces behind the camera,
degenerate or back-facing are culled. Public tensors are NHWC.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from .. import resolve_device
from .zoom import _bilinear_sample


class RasterOut(NamedTuple):
    mask: Tensor         # (B, H, W)   hard coverage {0,1}
    prob: Tensor         # (B, H, W)   soft silhouette probability
    depth: Tensor        # (B, H, W)   camera-space z (0 where empty)
    attr: Tensor         # (B, H, W, D) interpolated vertex attributes
    face_id: Tensor      # (B, H, W)   winning face index (-1 where empty)
    bary: Tensor         # (B, H, W, 3) clipped, renormalised barycentrics
                         #              of the winner (0 where empty)


def project_mesh(verts: Tensor, K: Tensor, R: Tensor, t: Tensor,
                 eps: float = 1e-8) -> tuple[Tensor, Tensor]:
    """verts ([B,]V,3) object frame -> pixels ([B,]V,2) and camera z ([B,]V).
    K, R ([B,]3,3); t ([B,]3)."""
    cam = verts @ R.transpose(-1, -2) + t[..., None, :]
    z = cam[..., 2]
    u = K[..., 0, 0, None] * cam[..., 0] / (z + eps) + K[..., 0, 2, None]
    v = K[..., 1, 1, None] * cam[..., 1] / (z + eps) + K[..., 1, 2, None]
    return torch.stack([u, v], dim=-1), z


def _face_gather(x: Tensor, faces: Tensor) -> Tensor:
    """x (B, V, ...), faces (B, F, 3) -> (B, F, 3, ...)."""
    b = torch.arange(x.shape[0], device=x.device)[:, None, None]
    return x[b, faces]


def _bin_faces(v2d_f: Tensor, valid_f: Tensor, height: int, width: int,
               tile_px: int, faces_per_tile: int, zmean_f: Tensor) -> Tensor:
    """Assign faces to tiles. Returns (B, T, K) int32 face ids (-1 = empty).

    v2d_f (B,F,3,2) screen-space face vertices; valid_f (B,F) bool;
    zmean_f (B,F) mean face depth. A tile whose overlap set exceeds K keeps
    the K nearest faces. Ties go to the lower face index, as jax.lax.top_k
    breaks them: a stable descending sort, never torch.topk, which promises
    no order among equal keys.
    """
    B, F = valid_f.shape
    th = -(-height // tile_px)
    tw = -(-width // tile_px)
    fmin = v2d_f.amin(dim=2)                                  # (B,F,2)
    fmax = v2d_f.amax(dim=2)
    dev = v2d_f.device
    ty = torch.arange(th, device=dev, dtype=torch.float32)[:, None] * tile_px
    tx = torch.arange(tw, device=dev, dtype=torch.float32)[:, None] * tile_px
    pad = 1.0                  # bbox test expanded 1 px for soft edges
    ov_y = ((fmin[:, None, :, 1] <= ty + tile_px + pad)
            & (fmax[:, None, :, 1] >= ty - pad))              # (B,th,F)
    ov_x = ((fmin[:, None, :, 0] <= tx + tile_px + pad)
            & (fmax[:, None, :, 0] >= tx - pad))              # (B,tw,F)
    overlap = ov_y[:, :, None, :] & ov_x[:, None, :, :] & valid_f[:, None, None, :]
    overlap = overlap.reshape(B, th * tw, F)
    key = torch.where(overlap, -zmean_f[:, None, :], -torch.inf)
    k = min(faces_per_tile, F)
    vals, idx = torch.sort(key, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    cand = torch.where(torch.isfinite(vals), idx, -1).to(torch.int32)
    if k < faces_per_tile:
        cand = torch.nn.functional.pad(cand, (0, faces_per_tile - k), value=-1)
    return cand


def _pack_faces(v2d_f: Tensor, zmean_f: Tensor, valid_f: Tensor,
                zinv_f: Tensor, attr_f: Tensor) -> Tensor:
    """Per-face table the fine stage gathers its candidates from:
    (B, F, 11 + 3D) f32 rows [x0,y0,x1,y1,x2,y2, zmean, valid, 1/z0,1/z1,1/z2,
    attr v0 (D), attr v1 (D), attr v2 (D)]."""
    B, F = valid_f.shape
    return torch.cat([v2d_f.reshape(B, F, 6), zmean_f[..., None],
                      valid_f.to(torch.float32)[..., None], zinv_f,
                      attr_f.reshape(B, F, -1)], dim=-1).contiguous()


def face_data(verts, faces, attrs, K, R, t, cull_backfaces: bool = True):
    """Projected faces and their validity. Tensors already on one device;
    verts (B,V,3)|(V,3), faces (F,3)|(B,F,3), attrs (B,V,D)|(V,D),
    K (B,3,3)|(3,3), R (B,3,3), t (B,3). Returns (v2d_f (B,F,3,2),
    zmean_f (B,F), zinv_f (B,F,3), attr_f (B,F,3,D), valid_f (B,F))."""
    B = R.shape[0]
    verts = verts.expand(B, *verts.shape[-2:])
    faces = faces.long().expand(B, *faces.shape[-2:])
    attrs = attrs.expand(B, *attrs.shape[-2:])
    K = K.expand(B, 3, 3)
    v2d, z = project_mesh(verts, K, R, t)
    v2d_f = _face_gather(v2d, faces)                          # (B,F,3,2)
    z_f = _face_gather(z, faces)                              # (B,F,3)
    attr_f = _face_gather(attrs, faces)                       # (B,F,3,D)
    zmean_f = z_f.mean(dim=2)
    zinv_f = 1.0 / z_f.clamp_min(1e-8)

    # validity: in front of the camera, non-degenerate, front-facing
    front = (z_f > 1e-6).all(dim=2)
    x0, y0 = v2d_f[..., 0, 0], v2d_f[..., 0, 1]
    x1, y1 = v2d_f[..., 1, 0], v2d_f[..., 1, 1]
    x2, y2 = v2d_f[..., 2, 0], v2d_f[..., 2, 1]
    area2 = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    valid_f = front & (area2.abs() > 1e-10)
    if cull_backfaces:
        # v-down image coords: a face whose outward normal points at the
        # camera winds clockwise on screen -> negative signed area
        valid_f = valid_f & (area2 < 0)
    return v2d_f, zmean_f, zinv_f, attr_f, valid_f


def raster_inputs(verts, faces, attrs, K, R, t, height: int, width: int,
                  tile_px: int = 16, faces_per_tile: int = 128,
                  cull_backfaces: bool = True) -> tuple[Tensor, Tensor]:
    """Everything before the fine stage: face_data, binning, face table.
    Returns (ftab (B,F,11+3D) f32, cand (B*T, K) int32)."""
    v2d_f, zmean_f, zinv_f, attr_f, valid_f = face_data(
        verts, faces, attrs, K, R, t, cull_backfaces)
    cand = _bin_faces(v2d_f, valid_f, height, width, tile_px, faces_per_tile,
                      zmean_f)
    ftab = _pack_faces(v2d_f, zmean_f, valid_f, zinv_f, attr_f)
    return ftab, cand.reshape(-1, cand.shape[-1]).contiguous()


def rasterize_batch(verts, faces, attrs, K, R, t, height: int = 64,
                    width: int = 64, tile_px: int = 16,
                    faces_per_tile: int = 128, sigma_px: float = 1.0,
                    zbuf_mode: str = "persp", cull_backfaces: bool = True,
                    with_prob: bool = True, impl: str = "kernel",
                    device=None) -> RasterOut:
    """Rasterize B meshes (or one shared mesh) under B poses.

    verts (B,V,3)|(V,3); faces (F,3)|(B,F,3); attrs (B,V,D)|(V,D);
    K (B,3,3)|(3,3); R (B,3,3); t (B,3). Arrays or tensors; they are moved
    to `device` (CUDA by default). impl: 'kernel' runs the fine stage through
    ops/raster_cuda.fine_raster (the CUDA kernel for CUDA tensors), 'plain'
    through its plain PyTorch version on any device. When gradients are
    needed the fine stage runs as raster_cuda.FineRaster, whose backward is
    kernel B2 (or its plain version): prob, depth and attr carry gradients
    back to the vertices, the pose and the attributes.
    """
    from .raster_plain import FineRaster, fine_raster_plain
    if impl not in ("kernel", "plain"):
        raise ValueError(f"unknown impl: {impl!r}")
    if zbuf_mode not in ("persp", "face"):
        raise ValueError(f"unknown zbuf_mode: {zbuf_mode!r}")
    dev = resolve_device(device)
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    ftab, cand = raster_inputs(
        f32(verts), torch.as_tensor(faces, device=dev), f32(attrs), f32(K),
        f32(R), f32(t), height, width, tile_px, faces_per_tile,
        cull_backfaces)
    args = (ftab, cand, height, width, tile_px, sigma_px, with_prob,
            zbuf_mode == "persp")
    if torch.is_grad_enabled() and ftab.requires_grad:
        return RasterOut(*FineRaster.apply(*args, impl))
    return fine_raster_plain(*args)


def rasterize_single(verts, faces, attrs, K, R, t, **kw) -> RasterOut:
    """One mesh under one pose: verts (V,3), faces (F,3), attrs (V,D), K,
    R (3,3), t (3,), through rasterize_batch as a batch of one (its
    keywords); outputs without the batch axis."""
    R = torch.as_tensor(R)[None]
    t = torch.as_tensor(t)[None]
    out = rasterize_batch(verts, faces, attrs, K, R, t, **kw)
    return RasterOut(*(x[0] for x in out))


def render_xyz_mask_depth(verts, faces, K, R, t, height, width, **kw):
    """Object-frame xyz, hard mask, depth and soft silhouette of B poses
    (rasterize_batch with the vertices as the attribute)."""
    out = rasterize_batch(verts, faces, verts, K, R, t,
                          height=height, width=width, **kw)
    return {"xyz": out.attr, "mask": out.mask, "depth": out.depth,
            "prob": out.prob}


def render_color(verts, faces, colors, K, R, t, height, width, **kw):
    """Vertex-colour render of B poses: color, soft silhouette, hard mask,
    depth."""
    out = rasterize_batch(verts, faces, colors, K, R, t,
                          height=height, width=width, **kw)
    return {"color": out.attr, "prob": out.prob, "mask": out.mask,
            "depth": out.depth}


def sample_texture(tex: Tensor, u: Tensor, v: Tensor,
                   index: Tensor | None = None) -> Tensor:
    """Bilinear texture lookup of UVs u, v (B, H, W) at pixel coordinates
    (u (Wt - 1), v (Ht - 1)), as the JAX package samples a texture: tex
    (N, Ht, Wt, C), image index[b] (default b) for row b, taps outside
    read zero (ops/zoom.py::_bilinear_sample). Differentiable in u, v and
    tex."""
    ht, wt = tex.shape[1], tex.shape[2]
    return _bilinear_sample(tex, u * (wt - 1), v * (ht - 1), index)


def _textures_for(texture: Tensor, B: int) -> tuple[Tensor, Tensor | None]:
    """A shared (Ht, Wt, C) texture as a table of one read by every image,
    or B textures (B, Ht, Wt, C) read in order."""
    if texture.ndim == 3:
        return texture[None], torch.zeros(B, dtype=torch.long,
                                          device=texture.device)
    return texture, None


def render_textured(verts, faces, uv, texture, K, R, t, height, width,
                    **kw):
    """Texture-mapped render of B poses (DIB-R TexRender): the per-vertex
    UVs rasterised as two attribute channels (the fine stage's kernels at
    D = 2), then the texture sampled bilinearly at them and masked. uv
    (V,2)|(B,V,2) in [0, 1] (v down); texture (Ht,Wt,3) shared or
    (B,Ht,Wt,3). Differentiable in the pose, the vertices, the UVs and the
    texels. Returns color, soft silhouette, hard mask, depth."""
    out = rasterize_batch(verts, faces, uv, K, R, t,
                          height=height, width=width, **kw)
    tex, index = _textures_for(
        torch.as_tensor(texture, dtype=torch.float32,
                        device=out.attr.device), out.mask.shape[0])
    color = sample_texture(tex, out.attr[..., 0], out.attr[..., 1], index)
    return {"color": color * out.mask[..., None], "prob": out.prob,
            "mask": out.mask, "depth": out.depth}


def render_shaded(verts, faces, normals, K, R, t, height, width, *,
                  mode: str = "lambertian", colors=None, uv=None,
                  texture=None, light_dir=(0.0, 0.0, -1.0),
                  ambient: float = 0.4, diffuse: float = 0.6,
                  material=None, shininess: float = 40.0, sh_coeffs=None,
                  **kw):
    """Lit render of B poses (DIB-R's Lambertian, Phong and
    spherical-harmonics modes): one rasterisation of [albedo | normal]
    attributes (vertex colours, or UVs and a texture), then the shading
    per pixel on the camera-frame normal R n. normals (V,3)|(B,V,3)
    object-frame vertex normals (compute_vertex_normals); light_dir (3,) or
    (B,3) in the camera frame; material (B,3,3) rows ambient, diffuse,
    specular (phong; default [[a]*3, [d]*3, [0.5]*3]); sh_coeffs (B,9).
    Returns color (clipped to [0, 1], masked), soft silhouette, hard mask,
    depth and the camera-frame normal (masked)."""
    from .geometry import backproject_depth
    dev = resolve_device(kw.get("device"))
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    use_tex = uv is not None
    base_attr = f32(uv if use_tex else colors)
    normals = f32(normals)
    R = f32(R)
    nd = base_attr.shape[-1]
    if base_attr.ndim != normals.ndim:
        B = R.shape[0]
        base_attr = base_attr.expand(B, *base_attr.shape[-2:])
        normals = normals.expand(B, *normals.shape[-2:])
    attrs = torch.cat([base_attr, normals], dim=-1)
    out = rasterize_batch(verts, faces, attrs, K, R, t,
                          height=height, width=width, **kw)
    B = out.mask.shape[0]
    n_obj = out.attr[..., nd:nd + 3]
    Rb = R.expand(B, 3, 3)
    n_cam = torch.einsum("bij,bhwj->bhwi", Rb, n_obj)
    n_cam = n_cam / torch.linalg.vector_norm(
        n_cam, dim=-1, keepdim=True).clamp_min(1e-8)

    if use_tex:
        tex, index = _textures_for(f32(texture), B)
        base = sample_texture(tex, out.attr[..., 0], out.attr[..., 1], index)
    else:
        base = out.attr[..., :3]

    if mode == "sh":
        if sh_coeffs is None:
            raise ValueError("sh mode needs sh_coeffs (B, 9)")
        x, y, z = n_cam[..., 0:1], n_cam[..., 1:2], n_cam[..., 2:3]
        bands = torch.cat([
            0.2820948 * torch.ones_like(x),
            -0.3257350 * y, 0.3257350 * z, -0.3257350 * x,
            0.2731371 * (x * y), -0.2731371 * (y * z),
            0.1365686 * (z * z) - 0.0788479,
            -0.1931371 * (x * z), 0.1365686 * (x * x - y * y),
        ], dim=-1)                                            # (B,H,W,9)
        coef = (bands * f32(sh_coeffs)[:, None, None, :]).sum(
            -1, keepdim=True)
        color = coef * base
    elif mode in ("lambertian", "phong"):
        light = f32(light_dir)
        light = light / torch.linalg.vector_norm(
            light, dim=-1, keepdim=True).clamp_min(1e-8)
        lb = light.expand(B, 3)[:, None, None, :]
        cos_t = (n_cam * lb).sum(-1, keepdim=True).clamp(0.0, 1.0)
        if mode == "lambertian":
            color = base * (ambient + diffuse * cos_t)
        else:
            mat = f32(material) if material is not None else f32(
                [[ambient] * 3, [diffuse] * 3, [0.5] * 3]).expand(B, 3, 3)
            # the eye direction from the camera-frame fragment position
            pos = backproject_depth(out.depth, f32(K).expand(B, 3, 3))
            eye = -pos / torch.linalg.vector_norm(
                pos, dim=-1, keepdim=True).clamp_min(1e-8)
            refl = -lb + 2.0 * cos_t * n_cam
            cos_a = (refl * eye).sum(-1, keepdim=True).clamp(1e-5, 1.0)
            cos_a = cos_a ** shininess
            amb = mat[:, 0][:, None, None, :]
            dif = mat[:, 1][:, None, None, :] * cos_t
            spe = mat[:, 2][:, None, None, :] * cos_a
            color = (amb + dif) * base + spe
    else:
        raise ValueError(f"unknown shading mode: {mode}")

    color = color.clamp(0.0, 1.0) * out.mask[..., None]
    return {"color": color, "prob": out.prob, "mask": out.mask,
            "depth": out.depth, "normal": n_cam * out.mask[..., None]}


def compute_vertex_normals(verts: Tensor, faces: Tensor) -> Tensor:
    """Area-weighted vertex normals of one mesh (V,3), (F,3): each face's
    edge cross product added to its three vertices (index_add_), then
    normalised."""
    faces = faces.long()
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    fn = torch.linalg.cross(v1 - v0, v2 - v0)
    vn = torch.zeros_like(verts)
    for i in range(3):
        vn.index_add_(0, faces[:, i], fn)
    return vn / torch.linalg.vector_norm(vn, dim=-1, keepdim=True).clamp_min(1e-12)
