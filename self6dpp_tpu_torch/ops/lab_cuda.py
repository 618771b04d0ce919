"""LAB loss value and image gradient in one pass: the CUDA kernel
csrc/lab_value_grad.cu (kernel B3) and its plain PyTorch version.

The kernel replaces the TPU kernel B3, self6dpp_tpu/ops/lab_pallas.py::
_kernel (lab_value_grad_pallas -> pallas_call). Both compute, for pred and
gt (B, S, S, 3) NHWC float32 and a mask (B, S, S):
  the masked L1 on Lab a, b (+ L when no_l is False) and its analytic
  gradient d/d(pred) through the sRGB linearisation, XYZ, f(t) (cube root
  branch) and Lab, both divided by max(sum(mask), 1) * n_ch,
the value of ops/color.py::lab_loss and its gradient. The stage-II step
injects the gradient into the render's cotangent (losses/self_loss.py::
InjectGrad), as the JAX package does.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch import Tensor

from .color import FT, RGB2XYZ, SRGB_T, XYZ_REF

_EPS = 1e-8
_BLOCK = 256            # threads (pixels) per block of the first pass


def _split_lab_grad(p: Tensor, g: Tensor, no_l: bool) -> tuple[Tensor, Tensor]:
    """Per-pixel |Lab difference| (B,S,S) and its gradient with respect to
    p (B,S,S,3), before masking. The analytic chain of lab_pallas._kernel."""
    def lin(c):
        return torch.where(c > SRGB_T, ((c + 0.055) / 1.055) ** 2.4, c / 12.92)

    def dlin(c):
        return torch.where(c > SRGB_T, (2.4 / 1.055) * ((c + 0.055) / 1.055) ** 1.4,
                           torch.full_like(c, 1.0 / 12.92))

    def cbrt(c):
        return c.clamp_min(_EPS) ** (1.0 / 3.0)

    def f(c):
        return torch.where(c > FT, cbrt(c), 7.787 * c + 16.0 / 116.0)

    def df(c):
        cb = cbrt(c)
        dcbrt = torch.where(c > _EPS, 1.0 / (3.0 * cb * cb), torch.zeros_like(c))
        return torch.where(c > FT, dcbrt, torch.full_like(c, 7.787))

    def chans(rgb):
        rl, gl, bl = (lin(c) for c in rgb.unbind(-1))
        M = RGB2XYZ
        xyz = [(M[i][0] * rl + M[i][1] * gl + M[i][2] * bl) / XYZ_REF[i]
               for i in range(3)]
        fx, fy, fz = (f(c) for c in xyz)
        return xyz, (116.0 * fy - 16.0, 500.0 * (fx - fy), 200.0 * (fy - fz))

    (xp, yp, zp), (Lp, ap, bp) = chans(p)
    _, (Lg, ag, bg) = chans(g)
    diff = (ap - ag).abs() + (bp - bg).abs()
    sa, sb = torch.sign(ap - ag), torch.sign(bp - bg)
    dfx = 500.0 * sa
    dfy = -500.0 * sa + 200.0 * sb
    dfz = -200.0 * sb
    if not no_l:
        diff = diff + (Lp - Lg).abs()
        dfy = dfy + 116.0 * torch.sign(Lp - Lg)
    dx = dfx * df(xp) / XYZ_REF[0]
    dy = dfy * df(yp) / XYZ_REF[1]
    dz = dfz * df(zp) / XYZ_REF[2]
    M = RGB2XYZ
    grad = torch.stack([(dx * M[0][j] + dy * M[1][j] + dz * M[2][j])
                        * dlin(p[..., j]) for j in range(3)], dim=-1)
    return diff, grad


def lab_value_grad_plain(pred: Tensor, gt: Tensor, mask: Tensor,
                         no_l: bool = True) -> tuple[Tensor, Tensor]:
    """Plain PyTorch version of kernel B3: (value, d value / d pred)."""
    diff, grad = _split_lab_grad(pred, gt, no_l)
    n_ch = 2 if no_l else 3
    norm = 1.0 / (mask.sum().clamp_min(1.0) * n_ch)
    return (diff * mask).sum() * norm, grad * mask[..., None] * norm


@functools.cache
def _lib() -> ctypes.CDLL:
    from ..kernels import build
    lib = build.load("lab_value_grad")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lab_value_grad.argtypes = [p] * 6 + [i, i, i, p]
    lib.lab_value_grad.restype = i
    return lib


def lab_value_grad(pred: Tensor, gt: Tensor, mask: Tensor,
                   no_l: bool = True) -> tuple[Tensor, Tensor]:
    """(value, gradient): the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. The value is a 0-d tensor on the device (no
    host round trip). `lab_value_grad.launches` counts kernel launches,
    two per call (the per-block pass and the reduction of its partials)."""
    if all(x.device.type == "cpu" for x in (pred, gt, mask)):
        return lab_value_grad_plain(pred, gt, mask, no_l)
    if pred.device.type != "cuda" or gt.device != pred.device \
            or mask.device != pred.device:
        raise ValueError("pred, gt and mask must lie on one CUDA device "
                         "(or the CPU)")
    if any(x.dtype != torch.float32 for x in (pred, gt, mask)):
        raise TypeError("lab_value_grad takes float32 tensors")
    if pred.ndim != 4 or pred.shape[-1] != 3 or gt.shape != pred.shape \
            or mask.shape != pred.shape[:3]:
        raise ValueError(f"need pred, gt (B,S,S,3) and mask (B,S,S); got "
                         f"{tuple(pred.shape)}, {tuple(gt.shape)}, "
                         f"{tuple(mask.shape)}")
    pred, gt, mask = pred.contiguous(), gt.contiguous(), mask.contiguous()
    n = mask.numel()
    nblocks = -(-n // _BLOCK)
    grad = torch.empty_like(pred)
    partial = torch.empty((nblocks, 2), dtype=torch.float32, device=pred.device)
    sums = torch.empty(2, dtype=torch.float32, device=pred.device)
    with torch.cuda.device(pred.device):
        stream = torch.cuda.current_stream(pred.device).cuda_stream
        err = _lib().lab_value_grad(pred.data_ptr(), gt.data_ptr(),
                                    mask.data_ptr(), grad.data_ptr(),
                                    partial.data_ptr(), sums.data_ptr(), n,
                                    nblocks, int(no_l), stream)
    if err != 0:
        raise RuntimeError(f"lab_value_grad launch failed: CUDA error {err}")
    lab_value_grad.launches += 2        # lab_pixels_kernel, lab_reduce_kernel
    n_ch = 2 if no_l else 3
    norm = 1.0 / (sums[1].clamp_min(1.0) * n_ch)
    return sums[0] * norm, grad * norm


lab_value_grad.launches = 0
