"""The LAB opaque probe's stand-in gradient, sign(r - i) * 1e-3: the CUDA
kernels csrc/sign_g.cu (P1, P2) and their plain PyTorch versions.

The kernels replace the TPU kernels of tools/probes/lab_opaque_probe.py:
P1, _sign_kernel (pallas_g), on r and i as (B, n); P2, _sign3_kernel
(pallas_g_split), on three channel-split (B, S²) planes of each. The sign
is jnp.sign's: ±0 and NaN map to themselves (torch.sign(-0.0) is +0.0), so
both versions write d > 0 ? 1 : (d < 0 ? -1 : d), times 1e-3, and agree
bitwise with each other and with the JAX kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch import Tensor


def _sign_scaled(r: Tensor, i: Tensor) -> Tensor:
    d = r - i
    return torch.where(d > 0, 1.0, torch.where(d < 0, -1.0, d)) * 1e-3


def sign_g_plain(r: Tensor, i: Tensor) -> Tensor:
    """Plain PyTorch version of kernel P1."""
    return _sign_scaled(r, i)


def sign_g_split_plain(r: tuple[Tensor, Tensor, Tensor],
                       i: tuple[Tensor, Tensor, Tensor]
                       ) -> tuple[Tensor, Tensor, Tensor]:
    """Plain PyTorch version of kernel P2."""
    return tuple(_sign_scaled(a, b) for a, b in zip(r, i))


@functools.cache
def _lib() -> ctypes.CDLL:
    from ..kernels import build
    lib = build.load("sign_g")
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.sign_g.argtypes = [p, p, p, i64, p]
    lib.sign_g.restype = ctypes.c_int
    lib.sign_g_split.argtypes = [p, p, p, i64, i64, p]
    lib.sign_g_split.restype = ctypes.c_int
    return lib


def _check(planes: list[Tensor], name: str) -> None:
    dev = planes[0].device
    if dev.type != "cuda" or any(x.device != dev for x in planes):
        raise ValueError(f"{name}: the inputs must lie on one CUDA device "
                         "(or the CPU)")
    if any(x.dtype != torch.float32 for x in planes):
        raise TypeError(f"{name} takes float32 tensors")
    if planes[0].ndim != 2 or any(x.shape != planes[0].shape for x in planes):
        raise ValueError(f"{name}: need (B, n) inputs of one shape; got "
                         f"{[tuple(x.shape) for x in planes]}")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def sign_g(r: Tensor, i: Tensor) -> Tensor:
    """P1: sign(r - i) * 1e-3 of (B, n) float32 tensors, as (B, n): the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors.
    `sign_g.launches` counts kernel launches."""
    if r.device.type == "cpu" and i.device.type == "cpu":
        return sign_g_plain(r, i)
    _check([r, i], "sign_g")
    r, i = r.contiguous(), i.contiguous()
    out = torch.empty_like(r)
    with torch.cuda.device(r.device):
        err = _lib().sign_g(r.data_ptr(), i.data_ptr(), out.data_ptr(),
                            r.numel(), _stream(r.device))
    if err != 0:
        raise RuntimeError(f"sign_g launch failed: CUDA error {err}")
    sign_g.launches += 1
    return out


def sign_g_split(r: tuple[Tensor, Tensor, Tensor],
                 i: tuple[Tensor, Tensor, Tensor]
                 ) -> tuple[Tensor, Tensor, Tensor]:
    """P2: sign(r_c - i_c) * 1e-3 for three channel planes r_c, i_c, each
    (B, n) float32 at any strides (a channel view of an NHWC tensor, say);
    returns three contiguous (B, n) planes. The CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. `sign_g_split.launches`
    counts kernel launches."""
    planes = [*r, *i]
    if len(planes) != 6:
        raise ValueError("sign_g_split takes three r and three i planes")
    if all(x.device.type == "cpu" for x in planes):
        return sign_g_split_plain(tuple(r), tuple(i))
    _check(planes, "sign_g_split")
    if any(s < 0 for x in planes for s in x.stride()):
        raise ValueError("sign_g_split takes planes with non-negative strides")
    batch, n = planes[0].shape
    out = [torch.empty((batch, n), dtype=torch.float32, device=r[0].device)
           for _ in range(3)]
    ptrs = (ctypes.c_void_p * 6)(*(x.data_ptr() for x in planes))
    strides = (ctypes.c_int64 * 12)(*(s for x in planes for s in x.stride()))
    outs = (ctypes.c_void_p * 3)(*(x.data_ptr() for x in out))
    with torch.cuda.device(r[0].device):
        err = _lib().sign_g_split(ctypes.addressof(ptrs),
                                  ctypes.addressof(strides),
                                  ctypes.addressof(outs), batch, n,
                                  _stream(r[0].device))
    if err != 0:
        raise RuntimeError(f"sign_g_split launch failed: CUDA error {err}")
    sign_g_split.launches += 1
    return tuple(out)


sign_g.launches = 0
sign_g_split.launches = 0
