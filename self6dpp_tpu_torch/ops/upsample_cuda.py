"""The geo head's bilinear 2x upsample with align_corners=True on the card:
the launchers of csrc/upsample2x.cu's forward and backward kernels.

models/layers.py holds what they read and what they are held to: the
cached index and weight tables (upsample_tables), the plain forward
(upsample2x_align_corners_plain, the JAX package's gathers and lerps) and
the plain gather-form backward (upsample2x_align_corners_bwd_plain), and
the dispatcher upsample2x_align_corners, whose autograd Function calls
these two for CUDA tensors. Both take NCHW-contiguous bfloat16 or float32
tensors and raise on anything else.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch import Tensor

# a block's shared memory (one band of rows of one plane): small enough that
# several blocks share an SM; a band is halved until its rows fit
SMEM_TARGET = 32 * 1024
MAX_SMEM = 227 * 1024           # an H100 block's largest opt-in
_BF16 = {torch.bfloat16: 1, torch.float32: 0}


@functools.cache
def _lib() -> ctypes.CDLL:
    from ..kernels import build
    lib = build.load("upsample2x")
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.upsample2x_fwd.argtypes = [p, p, i, i64, i, i, p, p, p, p, i, i, i,
                                   p]
    lib.upsample2x_fwd.restype = i
    lib.upsample2x_bwd.argtypes = [p, p, i, i64, i, i, p, p, p, i, p, p, p,
                                   i, i, i, i, p]
    lib.upsample2x_bwd.restype = i
    return lib


def band_plan(first: tuple[int, ...], last: tuple[int, ...],
              row_bytes: int) -> tuple[int, int]:
    """(rows a band, most source rows a band reads) for a pass whose row r
    reads the source rows first[r] .. last[r] (both non-decreasing), each
    taking row_bytes of shared memory: all rows in one band, halved until
    the source rows of a band fit SMEM_TARGET (or a band is one row).
    Raises when one row's do not fit MAX_SMEM."""
    n = len(first)
    rows = n
    while True:
        need = max(last[min(r + rows, n) - 1] - first[r] + 1
                   for r in range(0, n, rows))
        if need * row_bytes <= SMEM_TARGET or rows == 1:
            break
        rows = (rows + 1) // 2
    if need * row_bytes + 16 > MAX_SMEM:
        raise ValueError(f"upsample2x: source rows of {row_bytes} bytes do "
                         "not fit a block's shared memory")
    return rows, need


def smem_bytes(rows: int, floats: int, elems: int, elem_bytes: int) -> int:
    """A block's shared memory in csrc/upsample2x.cu: rows x floats float32
    sums, padded to 16 bytes, then the staged rows x elems source
    elements."""
    return (rows * floats + 3) // 4 * 16 + rows * elems * elem_bytes


@functools.cache
def _plans(tab, elem_bytes: int) -> tuple[tuple[int, int, int], ...]:
    """(band rows, source rows, shared bytes) of the forward and of the
    backward for one table set and element size (cached: upsample_tables
    keeps each set for the process)."""
    y, w = tab.y, tab.x.n
    fr, fm = band_plan(y.lo_host, y.hi_host, 2 * w * 4 + w * elem_bytes)
    br, bm = band_plan(y.inv_lo_host, y.inv_hi_host,
                       w * 4 + 2 * w * elem_bytes)
    return ((fr, fm, smem_bytes(fm, 2 * w, w, elem_bytes)),
            (br, bm, smem_bytes(bm, w, 2 * w, elem_bytes)))


def _check(t: Tensor, name: str, shape: tuple[int, int]) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got "
                         f"{t.device}")
    if t.dtype not in _BF16:
        raise TypeError(f"{name} takes bfloat16 or float32, got {t.dtype}")
    if t.ndim != 4 or tuple(t.shape[2:]) != shape:
        raise ValueError(f"{name}: need (N, C, {shape[0]}, {shape[1]}), got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} takes NCHW-contiguous tensors (not "
                         "channels-last or strided views)")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def upsample2x(x: Tensor, tab) -> Tensor:
    """(N, C, 2h, 2w) from x (N, C, h, w) on a card, bitwise equal to
    models/layers.py::upsample2x_align_corners_plain there; tab is
    upsample_tables(h, w, x.dtype, x.device). `upsample2x.launches` counts
    kernel launches."""
    h, w = tab.y.n, tab.x.n
    _check(x, "upsample2x", (h, w))
    out = x.new_empty((x.shape[0], x.shape[1], 2 * h, 2 * w))
    planes = x.shape[0] * x.shape[1]
    if planes == 0:
        return out
    (rows, src_rows, smem), _ = _plans(tab, x.element_size())
    with torch.cuda.device(x.device):
        err = _lib().upsample2x_fwd(
            x.data_ptr(), out.data_ptr(), _BF16[x.dtype], planes, h, w,
            tab.y.idx.data_ptr(), tab.y.wt.data_ptr(), tab.x.idx.data_ptr(),
            tab.x.wt.data_ptr(), rows, src_rows, smem, _stream(x.device))
    if err != 0:
        raise RuntimeError(f"upsample2x launch failed: CUDA error {err}")
    upsample2x.launches += 1
    return out


def upsample2x_bwd(g: Tensor, tab) -> Tensor:
    """The input's gradient (N, C, h, w) from the output's g (N, C, 2h, 2w)
    on a card, in gather form: float32 sums in the order of
    models/layers.py::upsample2x_align_corners_bwd_plain, rounded once.
    `upsample2x_bwd.launches` counts kernel launches."""
    h, w = tab.y.n, tab.x.n
    _check(g, "upsample2x_bwd", (2 * h, 2 * w))
    gin = g.new_empty((g.shape[0], g.shape[1], h, w))
    planes = g.shape[0] * g.shape[1]
    if planes == 0:
        return gin
    _, (rows, src_rows, smem) = _plans(tab, g.element_size())
    y, x = tab.y, tab.x
    with torch.cuda.device(g.device):
        err = _lib().upsample2x_bwd(
            g.data_ptr(), gin.data_ptr(), _BF16[g.dtype], planes, h, w,
            y.inv_o.data_ptr(), y.inv_w.data_ptr(), y.inv_n.data_ptr(),
            y.inv_o.shape[1], x.inv_o.data_ptr(), x.inv_w.data_ptr(),
            x.inv_n.data_ptr(), x.inv_o.shape[1], rows, src_rows, smem,
            _stream(g.device))
    if err != 0:
        raise RuntimeError(f"upsample2x_bwd launch failed: CUDA error {err}")
    upsample2x_bwd.launches += 1
    return gin


upsample2x.launches = 0
upsample2x_bwd.launches = 0
