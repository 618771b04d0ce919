"""The yardstick's counts: the card's peaks, the work that a call of each
hand-written kernel needs on its data (operations and bytes, copied from
chip_smoke.py's derivation of B1, B2 and B3), the least time it could take
(its roofline bound), and the model FLOPs of a step or request counted over
the plain reference. None of it reads the program's kernels: a kernel's
counts follow from its inputs and outputs, whatever computes them."""

from __future__ import annotations

import contextlib

import torch

from .reference.ops.color import FT, RGB2XYZ, SRGB_T, XYZ_REF
from .reference.ops.raster_plain import _GEO, _tile_pixels

# NVIDIA H100 SXM (data sheet, 700 W): HBM bytes/s, f32 FLOP/s outside the
# tensor cores, dense bf16 FLOP/s on the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_BF16 = 989e12
# the special-function units: 16 results a clock per SM on compute
# capability 9.0, x 132 SMs x 1.98 GHz (the clock the f32 peak implies)
PEAK_SFU = 132 * 16 * 1.98e9

# f32 operations the functions need, counted from the kernels' sources (a
# comparison, a transcendental or a division counts as one); see
# chip_smoke.py for each term's derivation.
OPS_TEST = 20           # per (pixel, valid candidate): edges, barycentrics
OPS_CAND = 27           # per (occupied tile, valid candidate), once
OPS_SEG = 52            # per (uncovered pixel, valid candidate): silhouette
OPS_WIN_FWD = 37        # B1 per covered pixel
OPS_WIN_BWD = 153       # B2 per covered pixel with a depth or attr cotangent
OPS_SEG_BWD = 22        # B2 per (uncovered pixel with a prob cotangent, cand)
OPS_LAB, OPS_LAB_L = 97, 9
OPS_LAB_POW = {"pred": (13, 3), "gt": (11, 3)}       # (f32, SFU)
OPS_LAB_CUBE = {"pred": (17, 2), "gt": (16, 2)}


def raster_counts(ftab, cand, mask, tile_px, height, width, cts=None):
    """What a render's data makes the fine stage do (chip_smoke.py's
    raster_counts): face rows the candidate lists name, valid candidates
    per tile, occupied tiles, covered pixels, per tile the in-image and
    uncovered pixels; with the cotangents cts = (dprob, ddepth, dattr) the
    pixels the backward needs."""
    B, F, _ = ftab.shape
    T = cand.shape[0]
    th, tw = -(-height // tile_px), -(-width // tile_px)
    b_of_t = torch.arange(T, device=cand.device) // (T // B)
    valid = (cand >= 0) & (ftab[b_of_t[:, None], cand.long().clamp_min(0),
                                7] > 0.5)
    n_valid = valid.sum(1).float()

    def tiles(x):
        return _tile_pixels(x.float(), tile_px, th * tw, tw)
    covered = tiles(mask) > 0.5
    uncovered = tiles(1.0 - mask) > 0.5
    occupied = n_valid > 0
    ids = cand.view(B, -1)
    face_rows = sum(int(torch.unique(ids[i][ids[i] >= 0]).numel())
                    for i in range(B))
    out = {"face_rows_read": face_rows,
           "occupied_tiles": int(occupied.sum()),
           "covered_pixels": int(mask.sum()),
           "_n_valid": n_valid,
           "_pixels": tiles(torch.ones_like(mask)).sum(1),
           "_uncovered": uncovered.sum(1).float()}
    if cts is not None:
        dprob, ddepth, dattr = (c != 0 for c in cts)
        win = covered & (tiles(ddepth | dattr.any(-1)) > 0.5)
        sil = uncovered & (tiles(dprob) > 0.5)
        out.update({"_active": tiles(dprob | ddepth | dattr.any(-1)).sum(1),
                    "_win": win.sum(1).float(), "_sil": sil.sum(1).float()})
    return out


def b1_ops(n, with_prob=True):
    nv = n["_n_valid"]
    return (float((nv * n["_pixels"]).sum()) * OPS_TEST
            + float(nv.sum()) * OPS_CAND
            + n["covered_pixels"] * OPS_WIN_FWD
            + with_prob * float((nv * n["_uncovered"]).sum()) * OPS_SEG)


def b2_ops(n):
    nv = n["_n_valid"]
    return (float((nv * n["_active"]).sum()) * OPS_TEST
            + float(nv.sum()) * OPS_CAND
            + float(n["_win"].sum()) * OPS_WIN_BWD
            + float((nv * n["_sil"]).sum()) * (OPS_SEG + OPS_SEG_BWD))


def bound_ms(bytes_moved, ops, sfu_ops=0.0) -> float:
    """The least time for the work: bytes at the HBM rate, f32 operations
    at the f32 rate, special-function operations at the SFU rate, the
    largest of the three."""
    return max(bytes_moved / PEAK_BYTES, ops / PEAK_F32,
               sfu_ops / PEAK_SFU) * 1e3


def lab_ops(pred, gt, no_l=True):
    """(f32, SFU) operations that B3's arithmetic needs on these inputs:
    the power and cube-root branches as the data takes them."""
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


def b1_bound_ms(call) -> float:
    """B1's bound on one call: (ftab, cand, height, width, tile_px, sigma,
    with_prob, persp) and its output mask."""
    (ftab, cand, h, w, tp, _, with_prob, _), mask = call
    B, _, C = ftab.shape
    D = (C - _GEO) // 3
    n = raster_counts(ftab, cand, mask, tp, h, w)
    return bound_ms(n["face_rows_read"] * C * 4 + cand.numel() * 4
                    + B * h * w * (4 + D + 3) * 4, b1_ops(n, with_prob))


def b2_bound_ms(call) -> float:
    """B2's bound on one call: (ftab, cand, dprob, ddepth, dattr, height,
    width, tile_px, ...) and the forward's mask."""
    (ftab, cand, dprob, ddepth, dattr, h, w, tp, *_), mask = call
    B, F, C = ftab.shape
    D = (C - _GEO) // 3
    n = raster_counts(ftab, cand, mask, tp, h, w, (dprob, ddepth, dattr))
    return bound_ms(n["face_rows_read"] * C * 4 + cand.numel() * 4
                    + n["occupied_tiles"] * tp * tp * (2 + D) * 4
                    + B * F * C * 4, b2_ops(n))


def lab_bound_ms(call) -> float:
    """B3's bound on one call: (pred, gt, mask, no_l, ...)."""
    (pred, gt, mask, no_l, *_), _ = call
    return bound_ms(mask.numel() * (3 + 3 + 1 + 3) * 4, *lab_ops(pred, gt,
                                                                no_l))


class KernelCalls:
    """Records the arguments (and B1's output mask) of the first `keep`
    calls of B1, B2 and B3 that the program makes while active, by wrapping
    the port's entry functions; the wrappers pass everything through."""

    def __init__(self, keep: int = 8):
        self.keep = keep
        self.calls: dict[str, list] = {"fine_raster_fwd": [],
                                       "fine_raster_bwd": [],
                                       "lab_value_grad": []}
        self._masks: dict[int, torch.Tensor] = {}

    def _add(self, name, item):
        if len(self.calls[name]) < self.keep:
            self.calls[name].append(item)

    @contextlib.contextmanager
    def active(self):
        from self6dpp_tpu_torch.losses import self_loss
        from self6dpp_tpu_torch.ops import raster_cuda
        fine, bwd = raster_cuda._fine, raster_cuda.fine_raster_bwd
        lab = self_loss.lab_value_grad_scaled

        def fine_w(*args):
            out = fine(*args)
            m = out[0].mask
            if len(self._masks) < self.keep:
                self._masks[args[1].data_ptr()] = m
            self._add("fine_raster_fwd", (args[:8], m))
            return out

        def bwd_w(*args):
            mask = self._masks.get(args[1].data_ptr())
            if mask is not None:
                self._add("fine_raster_bwd", (args, mask))
            return bwd(*args)

        def lab_w(*args):
            self._add("lab_value_grad", (args, None))
            return lab(*args)
        # the port counts B2's launches on the module's function object
        bwd_w.launches = bwd.launches
        raster_cuda._fine, raster_cuda.fine_raster_bwd = fine_w, bwd_w
        self_loss.lab_value_grad_scaled = lab_w
        try:
            yield self
        finally:
            bwd.launches = bwd_w.launches
            raster_cuda._fine, raster_cuda.fine_raster_bwd = fine, bwd
            self_loss.lab_value_grad_scaled = lab
            self._masks.clear()


BOUNDS = {"fine_raster_fwd": b1_bound_ms, "fine_raster_bwd": b2_bound_ms,
          "lab_value_grad": lab_bound_ms}


def model_flops(fn) -> float:
    """The FLOPs PyTorch's flop counter counts over fn() (matrix products
    and convolutions, forward and backward)."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        fn()
    return float(fc.get_total_flops())
