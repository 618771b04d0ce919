"""Shared layers (port of self6dpp_tpu/models/layers.py). Modules take and
return NCHW tensors; module names follow the reference torch checkpoints."""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as Fnn
from torch import Tensor, nn
from torch.autograd.function import once_differentiable

from ..ops import upsample_cuda
from ..parallel.dist import data_size, global_sum


def get_act(name: str) -> nn.Module:
    name = name.lower()
    if name == "relu":
        return nn.ReLU()
    if name in ("lrelu", "leakyrelu", "leaky_relu"):
        return nn.LeakyReLU(0.1)
    if name == "gelu":
        return nn.GELU(approximate="none")      # exact erf form
    if name in ("silu", "swish"):
        return nn.SiLU()
    if name == "mish":
        return nn.Mish()
    if name == "sigmoid":
        return nn.Sigmoid()
    if name in ("none", "identity"):
        return nn.Identity()
    raise ValueError(f"unknown act: {name}")


def gn_groups(num_gn_groups: int, channels: int) -> int:
    """The JAX package's group count: at most num_gn_groups, lowered until
    it divides the channels."""
    groups = min(num_gn_groups, channels)
    while channels % groups:
        groups -= 1
    return groups


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d whose training mode is Flax's nn.BatchNorm(momentum=m),
    as the JAX package trains: batch statistics in float32 (float64 for a
    float64 input) with the variance as E[x²] - E[x]² clipped at 0, x
    normalised with them, and the running statistics updated in place as
    m r + (1 - m) s with the biased variance (torch's BatchNorm2d takes the
    unbiased one, n/(n-1) away: 1 + 6.5e-4 at batch 24 and stride 32).
    flax_momentum is Flax's m: 0.9 for GDRN and FlowNetS, 0.97 (eps 1e-3)
    for YOLOv4. Eval mode is torch's. Same state_dict as nn.BatchNorm2d.
    Under data parallel (parallel/dist.py) the statistics are the global
    batch's: x and x² summed over the ranks, differentiably."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 flax_momentum: float = 0.9):
        super().__init__(num_features, eps=eps)
        self.flax_momentum = flax_momentum

    def forward(self, x: Tensor) -> Tensor:
        if not self.training:
            return super().forward(x)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if data_size() > 1:
            # the global batch's statistics, as Flax computes them under
            # jit on a data mesh: sums of x and x² over every rank
            n = xf.numel() // xf.shape[1] * data_size()
            sums = global_sum(torch.stack([xf.sum((0, 2, 3)),
                                           (xf * xf).sum((0, 2, 3))]))
            mean, ex2 = sums[0] / n, sums[1] / n
        else:
            mean = xf.mean((0, 2, 3))
            ex2 = (xf * xf).mean((0, 2, 3))
        var = (ex2 - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            m = self.flax_momentum
            self.running_mean.mul_(m).add_(mean.detach(), alpha=1.0 - m)
            self.running_var.mul_(m).add_(var.detach(), alpha=1.0 - m)
            self.num_batches_tracked.add_(1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]
        return y.to(x.dtype)


def Norm(kind: str, channels: int, num_gn_groups: int = 32) -> nn.Module:
    """GroupNorm (eps 1e-5, as torch and the JAX package set it) or
    BatchNorm (eps 1e-5, trained as Flax trains it: FlaxBatchNorm2d)."""
    if kind == "GN":
        return nn.GroupNorm(gn_groups(num_gn_groups, channels), channels,
                            eps=1e-5)
    if kind == "BN":
        return FlaxBatchNorm2d(channels, eps=1e-5)
    if kind in ("none", ""):
        return nn.Identity()
    raise ValueError(f"unknown norm: {kind}")


class ConvNormAct(nn.Module):
    """conv (no bias, 'same' padding at stride 1) -> norm -> act; the
    reference ConvModule with children `conv` and `gn`."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3,
                 norm: str = "GN", num_gn_groups: int = 32, act: str = "gelu"):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel_size, 1, kernel_size // 2,
                              bias=False)
        self.gn = Norm(norm, cout, num_gn_groups)
        self.act = get_act(act)

    def forward(self, x: Tensor) -> Tensor:
        return self.act(self.gn(self.conv(x)))


class Upsample2x(nn.Module):
    """2x spatial upsample: bilinear with align_corners=True (torch
    UpsamplingBilinear2d, as the reference geo head) or nearest."""

    def __init__(self, method: str = "bilinear"):
        super().__init__()
        if method not in ("bilinear", "nearest"):
            raise ValueError(f"unknown upsample: {method}")
        self.method = method

    def forward(self, x: Tensor) -> Tensor:
        if self.method == "nearest":
            return Fnn.interpolate(x, scale_factor=2, mode="nearest")
        return upsample2x_align_corners(x)


def upsample2x_align_corners(x: Tensor) -> Tensor:
    """Bilinear 2x with align_corners=True of NCHW x: on a card the CUDA
    kernels of csrc/upsample2x.cu through one autograd Function (forward
    bitwise equal to upsample2x_align_corners_plain there, backward
    upsample2x_align_corners_bwd_plain's gather form), which raise on a
    dtype other than bfloat16 or float32 or a layout other than
    NCHW-contiguous; elsewhere upsample2x_align_corners_plain."""
    if x.device.type == "cuda":
        return _Upsample2x.apply(x)
    return upsample2x_align_corners_plain(x)


def upsample2x_align_corners_plain(x: Tensor) -> Tensor:
    """Bilinear 2x with align_corners=True, written as the JAX package's
    _resize_align_corners (two gathers and lerps), so that both round
    alike."""
    n, c, h, w = x.shape
    ys = torch.linspace(0.0, h - 1.0, 2 * h, device=x.device)
    xs = torch.linspace(0.0, w - 1.0, 2 * w, device=x.device)
    y0 = ys.floor().long().clamp(0, h - 1)
    y1 = (y0 + 1).clamp(0, h - 1)
    x0 = xs.floor().long().clamp(0, w - 1)
    x1 = (x0 + 1).clamp(0, w - 1)
    wy = (ys - y0).to(x.dtype)[None, None, :, None]
    wx = (xs - x0).to(x.dtype)[None, None, None, :]
    top = x[:, :, y0][:, :, :, x0] * (1 - wx) + x[:, :, y0][:, :, :, x1] * wx
    bot = x[:, :, y1][:, :, :, x0] * (1 - wx) + x[:, :, y1][:, :, :, x1] * wx
    return top * (1 - wy) + bot * wy


@dataclasses.dataclass(eq=False)
class UpsampleAxis:
    """One axis of the align-corners 2x upsample, n inputs to 2n outputs,
    from upsample2x_align_corners_plain's torch.linspace code: output o
    reads input idx[0, o] with weight wt[0, o] (1 - w, rounded to the
    working dtype) and idx[1, o] with wt[1, o] (w); input i is read by the
    outputs inv_o[i, :inv_n[i]], ascending, with weights inv_w[i, ...].
    Indices int32 on the device; weights the working dtype's values in its
    float32 (float64) accumulation type. The *_host tuples give, for each
    output, the first and last input it reads (lo, hi) and, for each input,
    the first and last output that reads it (inv_lo, inv_hi)."""
    n: int
    idx: Tensor
    wt: Tensor
    inv_o: Tensor
    inv_w: Tensor
    inv_n: Tensor
    lo_host: tuple[int, ...]
    hi_host: tuple[int, ...]
    inv_lo_host: tuple[int, ...]
    inv_hi_host: tuple[int, ...]


@dataclasses.dataclass(eq=False)
class UpsampleTables:
    y: UpsampleAxis
    x: UpsampleAxis


def _upsample_axis(n: int, dtype: torch.dtype,
                   device: torch.device) -> UpsampleAxis:
    s = torch.linspace(0.0, n - 1.0, 2 * n, device=device)
    i0 = s.floor().long().clamp(0, n - 1)
    i1 = (i0 + 1).clamp(0, n - 1)
    w = (s - i0).to(dtype)
    acc = torch.promote_types(dtype, torch.float32)
    wt = torch.stack([1 - w, w]).to(acc)
    lo, hi = tuple(i0.tolist()), tuple(i1.tolist())
    taps = [[] for _ in range(n)]
    for o, (a, b, wa, wb) in enumerate(zip(lo, hi, *wt.tolist())):
        taps[a].append((o, wa))
        taps[b].append((o, wb))
    k = max(len(t) for t in taps)
    pad = [t + [(0, 0.0)] * (k - len(t)) for t in taps]
    firsts, lasts = [t[0][0] for t in taps], [t[-1][0] for t in taps]
    if any(a > b for seq in (lo, hi, firsts, lasts)
           for a, b in zip(seq, seq[1:])):
        raise RuntimeError(f"upsample tables at n={n} are not monotone")
    i32 = dict(dtype=torch.int32, device=device)
    return UpsampleAxis(
        n, torch.stack([i0, i1]).to(torch.int32), wt,
        torch.tensor([[o for o, _ in t] for t in pad], **i32),
        torch.tensor([[v for _, v in t] for t in pad], dtype=acc,
                     device=device),
        torch.tensor([len(t) for t in taps], **i32), lo, hi, tuple(firsts),
        tuple(lasts))


def build_upsample_tables(h: int, w: int, dtype: torch.dtype,
                          device: torch.device) -> UpsampleTables:
    """The index and weight tables of the (h, w) -> (2h, 2w) upsample in
    `dtype` on `device` (upsample_tables caches them)."""
    return UpsampleTables(_upsample_axis(h, dtype, device),
                          _upsample_axis(w, dtype, device))


@functools.cache
def upsample_tables(h: int, w: int, dtype: torch.dtype,
                    device: torch.device) -> UpsampleTables:
    """build_upsample_tables, once per (h, w, dtype, device)."""
    return build_upsample_tables(h, w, dtype, device)


def _gather_taps(g: Tensor, ax: UpsampleAxis, dim: int) -> Tensor:
    """sum_j g[..., inv_o[i, j], ...] * inv_w[i, j] over j < inv_n[i] along
    `dim`, in the order of j."""
    shape = [1] * g.ndim
    shape[dim] = ax.n
    out = None
    for j in range(ax.inv_o.shape[1]):
        term = (g.index_select(dim, ax.inv_o[:, j])
                * ax.inv_w[:, j].to(g.dtype).view(shape))
        term = torch.where((ax.inv_n > j).view(shape), term, 0.0)
        out = term if out is None else out + term
    return out


def upsample2x_align_corners_bwd_plain(
        g: Tensor, tables: UpsampleTables | None = None) -> Tensor:
    """The gradient of upsample2x_align_corners with respect to its (N, C,
    h, w) input, from the output's g (N, C, 2h, 2w), in gather form: each
    input sums the outputs that read it, times the rounded weights the
    forward applied (tables, by default upsample_tables(h, w, g.dtype,
    g.device)), along W, then along H, in float32 (float64 for float64 g),
    rounded to g's dtype once. The arithmetic of csrc/upsample2x.cu's
    backward."""
    tab = tables if tables is not None else upsample_tables(
        g.shape[2] // 2, g.shape[3] // 2, g.dtype, g.device)
    acc = torch.promote_types(g.dtype, torch.float32)
    gx = _gather_taps(g.to(acc), tab.x, 3)
    return _gather_taps(gx, tab.y, 2).to(g.dtype)


class _Upsample2x(torch.autograd.Function):
    """upsample2x_align_corners on a card: both directions are kernels."""

    @staticmethod
    def forward(ctx, x: Tensor) -> Tensor:
        ctx.tab = upsample_tables(x.shape[2], x.shape[3], x.dtype, x.device)
        return upsample_cuda.upsample2x(x, ctx.tab)

    @staticmethod
    @once_differentiable
    def backward(ctx, g: Tensor) -> Tensor:
        return upsample_cuda.upsample2x_bwd(g.contiguous(), ctx.tab)


def ConvTranspose2x(cin: int, cout: int, kernel_size: int = 3) -> nn.Module:
    """Exactly-2x transposed conv of the 'deconv' up-blocks at any kernel
    size k, as the JAX package's ConvTranspose2x: its stride-2 transpose
    padded (k-1, k-1) and cropped at (k-1)//2 (at k = 4 Flax's 'SAME',
    the same numbers) is torch's ConvTranspose2d with padding (k-1)//2 and
    output padding k % 2 (k = 3: padding 1, output padding 1). The JAX
    kernels are not flipped; convert.py flips them."""
    return nn.ConvTranspose2d(cin, cout, kernel_size, 2,
                              padding=(kernel_size - 1) // 2,
                              output_padding=kernel_size % 2, bias=False)


def dropblock_gamma(drop_prob: float, block_size: int, h: int, w: int
                    ) -> float:
    """DropBlock's seed rate: p / b² · HW / ((H-b+1)(W-b+1))."""
    valid = max((h - block_size + 1) * (w - block_size + 1), 1)
    return drop_prob / block_size ** 2 * (h * w) / valid


def dropblock_seed(generator: torch.Generator | None, shape: tuple,
                   gamma: float, dtype: torch.dtype,
                   device: torch.device) -> Tensor:
    """The Bernoulli(gamma) seed mask of `shape` (N, H, W, 1), drawn from
    `generator` (torch's default one when None) on `device`, as uniform <
    gamma (jax.random.bernoulli's rule)."""
    u = torch.rand(shape, generator=generator, device=device)
    return (u < gamma).to(dtype)


def dropblock_apply(x: Tensor, seed: Tensor, block_size: int = 5) -> Tensor:
    """DropBlock's arithmetic on NHWC x: the seed (N, H, W, 1) dilated by a
    block_size² stride-1 max pool (padded with -inf), kept = 1 - block,
    x · keep / max(mean(keep), 1e-6)."""
    pad = block_size // 2
    block = Fnn.max_pool2d(seed.permute(0, 3, 1, 2), block_size, 1, pad)
    keep = 1.0 - block.permute(0, 2, 3, 1)
    denom = keep.mean((1, 2, 3), keepdim=True).clamp_min(1e-6)
    return x * keep / denom


class DropBlock(nn.Module):
    """DropBlock2D on NHWC inputs (port of the JAX package's DropBlock): in
    training mode with drop_prob > 0 it drops block_size² blocks around a
    Bernoulli seed mask drawn from the generator it is given; otherwise the
    identity, drawing nothing."""

    def __init__(self, drop_prob: float = 0.0, block_size: int = 5):
        super().__init__()
        self.drop_prob = drop_prob
        self.block_size = block_size

    def forward(self, x: Tensor,
                generator: torch.Generator | None = None) -> Tensor:
        if not self.training or self.drop_prob <= 0.0:
            return x
        n, h, w, _ = x.shape
        gamma = dropblock_gamma(self.drop_prob, self.block_size, h, w)
        seed = dropblock_seed(generator, (n, h, w, 1), gamma, x.dtype,
                              x.device)
        return dropblock_apply(x, seed, self.block_size)
