"""YOLOv4 detector (port of self6dpp_tpu/models/yolo.py): CSP-Darknet53
with Mish, SPP, the PAN neck and three YOLO heads of 3 anchors; the
decode of the raw heads, the CIoU box loss with the objectness and class
BCE (static-shape target assignment), and the host-side NMS.

Modules take NCHW and return each head as (B, H, W, 3, 5 + nc), the JAX
package's layout. Traps of the translation:
  * Flax's padding "SAME" on the stride-2 3x3 convs pads (0, 1) on an even
    input, not (1, 1): same_pad computes Flax's split for any size;
  * the head's (B, H, W, 3·no) reshape is anchor-major in the channels, so
    from NCHW it is view(b, 3, no, h, w).permute(0, 3, 4, 1, 2);
  * the objectness target is a scatter-max over duplicate cells
    (scatter_reduce "amax"), a constant like CIoU's alpha.
Batch norm trains as Flax's does at momentum 0.97 and eps 1e-3
(models/layers.py::FlaxBatchNorm2d).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as Fnn
from torch import Tensor, nn

from ..parallel.dist import batch_denom
from .layers import FlaxBatchNorm2d

# default anchors (yolov4-mish.yaml, 3 per scale, strides 8/16/32)
DEFAULT_ANCHORS = (
    ((12, 16), (19, 36), (40, 28)),
    ((36, 75), (76, 55), (72, 146)),
    ((142, 110), (192, 243), (459, 401)),
)
BALANCE = (4.0, 1.0, 0.4)       # objectness (and box) weight per scale
BN_MOMENTUM = 0.97
BN_EPS = 1e-3
# flax's truncated normal draws within 2 std of a unit normal and rescales
# by the truncated distribution's std so the variance is the asked one
_TRUNC_STD = 0.87962566103423978


@dataclass(frozen=True)
class YoloConfig:
    num_classes: int = 13
    input_size: int = 640
    depth_multiple: float = 1.0
    width_multiple: float = 1.0
    anchors: tuple = DEFAULT_ANCHORS
    # loss weights (det/yolov4 hyp)
    box_lw: float = 0.05
    obj_lw: float = 1.0
    cls_lw: float = 0.5
    anchor_t: float = 4.0
    conf_thresh: float = 0.001
    iou_thresh: float = 0.65


def same_pad(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """Flax/XLA 'SAME' padding (low, high) along one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class ConvBnMish(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1):
        super().__init__()
        self.kernel, self.stride = kernel, stride
        self.conv = nn.Conv2d(cin, cout, kernel, stride, bias=False)
        self.bn = FlaxBatchNorm2d(cout, eps=BN_EPS, flax_momentum=BN_MOMENTUM)

    def forward(self, x: Tensor) -> Tensor:
        if self.kernel > 1:
            ph = same_pad(x.shape[2], self.kernel, self.stride)
            pw = same_pad(x.shape[3], self.kernel, self.stride)
            x = Fnn.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        return Fnn.mish(self.bn(self.conv(x)))


class Bottleneck(nn.Module):
    def __init__(self, cin: int, cout: int, shortcut: bool = True):
        super().__init__()
        self.cv1 = ConvBnMish(cin, cout, 1)
        self.cv2 = ConvBnMish(cout, cout, 3)
        self.add = shortcut and cin == cout

    def forward(self, x: Tensor) -> Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class CSPBlock(nn.Module):
    """Cross-stage-partial block (BottleneckCSP): cv1 and the bottlenecks
    m, then cv3 on that branch and cv2 on the input, batch norm and Mish
    over both, cv4."""

    def __init__(self, cin: int, cout: int, n: int = 1, shortcut: bool = True):
        super().__init__()
        c_ = cout // 2
        self.cv1 = ConvBnMish(cin, c_, 1)
        self.m = nn.ModuleList(Bottleneck(c_, c_, shortcut) for _ in range(n))
        self.cv3 = nn.Conv2d(c_, c_, 1, bias=False)
        self.cv2 = nn.Conv2d(cin, c_, 1, bias=False)
        self.bn = FlaxBatchNorm2d(2 * c_, eps=BN_EPS,
                                  flax_momentum=BN_MOMENTUM)
        self.cv4 = ConvBnMish(2 * c_, cout, 1)

    def forward(self, x: Tensor) -> Tensor:
        y1 = self.cv1(x)
        for b in self.m:
            y1 = b(y1)
        y = torch.cat([self.cv3(y1), self.cv2(x)], 1)
        return self.cv4(Fnn.mish(self.bn(y)))


class SPP(nn.Module):
    def __init__(self, cin: int, cout: int,
                 pools: tuple[int, ...] = (5, 9, 13)):
        super().__init__()
        c_ = cout // 2
        self.pools = pools
        self.cv1 = ConvBnMish(cin, c_, 1)
        self.cv2 = ConvBnMish(c_ * (len(pools) + 1), cout, 1)

    def forward(self, x: Tensor) -> Tensor:
        x = self.cv1(x)
        # max pooling pads with -inf, as Flax's 'SAME' max_pool does
        outs = [x] + [Fnn.max_pool2d(x, k, 1, k // 2) for k in self.pools]
        return self.cv2(torch.cat(outs, 1))


def _up2(x: Tensor) -> Tensor:
    return Fnn.interpolate(x, scale_factor=2, mode="nearest")


class YOLOv4(nn.Module):
    """x (B, 3, S, S) in [0, 1] -> the raw heads [(B, S/8, S/8, 3, 5+nc),
    (.. /16 ..), (.. /32 ..)]. Module names follow the reference's layers:
    the backbone's stem, downsamples and CSP stages, spp, the PAN neck's
    laterals, top-down and bottom-up blocks, and the three heads."""

    def __init__(self, cfg: YoloConfig):
        super().__init__()
        self.cfg = cfg
        w = lambda ch: max(int(ch * cfg.width_multiple), 32)
        d = lambda n: max(int(round(n * cfg.depth_multiple)), 1)
        CB, CSP = ConvBnMish, CSPBlock
        # backbone (CSP-Darknet53)
        self.stem = CB(3, w(32), 3)
        self.down1 = CB(w(32), w(64), 3, 2)
        self.csp1 = CSP(w(64), w(64), d(1))
        self.down2 = CB(w(64), w(128), 3, 2)
        self.csp2 = CSP(w(128), w(128), d(2))
        self.down3 = CB(w(128), w(256), 3, 2)
        self.csp3 = CSP(w(256), w(256), d(8))               # stride 8
        self.down4 = CB(w(256), w(512), 3, 2)
        self.csp4 = CSP(w(512), w(512), d(8))               # stride 16
        self.down5 = CB(w(512), w(1024), 3, 2)
        self.csp5 = CSP(w(1024), w(1024), d(4))
        self.spp = SPP(w(1024), w(1024))                    # stride 32
        # PAN neck
        self.reduce5 = CB(w(1024), w(512), 1)
        self.lat4 = CB(w(512), w(512), 1)
        self.td4 = CSP(2 * w(512), w(512), d(2), shortcut=False)
        self.reduce4 = CB(w(512), w(256), 1)
        self.lat3 = CB(w(256), w(256), 1)
        self.td3 = CSP(2 * w(256), w(256), d(2), shortcut=False)
        self.bu3 = CB(w(256), w(256), 3, 2)
        self.pan4 = CSP(w(256) + w(512), w(512), d(2), shortcut=False)
        self.bu4 = CB(w(512), w(512), 3, 2)
        self.pan5 = CSP(w(512) + w(512), w(1024), d(2), shortcut=False)
        no = 5 + cfg.num_classes
        self.heads = nn.ModuleList(nn.Conv2d(c, 3 * no, 1)
                                   for c in (w(256), w(512), w(1024)))

    def forward(self, x: Tensor) -> list[Tensor]:
        x = self.csp1(self.down1(self.stem(x)))
        x = self.csp2(self.down2(x))
        p3 = self.csp3(self.down3(x))
        p4 = self.csp4(self.down4(p3))
        p5 = self.spp(self.csp5(self.down5(p4)))
        u5 = self.reduce5(p5)
        n4 = self.td4(torch.cat([_up2(u5), self.lat4(p4)], 1))
        u4 = self.reduce4(n4)
        n3 = self.td3(torch.cat([_up2(u4), self.lat3(p3)], 1))
        n4b = self.pan4(torch.cat([self.bu3(n3), n4], 1))
        n5b = self.pan5(torch.cat([self.bu4(n4b), u5], 1))
        no = 5 + self.cfg.num_classes
        outs = []
        for head, feat in zip(self.heads, (n3, n4b, n5b)):
            y = head(feat)
            b, _, h, ww = y.shape
            outs.append(y.view(b, 3, no, h, ww).permute(0, 3, 4, 1, 2))
        return outs


@torch.no_grad()
def init_weights_(model: YOLOv4, generator: torch.Generator) -> YOLOv4:
    """Draw the weights as Flax's defaults do: LeCun normal (truncated) for
    every conv, zero biases, batch norm at scale 1, bias 0 and statistics
    (0, 1). Drawn in float32 on the CPU, whatever the model's device."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            w = m.weight
            s = math.prod(w.shape[1:]) ** -0.5 / _TRUNC_STD
            w.copy_(nn.init.trunc_normal_(torch.empty(w.shape), 0.0, s,
                                          -2 * s, 2 * s, generator=generator))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
    return model


def build_yolo(ycfg: YoloConfig, device=None, seed: int | None = None
               ) -> YOLOv4:
    """YOLOv4 on `device` (CUDA by default), float32, in eval mode; with a
    seed its weights are drawn by init_weights_."""
    from .. import resolve_device
    model = YOLOv4(ycfg)
    if seed is not None:
        init_weights_(model, torch.Generator().manual_seed(seed))
    return model.to(resolve_device(device)).eval()


def decode_predictions(outs: list[Tensor], cfg: YoloConfig) -> Tensor:
    """Raw heads -> (B, N, 5+nc): xywh in pixels (xy = (2σ - 0.5 + grid) ·
    stride, wh = (2σ)² · anchor), objectness and classes as sigmoids."""
    res = []
    for si, out in enumerate(outs):
        stride = cfg.input_size // out.shape[1]
        b, h, w, na, no = out.shape
        kw = dict(dtype=out.dtype, device=out.device)
        gy = torch.arange(h, **kw)[None, :, None, None]
        gx = torch.arange(w, **kw)[None, None, :, None]
        sig = torch.sigmoid(out)
        anchors = torch.tensor(cfg.anchors[si], **kw)
        xy = torch.stack([(sig[..., 0] * 2.0 - 0.5 + gx) * stride,
                          (sig[..., 1] * 2.0 - 0.5 + gy) * stride], -1)
        wh = (sig[..., 2:4] * 2.0) ** 2 * anchors
        res.append(torch.cat([xy, wh, sig[..., 4:]], -1).reshape(b, -1, no))
    return torch.cat(res, 1)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def bbox_ciou(box1: Tensor, box2: Tensor, eps: float = 1e-7) -> Tensor:
    """Complete IoU between xywh boxes (..., 4); alpha is a constant."""
    b1x1, b1y1 = box1[..., 0] - box1[..., 2] / 2, box1[..., 1] - box1[..., 3] / 2
    b1x2, b1y2 = box1[..., 0] + box1[..., 2] / 2, box1[..., 1] + box1[..., 3] / 2
    b2x1, b2y1 = box2[..., 0] - box2[..., 2] / 2, box2[..., 1] - box2[..., 3] / 2
    b2x2, b2y2 = box2[..., 0] + box2[..., 2] / 2, box2[..., 1] + box2[..., 3] / 2
    inter = (torch.minimum(b1x2, b2x2) - torch.maximum(b1x1, b2x1)).clamp(0) * \
        (torch.minimum(b1y2, b2y2) - torch.maximum(b1y1, b2y1)).clamp(0)
    w1, h1 = b1x2 - b1x1, b1y2 - b1y1
    w2, h2 = b2x2 - b2x1, b2y2 - b2y1
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    cw = torch.maximum(b1x2, b2x2) - torch.minimum(b1x1, b2x1)
    ch = torch.maximum(b1y2, b2y2) - torch.minimum(b1y1, b2y1)
    c2 = cw ** 2 + ch ** 2 + eps
    rho2 = (box1[..., 0] - box2[..., 0]) ** 2 \
        + (box1[..., 1] - box2[..., 1]) ** 2
    v = (4 / math.pi ** 2) * (torch.atan(w2 / (h2 + eps))
                              - torch.atan(w1 / (h1 + eps))) ** 2
    alpha = v / (v - iou + (1 + eps))
    return iou - (rho2 / c2 + alpha.detach() * v)


def _bce_logits(logit: Tensor, target: Tensor) -> Tensor:
    return logit.clamp_min(0) - logit * target + \
        torch.log1p(torch.exp(-logit.abs()))


def yolo_loss(outs: list[Tensor], targets: Tensor, tvalid: Tensor,
              cfg: YoloConfig) -> dict[str, Tensor]:
    """targets (B, M, 5) rows [cls, cx, cy, w, h] in pixels; tvalid (B, M).
    Each target matches the anchors whose wh ratio is within anchor_t, at
    its centre cell and at the two neighbour cells nearer its offset; a
    neighbour off the grid is clipped for the gather and masked."""
    total_box = total_obj = total_cls = outs[0].new_zeros(())
    for si, out in enumerate(outs):
        stride = cfg.input_size // out.shape[1]
        b, h, w, na, no = out.shape
        dev, dt = out.device, out.dtype
        anchors = torch.tensor(cfg.anchors[si], dtype=dt, device=dev) / stride
        t_xy = targets[..., 1:3] / stride
        t_wh = targets[..., 3:5] / stride
        t_cls = targets[..., 0].to(torch.int64)

        r = t_wh[:, :, None, :] / anchors[None, None]
        ratio = torch.maximum(r, 1.0 / r.clamp_min(1e-9)).amax(-1)
        match = (ratio < cfg.anchor_t) & tvalid[:, :, None]

        fx = torch.remainder(t_xy[..., 0], 1.0)
        fy = torch.remainder(t_xy[..., 1], 1.0)
        zero = torch.zeros_like(fx)
        offs = [torch.zeros_like(t_xy),
                torch.stack([torch.where(fx < 0.5, -1.0, 1.0), zero], -1),
                torch.stack([zero, torch.where(fy < 0.5, -1.0, 1.0)], -1)]

        obj_target = torch.zeros(b * h * w * na, dtype=dt, device=dev)
        tbox = torch.cat([t_xy, t_wh], -1)[:, :, None, :]
        bidx = torch.arange(b, device=dev)[:, None]
        aidx = torch.arange(na, device=dev)[None, None, :]
        for off in offs:
            cell = torch.floor(t_xy + off).to(torch.int64)
            inb = ((cell[..., 0] >= 0) & (cell[..., 0] < w)
                   & (cell[..., 1] >= 0) & (cell[..., 1] < h))
            sel = match & inb[:, :, None]
            ci = cell[..., 0].clamp(0, w - 1)
            cj = cell[..., 1].clamp(0, h - 1)
            pred = out[bidx, cj, ci]                              # (B,M,A,no)
            sig = torch.sigmoid(pred)
            pxy = sig[..., :2] * 2.0 - 0.5 + cell[:, :, None, :].to(dt)
            pwh = (sig[..., 2:4] * 2.0) ** 2 * anchors[None, None]
            ciou = bbox_ciou(torch.cat([pxy, pwh], -1), tbox)     # (B,M,A)
            selm = sel.to(dt)
            nsel = batch_denom(selm.sum())
            total_box = total_box + ((1.0 - ciou) * selm).sum() / nsel \
                * BALANCE[si]
            if cfg.num_classes > 1:
                onehot = Fnn.one_hot(t_cls, cfg.num_classes).to(dt)[:, :, None]
                bce = _bce_logits(pred[..., 5:], onehot)
                total_cls = total_cls + (bce.mean(-1) * selm).sum() / nsel
            # objectness target: the detached IoU, the max over duplicates
            iou_d = ciou.detach().clamp(0.0, 1.0) * selm
            flat = ((bidx[:, :, None] * h + cj[:, :, None]) * w
                    + ci[:, :, None]) * na + aidx
            obj_target.scatter_reduce_(0, flat.reshape(-1), iou_d.reshape(-1),
                                       "amax")
        obce = _bce_logits(out[..., 4], obj_target.view(b, h, w, na))
        total_obj = total_obj + obce.mean() * BALANCE[si]

    return {"loss_box": total_box * cfg.box_lw,
            "loss_obj": total_obj * cfg.obj_lw,
            "loss_cls": total_cls * cfg.cls_lw}


# ---------------------------------------------------------------------------
# NMS (host-side, test-time only)
# ---------------------------------------------------------------------------

def non_max_suppression(pred: np.ndarray, conf_thres: float = 0.001,
                        iou_thres: float = 0.65, max_det: int = 100,
                        ) -> list[np.ndarray]:
    """pred (B, N, 5+nc) numpy -> per image (k, 6) [x1, y1, x2, y2, conf,
    cls]; per-class NMS by offsetting each class's boxes by 4096 px."""
    out = []
    for p in pred:
        conf = p[:, 4:5] * p[:, 5:]
        cls = conf.argmax(1)
        score = conf.max(1)
        keep = score > conf_thres
        boxes = p[keep, :4]
        score = score[keep]
        cls = cls[keep]
        x1 = boxes[:, 0] - boxes[:, 2] / 2
        y1 = boxes[:, 1] - boxes[:, 3] / 2
        x2 = boxes[:, 0] + boxes[:, 2] / 2
        y2 = boxes[:, 1] + boxes[:, 3] / 2
        xyxy = np.stack([x1, y1, x2, y2], 1)
        offset = cls[:, None] * 4096.0
        picked = _nms_numpy(xyxy + offset, score, iou_thres, max_det)
        out.append(np.concatenate([
            xyxy[picked], score[picked, None],
            cls[picked, None].astype(np.float32)
        ], axis=1) if len(picked) else np.zeros((0, 6), np.float32))
    return out


def _nms_numpy(boxes: np.ndarray, scores: np.ndarray, iou_thres: float,
               max_det: int | None = None):
    """Greedy NMS in descending score order; stops once max_det boxes are
    kept (the greedy picks so far are final, so the first max_det are the
    full run's)."""
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0 and (max_det is None or len(keep) < max_det):
        i = order[0]
        keep.append(int(i))
        if order.size == 1:
            break
        xx1 = np.maximum(boxes[i, 0], boxes[order[1:], 0])
        yy1 = np.maximum(boxes[i, 1], boxes[order[1:], 1])
        xx2 = np.minimum(boxes[i, 2], boxes[order[1:], 2])
        yy2 = np.minimum(boxes[i, 3], boxes[order[1:], 3])
        inter = np.maximum(xx2 - xx1, 0) * np.maximum(yy2 - yy1, 0)
        a1 = (boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
        a2 = (boxes[order[1:], 2] - boxes[order[1:], 0]) * \
             (boxes[order[1:], 3] - boxes[order[1:], 1])
        iou = inter / np.maximum(a1 + a2 - inter, 1e-9)
        order = order[1:][iou <= iou_thres]
    return np.asarray(keep, dtype=np.int64)
