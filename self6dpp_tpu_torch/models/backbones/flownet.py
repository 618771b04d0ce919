"""FlowNetS encoder/decoder (port of self6dpp_tpu/models/backbones/flownet.py).

Submodule names follow the reference torch module
(core/deepim/models/backbones/flownets.py): conv1.0 ... conv6_1.0,
predict_flow6, upsampled_flow6_to_5, deconv5.0, ... (with batch norm
conv1.1 ... conv6_1.1) so a reference checkpoint loads as it is. Works in
NCHW inside; DeepIM converts at its boundary.
"""

from __future__ import annotations

import torch
from torch import Tensor, nn

from ..layers import FlaxBatchNorm2d

FLOWNETS_WIDTHS = (64, 128, 256, 512, 512, 1024)


def _conv(cin: int, cout: int, k: int, s: int, use_bn: bool) -> nn.Sequential:
    # torch symmetric padding (k-1)//2, leaky ReLU 0.1; with batch norm the
    # conv has no bias and BN (Flax's momentum 0.9 in train mode) follows
    pad = (k - 1) // 2
    if use_bn:
        return nn.Sequential(nn.Conv2d(cin, cout, k, s, pad, bias=False),
                             FlaxBatchNorm2d(cout, eps=1e-5),
                             nn.LeakyReLU(0.1))
    return nn.Sequential(nn.Conv2d(cin, cout, k, s, pad), nn.LeakyReLU(0.1))


def _deconv(cin: int, cout: int) -> nn.Sequential:
    return nn.Sequential(nn.ConvTranspose2d(cin, cout, 4, 2, 1, bias=True),
                         nn.LeakyReLU(0.1))


def _predict_flow(cin: int) -> nn.Conv2d:
    return nn.Conv2d(cin, 2, 3, 1, 1, bias=True)


def _up_flow() -> nn.ConvTranspose2d:
    return nn.ConvTranspose2d(2, 2, 4, 2, 1, bias=False)


class FlowNetS(nn.Module):
    """out_flow_level: 'flow4', 'all' (flow2 ... flow6, through the concat3
    and concat2 decoder stages) or 'none'; out_concat4 keeps the decoder up
    to concat4 for the DeepIM mask head."""

    def __init__(self, in_channels: int = 6, use_bn: bool = False,
                 out_flow_level: str = "flow4", out_concat4: bool = True,
                 widths: tuple[int, ...] = FLOWNETS_WIDTHS):
        super().__init__()
        if out_flow_level not in ("flow4", "all", "none"):
            raise ValueError(f"unknown out_flow_level {out_flow_level!r}")
        w = widths
        self.use_bn = use_bn
        self.out_flow_level = out_flow_level
        self.out_concat4 = out_concat4
        c = lambda cin, cout, k, s: _conv(cin, cout, k, s, use_bn)
        self.conv1 = c(in_channels, w[0], 7, 2)
        self.conv2 = c(w[0], w[1], 5, 2)
        self.conv3 = c(w[1], w[2], 5, 2)
        self.conv3_1 = c(w[2], w[2], 3, 1)
        self.conv4 = c(w[2], w[3], 3, 2)
        self.conv4_1 = c(w[3], w[3], 3, 1)
        self.conv5 = c(w[3], w[4], 3, 2)
        self.conv5_1 = c(w[4], w[4], 3, 1)
        self.conv6 = c(w[4], w[5], 3, 2)
        self.conv6_1 = c(w[5], w[5], 3, 1)
        self.has_decoder = out_flow_level != "none" or out_concat4
        if self.has_decoder:
            c5 = w[4] + w[3] + 2                   # out5 | deconv5 | up6
            self.predict_flow6 = _predict_flow(w[5])
            self.upsampled_flow6_to_5 = _up_flow()
            self.deconv5 = _deconv(w[5], w[3])
            self.predict_flow5 = _predict_flow(c5)
            self.upsampled_flow5_to_4 = _up_flow()
            self.deconv4 = _deconv(c5, w[2])
        c4 = w[3] + w[2] + 2                       # out4 | deconv4 | up5
        if out_flow_level != "none":
            self.predict_flow4 = _predict_flow(c4)
        if out_flow_level == "all":
            c3 = w[2] + w[1] + 2                   # out3 | deconv3 | up4
            self.upsampled_flow4_to_3 = _up_flow()
            self.deconv3 = _deconv(c4, w[1])
            self.predict_flow3 = _predict_flow(c3)
            self.upsampled_flow3_to_2 = _up_flow()
            self.deconv2 = _deconv(c3, w[0])
            self.predict_flow2 = _predict_flow(w[1] + w[0] + 2)

    def forward(self, x: Tensor):
        """x (B, C, H, W). Returns (out6 (B,w5,H/64,W/64),
        concat4 (B,w3+w2+2,H/16,W/16) | None, flow): flow4 (B,2,H/16,W/16)
        for 'flow4', [flow2, flow3, flow4, flow5, flow6] (at H/4 ... H/64)
        for 'all', None for 'none'."""
        out2 = self.conv2(self.conv1(x))
        out3 = self.conv3_1(self.conv3(out2))
        out4 = self.conv4_1(self.conv4(out3))
        out5 = self.conv5_1(self.conv5(out4))
        out6 = self.conv6_1(self.conv6(out5))
        if not self.has_decoder:
            return out6, None, None
        flow6 = self.predict_flow6(out6)
        concat5 = torch.cat([out5, self.deconv5(out6),
                             self.upsampled_flow6_to_5(flow6)], dim=1)
        flow5 = self.predict_flow5(concat5)
        concat4 = torch.cat([out4, self.deconv4(concat5),
                             self.upsampled_flow5_to_4(flow5)], dim=1)
        flow = None
        if self.out_flow_level == "flow4":
            flow = self.predict_flow4(concat4)
        elif self.out_flow_level == "all":
            flow4 = self.predict_flow4(concat4)
            concat3 = torch.cat([out3, self.deconv3(concat4),
                                 self.upsampled_flow4_to_3(flow4)], dim=1)
            flow3 = self.predict_flow3(concat3)
            concat2 = torch.cat([out2, self.deconv2(concat3),
                                 self.upsampled_flow3_to_2(flow3)], dim=1)
            flow = [self.predict_flow2(concat2), flow3, flow4, flow5, flow6]
        return out6, (concat4 if self.out_concat4 else None), flow
