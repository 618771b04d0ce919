"""Typed pose and detection containers (port of self6dpp_tpu/utils/
structures.py; reference lib/structures): Poses, Boxes and Instances as
frozen dataclasses of tensors, with the JAX package's methods."""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import Tensor


@dataclass(frozen=True)
class Poses:
    """A batch of rigid poses: R (N, 3, 3), t (N, 3)."""
    R: Tensor
    t: Tensor

    @classmethod
    def create(cls, R, t) -> "Poses":
        """From anything torch.as_tensor takes; checks the shapes."""
        R, t = torch.as_tensor(R), torch.as_tensor(t)
        if R.ndim != 3 or R.shape[1:] != (3, 3):
            raise ValueError(f"R: shape {tuple(R.shape)}, want (N, 3, 3)")
        if t.ndim != 2 or t.shape[1] != 3:
            raise ValueError(f"t: shape {tuple(t.shape)}, want (N, 3)")
        return cls(R=R, t=t)

    def __len__(self) -> int:
        return self.R.shape[0]

    def compose(self, other: "Poses") -> "Poses":
        """self ∘ other: `other` applied first."""
        return Poses(R=self.R @ other.R,
                     t=torch.einsum("nij,nj->ni", self.R, other.t) + self.t)

    def inverse(self) -> "Poses":
        Rt = self.R.transpose(-1, -2)
        return Poses(R=Rt, t=-torch.einsum("nij,nj->ni", Rt, self.t))

    def transform(self, pts: Tensor) -> Tensor:
        """pts (N, P, 3) in each pose's frame -> (N, P, 3)."""
        return torch.einsum("nij,npj->npi", self.R, pts) + self.t[:, None]

    def as_matrix(self) -> Tensor:
        """(N, 3, 4) [R | t]."""
        return torch.cat([self.R, self.t[..., None]], dim=-1)


@dataclass(frozen=True)
class Boxes:
    """2D boxes, xyxy (N, 4)."""
    xyxy: Tensor

    @property
    def centers(self) -> Tensor:
        return (self.xyxy[:, :2] + self.xyxy[:, 2:]) / 2.0

    @property
    def wh(self) -> Tensor:
        return self.xyxy[:, 2:] - self.xyxy[:, :2]

    def area(self) -> Tensor:
        wh = self.wh.clamp_min(0.0)
        return wh[:, 0] * wh[:, 1]

    def scaled(self, factor: float) -> "Boxes":
        """Each box scaled about its centre."""
        c = self.centers
        half = self.wh * factor / 2.0
        return Boxes(xyxy=torch.cat([c - half, c + half], dim=1))

    def clipped(self, h: int, w: int) -> "Boxes":
        """Corners clipped to [0, w - 1] x [0, h - 1]."""
        x1 = self.xyxy[:, 0].clamp(0, w - 1)
        y1 = self.xyxy[:, 1].clamp(0, h - 1)
        x2 = self.xyxy[:, 2].clamp(0, w - 1)
        y2 = self.xyxy[:, 3].clamp(0, h - 1)
        return Boxes(xyxy=torch.stack([x1, y1, x2, y2], dim=1))


@dataclass(frozen=True)
class Instances:
    """One image's detections or annotations, padded to a fixed count."""
    boxes: Boxes
    classes: Tensor       # (N,) int
    scores: Tensor        # (N,)
    valid: Tensor         # (N,) bool

    def topk(self, k: int) -> "Instances":
        """The k highest-scoring instances, valid ones first (ties: the
        lower index first, as jax.lax.top_k takes them)."""
        score = torch.where(self.valid, self.scores,
                            torch.full_like(self.scores, -torch.inf))
        idx = torch.sort(score, descending=True, stable=True).indices[:k]
        return Instances(boxes=Boxes(xyxy=self.boxes.xyxy[idx]),
                         classes=self.classes[idx], scores=self.scores[idx],
                         valid=self.valid[idx])
