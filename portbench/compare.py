"""The numbers that decide `correct`, worked out the same way from the
program's run and from the reference's, and the gaps between them.

Training (three steps from one state, on three different batches):
  loss   each step's loss terms;
  grad   each leaf's norm of the first step's gradient as the solver got it
         (Ranger's first moment after one step, over 1 - beta1);
  change each leaf's norm of its change over the three steps, the
         student's and the EMA teacher's (and, in stage I, each batch-norm
         statistic's).
A gap of norms is taken leaf by leaf: |a - b| / max(b, median b), with b
the reference's; by the worst leaf, by the median leaf's own gap, or
(grad_upper_half_gap) as the mean over the leaves whose reference
gradient is at or above the median leaf's, where the bf16 program's
rounding is smallest against the gradient. Leaves whose reference
gradient is under a thousandth of the median leaf's move by round-off
alone (a bias under a softmax, a frozen statistic): they are left out of
the change.
Refinement: the angle between the two final rotations, the distance
between the two final translations, the distance in pixels between the
two translations' projections into the frame (the image-plane position of
the object's centre) and the relative gap of their depths, the widest and
the mean over every ROI compared.
"""

from __future__ import annotations

import math

import torch
from torch import Tensor

QUIET = 1e-3        # a leaf whose reference gradient is under this share
                    # of the median leaf's is left out of the change


class StepReadings:
    """Records the readings of three steps of a training state."""

    def __init__(self, params: list[Tensor], teacher: list[Tensor] | None,
                 stats: list[Tensor] | None = None):
        self.params, self.teacher, self.stats = params, teacher, stats
        with torch.no_grad():
            self.p0 = [p.detach().clone() for p in params]
            self.t0 = [p.detach().clone() for p in teacher or []]
            self.s0 = [s.detach().float().clone() for s in stats or []]
        self.losses: list[dict[str, Tensor]] = []
        self.grad: Tensor | None = None

    @torch.no_grad()
    def after_step(self, opt, metrics: dict[str, Tensor]) -> None:
        self.losses.append({k: v.detach().float() for k, v in metrics.items()})
        if self.grad is None:
            b1 = opt.param_groups[0]["b1"]
            mu = [opt.state[p]["mu"] for p in self.params]
            self.grad = torch.stack(torch._foreach_norm(mu)) / (1 - b1)

    @torch.no_grad()
    def finish(self) -> dict:
        """The readings on the host; frees the snapshots."""
        def change(now, then):
            if not now:
                return None
            d = torch._foreach_sub([x.detach().float() for x in now], then)
            return torch.stack(torch._foreach_norm(d)).cpu()
        out = {"losses": [{k: float(v) for k, v in s.items()}
                          for s in self.losses],
               "grad": self.grad.cpu(),
               "change": change(self.params, self.p0),
               "teacher_change": change(self.teacher, self.t0),
               "stats_change": change(self.stats, self.s0)}
        self.p0 = self.t0 = self.s0 = None
        return out


def leaf_gaps(prog: Tensor, ref: Tensor, keep: Tensor | None = None
              ) -> Tensor:
    """Each kept leaf's |prog - ref| / max(ref, median ref)."""
    prog, ref = prog.double(), ref.double()
    if keep is not None:
        prog, ref = prog[keep], ref[keep]
    return (prog - ref).abs() / torch.maximum(ref, ref.median())


def leaf_gap(prog: Tensor, ref: Tensor, keep: Tensor | None = None) -> float:
    """The worst kept leaf's gap (leaf_gaps)."""
    return float(leaf_gaps(prog, ref, keep).max())


def loss_gap(prog: list[dict], ref: list[dict]) -> float:
    """max over steps and terms of |prog - ref| / |ref|; a term under a
    thousandth of the step's mean |term| is measured against that
    thousandth (a term that is all but zero)."""
    worst = 0.0
    for p, r in zip(prog, ref, strict=True):
        if set(p) != set(r):
            return math.inf
        terms = {k: v for k, v in r.items() if k != "total_loss"}
        floor = 1e-3 * sum(abs(v) for v in terms.values()) \
            / max(len(terms), 1)
        for k, v in r.items():
            worst = max(worst, abs(p[k] - v) / max(abs(v), floor, 1e-30))
    return worst


def train_numbers(prog: dict, ref: dict) -> dict[str, float]:
    """Every gap of a training cell (those the cell's limits name are
    compared; the rest are recorded)."""
    keep = ref["grad"] >= QUIET * ref["grad"].median()
    out = {"loss_gap": loss_gap(prog["losses"], ref["losses"]),
           "first_terms_gap": loss_gap(prog["losses"][:1], ref["losses"][:1]),
           "grad_gap": leaf_gap(prog["grad"], ref["grad"]),
           "grad_leaf_median_gap": leaf_gaps(prog["grad"], ref["grad"])
           .median().item(),
           "grad_upper_half_gap": leaf_gaps(
               prog["grad"], ref["grad"],
               ref["grad"] >= ref["grad"].median()).mean().item(),
           "change_gap": leaf_gap(prog["change"], ref["change"], keep),
           "change_median_leaf_gap": leaf_gaps(prog["change"], ref["change"],
                                               keep).median().item(),
           "quiet_leaves": int((~keep).sum())}
    if ref["teacher_change"] is not None:
        out["teacher_change_gap"] = leaf_gap(prog["teacher_change"],
                                             ref["teacher_change"], keep)
    if ref["stats_change"] is not None:
        sk = ref["stats_change"] >= QUIET * ref["stats_change"].median()
        out["stats_change_gap"] = leaf_gap(prog["stats_change"],
                                           ref["stats_change"], sk)
        out["stats_change_median_leaf_gap"] = leaf_gaps(
            prog["stats_change"], ref["stats_change"], sk).median().item()
    return out


def rotation_deg(a: Tensor, b: Tensor) -> Tensor:
    """Angle in degrees between rotation matrices a and b (..., 3, 3), from
    |a - b|_F = 2 sqrt(2) sin(angle / 2), which stays exact near 0."""
    d = (a.double() - b.double()).flatten(-2).norm(dim=-1)
    return torch.rad2deg(2 * torch.asin((d / 8 ** 0.5).clamp(max=1.0)))


def projection(K: Tensor, t: Tensor) -> Tensor:
    """The pixel (u, v) at which the camera K (B, 3, 3) sees the point t
    (B, 3)."""
    p = torch.einsum("bij,bj->bi", K.double(), t.double())
    return p[:, :2] / p[:, 2:]


def pose_numbers(prog: list[tuple[Tensor, Tensor]],
                 ref: list[tuple[Tensor, Tensor]],
                 cams: list[Tensor]) -> dict[str, float]:
    """The widest and the mean gap over every ROI compared: rotation in
    degrees, translation in millimetres, its projection by each ROI's
    camera in cams in pixels, and its depth relative to the reference's."""
    pairs = list(zip(prog, ref, cams, strict=True))
    rot = torch.cat([rotation_deg(p[0], r[0]).flatten() for p, r, _ in pairs])
    trans = torch.cat([(p[1].double() - r[1].double()).norm(dim=-1)
                       for p, r, _ in pairs]) * 1e3
    center = torch.cat([(projection(K, p[1]) - projection(K, r[1]))
                        .norm(dim=-1) for p, r, K in pairs])
    depth = torch.cat([((p[1][:, 2].double() - r[1][:, 2].double())
                        / r[1][:, 2].double()).abs() for p, r, _ in pairs])
    return {"rot_gap_deg": float(rot.max()),
            "rot_gap_mean_deg": float(rot.mean()),
            "center_gap_px": float(center.max()),
            "center_gap_mean_px": float(center.mean()),
            "trans_gap_mm": float(trans.max()),
            "trans_gap_mean_mm": float(trans.mean()),
            "depth_gap_rel": float(depth.max())}


def judge(numbers: dict[str, float], limits: dict[str, float]
          ) -> tuple[bool, dict]:
    """(every limited number within its limit, {name: {value, limit}})."""
    checks = {k: {"value": numbers.get(k, math.inf), "limit": v}
              for k, v in limits.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
