"""The single-process forms of the port's data-parallel reductions: the
reference runs on one device, where each is the identity or its plain
single-rank value."""

from __future__ import annotations

from torch import Tensor


def data_size() -> int:
    return 1


def global_sum(x: Tensor) -> Tensor:
    return x


def global_mean(x: Tensor) -> Tensor:
    return x


def batch_denom(s: Tensor) -> Tensor:
    """A loss normaliser: max(s, 1)."""
    return s.clamp_min(1.0)


def rank_share(s: Tensor) -> None:
    return None


def global_max(x: Tensor) -> Tensor:
    return x
