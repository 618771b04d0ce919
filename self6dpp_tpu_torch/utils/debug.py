"""Numerical-failure helpers (port of self6dpp_tpu/utils/debug.py).

The JAX package turns on jax_debug_nans/infs, checks pytrees for finite
values and forces deterministic XLA reductions. Their torch counterparts:
  - nan_debugging(): torch.autograd.set_detect_anomaly (the backward op
    that makes a NaN raises, with the forward's trace), and
    check_finite_tree on what the block returns through its `check`;
  - check_finite_tree(tree, name): raises FloatingPointError naming the
    path of the first non-finite leaf of nested dicts, lists and tuples of
    tensors or arrays, or of a module's parameters and buffers;
  - assert_trees_close(a, b): leaf by leaf within rtol/atol;
  - deterministic(): torch.use_deterministic_algorithms with cuDNN's
    deterministic flag on and its benchmark off, the old settings restored
    on exit.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch
from torch import nn


def enable_nan_debugging() -> None:
    torch.autograd.set_detect_anomaly(True, check_nan=True)


def disable_nan_debugging() -> None:
    torch.autograd.set_detect_anomaly(False)


@contextlib.contextmanager
def nan_debugging():
    """Anomaly detection for the block; yields check(tree, name) that
    raises for a non-finite leaf (check_finite_tree)."""
    old = torch.is_anomaly_enabled()
    old_nan = torch.is_anomaly_check_nan_enabled()
    enable_nan_debugging()
    try:
        yield check_finite_tree
    finally:
        torch.autograd.set_detect_anomaly(old, check_nan=old_nan)


def _leaves(tree, path=""):
    """(path, leaf) of nested dicts, lists, tuples and modules."""
    if isinstance(tree, nn.Module):
        for n, t in tree.state_dict(keep_vars=True).items():
            yield f"{path}/{n}" if path else n, t
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}" if path else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}" if path else str(i))
    elif tree is not None:
        yield path, tree


def _numpy(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().float().cpu().numpy() if x.is_floating_point() \
            else x.detach().cpu().numpy()
    return np.asarray(x)


def check_finite_tree(tree, name: str = "tree") -> None:
    """Raise FloatingPointError at the first leaf with a NaN or an inf,
    naming its path and the counts."""
    for path, leaf in _leaves(tree):
        a = _numpy(leaf)
        if a.dtype.kind in "fc" and not np.isfinite(a).all():
            raise FloatingPointError(
                f"non-finite values in {name} at {path}: "
                f"nan={int(np.isnan(a).sum())}, inf={int(np.isinf(a).sum())}")


def assert_trees_close(a, b, rtol: float = 1e-5, atol: float = 1e-6) -> None:
    """The two trees have the same paths and close leaves."""
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    if sorted(la) != sorted(lb):
        raise AssertionError(f"tree paths differ: {sorted(set(la) ^ set(lb))}")
    for p in la:
        np.testing.assert_allclose(_numpy(la[p]), _numpy(lb[p]), rtol=rtol,
                                   atol=atol, err_msg=p)


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms for the block (reproducibility runs):
    torch.use_deterministic_algorithms(True), cuDNN deterministic and no
    benchmark, CUBLAS_WORKSPACE_CONFIG set as cuBLAS needs it; the old
    settings restored on exit."""
    old = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled(),
           torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
           os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(old[0], warn_only=old[1])
        torch.backends.cudnn.deterministic = old[2]
        torch.backends.cudnn.benchmark = old[3]
        if old[4] is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = old[4]
