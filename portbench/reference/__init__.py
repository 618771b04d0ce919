"""The plain reference of the benchmark: a frozen copy of the port's plain
PyTorch paths (models, losses, rasterizer, solver), with every hand-written
kernel replaced by its plain version and the data-parallel reductions by
their single-process forms. It imports neither the port nor the JAX
package, and runs in float32 with TF32 off (see steps.py)."""

import torch


def resolve_device(device=None) -> torch.device:
    """The device the reference runs on: CUDA unless the caller asks for
    another."""
    return torch.device("cuda" if device is None else device)
