"""Metric writers (port of self6dpp_tpu/engine/writers.py; reference
core/utils/my_writer.py): a rolling scalar store, a terminal printer with
the ETA, metrics.json lines and an optional TensorBoard writer.

Without the tensorboard package the TensorBoard writer logs one warning
and writes nothing; metrics.json and the checkpoints never depend on it.
"""

from __future__ import annotations

import json
import logging
import os
import time
from collections import defaultdict, deque

import numpy as np

from ..parallel.dist import is_main

logger = logging.getLogger("self6dpp_tpu_torch")


class EventStorage:
    """Rolling scalar store (median over the last `window` values, as
    detectron2's HistoryBuffer); `tb` is the TensorBoard writer, when the
    trainer has one (image grids reach it here)."""

    def __init__(self, window: int = 20):
        self.window = window
        self._hist: dict[str, deque] = defaultdict(lambda: deque(maxlen=window))
        self._latest: dict[str, float] = {}
        self.iter = 0
        self.tb = None

    def put_scalars(self, **kw) -> None:
        for k, v in kw.items():
            v = float(v)
            self._hist[k].append(v)
            self._latest[k] = v

    def median(self, key: str) -> float:
        h = sorted(self._hist[key])
        return h[len(h) // 2] if h else 0.0

    def latest(self) -> dict[str, float]:
        return dict(self._latest)


class TerminalWriter:
    """Logs, every log_period iterations, the median of each loss and the
    ETA from the time since the last line."""

    def __init__(self, storage: EventStorage, max_iter: int,
                 log_period: int = 100):
        self.storage = storage
        self.max_iter = max_iter
        self.log_period = log_period
        self._t0 = time.perf_counter()
        self._last_iter = 0

    def write(self) -> None:
        it = self.storage.iter
        if it % self.log_period != 0:
            return
        elapsed = time.perf_counter() - self._t0
        done = max(it - self._last_iter, 1)
        per_iter = elapsed / done
        eta = per_iter * (self.max_iter - it)
        self._t0 = time.perf_counter()
        self._last_iter = it
        scalars = " ".join(
            f"{k}: {self.storage.median(k):.4f}"
            for k in sorted(self.storage.latest())
            if k.startswith(("loss", "total")))
        logger.info(
            f"iter {it}/{self.max_iter} eta {eta / 60:.1f}min "
            f"({per_iter:.3f}s/it) {scalars}")


class JSONWriter:
    """Appends, every log_period iterations, one JSON line of the latest
    scalars to metrics.json."""

    def __init__(self, storage: EventStorage, path: str,
                 log_period: int = 100):
        self.storage = storage
        self.path = path
        self.log_period = log_period
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def write(self) -> None:
        if self.storage.iter % self.log_period != 0:
            return
        row = {"iteration": self.storage.iter, **self.storage.latest()}
        with open(self.path, "a") as f:
            f.write(json.dumps(row) + "\n")


class TensorboardWriter:
    """Scalars every log_period iterations, images and text on request,
    through torch.utils.tensorboard; a logged no-op without the
    tensorboard package."""

    def __init__(self, storage: EventStorage, log_dir: str,
                 log_period: int = 100):
        self.storage = storage
        self.log_period = log_period
        try:
            from torch.utils.tensorboard import SummaryWriter
            self.w = SummaryWriter(log_dir=log_dir)
        except ImportError as e:
            logger.warning(f"no TensorBoard writer ({e}); its scalars, "
                           "images and text are not written")
            self.w = None

    def write(self) -> None:
        if self.w is None or self.storage.iter % self.log_period != 0:
            return
        for k, v in self.storage.latest().items():
            self.w.add_scalar(k, v, self.storage.iter)

    def add_image(self, tag: str, img_hwc, step: int | None = None) -> None:
        """img float in [0, 1] or uint8, (H, W, C)."""
        if self.w is None:
            return
        img = np.asarray(img_hwc)
        if img.dtype != np.uint8:
            img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        self.w.add_image(tag, img, step or self.storage.iter,
                         dataformats="HWC")

    def add_text(self, tag: str, text: str, step: int | None = None) -> None:
        if self.w is not None:
            self.w.add_text(tag, text, step or self.storage.iter)

    def close(self) -> None:
        if self.w is not None:
            self.w.flush()
            self.w.close()


def setup_logger(output_dir: str | None = None,
                 level: int = logging.INFO) -> logging.Logger:
    """The port's logger: to the terminal, and to <output_dir>/log.txt
    when given and this process is rank 0 (set up once per process)."""
    lg = logging.getLogger("self6dpp_tpu_torch")
    if lg.handlers:
        return lg
    lg.setLevel(level)
    fmt = logging.Formatter("[%(asctime)s %(levelname).1s] %(message)s",
                            datefmt="%m%d %H:%M:%S")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    lg.addHandler(sh)
    if output_dir and is_main():
        os.makedirs(output_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(output_dir, "log.txt"))
        fh.setFormatter(fmt)
        lg.addHandler(fh)
    return lg
