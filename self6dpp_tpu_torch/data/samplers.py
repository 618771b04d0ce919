"""Index streams for the loader (port of self6dpp_tpu/data/samplers.py;
reference core/utils/my_distributed_sampler.py). Plain numpy generators:
from the same seed each yields the JAX package's indices.
"""

from __future__ import annotations

import itertools
from typing import Iterator

import numpy as np


def process_shard(indices: Iterator[int], process_id: int,
                  process_count: int) -> Iterator[int]:
    """Process r of P takes indices[r::P] of a stream every process draws
    from the same seed, so the strided slices partition each epoch."""
    yield from itertools.islice(indices, process_id, None, process_count)


def training_sampler(n: int, seed: int = 0, shuffle: bool = True
                     ) -> Iterator[int]:
    """Infinite stream of indices, each epoch a fresh permutation."""
    rng = np.random.default_rng(seed)
    while True:
        order = rng.permutation(n) if shuffle else np.arange(n)
        yield from order


def repeat_factor_sampler(repeat_factors: np.ndarray, seed: int = 0
                          ) -> Iterator[int]:
    """Category-rebalanced infinite stream: index i appears floor(rf_i) +
    Bernoulli(frac(rf_i)) times per epoch, the epoch shuffled."""
    rng = np.random.default_rng(seed)
    rf = np.asarray(repeat_factors, dtype=np.float64)
    while True:
        ints = np.floor(rf).astype(int)
        frac = rf - ints
        reps = ints + (rng.random(len(rf)) < frac)
        idx = np.repeat(np.arange(len(rf)), reps)
        rng.shuffle(idx)
        yield from idx


def repeat_factors_from_category_frequency(cat_ids: np.ndarray,
                                           repeat_thresh: float = 0.01
                                           ) -> np.ndarray:
    """Per index max(1, sqrt(t / f_c)), f_c its category's frequency (the
    LVIS recipe)."""
    cats, counts = np.unique(cat_ids, return_counts=True)
    freq = counts / len(cat_ids)
    per_cat = {c: max(1.0, np.sqrt(repeat_thresh / f))
               for c, f in zip(cats, freq)}
    return np.asarray([per_cat[c] for c in cat_ids])


def inference_sampler(n: int) -> Iterator[int]:
    """Sequential, one pass."""
    yield from range(n)


def infinite_subset_random_sampler(n: int, subset_ratio: float = 1.0,
                                   seed: int = 0,
                                   weights: np.ndarray | None = None
                                   ) -> Iterator[int]:
    """Each epoch a random subset of max(n * ratio, 1) indices without
    replacement, drawn with probabilities proportional to `weights` when
    given."""
    rng = np.random.default_rng(seed)
    k = max(int(n * subset_ratio), 1)
    p = None
    if weights is not None:
        w = np.asarray(weights, dtype=np.float64)
        p = w / w.sum()
    while True:
        idx = rng.choice(n, size=k, replace=False, p=p)
        yield from idx


def batch_separated_batches(group_ids: np.ndarray, batch_size: int,
                            seed: int = 0) -> Iterator[np.ndarray]:
    """Infinite stream of index batches that never mix group ids (the
    BatchSeparatedBatchSampler): each round shuffles every group and the
    groups' order, then yields each group's whole batches."""
    rng = np.random.default_rng(seed)
    groups: dict = {}
    for i, gid in enumerate(group_ids):
        groups.setdefault(gid, []).append(i)
    while True:
        pools = {g: rng.permutation(v).tolist() for g, v in groups.items()}
        order = rng.permutation(list(pools))
        for g in order:
            pool = pools[g]
            for s in range(0, len(pool) - batch_size + 1, batch_size):
                yield np.asarray(pool[s:s + batch_size])
