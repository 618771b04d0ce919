"""Data parallel over processes (self6dpp_tpu_torch/parallel/dist.py, the
port of self6dpp_tpu/parallel/mesh.py's process layer), as
tests/test_multihost.py holds the JAX package: two gloo processes on
localhost, each feeding its own half of the global batch, against a
one-process oracle on the whole global batch in rank order.

Each rank draws its records from data/samplers.py::process_shard over the
one training stream every rank draws (the two halves are disjoint). Two
steps are held, one update each from the same seeded state:
  - stage I on masknormvf_tiny (micro backbone with batch norm in train
    mode: the global batch's statistics; the masked xyz/region/vf/norm
    normalisers);
  - the stage-II pose step on stage2_pose_tiny with the whole loss suite
    (LAB through B3's plain version, LPIPS, MS-SSIM's per-level means, the
    chamfer, the RW_BCE mask loss's counts).
The ranks' mean loss terms equal the oracle's within 1e-5 relative, and
every parameter after the update within 1e-5; both ranks hold the same
parameters. The worker is this file run as a script (it imports only
torch, numpy and the port)."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

POOL, GLOBAL_BS, WORLD = 8, 4, 2
RTOL = 1e-5


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def local_indices(r: int, world: int) -> list[int]:
    """Rank r's records of the first global batch: its process_shard of
    the training stream every rank draws from seed 0."""
    from self6dpp_tpu_torch.data.samplers import process_shard, \
        training_sampler
    stream = process_shard(training_sampler(POOL, seed=0), r, world)
    return [int(next(stream)) for _ in range(GLOBAL_BS // world)]


def take(pool: dict, idx: list[int]) -> dict:
    """The batch-major entries of `pool` at idx; the rest (per-class mesh
    tables) as they are."""
    import torch
    ix = torch.as_tensor(idx)
    return {k: v[ix] if v.ndim > 0 and v.shape[0] == POOL else v
            for k, v in pool.items()}


def flat_params(model) -> np.ndarray:
    return np.concatenate([p.detach().reshape(-1).double().numpy()
                           for p in model.parameters()])


def run_worker(rank: int, world: int, port: int, out: str) -> None:
    import torch

    from self6dpp_tpu_torch import config as tc
    from self6dpp_tpu_torch.data.synthetic import make_gdrn_batch
    from self6dpp_tpu_torch.engine import gdrn_engine as ge
    from self6dpp_tpu_torch.engine import self_engine as se
    from self6dpp_tpu_torch.engine.deepim_engine import to_device
    from self6dpp_tpu_torch.models.lpips import build_lpips
    from self6dpp_tpu_torch.parallel import dist

    torch.set_num_threads(1)
    if world > 1:
        dist.init_distributed(f"localhost:{port}", world, rank,
                              device="cpu")
        assert dist.world_size() == world and dist.rank() == rank
    idx = (local_indices(rank, world) if world > 1 else
           sum((local_indices(r, WORLD) for r in range(WORLD)), []))
    res = {"idx": np.asarray(idx)}

    # stage I: batch norm in train mode
    cfg = tc.masknormvf_tiny()
    pool = to_device(make_gdrn_batch(cfg, POOL, seed=0, n_points=32), "cpu")
    model = ge.build_gdrn(cfg, "cpu", seed=0)
    state = ge.init_state(cfg, model)
    _, m = ge.make_train_step(cfg, model)(state, take(pool, idx))
    for k, v in dist.mean_metrics(m).items():
        res[f"s1/{k}"] = float(v)
    res["s1/params"] = flat_params(model)

    # stage II: the pose step with the whole loss suite
    cfg = tc.stage2_pose_tiny()
    model = ge.build_gdrn(cfg, "cpu", seed=0)
    pool = se.stage2_batch(cfg, POOL, "cpu", seed=0)
    se.aim_heads_(model, pool)
    # a mask logit about 0: the teacher's pseudo masks then cover part of
    # each ROI, a different count on each rank, so that a normaliser summed
    # on one rank only (LAB's, the mask loss's, the chamfer's) shows
    with torch.no_grad():
        model.geo_head_net.out_layer.bias[0] = 0.0
    state = ge.init_state(cfg, model)
    step = se.make_self_train_step(cfg, model, build_lpips("cpu", 1),
                                   impl="plain")
    _, m = step(state, take(pool, idx))
    for k, v in dist.mean_metrics(m).items():
        res[f"s2/{k}"] = float(v)
    res["s2/params"] = flat_params(model)
    np.savez(out, **res)
    if world > 1:
        torch.distributed.destroy_process_group()


def test_two_ranks_equal_one_rank_on_the_global_batch(tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    here = os.path.abspath(__file__)
    root = os.path.dirname(os.path.dirname(here))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    port = free_port()
    runs = [(r, WORLD, str(tmp_path / f"rank{r}.npz")) for r in range(WORLD)]
    runs.append((0, 1, str(tmp_path / "oracle.npz")))
    procs = [subprocess.Popen(
        [sys.executable, here, str(r), str(w), str(port), out], env=env,
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r, w, out in runs]
    try:
        logs = [p.communicate(timeout=240)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    r0, r1, oracle = (dict(np.load(out)) for _, _, out in runs)

    # distinct records, in rank order, making up the oracle's batch
    assert not set(r0["idx"]) & set(r1["idx"])
    assert list(oracle["idx"]) == list(r0["idx"]) + list(r1["idx"])
    for stage in ("s1", "s2"):
        keys = sorted(k for k in oracle if k.startswith(stage + "/")
                      and k != f"{stage}/params")
        assert len(keys) > 5 and keys == sorted(
            k for k in r0 if k.startswith(stage + "/")
            and k != f"{stage}/params")
        for k in keys:
            assert r0[k] == r1[k], k                 # the ranks' mean
            assert r0[k] == pytest.approx(float(oracle[k]), rel=RTOL,
                                          abs=1e-7), k
        p0, p1, po = (x[f"{stage}/params"] for x in (r0, r1, oracle))
        np.testing.assert_array_equal(p0, p1)
        np.testing.assert_allclose(p0, po, rtol=RTOL, atol=1e-7)
    # the terms whose normalisers sum over the batch are in the check
    assert {"s1/loss_coor_x", "s1/loss_region", "s1/loss_vf_vis",
            "s1/loss_norm", "s2/loss_color_ab_obj", "s2/loss_mask_self",
            "s2/loss_ms_ssim", "s2/loss_chamfer",
            "s2/loss_init_pred_xyz"} <= set(oracle)


def test_loader_ranks_take_disjoint_shards(monkeypatch):
    """GDRNDataset.batches' training stream under two ranks (rank and
    world patched in): rank r takes [r::2] of the one stream every rank
    draws, so two ranks' batches are disjoint and together the first
    global batches of the one-rank stream."""
    from self6dpp_tpu_torch import config as tc
    from self6dpp_tpu_torch.data import loader
    from self6dpp_tpu_torch.data.bop import Instance, Record

    eye = np.eye(3, dtype=np.float32)
    recs = [Record("x.png", None, eye, 1.0, 0, i,
                   [Instance(1, np.zeros(4), np.zeros(4), eye,
                             np.zeros(3))] * 2) for i in range(5)]

    def keys_of(r, world, n_batches=2):
        monkeypatch.setattr(loader, "rank", lambda: r)
        monkeypatch.setattr(loader, "world_size", lambda: world)
        ds = loader.GDRNDataset(tc.gdrn_synthetic_smoke(), recs, None, None,
                                train=True, seed=3, device="cpu")
        ds.make_samples = lambda keys, pool=None: [
            {"key": np.asarray(k)} for k in keys]
        it = ds.batches(2, num_workers=0)
        return [tuple(k) for _ in range(n_batches)
                for k in next(it)["key"]]

    one = keys_of(0, 1, n_batches=4)
    r0, r1 = keys_of(0, WORLD), keys_of(1, WORLD)
    assert not set(r0) & set(r1) and len(set(one)) == 8
    assert r0 == one[0::2] and r1 == one[1::2]


def test_single_process_flags_are_a_no_op():
    """--dist-nprocs 1 (or no coordinator) joins no group, as the JAX
    init_distributed returns; the CLIs take the three flags."""
    import argparse

    import torch

    from self6dpp_tpu_torch.parallel import dist
    from self6dpp_tpu_torch.tools import (train_deepim, train_gdrn,
                                          train_self6dpp, train_yolov4)
    flags = ["--config", "c", "--dist-coordinator", "localhost:1",
             "--dist-nprocs", "1", "--dist-rank", "0"]
    for cli in (train_gdrn, train_deepim, train_self6dpp, train_yolov4):
        args = cli.parse_args(flags)
        assert (args.dist_coordinator, args.dist_nprocs,
                args.dist_rank) == ("localhost:1", 1, 0)
        dev = dist.maybe_init_distributed_from_args(args, torch.device("cpu"))
        assert dev == torch.device("cpu") and dist.world_size() == 1
    p = argparse.ArgumentParser()
    dist.add_distributed_args(p)
    assert vars(p.parse_args([])) == {"dist_coordinator": "",
                                      "dist_nprocs": 1, "dist_rank": 0}
    x = torch.arange(3.0, requires_grad=True)
    assert dist.global_sum(x) is x and dist.mean_metrics({}) == {}
    assert float(dist.batch_denom(torch.tensor(0.25))) == 1.0
    assert dist.rank_share(torch.tensor(3.0)) is None and dist.is_main()


if __name__ == "__main__":
    run_worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
               sys.argv[4])
