"""Parameter sharding over the ranks (self6dpp_tpu_torch/parallel/mesh.py,
the port of self6dpp_tpu/parallel/mesh.py's make_mesh,
param_sharding_rules and shard_state):
  - the sharding rule picks the JAX package's axis (or replication) leaf
    by leaf on a micro GDRN's parameters at fsdp 2 and 4;
  - two gloo processes at the grid (1, 2) run two stage-I steps
    (masknormvf_tiny, batch norm in train mode) and one stage-II pose step
    (stage2_pose_tiny, the whole loss suite), Ranger and the EMA, on the
    global batch; their gathered parameters, EMA and solver moments equal
    a one-process run's within 1e-5, each rank holding half of every
    sharded leaf (and of its EMA copy and moments);
  - the checkpoint the sharded run saved loads into a one-process run;
  - four processes at (2, 2) run two stage-I steps, each data group on
    its half of the global batch, against the one-process run;
  - at the grid (1, 1), shard_state(force=True) takes the sharded path
    and gives the unsharded state bit for bit.
The runs shard every leaf of 2^10 elements or more (min_size), so that
convolutions cut across their input channels, the PnP head's dense
layers and the geo head's deconvolution all take the sharded path; the
rule test holds the default 2^16 too. The worker is this file run as a
script (it imports only torch, numpy and the port)."""

import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

GLOBAL_BS, WORLD, MIN_SIZE = 2, 2, 2 ** 10
RTOL = 1e-5


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def stage1_cfg():
    from self6dpp_tpu_torch import config as tc
    cfg = tc.masknormvf_tiny()
    return dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, ims_per_batch=GLOBAL_BS, reference_bs=GLOBAL_BS))


def snapshot(state) -> dict:
    """Gathered parameters, EMA and solver state (whole tensors)."""
    import torch
    from self6dpp_tpu_torch.parallel.mesh import gathered
    out = {}
    with gathered(state):
        for n, p in state.model.named_parameters():
            out[f"p/{n}"] = p.detach().double().numpy().copy()
        for n, p in state.teacher.named_parameters():
            out[f"ema/{n}"] = p.detach().double().numpy().copy()
    sd = state.opt.state_dict()
    names = [n for n, _ in state.model.named_parameters()]
    for i, st in sd["state"].items():
        for k, v in st.items():
            if torch.is_tensor(v) and v.ndim:
                out[f"opt/{names[i]}/{k}"] = v.double().numpy().copy()
    return out


def take(batch: dict, idx) -> dict:
    """The batch-major entries of a GLOBAL_BS * 2 pool at idx."""
    import torch
    ix = torch.as_tensor(idx)
    return {k: v[ix] if v.ndim > 0 and v.shape[0] == 2 * GLOBAL_BS else v
            for k, v in batch.items()}


def run_grid_worker(rank: int, world: int, port: int, out: str) -> None:
    """The (2, 2) grid (world 4) or its one-process oracle (world 1): two
    stage-I steps on 2 x GLOBAL_BS records, data rank i taking the records
    [i::2], the oracle all of them in data-rank order."""
    import torch

    from self6dpp_tpu_torch.data.synthetic import make_gdrn_batch
    from self6dpp_tpu_torch.engine import gdrn_engine as ge
    from self6dpp_tpu_torch.engine.deepim_engine import to_device
    from self6dpp_tpu_torch.parallel import dist, mesh

    torch.set_num_threads(1)
    if world > 1:
        dist.init_distributed(f"localhost:{port}", world, rank, device="cpu")
    cfg = stage1_cfg()
    grid = mesh.make_mesh(dataclasses.replace(
        cfg.dist, mesh_shape=(2, 2) if world > 1 else (1, 1)))
    pool = to_device(make_gdrn_batch(cfg, 2 * GLOBAL_BS, seed=0,
                                     n_points=32), "cpu")
    idx = (list(range(grid.data_index, 2 * GLOBAL_BS, 2)) if world > 1
           else [0, 2, 1, 3])
    model = ge.build_gdrn(cfg, "cpu", seed=0)
    state = ge.init_state(cfg, model)
    if world > 1:
        mesh.shard_state(state, grid, min_size=MIN_SIZE)
    step = ge.make_train_step(cfg, model)
    for _ in range(2):
        _, m = step(state, take(pool, idx))
    res = {f"s1/{k}": v for k, v in snapshot(state).items()}
    res["s1/loss"] = float(dist.mean_metrics(m)["total_loss"])
    res["grid"] = np.asarray([grid.data_index, grid.fsdp_index])
    np.savez(out, **res)
    if world > 1:
        torch.distributed.destroy_process_group()


def run_worker(rank: int, world: int, port: int, out: str, ckpt: str) -> None:
    import torch

    from self6dpp_tpu_torch import config as tc
    from self6dpp_tpu_torch.data.synthetic import make_gdrn_batch
    from self6dpp_tpu_torch.engine import gdrn_engine as ge
    from self6dpp_tpu_torch.engine import self_engine as se
    from self6dpp_tpu_torch.engine.checkpoint import CheckpointManager
    from self6dpp_tpu_torch.engine.deepim_engine import to_device
    from self6dpp_tpu_torch.parallel import dist, mesh

    torch.set_num_threads(1)
    if world > 1:
        dist.init_distributed(f"localhost:{port}", world, rank, device="cpu")
    cfg = stage1_cfg()
    grid = mesh.make_mesh(dataclasses.replace(cfg.dist,
                                              mesh_shape=(1, world)))
    res = {}

    def shard(state):
        if world > 1:
            mesh.shard_state(state, grid, min_size=MIN_SIZE)

    def half(state):
        """Each sharded leaf, its EMA copy and its moments: half the
        whole on this rank, the module's tensor an empty placeholder."""
        if world == 1:
            return True
        fs = state.fsdp
        ok = bool(fs.student.entries)
        for n, (p, spec, sh) in fs.student.entries.items():
            whole = int(np.prod(spec.full_shape))
            ok &= p.numel() == 0 and sh.numel() * 2 == whole
            ok &= fs.teacher.entries[n][2].numel() * 2 == whole
            ok &= fs.student.resident_bytes(n) * 2 == whole * 4
            for v in state.opt.state[sh].values():
                ok &= v.numel() * 2 == whole
        return ok

    # stage I: two steps, batch norm in train mode
    batch = to_device(make_gdrn_batch(cfg, GLOBAL_BS, seed=0, n_points=32),
                      "cpu")
    model = ge.build_gdrn(cfg, "cpu", seed=0)
    state = ge.init_state(cfg, model)
    shard(state)
    step = ge.make_train_step(cfg, model)
    for _ in range(2):
        _, m = step(state, batch)
    res["s1/half"] = half(state)
    res["s1/loss"] = float(dist.mean_metrics(m)["total_loss"])
    res.update({f"s1/{k}": v for k, v in snapshot(state).items()})

    # stage II: one pose step with the whole loss suite
    cfg2 = tc.stage2_pose_tiny()
    model, state, batch, lpips = se.build_stage2(cfg2, GLOBAL_BS, "cpu")
    shard(state)
    _, m = se.build_self_train_step(cfg2, model, lpips, impl="plain")(
        state, batch)
    res["s2/half"] = half(state)
    res["s2/loss"] = float(dist.mean_metrics(m)["total_loss"])
    res.update({f"s2/{k}": v for k, v in snapshot(state).items()})
    if world > 1:
        CheckpointManager(ckpt).save(state, force=True)
    np.savez(out, **res)
    if world > 1:
        torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    here = os.path.abspath(__file__)
    root = os.path.dirname(os.path.dirname(here))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    port, ckpt = free_port(), str(tmp / "ckpt")
    jobs = [(r, WORLD, str(tmp / f"rank{r}.npz")) for r in range(WORLD)]
    jobs.append((0, 1, str(tmp / "oracle.npz")))
    procs = [subprocess.Popen(
        [sys.executable, here, str(r), str(w), str(port), out, ckpt],
        env=env, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r, w, out in jobs]
    try:
        logs = [p.communicate(timeout=240)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [dict(np.load(out)) for _, _, out in jobs], ckpt


def test_sharded_ranks_equal_one_process(runs):
    (r0, r1, oracle), _ = runs
    for stage in ("s1", "s2"):
        assert r0[f"{stage}/half"] and r1[f"{stage}/half"], stage
        keys = sorted(k for k in oracle if k.startswith(stage + "/")
                      and k.split("/")[1] in ("p", "ema", "opt"))
        assert keys and sorted(k for k in r0 if k in keys) == keys
        for k in keys:
            scale = max(np.abs(oracle[k]).max(), 1e-3)
            for r in (r0, r1):
                np.testing.assert_allclose(r[k], oracle[k], rtol=RTOL,
                                           atol=RTOL * scale, err_msg=k)
            assert np.array_equal(r0[k], r1[k]), k
        np.testing.assert_allclose(r0[f"{stage}/loss"], oracle[f"{stage}/loss"],
                                   rtol=RTOL)
    # the step moved the parameters
    assert any(not np.array_equal(oracle[k], oracle[k.replace("/p/", "/ema/")])
               for k in oracle if k.startswith("s2/p/"))


def test_grid_2x2_equals_one_process(tmp_path):
    """Four gloo processes at (2, 2): two data groups of two fsdp ranks
    (the groups of both axes built), two stage-I steps on their halves of
    the global batch; every rank's gathered state equals the one-process
    run on the whole batch within 1e-5 (the moments within 1e-3 of their
    scale), the two ranks of an fsdp group bit for bit."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    here = os.path.abspath(__file__)
    root = os.path.dirname(os.path.dirname(here))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    port = free_port()
    jobs = [(r, 4, str(tmp_path / f"r{r}.npz")) for r in range(4)]
    jobs.append((0, 1, str(tmp_path / "oracle.npz")))
    procs = [subprocess.Popen(
        [sys.executable, here, "grid", str(r), str(w), str(port), out],
        env=env, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r, w, out in jobs]
    try:
        logs = [p.communicate(timeout=240)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    *ranks, oracle = (dict(np.load(out)) for _, _, out in jobs)
    assert [list(r["grid"]) for r in ranks] == [[0, 0], [0, 1], [1, 0],
                                                [1, 1]]
    keys = sorted(k for k in oracle if k.startswith(("s1/p/", "s1/ema/",
                                                     "s1/opt/")))
    for k in keys:
        # the moments are gradients: split over two data groups, batch
        # norm's statistics (E[x^2] - E[x]^2 over the halves) round
        # otherwise, which the gradients carry at ~1e-4 of their scale
        # (tests/test_torch_dist.py holds data parallel on parameters)
        tol = RTOL if "/opt/" not in k else 1e-3
        scale = max(np.abs(oracle[k]).max(), 1e-3 if tol == RTOL else 0)
        for r in ranks:
            np.testing.assert_allclose(r[k], oracle[k], rtol=tol,
                                       atol=tol * scale, err_msg=k)
        assert np.array_equal(ranks[0][k], ranks[1][k]), k
        assert np.array_equal(ranks[2][k], ranks[3][k]), k
    np.testing.assert_allclose(ranks[0]["s1/loss"], oracle["s1/loss"],
                               rtol=RTOL)


def test_sharded_checkpoint_loads_into_one_process(runs):
    """The (1, 2) run's checkpoint (whole tensors, written by rank 0)
    restores into a one-process stage-II state: its parameters, EMA and
    solver state are the sharded run's."""
    from self6dpp_tpu_torch import config as tc
    from self6dpp_tpu_torch.engine import self_engine as se
    from self6dpp_tpu_torch.engine.checkpoint import CheckpointManager
    import torch
    (r0, _, _), ckpt = runs
    torch.set_num_threads(1)
    _, state, _, _ = se.build_stage2(tc.stage2_pose_tiny(), GLOBAL_BS, "cpu")
    CheckpointManager(ckpt).restore(state)
    assert state.step == 1 and state.fsdp is None
    got = snapshot(state)
    for k, v in got.items():
        np.testing.assert_array_equal(v, r0[f"s2/{k}"], err_msg=k)


def gdrn_jax_specs(fsdp, min_size):
    """{port parameter name: the JAX rule's fsdp axis in the JAX layout, or
    None} on stage2_pose_tiny's GDRN, the JAX tree laid out by
    convert.gdrn_state_dict_to_flax."""
    import jax
    from self6dpp_tpu.config.base import DistConfig as JDist
    from self6dpp_tpu.parallel import mesh as jmesh
    from self6dpp_tpu_torch import config as tc
    from self6dpp_tpu_torch import convert
    from self6dpp_tpu_torch.engine import gdrn_engine as ge
    model = ge.build_gdrn(tc.stage2_pose_tiny(), "cpu", seed=0)
    jm = jmesh.make_mesh(JDist(mesh_shape=(-1, fsdp)), jax.devices()[:8])
    params = convert.gdrn_state_dict_to_flax(model)["params"]
    rules = jmesh.param_sharding_rules(params, jm, min_size=min_size)
    key_map = convert.gdrn_key_map(model)
    out = {}
    for n, _ in model.named_parameters():
        kind, fk = convert._flax_key(n, key_map)
        node = rules
        for part in fk.split(".")[1:]:
            node = node[part]
        spec = tuple(node.spec)
        out[n] = (kind, spec.index("fsdp") if "fsdp" in spec else None)
    return model, out


@pytest.mark.parametrize("fsdp", [2, 4])
@pytest.mark.parametrize("min_size", [2 ** 16, MIN_SIZE])
def test_rule_picks_the_jax_axis(fsdp, min_size):
    from self6dpp_tpu_torch.parallel.mesh import (_jax_shape_axes,
                                                  param_sharding_rules)
    model, jax_axes = gdrn_jax_specs(fsdp, min_size)
    ours = param_sharding_rules(model, fsdp, min_size)
    shapes = dict(model.named_parameters())
    assert any(a is not None for _, a in jax_axes.values())
    for n, (kind, jax_axis) in jax_axes.items():
        want = (None if jax_axis is None else
                _jax_shape_axes(tuple(shapes[n].shape), kind)[1][jax_axis])
        assert ours[n] == want, (n, kind, ours[n], want)


def test_mesh_shape_must_fit_the_world():
    from self6dpp_tpu_torch.parallel.mesh import resolve_shape
    assert resolve_shape((-1, 2), 4) == (2, 2)
    assert resolve_shape((1, -1), 2) == (1, 2)
    assert resolve_shape(("2", "2"), 4) == (2, 2)     # --opts gives strings
    with pytest.raises(ValueError):
        resolve_shape((3, 2), 4)


def test_sharded_path_at_one_rank_is_bitwise():
    import torch
    from self6dpp_tpu_torch.data.synthetic import make_gdrn_batch
    from self6dpp_tpu_torch.engine import gdrn_engine as ge
    from self6dpp_tpu_torch.engine.deepim_engine import to_device
    from self6dpp_tpu_torch.parallel import mesh
    torch.set_num_threads(1)
    cfg = stage1_cfg()
    batch = to_device(make_gdrn_batch(cfg, GLOBAL_BS, seed=0, n_points=32),
                      "cpu")
    runs = []
    for force in (False, True):
        model = ge.build_gdrn(cfg, "cpu", seed=0)
        state = ge.init_state(cfg, model)
        if force:
            mesh.shard_state(state, mesh.make_mesh(cfg.dist),
                             min_size=MIN_SIZE, force=True)
            assert state.fsdp.student.entries
        step = ge.make_train_step(cfg, model)
        for _ in range(2):
            step(state, batch)
        runs.append(snapshot(state))
    assert sorted(runs[0]) == sorted(runs[1])
    for k in runs[0]:
        assert np.array_equal(runs[0][k], runs[1][k]), k


if __name__ == "__main__":
    if sys.argv[1] == "grid":
        run_grid_worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
                        sys.argv[5])
    else:
        run_worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
                   sys.argv[4], sys.argv[5])
