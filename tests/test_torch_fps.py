"""The port's farthest-point sampling (self6dpp_tpu_torch/ops/fps.py: the
host routine csrc/fps.c through ctypes) against the JAX package's
fps_numpy and the port's own fps_numpy, bit for bit: icospheres (whose
symmetry makes ties), a mesh with duplicated vertices, random clouds; and
the JAX package's native function on random clouds, where there are no
ties. On a symmetric mesh the JAX native function returns different lists
from call to call; the port's returns one."""

import os

import numpy as np
import pytest

from self6dpp_tpu.ops import fps as jfps
from self6dpp_tpu_torch.data.meshes import make_icosphere
from self6dpp_tpu_torch.ops import fps as tfps


def icosphere(sub):
    return make_icosphere(subdivisions=sub)[0]


def duplicated():
    v = icosphere(2)
    return np.concatenate([v, v[::3], v[:5]]).astype(np.float32)


def cloud(n, seed=0):
    rng = np.random.default_rng(seed + n)
    return (rng.standard_normal((n, 3)) * [0.05, 0.03, 0.08]).astype(np.float32)


# ico6 (40,962 vertices): ties far apart in index order
MESHES = {f"ico{s}": (lambda s=s: icosphere(s)) for s in (1, 2, 3, 4, 6)}
MESHES["dup"] = duplicated
MESHES.update({f"cloud{n}": (lambda n=n: cloud(n))
               for n in (100, 500, 2000, 20000)})


@pytest.mark.parametrize("init_center", [True, False])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_native_equals_fps_numpy(name, init_center):
    pts = MESHES[name]()
    ks = [1, 8, 64] + ([len(pts)] if len(pts) <= 500 else [])
    for k in ks:
        got = tfps.farthest_point_sampling(pts, k, init_center)
        assert got.dtype == np.int32 and got.shape == (k,)
        np.testing.assert_array_equal(got, jfps.fps_numpy(pts, k, init_center),
                                      err_msg=f"{name} k={k}")
        np.testing.assert_array_equal(got, tfps.fps_numpy(pts, k, init_center))
    np.testing.assert_array_equal(tfps.fps_points(pts, 8, init_center),
                                  pts[tfps.fps_numpy(pts, 8, init_center)])


@pytest.mark.parametrize("n", [100, 2000, 20000])
def test_equals_jax_native_on_random_clouds(n):
    """Without ties the JAX native function agrees (its library is the one
    already built in native/; it is not rebuilt here)."""
    if not os.path.exists(jfps._LIB_PATH):
        pytest.skip("native/libself6dpp_native.so is not built")
    assert jfps._load_native(), "the JAX native library does not load"
    pts = cloud(n, seed=7)
    for k in (1, 8, 64):
        for ic in (True, False):
            np.testing.assert_array_equal(
                tfps.farthest_point_sampling(pts, k, ic),
                jfps.farthest_point_sampling(pts, k, ic))


def test_one_list_where_the_jax_native_one_varies():
    """icosphere(subdivisions=2), k 32, from the centroid: 20 calls give
    one list, fps_numpy's."""
    pts = icosphere(2)
    lists = {tuple(tfps.farthest_point_sampling(pts, 32, True))
             for _ in range(20)}
    assert lists == {tuple(jfps.fps_numpy(pts, 32, True))}
