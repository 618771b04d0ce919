"""The port's utils (self6dpp_tpu_torch/utils/): structures against the
JAX package's; debug's finiteness check names the path and
deterministic() restores the flags; profiling writes a CPU trace in
which a span is a named range; vis against cv2 through the JAX
package's vis.py on the same inputs, pixel for pixel. make_vis_fixture
writes the committed glyph and colormap fixture with cv2, which the port
does not import (python tests/test_torch_utils.py regenerates it)."""

import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "self6dpp_tpu_torch", "fixtures", "vis",
                       "hershey_simplex.npz")
_ORG = (40, 40)


def _render_text(s, shape=(80, 400)):
    import cv2
    im = np.zeros(shape, np.uint8)
    cv2.putText(im, s, _ORG, cv2.FONT_HERSHEY_SIMPLEX, 0.5, 255, 1)
    return im


def make_vis_fixture() -> dict:
    """cv2.putText's glyphs at FONT_HERSHEY_SIMPLEX, scale 0.5, thickness
    1 (each printable character's coverage drawn alone at _ORG, its offset
    from the pen, and the pen's advance, measured against a 'W' ten
    spaces on), and cv2's JET table."""
    import cv2

    def cols(s):
        return np.nonzero(_render_text(s).any(0))[0]
    space = (cols(" " * 10 + "W").min() - cols("W").min()) // 10
    out = {k: [] for k in ("codes", "shape", "offset", "dx", "dy",
                           "advance", "alpha")}
    o = 0
    for code in range(32, 127):
        c = chr(code)
        m = _render_text(c)
        if m.any():
            ys, xs = np.nonzero(m)
            y0, x0 = ys.min(), xs.min()
            a = m[y0:ys.max() + 1, x0:xs.max() + 1]
            dx, dy = x0 - _ORG[0], y0 - _ORG[1]
        else:
            a, dx, dy = np.zeros((0, 0), np.uint8), 0, 0
        adv = cols(c + " " * 10 + "W").max() - cols("W").max() - 10 * space
        for k, v in (("codes", code), ("shape", a.shape), ("offset", o),
                     ("dx", dx), ("dy", dy), ("advance", adv),
                     ("alpha", a.reshape(-1))):
            out[k].append(v)
        o += a.size
    arrays = {k: np.asarray(out[k], np.int32) for k in out if k != "alpha"}
    arrays["alpha"] = np.concatenate(out["alpha"]).astype(np.uint8)
    arrays["jet"] = cv2.applyColorMap(np.arange(256, dtype=np.uint8)[None],
                                      cv2.COLORMAP_JET)[0]
    return arrays


def write_vis_fixture(path=FIXTURE) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, **make_vis_fixture())


# --------------------------------------------------------------- structures

def test_structures_match_jax():
    from scipy.spatial.transform import Rotation
    from self6dpp_tpu.utils import structures as js
    from self6dpp_tpu_torch.utils import structures as ts
    rng = np.random.default_rng(0)
    R = Rotation.random(5, random_state=1).as_matrix().astype(np.float32)
    t = rng.standard_normal((5, 3)).astype(np.float32)
    R2 = Rotation.random(5, random_state=2).as_matrix().astype(np.float32)
    t2 = rng.standard_normal((5, 3)).astype(np.float32)
    pts = rng.standard_normal((5, 7, 3)).astype(np.float32)
    jp, jq = js.Poses.create(R, t), js.Poses.create(R2, t2)
    tp, tq = ts.Poses.create(R, t), ts.Poses.create(R2, t2)
    # the JAX Poses' __len__ is shadowed by chex's mapping (its field
    # count, 2); the port's gives the documented batch size
    assert len(tp) == 5 and len(jp) == 2
    pairs = [(tp.compose(tq).R, jp.compose(jq).R),
             (tp.compose(tq).t, jp.compose(jq).t),
             (tp.inverse().R, jp.inverse().R), (tp.inverse().t, jp.inverse().t),
             (tp.transform(torch.from_numpy(pts)), jp.transform(pts)),
             (tp.as_matrix(), jp.as_matrix())]
    with pytest.raises(ValueError):
        ts.Poses.create(R[:, :2], t)
    xyxy = np.array([[1, 2, 5, 9], [-3, 4, 20, 30], [6, 6, 4, 3]],
                    np.float32)
    jb, tb = js.Boxes(xyxy=xyxy), ts.Boxes(xyxy=torch.from_numpy(xyxy))
    pairs += [(tb.centers, jb.centers), (tb.wh, jb.wh),
              (tb.area(), jb.area()), (tb.scaled(1.5).xyxy, jb.scaled(1.5).xyxy),
              (tb.clipped(16, 12).xyxy, jb.clipped(16, 12).xyxy)]
    scores = np.array([0.3, 0.9, 0.9], np.float32)
    cls = np.array([1, 2, 3], np.int32)
    valid = np.array([True, False, True])
    ji = js.Instances(boxes=jb, classes=cls, scores=scores, valid=valid)
    ti = ts.Instances(boxes=tb, classes=torch.from_numpy(cls),
                      scores=torch.from_numpy(scores),
                      valid=torch.from_numpy(valid))
    jk, tk = ji.topk(2), ti.topk(2)
    pairs += [(tk.boxes.xyxy, jk.boxes.xyxy), (tk.classes, jk.classes),
              (tk.scores, jk.scores), (tk.valid, jk.valid)]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


# -------------------------------------------------------------------- debug

def test_check_finite_tree_names_the_path():
    from self6dpp_tpu_torch.utils import debug
    tree = {"a": torch.ones(3), "b": [torch.zeros(2),
                                      {"c": torch.tensor([1.0, np.nan])}]}
    with pytest.raises(FloatingPointError, match=r"state at b/1/c: nan=1"):
        debug.check_finite_tree(tree, "state")
    debug.check_finite_tree({"a": torch.ones(3), "i": torch.arange(3)})
    net = torch.nn.Linear(2, 2)
    with torch.no_grad():
        net.bias[0] = np.inf
    with pytest.raises(FloatingPointError, match=r"net at bias: nan=0, inf=1"):
        debug.check_finite_tree(net, "net")
    debug.assert_trees_close({"x": torch.ones(2)}, {"x": torch.ones(2) + 1e-7})
    with pytest.raises(AssertionError):
        debug.assert_trees_close({"x": torch.ones(2)}, {"y": torch.ones(2)})
    with debug.nan_debugging() as check:
        assert torch.is_anomaly_enabled()
        with pytest.raises(FloatingPointError):
            check([torch.tensor([np.inf])], "out")
    assert not torch.is_anomaly_enabled()


def test_deterministic_restores_the_flags():
    from self6dpp_tpu_torch.utils import debug
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.backends.cudnn.deterministic,
              torch.backends.cudnn.benchmark,
              os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    torch.backends.cudnn.benchmark = True
    try:
        with debug.deterministic():
            assert torch.are_deterministic_algorithms_enabled()
            assert torch.backends.cudnn.deterministic
            assert not torch.backends.cudnn.benchmark
        assert torch.backends.cudnn.benchmark
        assert (torch.are_deterministic_algorithms_enabled(),
                torch.backends.cudnn.deterministic,
                os.environ.get("CUBLAS_WORKSPACE_CONFIG")) == (
            before[0], before[1], before[3])
    finally:
        torch.backends.cudnn.benchmark = before[2]


# ---------------------------------------------------------------- profiling

def test_cpu_trace_and_step_timer(tmp_path):
    from self6dpp_tpu_torch.utils import profiling
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path / "trace")) as prof:
        with profiling.span("matmul_block"):
            x @ x
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    with open(tmp_path / "trace" / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "matmul_block" for e in events)
    assert any("matmul_block" == k.key for k in prof.key_averages())


# ---------------------------------------------------------------------- vis

def test_committed_vis_fixture_is_cv2s():
    want = make_vis_fixture()
    got = np.load(FIXTURE)
    assert sorted(got.files) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    assert os.path.getsize(FIXTURE) < 20_000


def test_vis_matches_cv2():
    from self6dpp_tpu.utils import vis as jv
    from self6dpp_tpu_torch.utils import vis as tv
    rng = np.random.default_rng(0)
    img = rng.random((48, 64, 3)).astype(np.float32)
    assert np.array_equal(tv.to_uint8(img), jv.to_uint8(img))
    ims = [img, rng.random((20, 30)).astype(np.float32),
           (rng.random((33, 41, 3)) * 255).astype(np.uint8)]
    assert np.array_equal(tv.grid_show(ims, ncol=2), jv.grid_show(ims, ncol=2))
    x = rng.standard_normal((24, 32)).astype(np.float32)
    assert np.array_equal(tv.heatmap(x), jv.heatmap(x))
    flow = rng.standard_normal((24, 70, 2)).astype(np.float32) * 3
    for mm in (None, 2.0):
        assert np.array_equal(tv.flow_to_rgb(flow, mm), jv.flow_to_rgb(flow, mm))
    chars = [chr(i) for i in range(32, 127)]
    for i in range(40):
        x1, y1 = (int(v) for v in rng.integers(-6, 60, 2))
        x2, y2 = x1 + int(rng.integers(0, 40)), y1 + int(rng.integers(0, 40))
        text = "".join(rng.choice(chars, int(rng.integers(0, 12))))
        color = tuple(int(v) for v in rng.integers(0, 256, 3))
        im = img if i % 2 else rng.random((48, 64)).astype(np.float32)
        assert np.array_equal(tv.draw_bbox(im, (x1, y1, x2, y2), color, text),
                              jv.draw_bbox(im, (x1, y1, x2, y2), color, text)), i


def test_pose_axes_match_cv2_inside_the_image():
    """Axes whose ends fall inside the image, pixel for pixel (OpenCV
    clips a line that leaves the image before walking it)."""
    from scipy.spatial.transform import Rotation
    from self6dpp_tpu.utils import vis as jv
    from self6dpp_tpu_torch.utils import vis as tv
    rng = np.random.default_rng(1)
    img = rng.random((96, 128, 3)).astype(np.float32)
    K = np.array([[150.0, 0, 64], [0, 150.0, 48], [0, 0, 1]])
    n = 0
    for s in range(60):
        R = Rotation.random(random_state=s).as_matrix()
        t = np.array([*rng.uniform(-0.05, 0.05, 2), rng.uniform(0.3, 0.6)])
        cam = np.float32([[0, 0, 0], [0.05, 0, 0], [0, 0.05, 0],
                          [0, 0, 0.05]]) @ R.T + t
        uv = cam @ K.T
        uv = uv[:, :2] / uv[:, 2:3]
        if not ((uv >= 2).all() and (uv[:, 0] < 126).all()
                and (uv[:, 1] < 94).all()):
            continue
        n += 1
        assert np.array_equal(tv.draw_pose_axes(img, K, R, t),
                              jv.draw_pose_axes(img, K, R, t)), s
    assert n >= 20


if __name__ == "__main__":
    write_vis_fixture(sys.argv[1] if len(sys.argv) > 1 else FIXTURE)
