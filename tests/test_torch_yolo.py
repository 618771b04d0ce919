"""The port's YOLOv4 (self6dpp_tpu_torch/models/yolo.py) against the JAX
package's on the CPU at width 0.125, depth 0.33, 3 classes, input 128,
batch 2, on the JAX init converted by convert.yolo_flax_to_state_dict.

Tolerances:
  * the eval-mode forward in float32, the heads at 1e-5;
  * the train-mode forward (batch statistics) and the running statistics
    after it at 1e-5, both packages in float64 (jax.enable_x64): in
    float32 a randomly initialised net with batch statistics of 2 images
    is ill-conditioned, each package's heads sit ~1e-4 from the float64
    forward (measured: 1.1-1.5e-4 on heads of magnitude 2.6-5.1), so the
    float32 train forward is held at 1e-3;
  * decode_predictions, bbox_ciou and yolo_loss with its gradient with
    respect to the heads, float32, at 1e-5, on targets that share a cell
    and an anchor (the objectness scatter-max), whose neighbour cells fall
    off the grid, and with one class (no class loss);
  * the NMS equal on the same predictions;
  * one Ranger step of the JAX CLI's train step: parameters and running
    statistics at 1e-4;
  * sgd_gc, adamp and sgdp on one weight of each YOLOv4 kind, laid out by
    convert.param_kinds: 2 steps at 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as Fnn

from self6dpp_tpu.engine.optim import build_optimizer as jbuild_optimizer
from self6dpp_tpu.engine.train_state import create_train_state as jcreate
from self6dpp_tpu.models import yolo as JY
from self6dpp_tpu_torch import convert
from self6dpp_tpu_torch.config import SolverConfig
from self6dpp_tpu_torch.engine.optim import build_optimizer
from self6dpp_tpu_torch.engine.train_state import create_train_state
from self6dpp_tpu_torch.models import yolo as TY
from self6dpp_tpu_torch.tools.train_yolov4 import make_train_step

S = 128
KW = dict(num_classes=3, input_size=S, width_multiple=0.125,
          depth_multiple=0.33)
TOL = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def nets():
    """(JAX model, its init as numpy, the port model on that init, x)."""
    jm = JY.YOLOv4(cfg=JY.YoloConfig(**KW))
    x = np.random.default_rng(0).random((2, S, S, 3), np.float32)
    v = jax.tree.map(np.asarray,
                     jax.jit(jm.init)(jax.random.PRNGKey(0), x))
    tm = TY.YOLOv4(TY.YoloConfig(**KW))
    tm.load_state_dict(convert.yolo_flax_to_state_dict(v, tm))
    return jm, v, tm, x


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def test_converter_round_trip_and_kinds(nets):
    jm, v, tm, _ = nets
    back = convert._flatten(convert.yolo_state_dict_to_flax(tm))
    ref = convert._flatten(v)
    assert set(back) == set(ref)
    assert all(np.array_equal(back[k], ref[k]) for k in ref)
    kinds = convert.param_kinds(tm)
    assert len(kinds) == len(list(tm.parameters()))
    assert set(kinds.values()) == {"conv", "bn"}


def test_forward_eval_matches_jax(nets):
    jm, v, tm, x = nets
    # running statistics of a train pass, so that eval normalises for real
    _, mut = jax.jit(lambda v, x: jm.apply(v, x, train=True,
                                           mutable=["batch_stats"]))(v, x)
    v2 = {"params": v["params"],
          "batch_stats": jax.tree.map(np.asarray, mut["batch_stats"])}
    tm.load_state_dict(convert.yolo_flax_to_state_dict(v2, tm))
    jo = jax.jit(lambda v, x: jm.apply(v, x))(v2, x)
    with torch.no_grad():
        to = tm.eval()(nchw(x))
    for a, b in zip(jo, to):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=TOL)
    tm.load_state_dict(convert.yolo_flax_to_state_dict(v, tm))


def test_forward_train_and_batch_stats_match_jax(nets):
    jm, v, tm, x = nets
    x64 = x.astype(np.float64)
    with jax.enable_x64(True):
        jm64 = JY.YOLOv4(cfg=JY.YoloConfig(**KW), dtype=jnp.float64)
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), v)
        jo, mut = jax.jit(lambda v, x: jm64.apply(
            v, x, train=True, mutable=["batch_stats"]))(v64, x64)
        jo = [np.asarray(a) for a in jo]
        stats = jax.tree.map(np.asarray, mut["batch_stats"])
    t64 = TY.YOLOv4(TY.YoloConfig(**KW))
    t64.load_state_dict(convert.yolo_flax_to_state_dict(v, t64))
    t64.double().train()
    to = t64(nchw(x64))
    for a, b in zip(jo, to):
        np.testing.assert_allclose(b.detach().numpy(), a, rtol=0, atol=TOL)
    got = convert._flatten(convert.yolo_state_dict_to_flax(
        t64, {k: t.double() if t.is_floating_point() else t
              for k, t in t64.state_dict().items()}))
    want = convert._flatten({"batch_stats": stats})
    for k, a in want.items():
        np.testing.assert_allclose(got[k], a, rtol=0, atol=TOL, err_msg=k)
    # float32: within the conditioning of batch statistics of 2 images
    jo32 = jax.jit(lambda v, x: jm.apply(v, x, train=True,
                                         mutable=["batch_stats"])[0])(v, x)
    to32 = tm.train()(nchw(x))
    tm.load_state_dict(convert.yolo_flax_to_state_dict(v, tm))
    for a, b in zip(jo32, to32):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   rtol=0, atol=1e-3)


def test_flax_same_padding_is_asymmetric_at_stride_2():
    """A stride-2 3x3 'SAME' conv on an even map pads (0, 1): same_pad
    matches Flax, torch's symmetric padding=1 does not."""
    import flax.linen as nn
    x = np.random.default_rng(1).standard_normal((1, 8, 8, 4)).astype(
        np.float32)
    conv = nn.Conv(5, (3, 3), strides=(2, 2), padding="SAME", use_bias=False)
    p = conv.init(jax.random.PRNGKey(0), x)
    want = np.asarray(conv.apply(p, x))
    k = np.asarray(p["params"]["kernel"])
    w = torch.from_numpy(k.transpose(3, 2, 0, 1).copy())
    assert TY.same_pad(8, 3, 2) == (0, 1) and TY.same_pad(8, 3, 1) == (1, 1)
    t = nchw(x)
    flax_pad = Fnn.conv2d(Fnn.pad(t, (0, 1, 0, 1)), w, stride=2)
    symmetric = Fnn.conv2d(t, w, stride=2, padding=1)
    got = flax_pad.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert np.abs(symmetric.permute(0, 2, 3, 1).numpy() - want).max() > 0.1


def _heads(rng, nc, b=2):
    no = 5 + nc
    return [rng.standard_normal((b, S // s, S // s, 3, no)).astype(np.float32)
            for s in (8, 16, 32)]


def _targets(nc):
    """[cls, cx, cy, w, h] px: two boxes on one cell and anchor, boxes whose
    neighbour cells fall off the grid on each side, a padded row."""
    t = np.array([
        [[0, 20.0, 21.0, 14.0, 17.0], [1 % nc, 21.0, 22.0, 13.0, 18.0],
         [2 % nc, 2.0, 3.0, 40.0, 30.0], [0, 126.0, 125.0, 60.0, 90.0],
         [1 % nc, 64.0, 64.0, 150.0, 140.0], [0, 0.0, 0.0, 0.0, 0.0]],
        [[1 % nc, 3.5, 100.0, 20.0, 35.0], [0, 90.0, 1.0, 80.0, 50.0],
         [2 % nc, 70.0, 60.0, 200.0, 160.0], [0, 60.0, 66.0, 30.0, 30.0],
         [0, 61.0, 67.0, 31.0, 29.0], [0, 0.0, 0.0, 0.0, 0.0]]],
        np.float32)
    valid = np.ones(t.shape[:2], bool)
    valid[:, -1] = False
    return t, valid


@pytest.mark.parametrize("nc", [3, 1])
def test_decode_ciou_and_loss_match_jax(nc):
    rng = np.random.default_rng(nc)
    heads = _heads(rng, nc)
    tg, tv = _targets(nc)
    jcfg, tcfg = JY.YoloConfig(**{**KW, "num_classes": nc}), \
        TY.YoloConfig(**{**KW, "num_classes": nc})

    np.testing.assert_allclose(
        TY.decode_predictions([torch.from_numpy(h) for h in heads],
                              tcfg).numpy(),
        np.asarray(jax.jit(lambda o: JY.decode_predictions(o, jcfg))(heads)),
        rtol=TOL, atol=TOL)

    b1 = rng.uniform(1, 60, (50, 4)).astype(np.float32)
    b2 = rng.uniform(1, 60, (50, 4)).astype(np.float32)
    np.testing.assert_allclose(
        TY.bbox_ciou(torch.from_numpy(b1), torch.from_numpy(b2)).numpy(),
        np.asarray(JY.bbox_ciou(b1, b2)), rtol=0, atol=TOL)

    def jloss(o):
        ld = JY.yolo_loss(o, tg, tv, jcfg)
        return sum(jax.tree.leaves(ld)), ld
    (jtotal, jld), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(heads)
    th = [torch.from_numpy(h).requires_grad_() for h in heads]
    tld = TY.yolo_loss(th, torch.from_numpy(tg), torch.from_numpy(tv), tcfg)
    total = sum(tld[k] for k in sorted(tld))
    total.backward()
    for k in ("loss_box", "loss_obj", "loss_cls"):
        np.testing.assert_allclose(float(tld[k].detach()), float(jld[k]),
                                   rtol=TOL, atol=TOL, err_msg=k)
    assert (float(tld["loss_cls"].detach()) == 0.0) == (nc == 1)
    np.testing.assert_allclose(float(total.detach()), float(jtotal),
                               rtol=TOL)
    for a, b in zip(jg, th):
        np.testing.assert_allclose(b.grad.numpy(), np.asarray(a), rtol=0,
                                   atol=TOL)


def test_nms_matches_jax():
    rng = np.random.default_rng(5)
    pred = np.concatenate([
        rng.uniform(0, S, (2, 300, 2)), rng.uniform(4, 60, (2, 300, 2)),
        rng.uniform(0, 1, (2, 300, 1 + 3))], -1).astype(np.float32)
    pred[:, 100:150] = pred[:, 50:100]                 # duplicates: ties
    pred[1, :, 4] = 1e-4                               # nothing passes
    for a, b in zip(JY.non_max_suppression(pred, 0.001, 0.65),
                    TY.non_max_suppression(pred, 0.001, 0.65)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_ranger_step_matches_jax(nets):
    """One step of the JAX CLI's train step (forward in train mode,
    yolo_loss, Ranger at a constant 1e-3 with clip 35) against the port's
    make_train_step, from the same init and batch."""
    jm, v, _, x = nets
    tg, tv = _targets(3)
    scfg = SolverConfig(base_lr=1e-3, lr_sched="constant")
    jcfg = JY.YoloConfig(**KW)
    tx, _ = jbuild_optimizer(scfg)
    state = jcreate(v["params"], v["batch_stats"], tx, with_ema=False)

    def train_step(state, x, tg, tv):
        def loss_fn(params):
            outs, mut = jm.apply({"params": params,
                                  "batch_stats": state.batch_stats}, x,
                                 train=True, mutable=["batch_stats"])
            ld = JY.yolo_loss(outs, tg, tv, jcfg)
            return sum(jax.tree.leaves(ld)), (ld, mut["batch_stats"])
        (total, (ld, bs)), g = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params)
        return state.apply_gradients(g).replace(batch_stats=bs), total
    jstate, jtotal = jax.jit(train_step)(state, x, tg, tv)

    tm = TY.YOLOv4(TY.YoloConfig(**KW))
    tm.load_state_dict(convert.yolo_flax_to_state_dict(v, tm))
    opt = build_optimizer(scfg, tm.parameters(),
                          kinds=list(convert.param_kinds(tm).values()))
    st = create_train_state(tm, opt, with_ema=False)
    st, metrics = make_train_step(TY.YoloConfig(**KW))(
        st, (nchw(x), torch.from_numpy(tg), torch.from_numpy(tv)))
    assert st.step == 1 and set(metrics) == {"loss_box", "loss_obj",
                                             "loss_cls", "total_loss"}
    np.testing.assert_allclose(float(metrics["total_loss"]), float(jtotal),
                               rtol=1e-4)
    got = convert._flatten(convert.yolo_state_dict_to_flax(tm))
    want = convert._flatten({"params": jstate.params,
                             "batch_stats": jstate.batch_stats})
    moved = 0.0
    for k, a in want.items():
        a = np.asarray(a)
        np.testing.assert_allclose(got[k], a, rtol=0, atol=1e-4, err_msg=k)
        if k.startswith("params"):
            moved = max(moved, float(np.abs(a - convert._flatten(v)[k]).max()))
    assert moved > 5e-4          # the step moved the weights


# one weight of each kind and shape in YOLOv4: a 3x3 and a 1x1 conv, a
# head conv with its bias, a batch norm's scale and bias
LAYOUT_PARAMS = ("stem.conv.weight", "csp1.cv3.weight", "heads.0.weight",
                 "heads.0.bias", "stem.bn.weight", "stem.bn.bias")


@pytest.mark.parametrize("name", ["sgd_gc", "adamp", "sgdp"])
def test_layout_optimizers_on_yolo_match_jax(nets, name):
    """sgd_gc, adamp and sgdp over 2 steps on YOLOv4 weights with the kinds
    of convert.param_kinds, against JAX's on the same weights and
    gradients in its layout: their centralisation and projection reduce
    over the axes of the JAX layout (rtol 1e-5, atol 1e-6)."""
    import optax
    from self6dpp_tpu.config.base import SolverConfig as JSolverConfig
    _, v, tm, _ = nets
    cfg = dict(lr_sched="constant", base_lr=1e-2, optimizer=name)
    key_map, kinds = convert.yolo_key_map(tm), convert.param_kinds(tm)
    flat = convert._flatten(v)
    jp = {n: jnp.asarray(flat[convert._flax_key(n, key_map)[1]])
          for n in LAYOUT_PARAMS}
    to_torch = lambda n, a: torch.from_numpy(np.array(
        convert._to_torch_layout(np.asarray(a), kinds[n], None)))
    params = [torch.nn.Parameter(to_torch(n, jp[n])) for n in LAYOUT_PARAMS]
    opt = build_optimizer(SolverConfig(**cfg), params,
                          kinds=[kinds[n] for n in LAYOUT_PARAMS])
    tx, _ = jbuild_optimizer(JSolverConfig(**cfg))
    jstate = tx.init(jp)
    rng = np.random.default_rng(7)
    for _ in range(2):
        g = {n: (0.5 * rng.standard_normal(a.shape)).astype(np.float32)
             for n, a in jp.items()}
        upd, jstate = tx.update(g, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for n, p in zip(LAYOUT_PARAMS, params):
            p.grad = to_torch(n, g[n])
        opt.step()
    for n, p in zip(LAYOUT_PARAMS, params):
        want = to_torch(n, jp[n]).numpy()
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-5,
                                   atol=1e-6, err_msg=n)
        assert np.abs(want - to_torch(n, flat[convert._flax_key(
            n, key_map)[1]]).numpy()).max() > 1e-3, n
