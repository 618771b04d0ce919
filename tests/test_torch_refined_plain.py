"""The port's stage-II pose step with the DeepIM refiner in the loop
(engine/self_engine.py::build_self_train_step with a refiner) against the
benchmark's plain reference of it (portbench/reference/refined.py), in
float32 on the CPU, over two steps from one state: stage2_pose_tiny's
GDR-Net with LPIPS, a FlowNetS of micro widths with 6 input channels at a
32² zoom, 2 iterations; weights, batch and teacher offset drawn from one
seed by portbench/inputs.py for both sides. The reference refines in
blocks of 1 ROI of the batch's 2. Also: the refined step's marks and
recorded spans hold the refiner's phases inside the step, and the
reference module loads nothing of the port or of JAX. Imports no JAX."""

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import inputs
from portbench.reference import config as rc
from portbench.reference import refined as ref_refined
from portbench.reference import steps as ref_steps
from portbench.reference.models.deepim import DeepIM as RefDeepIM
from self6dpp_tpu_torch import config as C
from self6dpp_tpu_torch.engine import gdrn_engine as ge
from self6dpp_tpu_torch.engine import self_engine as se
from self6dpp_tpu_torch.models.deepim import DeepIM
from self6dpp_tpu_torch.models.lpips import LPIPS
from self6dpp_tpu_torch.utils import profiling

SEED = 2_147_483_659
STEPS, ROIS, REFINE_BLOCK = 2, 2, 1
MICRO = (8, 12, 16, 16, 16, 24)
REFINER = dict(num_classes=2, input_h=32, input_w=32, in_channels=6,
               n_iter_test=2, with_flow=False, flow_lw=0.0,
               with_mask_head=False)
OVERRIDES = ["self_sup.refine_with_deepim=True"]
DEV = torch.device("cpu")
POSE_TOL = 5e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def refiner_std(name, m):
    """inputs.deepim_std at twice the gain: at unit gain this micro
    FlowNetS's pooled features, and so the poses it refines, hardly move
    (rotation by 5e-5 in 2 iterations)."""
    return 2.0 * inputs.deepim_std(name, m)


def draw(seed_stream, model, std_of):
    inputs.draw_weights_(model, inputs.generator(SEED, seed_stream, DEV),
                         std_of)


def start_(state, teacher_params):
    """The state as the benchmark's test-size stage-II cells start it: the
    teacher 0.1 leaf-RMS apart from the student, the solver past its first
    updates."""
    inputs.offset_teacher_(teacher_params, inputs.generator(SEED, 4, DEV),
                           0.1)
    state.step, state.opt.count = 8000, 10


def port_run(pool):
    cfg = C.apply_overrides(C.stage2_pose_tiny(), OVERRIDES)
    model = ge.build_gdrn(cfg, device=DEV)
    draw(0, model, inputs.gdrn_std)
    inputs.aim_gdrn_(model, pool[0])
    lpips = LPIPS().eval().requires_grad_(False)
    inputs.lpips_weights_(lpips, inputs.generator(SEED, 2, DEV))
    rcfg = C.Config(deepim=C.DeepIMConfig(**REFINER), renderer=cfg.renderer,
                    dist=C.DistConfig(compute_dtype="float32"))
    refiner = DeepIM(rcfg.deepim, widths=MICRO).eval()
    draw(5, refiner, refiner_std)
    refiner.init_identity_heads_()
    state = ge.init_state(cfg, model)
    start_(state, state.teacher_params())
    step = se.build_self_train_step(cfg, model, lpips=lpips,
                                    refiner=(refiner, rcfg))
    out = {"metrics": [], "pseudo": [], "marks": []}
    with torch.no_grad():
        tout = state.teacher(*ge.model_inputs(pool[0]))
        out["teacher_pose"] = tout["rot"], tout["trans"]
    for i in range(STEPS):
        pseudo, marks = {}, []
        with profiling.recording() as rec:
            state, m = step(state, pool[i], lambda n: marks.append(n),
                            pseudo_out=pseudo)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["pseudo"].append(pseudo)
        out["marks"].append(marks)
        if i == 0:
            out["spans"] = rec.spans
    out["params"] = [p.detach().clone() for p in state.model.parameters()]
    out["teacher"] = [p.detach().clone() for p in state.teacher_params()]
    return out


def reference_run(pool):
    cfg = ref_steps.float32_config(rc.apply_overrides(rc.stage2_pose_tiny(),
                                                      OVERRIDES))
    model = ref_steps.build_gdrn(cfg, DEV)
    draw(0, model, inputs.gdrn_std)
    inputs.aim_gdrn_(model, pool[0])
    lpips = ref_steps.build_lpips(DEV)
    inputs.lpips_weights_(lpips, inputs.generator(SEED, 2, DEV))
    rcfg = rc.Config(deepim=rc.DeepIMConfig(**REFINER), renderer=cfg.renderer,
                     dist=rc.DistConfig(compute_dtype="float32"))
    refiner = RefDeepIM(rcfg.deepim, widths=MICRO).eval()
    draw(5, refiner, refiner_std)
    refiner.init_identity_heads_()
    state = ref_steps.build_state(cfg, model)
    start_(state, list(state.teacher.parameters()))
    step = ref_refined.make_refined_train_step(
        cfg, lpips, refiner, rcfg, block=2, refine_block=REFINE_BLOCK)
    out = {"metrics": [], "pseudo": []}
    with ref_steps.plain_float32():
        for i in range(STEPS):
            pseudo = {}
            m = step(state, pool[i], pseudo_out=pseudo)
            out["metrics"].append({k: float(v) for k, v in m.items()})
            out["pseudo"].append(pseudo)
    out["params"] = [p.detach().clone() for p in model.parameters()]
    out["teacher"] = [p.detach().clone() for p in state.teacher.parameters()]
    return out


@pytest.fixture(scope="module")
def runs():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = C.stage2_pose_tiny()
        m = cfg.model
        g = inputs.generator(SEED, 1, DEV)
        meshes = inputs.class_meshes({"subdivisions": 1, "radius": 0.06,
                                      "colors": "position"},
                                     m.num_classes, g, DEV)
        sizes = dict(input_res=m.input_res, output_res=m.output_res,
                     num_classes=m.num_classes,
                     num_regions=m.geo_head.num_regions)
        pool = [inputs.gdrn_batch(sizes, ROIS, meshes, g, DEV,
                                  n_points=cfg.data.model_points,
                                  max_sym=cfg.data.max_sym_rots)
                for _ in range(STEPS)]
        return port_run(pool), reference_run(pool)
    finally:
        torch.set_num_threads(threads)


def test_refined_pseudo_pose_matches_reference(runs):
    """Both sides refine the same teacher pose through the same plain
    renders and float32 network. The reference's blocks of 1 ROI
    take other convolution paths than the port's batch of 2, and 2
    iterations carry that rounding on: up to 8.6e-6 read on the poses'
    elements, so 5e-5 (the refine moves them by 0.93, below)."""
    port, ref = runs
    for p, r in zip(port["pseudo"], ref["pseudo"]):
        assert p["rot"].shape == (ROIS, 3, 3)
        torch.testing.assert_close(p["rot"], r["rot"], rtol=0, atol=POSE_TOL)
        torch.testing.assert_close(p["trans"], r["trans"], rtol=0,
                                   atol=POSE_TOL)


def test_refiner_moves_the_pseudo_pose(runs):
    """The pose the step hands back is the refined one: it lies from the
    teacher's own by over a hundred times the tolerance above."""
    port, _ = runs
    rot, trans = port["teacher_pose"]
    moved = max(float((port["pseudo"][0]["rot"] - rot).abs().max()),
                float((port["pseudo"][0]["trans"] - trans).abs().max()))
    assert moved > 100 * POSE_TOL, moved


def test_refined_step_losses_match_reference(runs):
    """Every loss term of both steps, at 5e-4 relative: the pseudo-PM and
    translation terms read the refined pose and carry its gap (7.2e-5
    read, loss_PM_z of the second step); the LAB term is kernel B3's plain
    twin against autograd of lab_loss, the same float32 function in
    another order."""
    port, ref = runs
    for pm, rm in zip(port["metrics"], ref["metrics"]):
        assert set(pm) == set(rm)
        for k in rm:
            assert pm[k] == pytest.approx(rm[k], rel=5e-4, abs=1e-7), k


@pytest.mark.parametrize("which", ["params", "teacher"])
def test_refined_step_params_match_reference(runs, which):
    """The student's parameters and the EMA teacher after two steps, each
    element to 1e-5: Ranger moves an element by about its learning rate
    (1e-3) a step, and the two sides' parameters differ by 5e-8 (read)."""
    port, ref = runs
    for p, r in zip(port[which], ref[which], strict=True):
        torch.testing.assert_close(p, r, rtol=1e-5, atol=1e-5)


def test_refiner_phases_are_marks_and_spans_of_the_step(runs):
    port, _ = runs
    want = (["student_fwd", "teacher_fwd"] + ["render", "network_fwd"] * 2
            + ["refine", "render_fwd", "losses", "backward", "optimizer_ema"])
    assert port["marks"] == [want] * STEPS
    spans = port["spans"]
    roots = [s for s in spans if s.parent < 0]
    assert [s.name for s in roots] == ["train_step"]
    names = lambda n: [s for s in spans if s.name == n]
    (refine,) = names("refine")
    assert spans[refine.parent].name == "train_step"
    for n in ("render", "network_fwd"):
        got = names(n)
        assert len(got) == REFINER["n_iter_test"]
        assert all(s.step == 0 and spans[s.parent] is refine for s in got)


def test_reference_module_loads_no_port_and_no_jax():
    code = ("import json, sys; import portbench.reference.refined; "
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "portbench" in top
    assert not top & {"jax", "jaxlib", "flax", "self6dpp_tpu",
                      "self6dpp_tpu_torch"}
