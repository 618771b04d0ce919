"""Traffic kind gdrn_refined: gdrn_train's stage-II pose steps with
Self6D++'s DeepIM refiner in the loop, built as tools/train_self6dpp.py
builds them: engine/self_engine.py::build_self_train_step with the
refiner of tools/train_self6dpp.py::build_refiner_of, under the recipe's
self_sup.refine_with_deepim and self_sup.refiner_config. Each step's
teacher pseudo pose is refined by the refiner's n_iter_test iterations of
render, zoom and network before the labels read it; the step's marks hold
the refiner's render and network_fwd phases, once an iteration.

The configuration file's refiner.* sizes are held to the refiner's own
Config. The refiner's weights are drawn from the seed (inputs.deepim_std,
identity pose heads, as kind deepim_refine draws them) on a stream of this
kind's own. What decides `correct`: gdrn_train's training numbers, and the
refined pseudo pose of the first checked step, which the step hands back
(pseudo_out), against the reference's (reference/refined.py) by
compare.pose_numbers: pseudo_rot_gap_deg, pseudo_center_gap_px (pixels of
the ROI frame the refiner sees, by roi_zoom_K) and the rest as readings.
Faults: gdrn_train's, and the refiner built with 3 of its iterations
(refine_iters_3)."""

from __future__ import annotations

import dataclasses
import inspect
import math
from contextlib import nullcontext

import torch

from portbench import compare, inputs
from portbench.cells import Clock, check_sizes, reference_config
from portbench.harness import HERE
from portbench.kinds.gdrn_train import GdrnTrain
from portbench.reference import refined as ref_refined
from portbench.reference import steps as ref_steps

REFINER_W = 5           # generator stream of the refiner's weights
PREFIX = "refiner."     # the configuration file's keys of the refiner


def refine_iters_3(step):
    """The refinement fault: the program's refiner built with 3 of its 4
    iterations. It acts where the step is built (GdrnRefined.setup reads
    `refine_iters` off the wrapper it is handed); the step passes
    through."""
    return step


refine_iters_3.refine_iters = 3


def pseudo_numbers(own: dict, ref: dict) -> dict[str, float]:
    """compare.pose_numbers of two refined pseudo poses (dicts of rot,
    trans and the cameras K), each number prefixed pseudo_; infinite
    where the runs refined different numbers of ROIs."""
    if own["rot"].shape != ref["rot"].shape:
        return {"pseudo_rot_gap_deg": math.inf,
                "pseudo_center_gap_px": math.inf}
    got = compare.pose_numbers([(own["rot"], own["trans"])],
                               [(ref["rot"], ref["trans"])], [ref["K"]])
    return {"pseudo_" + k: v for k, v in got.items()}


class GdrnRefined(GdrnTrain):
    """Stage-II steps with the DeepIM refiner in the loop (traffic kind
    gdrn_refined)."""

    faults = GdrnTrain.faults + (("refine_iters_3", refine_iters_3),)

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 base: str = HERE):
        sizes = config["sizes"]
        own = {k: v for k, v in sizes.items() if not k.startswith(PREFIX)}
        super().__init__(dict(config, sizes=own), traffic, seed, device,
                         base)
        self.refiner_sizes = {k[len(PREFIX):]: v for k, v in sizes.items()
                              if k.startswith(PREFIX)}
        if self.stage != 2 or not self.cfg.self_sup.refine_with_deepim:
            raise ValueError("gdrn_refined runs stage II with "
                             "self_sup.refine_with_deepim")
        self.mark_names: list[str] | None = None

    def _refiner_weights_(self, model) -> None:
        inputs.draw_weights_(model, inputs.generator(self.seed, REFINER_W,
                                                     self.device),
                             inputs.deepim_std)
        model.init_identity_heads_()

    def setup(self, step_wrapper=None) -> None:
        """Build the state and the refiner, take the first steps (checked
        later; the first hands back its refined pseudo pose)."""
        from self6dpp_tpu_torch.engine import gdrn_engine as ge
        from self6dpp_tpu_torch.engine import self_engine as se
        from self6dpp_tpu_torch.models.lpips import LPIPS
        from self6dpp_tpu_torch.tools.train_self6dpp import build_refiner_of
        cfg, dev = self.cfg, self.device
        clock = Clock(dev)
        self.pool = self._batches()
        clock("inputs")
        with torch.device(dev):
            model = ge.build_gdrn(cfg, device=dev)
            lpips = LPIPS().eval().requires_grad_(False)
        self._weights_(model, lpips)
        self.state = ge.init_state(cfg, model)
        self._start_(self.state, self.state.teacher_params())
        dmodel, rcfg = build_refiner_of(cfg, dev)
        check_sizes(rcfg, self.refiner_sizes)
        self._refiner_weights_(dmodel)
        iters = getattr(step_wrapper, "refine_iters", None)
        if iters:
            rcfg = dataclasses.replace(rcfg, deepim=dataclasses.replace(
                rcfg.deepim, n_iter_test=iters))
        step = se.build_self_train_step(cfg, model, lpips=lpips,
                                        refiner=(dmodel, rcfg))
        if "pseudo_out" not in inspect.signature(step).parameters:
            raise RuntimeError("this program's stage-II step does not hand "
                               "back the pseudo pose it refined (pseudo_out)")
        self.step_fn = step_wrapper(step) if step_wrapper else step
        clock("build")
        st = self.state
        rec = compare.StepReadings(st.params(), st.teacher_params())
        pseudo: dict = {}
        for i in range(self.traffic["check_steps"]):
            self.state, metrics = self.step_fn(
                self.state, self.pool[i], pseudo_out=pseudo if i == 0
                else None)
            rec.after_step(self.state.opt, metrics)
        self.readings = rec.finish()
        self.readings["pseudo"] = self._pseudo(pseudo)
        self.n_issued = self.traffic["check_steps"]
        clock("checked_steps")
        self.setup_parts = clock.parts

    def _pseudo(self, pseudo: dict) -> dict:
        """A refined pseudo pose on the host, with the cameras it was
        refined in (the first batch's roi_zoom_K)."""
        return {"rot": pseudo["rot"].detach().cpu(),
                "trans": pseudo["trans"].detach().cpu(),
                "K": self.pool[0]["roi_zoom_K"].cpu()}

    def run(self, seconds: float, phases=None,
            max_steps: int | None = None) -> dict:
        """gdrn_train's window; with phases, keeps one step's mark names in
        order (mark_names: the refiner's repeat once an iteration)."""
        res = super().run(seconds, phases, max_steps)
        if phases is not None and phases.steps:
            self.mark_names = [n for n, _ in phases.steps[-1][1:]]
        return res

    # -- reference ---------------------------------------------------------
    def _reference_parts(self, control: bool = False):
        rcfg = reference_config(self.traffic["recipe"], self.overrides,
                                self.base)
        check_sizes(rcfg, {k: v for k, v in self.config["sizes"].items()
                           if k != "dist.compute_dtype"})
        dcfg = reference_config(self.traffic["refiner_recipe"], [],
                                self.base)
        check_sizes(dcfg, {k: v for k, v in self.refiner_sizes.items()
                           if k != "dist.compute_dtype"})
        dev = self.device
        model = ref_steps.build_gdrn(rcfg, dev)
        lpips = ref_steps.build_lpips(dev)
        self._weights_(model, lpips)
        refiner = ref_steps.build_deepim(
            dcfg, dev, torch.bfloat16 if control else torch.float32)
        self._refiner_weights_(refiner)
        state = ref_steps.build_state(rcfg, model)
        return rcfg, dcfg, model, lpips, refiner, state

    def reference(self, control: bool = False) -> dict:
        """The reference's readings of the same three steps from the same
        weights and batches, with the first step's refined pseudo pose
        (control: the networks in bfloat16 on float8 matrix products)."""
        rcfg, dcfg, model, lpips, refiner, state = \
            self._reference_parts(control)
        self._start_(state, list(state.teacher.parameters()))
        step = ref_refined.make_refined_train_step(
            rcfg, lpips, refiner, dcfg, block=self.traffic["render_block"],
            refine_block=self.traffic["refine_block"],
            low=torch.bfloat16 if control else None)
        rec = compare.StepReadings(list(model.parameters()),
                                   list(state.teacher.parameters()))
        pseudo: dict = {}
        ctx = ref_steps.fp8_matmuls() if control else nullcontext()
        with ref_steps.plain_float32(), ctx:
            for i in range(self.traffic["check_steps"]):
                rec.after_step(state.opt, step(
                    state, self.pool[i], pseudo_out=pseudo if i == 0
                    else None))
        out = rec.finish()
        out["pseudo"] = self._pseudo(pseudo)
        del state, model, lpips, refiner
        return out

    def gaps(self, ref: dict, own: dict | None = None) -> dict[str, float]:
        own = self.readings if own is None else own
        out = compare.train_numbers(own, ref)
        out.update(pseudo_numbers(own["pseudo"], ref["pseudo"]))
        return out

    def model_flops(self) -> float:
        """FLOPs of one step at this cell's batch: the reference's refined
        step (its networks forward and backward, the refiner's forwards)
        counted at two ROIs, per ROI times the batch."""
        from portbench import counts
        rcfg, dcfg, _, lpips, refiner, state = self._reference_parts()
        step = ref_refined.make_refined_train_step(
            rcfg, lpips, refiner, dcfg, checkpoint_backbone=False)
        two = inputs.take_rows(self.pool[0], slice(0, 2))
        return counts.model_flops(lambda: step(state, two)) / 2 * self.rois


DRIVER = GdrnRefined
