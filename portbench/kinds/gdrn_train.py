"""Traffic kind gdrn_train: GDR-Net training steps dispatched back to
back. Stage 2, the port's stage-II pose step (engine/self_engine.py::
build_self_train_step) with its EMA teacher, LPIPS and renderer; stage 1,
the stage-I step (engine/gdrn_engine.py::make_train_step). A pool of
distinct batches is cycled. Set-up takes the traffic's check_steps first
steps, whose readings the reference follows; the window's end-to-end
value is the ROIs it completed over its seconds. Faults: half of each
batch left out with the loss's mean over the rest, and the solver's
learning rate 1.3 times the configured one."""

from __future__ import annotations

import time
from contextlib import nullcontext

import torch

from portbench import compare, inputs
from portbench.cells import (DATA, LPIPS_W, TEACHER, WEIGHTS, Clock, Driver,
                             Phases, check_sizes, port_config,
                             reference_config, sync)
from portbench.harness import HERE
from portbench.reference import steps as ref_steps


def half_batch(step):
    """The training fault: each step sees the first half of its ROIs."""
    def broken(state, batch, mark=None, **kw):
        b = batch["roi_img"].shape[0]
        return step(state, inputs.take_rows(batch, slice(0, b // 2)), mark,
                    **kw)
    return broken


def wrong_lr(step, factor: float = 1.3):
    """A training fault in the solver: from the first step on, every
    update taken at `factor` times the configured learning rate."""
    def broken(state, batch, mark=None, **kw):
        if not getattr(state.opt, "_lr_fault", False):
            lr_fn = state.opt.lr_fn
            state.opt.lr_fn = lambda count: factor * lr_fn(count)
            state.opt._lr_fault = True
        return step(state, batch, mark, **kw)
    return broken


class GdrnTrain(Driver):
    """Training steps of GDR-Net (traffic kind gdrn_train)."""

    faults = (("half_batch", half_batch), ("lr_x1.3", wrong_lr))

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 base: str = HERE):
        self.config, self.traffic = config, traffic
        self.seed, self.device, self.base = seed, device, base
        self.stage = traffic["stage"]
        self.rois = traffic["rois"]
        self.overrides = list(traffic["overrides"])
        self.cfg = port_config(traffic["recipe"], self.overrides)
        check_sizes(self.cfg, config["sizes"])
        self.step_fn = None

    # -- program -----------------------------------------------------------
    def _batches(self) -> list[dict]:
        c, m = self.cfg, self.cfg.model
        g = inputs.generator(self.seed, DATA, self.device)
        meshes = inputs.class_meshes(self.config["meshes"], m.num_classes, g,
                                     self.device)
        sizes = dict(input_res=m.input_res, output_res=m.output_res,
                     num_classes=m.num_classes,
                     num_regions=m.geo_head.num_regions)
        return [inputs.gdrn_batch(sizes, self.rois, meshes, g, self.device,
                                  n_points=c.data.model_points,
                                  max_sym=c.data.max_sym_rots)
                for _ in range(self.traffic["pool"])]

    def _weights_(self, model, lpips=None) -> None:
        inputs.draw_weights_(model, inputs.generator(self.seed, WEIGHTS,
                                                     self.device),
                             inputs.gdrn_std)
        if self.stage == 2:
            inputs.aim_gdrn_(model, self.pool[0])
        if lpips is not None:
            inputs.lpips_weights_(lpips, inputs.generator(
                self.seed, LPIPS_W, self.device))

    def _start_(self, state, teacher_params) -> None:
        """The state as training finds it past the EMA ramp (traffic keys
        teacher_offset, step_count and solver_count): the teacher apart
        from the student, the step count (which sets the EMA decay) and
        the solver's count of updates (which sets the learning rate,
        RAdam's rectification and the Lookahead's syncs) advanced."""
        t = self.traffic
        if t.get("teacher_offset"):
            inputs.offset_teacher_(teacher_params, inputs.generator(
                self.seed, TEACHER, self.device), t["teacher_offset"])
        state.step = t.get("step_count", 0)
        state.opt.count = t.get("solver_count", 0)

    def setup(self, step_wrapper=None) -> None:
        """Build the state, take its first steps (checked later), warm up.
        step_wrapper(step) -> step lets a test break the timed path."""
        from self6dpp_tpu_torch.engine import gdrn_engine as ge
        from self6dpp_tpu_torch.engine import self_engine as se
        from self6dpp_tpu_torch.models.lpips import LPIPS
        cfg, dev = self.cfg, self.device
        clock = Clock(dev)
        self.pool = self._batches()
        clock("inputs")
        with torch.device(dev):
            model = ge.build_gdrn(cfg, device=dev)
            lpips = LPIPS().eval().requires_grad_(False) \
                if self.stage == 2 else None
        self._weights_(model, lpips)
        self.state = ge.init_state(cfg, model)
        self._start_(self.state, self.state.teacher_params())
        if self.stage == 2:
            step = se.build_self_train_step(cfg, model, lpips=lpips)
        else:
            step = ge.make_train_step(cfg, model)
        self.step_fn = step_wrapper(step) if step_wrapper else step
        clock("build")
        st = self.state
        stats = [b for n, b in st.model.named_buffers() if "running" in n] \
            if self.stage == 1 else None
        rec = compare.StepReadings(st.params(), st.teacher_params(), stats)
        for i in range(self.traffic["check_steps"]):
            self.state, metrics = self.step_fn(self.state, self.pool[i])
            rec.after_step(self.state.opt, metrics)
        self.readings = rec.finish()
        self.n_issued = self.traffic["check_steps"]
        clock("checked_steps")
        self.setup_parts = clock.parts

    def run(self, seconds: float, phases: Phases | None = None,
            max_steps: int | None = None) -> dict:
        """Issue steps back to back until `seconds` have passed on the
        host's clock (or max_steps), without synchronising; then wait for
        the card. Returns the ROIs completed and the seconds taken."""
        t0 = time.perf_counter()
        deadline, n, totals = t0 + seconds, 0, []
        while time.perf_counter() < deadline and (max_steps is None
                                                 or n < max_steps):
            batch = self.pool[self.n_issued % len(self.pool)]
            mark = phases.start() if phases is not None else None
            self.state, m = self.step_fn(self.state, batch, mark)
            totals.append(m["total_loss"])
            self.n_issued += 1
            n += 1
        sync(self.device)
        seconds = time.perf_counter() - t0
        failed = int((~torch.isfinite(torch.stack(totals))).sum()) \
            if totals else 0
        return {"steps": n, "work": n * self.rois, "seconds": seconds,
                "failed": failed}

    def end_to_end(self, res: dict) -> dict[str, float]:
        return {"train_rois_per_s": res["work"] / res["seconds"]}

    def free_program(self) -> None:
        self.state = self.step_fn = None

    # -- reference ---------------------------------------------------------
    def reference(self, control: bool = False) -> dict:
        """The reference's readings of the same three steps from the same
        weights and batches (control: the networks in bfloat16 on float8
        matrix products)."""
        rcfg = reference_config(self.traffic["recipe"], self.overrides,
                                self.base)
        check_sizes(rcfg, {k: v for k, v in self.config["sizes"].items()
                           if k != "dist.compute_dtype"})
        dev = self.device
        model = ref_steps.build_gdrn(rcfg, dev)
        lpips = ref_steps.build_lpips(dev) if self.stage == 2 else None
        self._weights_(model, lpips)
        state = ref_steps.build_state(rcfg, model)
        self._start_(state, list(state.teacher.parameters()))
        low = torch.bfloat16 if control else None
        if self.stage == 2:
            step = ref_steps.make_self_train_step(
                rcfg, lpips, block=self.traffic["render_block"], low=low)
        else:
            step = ref_steps.make_stage1_train_step(rcfg, low=low)
        stats = [b for n, b in model.named_buffers() if "running" in n] \
            if self.stage == 1 else None
        rec = compare.StepReadings(list(model.parameters()),
                                   list(state.teacher.parameters()), stats)
        ctx = ref_steps.fp8_matmuls() if control else nullcontext()
        with ref_steps.plain_float32(), ctx:
            for i in range(self.traffic["check_steps"]):
                rec.after_step(state.opt, step(state, self.pool[i]))
        out = rec.finish()
        del state, model, lpips
        return out

    def gaps(self, ref: dict, own: dict | None = None) -> dict[str, float]:
        return compare.train_numbers(self.readings if own is None else own,
                                     ref)

    def model_flops(self) -> float:
        """FLOPs of one step at this cell's batch: the reference step's
        (its networks forward and backward) counted at two ROIs, per ROI
        times the batch (each ROI's network work is its own)."""
        from portbench import counts
        rcfg = reference_config(self.traffic["recipe"], self.overrides,
                                self.base)
        model = ref_steps.build_gdrn(rcfg, self.device)
        lpips = ref_steps.build_lpips(self.device) if self.stage == 2 \
            else None
        self._weights_(model, lpips)
        state = ref_steps.build_state(rcfg, model)
        step = ref_steps.make_self_train_step(
            rcfg, lpips, checkpoint_backbone=False) if self.stage == 2 \
            else ref_steps.make_stage1_train_step(rcfg)
        two = inputs.take_rows(self.pool[0], slice(0, 2))
        return counts.model_flops(lambda: step(state, two)) / 2 * self.rois


DRIVER = GdrnTrain
