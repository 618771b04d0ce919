"""The general generator and drivers of the benchmark's cells. A traffic
file names its `kind`, and its parameters (batch, pool, overrides, noise,
limits) fill the driver of that kind:

  gdrn_train     GDR-Net training steps dispatched back to back: stage 2,
                 the port's stage-II pose step (engine/self_engine.py::
                 build_self_train_step) with its EMA teacher, LPIPS and
                 renderer; stage 1, the stage-I step (engine/gdrn_engine.py::
                 make_train_step). A pool of distinct batches is cycled.
  deepim_refine  a closed loop of one client: each request's ROIs refined by
                 engine/deepim_engine.py::make_eval_step, timed from its
                 submission to its poses on the host.

Each driver builds the program from the configuration and the seed
(set-up), checks its first steps or keeps its answers, runs the window,
frees the program and runs the reference (portbench/reference) on the same
inputs."""

from __future__ import annotations

import random
import time

import torch

from . import compare, inputs
from .reference import config as ref_config
from .reference import steps as ref_steps

WEIGHTS, DATA, LPIPS_W, TEACHER = 0, 1, 2, 4       # generator streams


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def port_config(name: str, overrides: list[str]):
    from self6dpp_tpu_torch import config as C
    return C.apply_overrides(getattr(C, name)(), list(overrides))


def reference_config(name: str, overrides: list[str]):
    cfg = ref_config.apply_overrides(getattr(ref_config, name)(),
                                     list(overrides))
    return ref_steps.float32_config(cfg)


def config_value(cfg, dotted: str):
    for part in dotted.split("."):
        cfg = getattr(cfg, part)
    return list(cfg) if isinstance(cfg, tuple) else cfg


def check_sizes(cfg, sizes: dict) -> None:
    """The configuration file's sizes are those of the config as run."""
    wrong = {k: (v, config_value(cfg, k)) for k, v in sizes.items()
             if config_value(cfg, k) != v}
    if wrong:
        raise ValueError(f"the configuration as run differs from its file: "
                         f"{wrong}")


class Clock:
    """Seconds of each part of set-up on the host's clock, each part ended
    by waiting for the device. Once the inputs are made, the device's peak
    memory restarts: it counts the program and its inputs, not the
    benchmark's making of them."""

    def __init__(self, device):
        self.device, self.parts = device, {}
        self.t = time.perf_counter()

    def __call__(self, name: str) -> None:
        sync(self.device)
        if name == "inputs" and self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        now = time.perf_counter()
        self.parts[name] = now - self.t
        self.t = now


class Phases:
    """mark(name) records a CUDA event after each phase of a step (the
    port's gdrn_engine.event_marker); read() gives each phase's mean time
    a step (or request) on the card's clock, summed over its occurrences.
    With spin, each mark also launches an empty kernel (torch.cuda._sleep
    of 0 cycles), whose launch the device trace shows at the host's time
    of the mark: what trace.reduce names the idle gaps by."""

    def __init__(self, spin: bool = False):
        self.steps: list[list] = []
        self.spin = spin

    def start(self):
        from self6dpp_tpu_torch.engine.gdrn_engine import event_marker
        marks: list = []
        self.steps.append(marks)
        record = event_marker(marks)

        def mark(name: str) -> None:
            record(name)
            if self.spin:
                torch.cuda._sleep(0)
        mark("start")
        return mark

    def read(self) -> dict[str, float]:
        sums: dict[str, float] = {}
        for marks in self.steps:
            for (_, a), (name, b) in zip(marks, marks[1:]):
                sums[name] = sums.get(name, 0.0) + a.elapsed_time(b)
        n = max(len(self.steps), 1)
        return {k: v / n for k, v in sums.items()}


class GdrnTrain:
    """Training steps of GDR-Net (traffic kind gdrn_train)."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, device
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

    def free_program(self) -> None:
        self.state = self.step_fn = None

    # -- reference ---------------------------------------------------------
    def reference_readings(self, control: bool = False) -> dict:
        """The reference's readings of the same three steps from the same
        weights and batches (control: the networks in bfloat16 on float8
        matrix products)."""
        rcfg = reference_config(self.traffic["recipe"], self.overrides)
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
        ctx = ref_steps.fp8_matmuls() if control else _null()
        with ref_steps.plain_float32(), ctx:
            for i in range(self.traffic["check_steps"]):
                rec.after_step(state.opt, step(state, self.pool[i]))
        out = rec.finish()
        del state, model, lpips
        return out

    def numbers(self, control: bool = False) -> dict[str, float]:
        return compare.train_numbers(self.readings,
                                     self.reference_readings(control))

    def model_flops(self) -> float:
        """FLOPs of one step at this cell's batch: the reference step's
        (its networks forward and backward) counted at two ROIs, per ROI
        times the batch (each ROI's network work is its own)."""
        from . import counts
        rcfg = reference_config(self.traffic["recipe"], self.overrides)
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


class DeepimRefine:
    """A closed loop of DeepIM refinement requests (traffic kind
    deepim_refine)."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, device
        self.rois = traffic["rois"]
        self.overrides = list(traffic["overrides"])
        self.cfg = port_config(traffic["recipe"], self.overrides)
        check_sizes(self.cfg, config["sizes"])
        self.rcfg = reference_config(traffic["recipe"], self.overrides)
        if self.cfg.deepim.in_channels != 6:
            raise ValueError("deepim_refine feeds 6-channel inputs")

    def _requests(self) -> list[dict]:
        t, dev = self.traffic, self.device
        g = inputs.generator(self.seed, DATA, dev)
        nc = self.cfg.deepim.num_classes
        meshes = inputs.class_meshes(self.config["meshes"], nc, g, dev)
        K = torch.tensor(inputs.LM_K, device=dev)
        n = t["pool"] * self.rois
        u = lambda shape, lo, hi: inputs._uniform(shape, lo, hi, g, dev)
        cls = torch.randint(0, nc, (n,), generator=g, device=dev)
        center = u((n, 2), *t["center_px"])
        z = u((n,), 0.6, 1.4)
        gt_trans = torch.stack([(center[:, 0] - K[0, 2]) / K[0, 0] * z,
                                (center[:, 1] - K[1, 2]) / K[1, 1] * z, z], 1)
        gt_rot = inputs.random_rotations(n, g, dev)
        d_rot = inputs.axis_angle(torch.deg2rad(torch.randn(
            (n, 3), generator=g, device=dev) * t["rot_noise_deg"]))
        d_trans = torch.randn((n, 3), generator=g, device=dev) \
            * torch.tensor(t["trans_noise_m"], device=dev)
        allb = {"K": K.expand(n, 3, 3).contiguous(),
                "verts": meshes["verts"][cls], "faces": meshes["faces"][cls],
                "colors": meshes["colors"][cls], "roi_cls": cls,
                "gt_rot": gt_rot, "gt_trans": gt_trans,
                "init_rot": d_rot @ gt_rot, "init_trans": gt_trans + d_trans}
        obs, boxes = [], []
        from .reference.ops.zoom import bboxes_from_pose
        block = t["render_block"]
        with torch.no_grad(), ref_steps.plain_float32():
            for i in range(0, n, block):
                part = {k: v[i:i + block] for k, v in allb.items()}
                o = ref_steps.render_observations(self.rcfg, part,
                                                  tuple(t["frame_hw"]))
                if not bool((o.mask.flatten(1).sum(1) > 0).all()):
                    raise RuntimeError("an ROI left the frame")
                obs.append(o.attr)
                boxes.append(bboxes_from_pose(part["verts"], part["K"],
                                              part["gt_rot"],
                                              part["gt_trans"]))
        allb["obs_img"], allb["obs_box"] = torch.cat(obs), torch.cat(boxes)
        r = self.rois
        return [{k: v[j * r:(j + 1) * r].contiguous() for k, v in allb.items()}
                for j in range(t["pool"])]

    def _weights_(self, model) -> None:
        inputs.draw_weights_(model, inputs.generator(self.seed, WEIGHTS,
                                                     self.device),
                             inputs.deepim_std)
        model.init_identity_heads_()

    def setup(self, step_wrapper=None) -> None:
        from self6dpp_tpu_torch.engine import deepim_engine as de
        dev = self.device
        clock = Clock(dev)
        self.pool = self._requests()
        clock("inputs")
        with torch.device(dev):
            model = de.build_deepim(self.cfg, device=dev)
        self._weights_(model)
        self.model = model
        step = de.make_eval_step(self.cfg, model, device=dev)
        self.step_fn = step_wrapper(step) if step_wrapper else step
        clock("build")
        self.answers: list[tuple[int, torch.Tensor, torch.Tensor]] = []
        self.n_issued = 0
        for req in self.pool[:self.traffic["warmup_requests"]]:
            self._request(req)
        self.answers.clear()
        self.n_issued = 0
        clock("warm_requests")
        self.setup_parts = clock.parts

    def _request(self, req):
        out = self.step_fn(req)
        return out["rot"].cpu(), out["trans"].cpu()

    def run(self, seconds: float, phases: Phases | None = None,
            max_steps: int | None = None) -> dict:
        """One client sending requests back to back for `seconds`: each
        timed from its submission to its poses on the host."""
        lat = []
        t0 = time.perf_counter()
        deadline = t0 + seconds
        refine_marks = None
        if phases is not None:
            refine_marks = self._marked_step()
        while time.perf_counter() < deadline and (max_steps is None
                                                 or len(lat) < max_steps):
            j = self.n_issued % len(self.pool)
            ts = time.perf_counter()
            if refine_marks is None:
                out = self.step_fn(self.pool[j])
            else:
                out = refine_marks(self.pool[j], phases.start())
            rot, trans = out["rot"].cpu(), out["trans"].cpu()
            lat.append(time.perf_counter() - ts)
            self.answers.append((j, rot, trans))
            self.n_issued += 1
        sync(self.device)
        seconds = time.perf_counter() - t0
        failed = sum(not (bool(torch.isfinite(r).all())
                          and bool(torch.isfinite(t).all()))
                     for _, r, t in self.answers[len(self.answers)
                                                 - len(lat):])
        return {"steps": len(lat), "work": len(lat) * self.rois,
                "latencies": lat, "seconds": seconds, "failed": failed}

    def _marked_step(self):
        """make_eval_step's request with make_refine_fn's mark hook on."""
        from self6dpp_tpu_torch.engine import deepim_engine as de
        refine = de.make_refine_fn(self.cfg, self.model,
                                   self.cfg.deepim.n_iter_test)

        def step(req, mark):
            b = de.to_device(req, self.device)
            with torch.inference_mode():
                rot, trans = refine(b, b["init_rot"], b["init_trans"], mark)
            return {"rot": rot, "trans": trans}
        return step

    def free_program(self) -> None:
        self.model = self.step_fn = None

    def sample(self) -> list[tuple[int, torch.Tensor, torch.Tensor]]:
        """The answers compared: the last answer of each of `sample` pool
        entries drawn from the seed among those the window answered."""
        last = {j: (j, r, t) for j, r, t in self.answers}
        keys = sorted(last)
        rng = random.Random(self.seed)
        return [last[j] for j in sorted(rng.sample(
            keys, min(self.traffic["sample"], len(keys))))]

    def reference_answers(self, picked, control: bool = False):
        """The reference's refined poses of the picked requests (control:
        the network in bfloat16 on float8 matrix products)."""
        model = ref_steps.build_deepim(
            self.rcfg, self.device,
            torch.bfloat16 if control else torch.float32)
        self._weights_(model)
        ctx = ref_steps.fp8_matmuls() if control else _null()
        out = []
        with ref_steps.plain_float32(), ctx:
            for j, _, _ in picked:
                rot, trans = ref_steps.refine(self.rcfg, model, self.pool[j])
                out.append((rot.cpu(), trans.cpu()))
        return out

    def model_flops(self) -> float:
        """FLOPs of one request: the reference's refine on a request of
        the pool (its network's four forwards)."""
        from . import counts
        model = ref_steps.build_deepim(self.rcfg, self.device)
        return counts.model_flops(
            lambda: ref_steps.refine(self.rcfg, model, self.pool[0]))

    def cameras(self, picked) -> list[torch.Tensor]:
        """Each picked request's cameras (B, 3, 3), on the host."""
        return [self.pool[j]["K"].cpu() for j, _, _ in picked]

    def numbers(self, control: bool = False) -> dict[str, float]:
        picked = self.sample()
        if not picked:
            return {"rot_gap_deg": float("inf"),
                    "center_gap_px": float("inf")}
        ref = self.reference_answers(picked, control)
        return compare.pose_numbers([(r, t) for _, r, t in picked], ref,
                                    self.cameras(picked))


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


KINDS = {"gdrn_train": GdrnTrain, "deepim_refine": DeepimRefine}


def make_cell(config: dict, traffic: dict, seed: int, device):
    return KINDS[traffic["kind"]](config, traffic, seed, device)

