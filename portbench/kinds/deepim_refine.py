"""Traffic kind deepim_refine: a closed loop of one client, each
request's ROIs refined by engine/deepim_engine.py::make_eval_step, timed
from its submission to its poses on the host. The window's end-to-end
values are the median and the 95th percentile of its requests' latencies;
its answers to a sample of requests drawn from the seed are compared with
the reference's. Fault: one ROI's answer altered where it is produced."""

from __future__ import annotations

import math
import random
import statistics
import time
from contextlib import nullcontext

import torch

from portbench import compare, inputs
from portbench.cells import (DATA, WEIGHTS, Driver, Clock, Phases,
                             check_sizes, percentile, port_config,
                             reference_config, sync)
from portbench.harness import HERE
from portbench.reference import steps as ref_steps


def turned_answer(step, degrees: float = 1.0):
    """The refinement fault: the first ROI's rotation turned by `degrees`
    about the camera's z axis where the answer is produced."""
    def broken(batch):
        out = dict(step(batch))
        rot = out["rot"].clone()
        a = math.radians(degrees)
        turn = torch.tensor([[math.cos(a), -math.sin(a), 0.0],
                             [math.sin(a), math.cos(a), 0.0],
                             [0.0, 0.0, 1.0]], device=rot.device)
        rot[0] = turn @ rot[0]
        out["rot"] = rot
        return out
    return broken


class DeepimRefine(Driver):
    """A closed loop of DeepIM refinement requests (traffic kind
    deepim_refine)."""

    faults = (("turned_answer", turned_answer),)

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 base: str = HERE):
        self.config, self.traffic = config, traffic
        self.seed, self.device, self.base = seed, device, base
        self.rois = traffic["rois"]
        self.overrides = list(traffic["overrides"])
        self.cfg = port_config(traffic["recipe"], self.overrides)
        check_sizes(self.cfg, config["sizes"])
        self.rcfg = reference_config(traffic["recipe"], self.overrides, base)
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
        from portbench.reference.ops.zoom import bboxes_from_pose
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

    def end_to_end(self, res: dict) -> dict[str, float]:
        lat = [x * 1e3 for x in res["latencies"]]
        return {"refine_ms_p50": statistics.median(lat),
                "refine_ms_p95": percentile(lat, 0.95)}

    def calibration_window(self, seconds: float) -> None:
        self.run(seconds)

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
        ctx = ref_steps.fp8_matmuls() if control else nullcontext()
        out = []
        with ref_steps.plain_float32(), ctx:
            for j, _, _ in picked:
                rot, trans = ref_steps.refine(self.rcfg, model, self.pool[j])
                out.append((rot.cpu(), trans.cpu()))
        return out

    def model_flops(self) -> float:
        """FLOPs of one request: the reference's refine on a request of
        the pool (its network's four forwards)."""
        from portbench import counts
        model = ref_steps.build_deepim(self.rcfg, self.device)
        return counts.model_flops(
            lambda: ref_steps.refine(self.rcfg, model, self.pool[0]))

    def cameras(self, picked) -> list[torch.Tensor]:
        """Each picked request's cameras (B, 3, 3), on the host."""
        return [self.pool[j]["K"].cpu() for j, _, _ in picked]

    def reference(self, control: bool = False) -> dict:
        """The reference's answers to the requests sample() picks, with
        their cameras."""
        picked = self.sample()
        return {"picked": [j for j, _, _ in picked],
                "cams": self.cameras(picked),
                "answers": self.reference_answers(picked, control)
                if picked else []}

    def gaps(self, ref: dict, own: dict | None = None) -> dict[str, float]:
        if not ref["picked"]:
            return {"rot_gap_deg": float("inf"),
                    "center_gap_px": float("inf")}
        if own is None:
            picked = self.sample()
            own = {"picked": [j for j, _, _ in picked],
                   "answers": [(r, t) for _, r, t in picked]}
        if own["picked"] != ref["picked"]:
            raise RuntimeError("the run answered other requests")
        return compare.pose_numbers(own["answers"], ref["answers"],
                                    ref["cams"])


DRIVER = DeepimRefine
