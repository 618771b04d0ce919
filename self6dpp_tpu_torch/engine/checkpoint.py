"""Checkpoints of the train state and weights as the JAX package's flat
.npz (port of self6dpp_tpu/engine/checkpoint.py: CheckpointManager,
save_params_npz, load_params_npz).

The .npz holds the JAX model's variables flattened to dotted keys
('params.backbone.conv1.kernel', 'batch_stats.…'), in the JAX layout;
convert.py maps them to and from the port's GDRN, DeepIM and YOLOv4.

The JAX package checkpoints through orbax, which the port does not have.
CheckpointManager writes its own step directories <dir>/<step>/ instead:
  PORT_STEP   the marker that tells a port step from an orbax step (JSON:
              format, step);
  model.npz   the student, as save_params_npz writes it (the JAX
              package's load_params_npz reads it);
  ema.npz     the EMA teacher, likewise (when the state has one);
  solver.pt   torch.save of the solver's state (its update count too), the
              step and the host generator's state.
A step is written to <step>.tmp and renamed when complete. A step
directory without the marker is an orbax step: the manager raises on it.
Every file holds whole tensors, whatever the rank grid that wrote it, and
loads into a run of any grid.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch
from torch import nn

from .. import convert
from ..convert import _flatten
from ..models.deepim import DeepIM
from ..models.gdrn import GDRN
from ..models.yolo import YOLOv4
from ..parallel.dist import is_main
from ..parallel.mesh import gathered
from .train_state import TrainState

MARKER = "PORT_STEP"
FORMAT = "self6dpp_tpu_torch/1"


def _to_flax(model: nn.Module) -> dict:
    """The model's variables in the JAX layout: a GDRN's, a DeepIM's or a
    YOLOv4's through convert.py; any other module's state_dict under
    'params' as it is (the layout of a JAX parameter tree with the same
    names)."""
    if isinstance(model, DeepIM):
        return convert.state_dict_to_flax(model)
    if isinstance(model, GDRN):
        return convert.gdrn_state_dict_to_flax(model)
    if isinstance(model, YOLOv4):
        return convert.yolo_state_dict_to_flax(model)
    if convert.part_key_map(model) is not None:
        return convert.part_state_dict_to_flax(model)
    return {"params": {k: v.detach().cpu().numpy()
                       for k, v in model.state_dict().items()}}


def _from_flat(flat: dict[str, np.ndarray], model: nn.Module) -> dict:
    """The model's state_dict from flat JAX-layout variables."""
    part = convert.part_key_map(model) is not None
    if not isinstance(model, (DeepIM, GDRN, YOLOv4)) and not part:
        return {k.partition(".")[2]: torch.as_tensor(v)
                for k, v in flat.items()}
    tree: dict = {}
    for k, v in flat.items():
        *path_, leaf = k.split(".")
        node = tree
        for p in path_:
            node = node.setdefault(p, {})
        node[leaf] = v
    if isinstance(model, DeepIM):
        return convert.flax_to_state_dict(tree, model)
    if isinstance(model, YOLOv4):
        return convert.yolo_flax_to_state_dict(tree, model)
    if part:
        return convert.part_flax_to_state_dict(tree, model)
    return convert.gdrn_flax_to_state_dict(tree, model)


def save_params_npz(path: str, model: nn.Module) -> None:
    """The model's variables in the JAX layout, as a flat .npz."""
    np.savez(path, **_flatten(_to_flax(model)))


def load_params_npz(path: str, model: nn.Module, strict: bool = True,
                    prefix: str = "") -> nn.Module:
    """Load a flat .npz of JAX-layout variables into the model, in place.
    strict=False keeps the model's own value for every variable the file
    lacks (a partial init, e.g. backbone weights under a whole GDRN).
    prefix: take only the file's variables under that scope
    ('params.<prefix>.…', 'batch_stats.<prefix>.…'), without it, e.g. a
    converted GDRN's geo_head into a TopDownGeoHead. Besides GDRN, DeepIM
    and YOLOv4 the model may be a part the JAX package builds alone
    (convert.part_key_map). Raises for an array of the file the model has
    no variable for, and for a shape that differs."""
    raw = dict(np.load(path))
    if prefix:
        raw = {f"{c}.{k[len(c) + len(prefix) + 2:]}": v
               for k, v in raw.items() for c in ("params", "batch_stats")
               if k.startswith(f"{c}.{prefix}.")}
    flat = _flatten(_to_flax(model))
    missing = sorted(set(flat) - set(raw))
    if strict and missing:
        raise KeyError(f"{path}: missing variables {missing[:8]}")
    unused = sorted(set(raw) - set(flat))
    if unused:
        raise KeyError(f"{path}: arrays the model has no variable for: "
                       f"{unused[:8]}")
    for k, v in raw.items():
        if v.shape != flat[k].shape:
            raise ValueError(f"{k}: file {v.shape} != model {flat[k].shape}")
        flat[k] = v
    with torch.no_grad():
        model.load_state_dict(_from_flat(flat, model), strict=True)
    return model


def step_dirs(directory: str) -> tuple[list[int], list[int]]:
    """(port steps, orbax steps) in `directory`, each sorted: the
    directories named by a step number, with and without the marker."""
    port, orbax = [], []
    if os.path.isdir(directory):
        for name in os.listdir(directory):
            if name.isdigit() and os.path.isdir(os.path.join(directory, name)):
                has = os.path.exists(os.path.join(directory, name, MARKER))
                (port if has else orbax).append(int(name))
    return sorted(port), sorted(orbax)


def check_no_orbax_steps(directory: str) -> None:
    """Raise when `directory` holds orbax steps: the JAX CLIs would resume
    from them, and the port cannot read them."""
    orbax = step_dirs(directory)[1]
    if orbax:
        raise RuntimeError(
            f"{directory} holds orbax checkpoint steps {orbax[:4]}, which "
            "the port does not read; export them with the JAX package's "
            "save_params_npz and pass --init-npz")


class CheckpointManager:
    """Periodic checkpoints of a TrainState in `directory`: save every
    save_period steps (0: only forced saves), the newest max_to_keep
    kept; restore, resume_or_load, and load_weights for a warm start."""

    def __init__(self, directory: str, max_to_keep: int = 2,
                 save_period: int = 5000):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_period = save_period

    def _dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def save(self, state: TrainState, step: int | None = None,
             force: bool = False) -> bool:
        """Write the state at `step` (default state.step) when the step is
        a multiple of save_period or force; a step already written is not
        written again; under data parallel only rank 0 writes (every rank
        holds the same state). A sharded state (parallel/mesh.py) is
        written whole: every rank calls save, gathers, and rank 0 writes.
        Returns whether it wrote."""
        step = state.step if step is None else int(step)
        if not force and (self.save_period <= 0
                          or step % self.save_period != 0):
            return False
        if state.fsdp is None:
            if not is_main():
                return False
            return self._write(state, step, state.opt.state_dict())
        # sharded: every rank gathers the whole tensors, rank 0 writes
        with gathered(state):
            solver = state.opt.state_dict()
            return self._write(state, step, solver) if is_main() else False

    def _write(self, state: TrainState, step: int, solver: dict) -> bool:
        if os.path.exists(self._dir(step)):
            return False
        check_no_orbax_steps(self.directory)
        tmp = self._dir(step) + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        save_params_npz(os.path.join(tmp, "model.npz"), state.model)
        if state.teacher is not None:
            save_params_npz(os.path.join(tmp, "ema.npz"), state.teacher)
        torch.save({"solver": solver, "step": step,
                    "host_rng": torch.get_rng_state()},
                   os.path.join(tmp, "solver.pt"))
        with open(os.path.join(tmp, MARKER), "w") as f:
            json.dump({"format": FORMAT, "step": step}, f)
        os.replace(tmp, self._dir(step))
        for old in self.all_steps()[:-self.max_to_keep or None]:
            shutil.rmtree(self._dir(old))
        return True

    def all_steps(self) -> list[int]:
        """The port's steps; raises when the directory holds orbax steps."""
        check_no_orbax_steps(self.directory)
        return step_dirs(self.directory)[0]

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _load_weights(self, state: TrainState, step: int) -> None:
        """The step's whole tensors into the student and teacher (a
        sharded state keeps each rank's part of them)."""
        d = self._dir(step)
        with gathered(state, write=True):
            load_params_npz(os.path.join(d, "model.npz"), state.model)
            ema = os.path.join(d, "ema.npz")
            if state.teacher is not None and os.path.exists(ema):
                load_params_npz(ema, state.teacher)

    def restore(self, state: TrainState, step: int | None = None
                ) -> TrainState:
        """The state at `step` (default the latest): weights, teacher,
        solver state and step count, and the host generator's state."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        self._load_weights(state, step)
        saved = torch.load(os.path.join(self._dir(step), "solver.pt"),
                           weights_only=True)
        state.opt.load_state_dict(saved["solver"])
        state.step = int(saved["step"])
        torch.set_rng_state(saved["host_rng"])
        return state

    def resume_or_load(self, state: TrainState, resume: bool = True
                       ) -> tuple[TrainState, int]:
        """(state, the iteration to start from): the latest step when
        resume and there is one, else the state as given and 0."""
        step = self.latest_step()
        if resume and step is not None:
            return self.restore(state, step), step
        return state, 0

    def load_weights(self, state: TrainState, step: int | None = None
                     ) -> TrainState:
        """Warm start: the student's and the teacher's weights of `step`
        (default the latest), the solver reset to a fresh state at them
        and the step count at 0. The JAX package keeps its solver state
        from before the load, so its Lookahead's slow weights stay those of
        the seeded init; the stage-I solver's state and schedule count
        are never restored (they would replay a long schedule into a short
        stage-II run)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        self._load_weights(state, step)
        state.opt.reset()
        state.step = 0
        return state
