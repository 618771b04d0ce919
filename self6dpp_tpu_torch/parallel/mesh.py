"""The rank grid and the parameters sharded over it (port of
self6dpp_tpu/parallel/mesh.py: make_mesh, param_sharding_rules,
shard_state; fsdp_size is RankMesh.fsdp, and step_shardings' part,
telling the step which state is sharded, is TrainState.fsdp).

make_mesh lays the ranks out as (data, fsdp) = DistConfig.mesh_shape (-1:
the rest), as the JAX package lays its devices out: rank r sits at
np.arange(world).reshape(shape)'s (i, j). The ranks of a row form an
fsdp group, those of a column a data group. The record stream is split
over the data index alone (the JAX batch sharding is P(data)), so the
ranks of one fsdp group take the same records and the global batch is
data x ims_per_batch; parallel/dist.py's reductions (batch-norm
statistics, loss normalisers, the gradient average, the metrics) run
over the data group.

shard_state keeps, on each rank, 1/fsdp of every parameter of 2^16
elements or more, cut along its largest axis that fsdp divides, chosen
in the JAX package's layout as param_sharding_rules chooses (the axis is
then the torch tensor's counterpart); the same slice of the EMA copy and
of every optimizer moment (RAdam's m and v, the Lookahead's slow weights,
the trace, MADGRAD's sums, the accumulator). Smaller parameters, the
batch-norm buffers and the step count are replicated. The model's
parameter then holds an empty placeholder; in a step:
  - before the student's (or the teacher's) forward, a forward pre-hook
    all-gathers each sharded parameter within the fsdp group;
  - after the backward, each gradient is reduce-scattered within the
    fsdp group (its mean: the group's ranks computed it on the same
    records) to the shard, then averaged over the data group with the
    replicated ones (dist.average_gradients);
  - the solver updates the shards; its reductions that reach past one
    shard get the whole leaf's value: the global-norm clip sums the
    shards' squares over the fsdp group, sgd_gc's centralisation and the
    AdamP/SGDP projection gather the leaf, compute, and keep their slice;
  - the EMA moves the teacher's shards, and the gathered tensors are
    dropped again.
A checkpoint holds whole tensors (every rank gathers, rank 0 writes) and
loads into a run of any grid. Sharding changes no number.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
from torch import Tensor, nn

from ..config import DistConfig
from .dist import rank, set_data_group, world_size

# the JAX layout's axes of a torch weight, by the kind of convert.
# param_kinds: JAX axis a is torch axis _PERM[kind][a] (engine/optim.py::
# to_jax_layout); 'dense' is a 1x1 conv whose JAX kernel is (in, out)
_PERM = {"conv": (2, 3, 1, 0), "deconv": (2, 3, 0, 1), "fc": (1, 0),
         "fc_flat": (1, 0), "dense": (1, 0)}


@dataclass
class RankMesh:
    shape: tuple[int, int]          # (data, fsdp)
    data_index: int
    fsdp_index: int
    fsdp_group: object | None       # None: a group of this rank alone
    data_group: object | None       # None: every rank (dist.py's default)

    @property
    def fsdp(self) -> int:
        return self.shape[1]

    @property
    def data(self) -> int:
        return self.shape[0]


def resolve_shape(mesh_shape, world: int) -> tuple[int, int]:
    """(data, fsdp) with a -1 entry taking the rest; raises unless
    data x fsdp is the world. Entries may be strings (--opts
    dist.mesh_shape=2,2 gives ('2', '2'))."""
    shape = [int(v) for v in mesh_shape]
    if len(shape) != 2:
        raise ValueError(f"mesh_shape {tuple(mesh_shape)}: (data, fsdp)")
    known = math.prod(s for s in shape if s > 0)
    shape = [world // known if s == -1 else s for s in shape]
    if math.prod(shape) != world or min(shape) < 1:
        raise ValueError(f"mesh {tuple(mesh_shape)} -> {shape} does not "
                         f"fit {world} ranks")
    return shape[0], shape[1]


_CURRENT: dict = {"mesh": None}


def current_mesh() -> RankMesh | None:
    """The grid the last make_mesh built (None before any)."""
    return _CURRENT["mesh"]


def make_mesh(cfg: DistConfig | None = None) -> RankMesh:
    """The (data, fsdp) grid of the process group's ranks (one rank: the
    grid (1, 1)). Every rank calls it, with the same config: it builds the
    groups of both axes in one order on all of them, and points
    dist.py's reductions at this rank's data group."""
    cfg = cfg or DistConfig()
    w, r = world_size(), rank()
    shape = resolve_shape(cfg.mesh_shape, w)
    grid = np.arange(w).reshape(shape)
    i, j = (int(x) for x in np.argwhere(grid == r)[0])
    fsdp_group = data_group = None
    if shape[0] > 1 and shape[1] > 1:
        for c in range(shape[1]):
            g = dist.new_group([int(x) for x in grid[:, c]])
            data_group = g if c == j else data_group
        for row in range(shape[0]):
            g = dist.new_group([int(x) for x in grid[row]])
            fsdp_group = g if row == i else fsdp_group
    elif shape[1] > 1:
        fsdp_group = dist.group.WORLD
    if shape[1] > 1:
        set_data_group(data_group, shape[0], i)
    else:
        set_data_group(None, None, None)
    _CURRENT["mesh"] = RankMesh(shape, i, j, fsdp_group, data_group)
    return _CURRENT["mesh"]



def _jax_shape_axes(shape: tuple[int, ...], kind: str | None
                    ) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """(the JAX layout's shape, its axes' torch axes) of a torch weight."""
    if kind == "dense" and len(shape) == 4:
        return (shape[1], shape[0]), (1, 0)
    perm = _PERM.get(kind)
    if perm is None or len(perm) != len(shape):
        return shape, tuple(range(len(shape)))
    return tuple(shape[a] for a in perm), perm


def sharding_axis(shape: tuple[int, ...], fsdp: int, kind: str | None = None,
                  min_size: int = 2 ** 16, force: bool = False
                  ) -> int | None:
    """The torch axis a tensor of this shape is cut along over fsdp ranks,
    or None (replicated): the JAX rule on the JAX layout's shape (below
    min_size or fsdp 1: replicated; else the largest axis fsdp divides,
    the first of equal ones). force: shard at fsdp 1 as well (one shard,
    the whole tensor), for running the sharded path on one rank."""
    if (fsdp <= 1 and not force) or math.prod(shape) < min_size:
        return None
    jshape, axes = _jax_shape_axes(tuple(shape), kind)
    for ax in sorted(range(len(jshape)), key=lambda a: -jshape[a]):
        if jshape[ax] % fsdp == 0:
            return axes[ax]
    return None


def param_sharding_rules(model: nn.Module, fsdp: int,
                         min_size: int = 2 ** 16, force: bool = False
                         ) -> dict[str, int | None]:
    """{parameter name: its torch axis (sharding_axis) or None}, the
    weights laid out as the JAX package lays them (convert.param_kinds,
    for a GDRN, a DeepIM or a YOLOv4; any other module as it is)."""
    from ..convert import param_kinds
    try:
        kinds = param_kinds(model)
    except (KeyError, AttributeError, TypeError):
        kinds = {}
    return {n: sharding_axis(tuple(p.shape), fsdp, kinds.get(n), min_size,
                             force)
            for n, p in model.named_parameters()}


class Shard:
    """How one leaf is cut: along `axis` into `size` equal parts over the
    fsdp group, this rank's part `index`; full_shape the whole leaf's."""

    def __init__(self, axis: int, mesh: RankMesh, full_shape):
        self.axis, self.size, self.index = axis, mesh.fsdp, mesh.fsdp_index
        self.group = mesh.fsdp_group
        self.full_shape = tuple(full_shape)

    def slice(self, t: Tensor) -> Tensor:
        """This rank's part of a whole leaf (a copy)."""
        return t.detach().chunk(self.size, self.axis)[self.index].clone()

    def gather(self, t: Tensor) -> Tensor:
        """The whole leaf from every rank's part t (collective)."""
        if self.size == 1:
            return t.detach().clone()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.detach().contiguous(), group=self.group)
        return torch.cat(parts, self.axis)

    def reduce_scatter_mean(self, g: Tensor) -> Tensor:
        """This rank's part of the group's mean of the whole leaf g
        (collective)."""
        if self.size == 1:
            return g
        gm = g.movedim(self.axis, 0).contiguous()
        out = torch.empty_like(gm.chunk(self.size, 0)[0])
        dist.reduce_scatter_tensor(out, gm, group=self.group)
        return (out / self.size).movedim(0, self.axis).contiguous()

    def all_reduce(self, x: Tensor) -> Tensor:
        """x summed over the fsdp group, in place (collective)."""
        if self.size > 1:
            dist.all_reduce(x, group=self.group)
        return x


class ShardedModule:
    """A module whose parameters named in `axes` are kept as this rank's
    Shard parts (`shards`, leaf tensors the solver updates), gathered into
    the module before its forward and dropped by release()."""

    def __init__(self, module: nn.Module, axes: dict[str, int | None],
                 mesh: RankMesh):
        self.module = module
        self.entries: dict[str, tuple[nn.Parameter, Shard, Tensor]] = {}
        for name, p in module.named_parameters():
            ax = axes.get(name)
            if ax is None:
                continue
            spec = Shard(ax, mesh, p.shape)
            shard = nn.Parameter(spec.slice(p), requires_grad=p.requires_grad)
            self.entries[name] = (p, spec, shard)
        self.gathered = True
        self.release()
        module.register_forward_pre_hook(lambda m, args: self.gather())

    def leaves(self) -> list[Tensor]:
        """The module's parameters in order, each sharded one's shard in
        its place."""
        return [self.entries[n][2] if n in self.entries else p
                for n, p in self.module.named_parameters()]

    def specs(self) -> list[Shard | None]:
        return [self.entries[n][1] if n in self.entries else None
                for n, _ in self.module.named_parameters()]

    @torch.no_grad()
    def gather(self) -> None:
        """Every sharded parameter whole in the module (collective; a
        no-op while gathered)."""
        if self.gathered:
            return
        for p, spec, shard in self.entries.values():
            p.data = spec.gather(shard)
        self.gathered = True

    def release(self) -> None:
        """Drop the gathered tensors: each sharded parameter holds an
        empty placeholder until the next gather."""
        if not self.gathered:
            return
        for p, _, shard in self.entries.values():
            p.data = shard.new_empty(0)
            p.grad = None
        self.gathered = False

    @torch.no_grad()
    def write_back(self) -> None:
        """Each gathered parameter's part into its shard (after the whole
        tensors were loaded)."""
        for p, spec, shard in self.entries.values():
            shard.copy_(spec.slice(p))

    @torch.no_grad()
    def reduce_grads(self) -> None:
        """Each sharded parameter's gradient reduce-scattered (mean) within
        the fsdp group into its shard's gradient (a parameter without a
        gradient counts zeros)."""
        for p, spec, shard in self.entries.values():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            shard.grad = spec.reduce_scatter_mean(g)
            p.grad = None

    def resident_bytes(self, name: str) -> int:
        """The bytes this rank holds for parameter `name` now: its shard
        and the module's tensor (the placeholder when released)."""
        p, _, shard = self.entries[name]
        return (shard.numel() + p.numel()) * shard.element_size()


class FsdpState:
    """The sharded student and (if any) teacher of a TrainState."""

    def __init__(self, mesh: RankMesh, student: ShardedModule,
                 teacher: ShardedModule | None):
        self.mesh, self.student, self.teacher = mesh, student, teacher

    def modules(self) -> list[ShardedModule]:
        return [m for m in (self.student, self.teacher) if m is not None]

    def reduce_grads(self) -> None:
        self.student.reduce_grads()

    def release(self) -> None:
        for m in self.modules():
            m.release()

    @contextlib.contextmanager
    def whole(self, write: bool = False):
        """Student and teacher whole for the block (every rank enters it:
        the gather is collective); write: then each rank keeps its part of
        what the block left in them (a loaded checkpoint)."""
        for m in self.modules():
            m.gather()
        try:
            yield
            if write:
                for m in self.modules():
                    m.write_back()
        finally:
            self.release()


def gathered(state, write: bool = False):
    """FsdpState.whole of a sharded state; else a context that does
    nothing."""
    fs = getattr(state, "fsdp", None)
    return fs.whole(write) if fs is not None else contextlib.nullcontext()


def shard_state(state, mesh: RankMesh, min_size: int = 2 ** 16,
                force: bool = False):
    """Shard the TrainState's parameters, EMA copy and solver state over
    the mesh's fsdp axis (param_sharding_rules), in place; returns the
    state. With no parameter to shard (fsdp 1, unless force) it is left
    as it is. force at fsdp 1 takes the sharded path with one shard a
    leaf (chip_smoke.py's one-card check)."""
    axes = param_sharding_rules(state.model, mesh.fsdp, min_size, force)
    if not any(a is not None for a in axes.values()):
        return state
    if state.fsdp is not None:
        raise RuntimeError("the state is sharded already")
    student = ShardedModule(state.model, axes, mesh)
    teacher = (ShardedModule(state.teacher, axes, mesh)
               if state.teacher is not None else None)
    state.opt.reshard(student.leaves(), student.specs())
    state.fsdp = FsdpState(mesh, student, teacher)
    return state
