"""Sharding-constraint injection for the model library (counterpart of the
reference's ``parallel/api.py``).

Models mark *logical* tensor roles (``residual``, ``act_ff``,
``expert_buf``...) through :func:`constrain`.  A :class:`Plan`, built per
(arch x shape x mesh) by :mod:`repro_torch.parallel.sharding`, maps those
roles to specs: tuples with one entry a tensor dim, each ``None``, a mesh
axis name or a tuple of them (the reference's ``PartitionSpec``s, entry
for entry).  With no active plan every call returns its input, so the
same model code runs unsharded on one device and sharded over a
``torch.distributed`` :class:`~torch.distributed.device_mesh.DeviceMesh`.

On a mesh a spec becomes DTensor placements (:func:`placements`) and
``constrain`` is ``redistribute``: like GSPMD's
``with_sharding_constraint`` it changes the layout, never the values.
A plain tensor handed to a planned op stands for the same value on every
rank (the program runs SPMD), so while a plan is active DTensor treats
one as replicated (``implicit_replication``).

The kernels never see a DTensor: :func:`local_call` runs a function on
each rank's local shards at placements the caller states, and the
kernel wrappers on the serving path go through it (``local_map``).

This is the software form of the paper's heterogeneous kernel→chiplet
mapping: the *role* of a tensor (dynamic attention operand vs. static
weight-stationary FFN operand) decides its placement, not the module that
computed it.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch
from torch.distributed.tensor import DTensor


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes without devices: enough to build a plan and
    its specs (the plan-as-data tests, and :func:`sharding.build_plan` on
    a mesh no process group backs)."""

    shape_tuple: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.shape_tuple))


def mesh_shape(mesh) -> dict[str, int]:
    """{axis name: size} of a DeviceMesh or an :class:`AbstractMesh`."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclasses.dataclass
class Plan:
    """A named-role → spec table bound to a mesh."""

    mesh: object
    roles: dict[str, tuple]
    # param-path rules, kept so a Plan describes one whole mapping (the
    # rules themselves live in sharding.param_spec)
    param_rules: tuple = ()
    name: str = ""

    def spec(self, role: str) -> Optional[tuple]:
        return self.roles.get(role)


# the active plan, one a process: where the reference's is a thread's,
# the port's must reach the autograd engine's device threads, which run a
# remat'd layer's forward again in the backward pass
_active: list = [None]
# how many activations of a plan on a DeviceMesh are open: DTensor's
# implicit_replication switches itself off on exit whatever it found, so
# only the outermost one enters it (a draft model's plan inside the target's)
_replicating: list = [0]


def current_plan() -> Optional[Plan]:
    return _active[0]


@contextlib.contextmanager
def activate_plan(plan: Optional[Plan]):
    prev = current_plan()
    _active[0] = plan
    try:
        if plan is not None and not isinstance(plan.mesh, AbstractMesh):
            from torch.distributed.tensor.experimental import implicit_replication
            _replicating[0] += 1
            try:
                with implicit_replication() if _replicating[0] == 1 else \
                        contextlib.nullcontext():
                    yield plan
            finally:
                _replicating[0] -= 1
        else:
            yield plan
    finally:
        _active[0] = prev


# ---------------------------------------------------------------------------
# specs → DTensor placements
# ---------------------------------------------------------------------------

def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on every
    mesh dim that an entry ``d`` names, ``Replicate()`` elsewhere.  Axes
    named together on one tensor dim must come in mesh-dim order: DTensor
    splits a dim over several mesh dims major to minor in that order, the
    order a ``PartitionSpec`` tuple means."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} are not in the mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def replicated(x, mesh):
    """A plain tensor as a replicated DTensor on ``mesh`` (a DTensor as it
    is)."""
    if is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)


def even(target, shape, mesh) -> tuple:
    """``target`` with a shard kept only where it splits its tensor dim
    into equal parts of more than one row: a dim of size 1, or one that the
    product of its mesh dims' sizes does not divide, is replicated.  DTensor
    takes uneven shards, but a local region's outputs are rebuilt from
    equal ones, and DTensor's views drop a size-1 dim it shards."""
    from torch.distributed.tensor import Replicate
    out = list(target)
    for d in {p.dim for p in target if p.is_shard()}:
        over = [i for i, p in enumerate(target) if p.is_shard(d)]
        n = 1
        for i in over:
            n *= mesh.size(i)
        if shape[d] <= 1 or shape[d] % n:
            for i in over:
                out[i] = Replicate()
    return tuple(out)


def to_placements(x, mesh, target):
    """``x`` redistributed to ``target`` (a plain tensor taken as
    replicated first)."""
    x = replicated(x, mesh)
    if tuple(x.placements) == tuple(target):
        return x
    return x.redistribute(mesh, tuple(target))


def full(x):
    """The whole value of ``x`` as a plain tensor on every rank (a plain
    tensor as it is)."""
    if not is_dtensor(x):
        return x
    return x.full_tensor()


def gather_dim(x, dim: int):
    """``x`` with tensor dim ``dim`` whole on every rank (its other dims as
    they were); a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    d = dim % x.dim()
    target = tuple(Replicate() if p.is_shard(d) or p.is_partial() else p for p in x.placements)
    return to_placements(x, x.device_mesh, target)


def constrain(x, role: str):
    """The active plan's placement for ``role`` (``x`` itself without a
    plan, or for a role the plan lacks)."""
    plan = current_plan()
    if plan is None:
        return x
    spec = plan.spec(role)
    if spec is None:
        return x
    return to_placements(x, plan.mesh, even(placements(spec, plan.mesh), x.shape, plan.mesh))


def local_call(fn, args, in_placements, out_placements, mesh, grad_placements=None):
    """``fn`` on each rank's local shards: every tensor of ``args`` is
    redistributed to its entry of ``in_placements`` (a plain tensor taken
    as replicated; a ``None`` entry passes the argument through), ``fn``
    runs on the local tensors with no plan active, and its output becomes
    a DTensor at ``out_placements`` (a tuple of them for several outputs).  ``local_map``,
    with plain tensors admitted.  ``grad_placements`` (default: the inputs'
    own) say how each input's local gradient is placed: ``Partial()``
    where a rank's gradient is its part of a sum (an operand replicated on
    a mesh dim that splits the other's contribution)."""
    from torch.distributed.tensor.experimental import local_map
    args = [a if p is None or not isinstance(a, torch.Tensor) else to_placements(a, mesh, p)
            for a, p in zip(args, in_placements)]
    from torch.distributed.tensor import Placement
    if out_placements and isinstance(out_placements[0], Placement):
        out_placements = list(out_placements)           # one output

    def unplanned(*local):
        with activate_plan(None):       # local tensors: no role applies
            return fn(*local)
    return local_map(unplanned, out_placements=out_placements,
                     in_placements=tuple(in_placements),
                     in_grad_placements=None if grad_placements is None
                     else tuple(grad_placements), device_mesh=mesh)(*args)


def planned_mesh(name: str, *tensors):
    """The active plan's DeviceMesh when a DTensor is among ``tensors``
    (None when none is): a planned call of a kernel wrapper.  A DTensor
    with no plan active, or on another mesh, is refused: it is never
    gathered to a whole tensor quietly."""
    for t in tensors:
        if isinstance(t, DTensor):
            break
    else:
        return None
    plan = current_plan()
    if plan is None or isinstance(plan.mesh, AbstractMesh):
        raise TypeError(f"{name}: a DTensor reached the kernel wrapper with no plan active")
    return plan.mesh


def region_placements(mesh, dims: dict) -> tuple:
    """Placements that shard tensor dim ``d`` over each mesh dim of
    ``dims[d]`` (mesh-dim indices) and replicate elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * mesh.ndim
    for d, mesh_dims in dims.items():
        for i in mesh_dims:
            out[i] = Shard(d)
    return tuple(out)


def sharded_over(placements_, dim: int) -> list[int]:
    """The mesh dims whose placement shards tensor dim ``dim``."""
    return [i for i, p in enumerate(placements_) if p.is_shard(dim)]


def shard_index(mesh, dims) -> int:
    """This rank's shard, counted from 0, of a tensor dim split evenly over
    the mesh dims ``dims`` (major to minor, as DTensor splits a dim over
    several mesh dims)."""
    coord = mesh.get_coordinate()
    index = 0
    for i in dims:
        index = index * mesh.size(i) + coord[i]
    return index


@contextlib.contextmanager
def local_views(mesh, tensors: dict, targets: dict):
    """Local tensors of ``tensors`` (name → DTensor or plain) at
    ``targets`` (name → placements), to write into in place: a DTensor
    already at its target lends its own local tensor, so writes land in
    it; one at other placements is redistributed into a copy, which is
    redistributed back and written into the DTensor on exit.  A plain
    tensor (the same on every rank) is sliced and read only."""
    local, back = {}, []
    for name, t in tensors.items():
        target = tuple(targets[name])
        if is_dtensor(t) and tuple(t.placements) == target:
            local[name] = t.to_local()
            continue
        local[name] = to_placements(t, mesh, target).to_local()
        if is_dtensor(t):
            back.append((t, local[name], target))
    with activate_plan(None):           # local tensors: no role applies
        yield local
    for t, loc, target in back:
        whole = DTensor.from_local(loc, mesh, target, run_check=False,
                                   shape=t.shape, stride=t.stride())
        t.to_local().copy_(whole.redistribute(mesh, t.placements).to_local())


def refuse_dtensor(name: str, *tensors) -> None:
    """A kernel wrapper's guard: a DTensor reaching it outside a planned
    ``local_map`` is refused, never gathered quietly."""
    for t in tensors:
        if isinstance(t, DTensor):
            raise TypeError(f"{name}: a DTensor reached the kernel wrapper; planned calls "
                            f"go through local_map with the plan's placements")
