"""What one step dispatches, counted for the roofline (the port's
counterpart of ``repro/roofline/hlo.py``).

The reference walks the optimized HLO text of a compiled step.  The port
has no HLO: a step is eager PyTorch, so :class:`CostMode`, a
``TorchDispatchMode``, sees every ATen op the step runs, forward and
backward, and counts per device:

- **FLOPs** of the ops the reference's ``_dot_flops`` and convolution
  branch count: ``mm``, ``addmm``, ``bmm``, ``baddbmm`` (``2 * out *
  contracted``) and ``convolution`` (``2 * out * weight / out channels``);
- **HBM bytes**: each op that launches work reads its operands and writes
  its results once (an expanded operand counts its distinct elements; a
  gather reads only the rows it gathers; an indexed write in place reads
  and writes only the rows it writes).  Views, metadata ops, allocations
  and ``prim.device`` count nothing.  Nothing is fused, so an intermediate
  the reference's fusions keep on chip is counted here both ways;
- **collective wire bytes** by the reference's ring model
  (``_collective_wire_bytes``), keyed by its names in :data:`COLLECTIVES`:
  ``_c10d_functional`` collectives (what DTensor's redistributions
  dispatch), ``c10d`` collectives, and ``c10d.recv_`` (the counterpart of
  ``collective-permute``: ``batch_isend_irecv`` dispatches
  ``c10d.send``/``c10d.recv_``, and the bytes a device receives are
  counted once, at the receive).  The group size is read from the op's
  own group;
- **memory**: the bytes of live storages, argument, output and alias bytes
  (outputs that share an argument's storage: a cache or a parameter
  updated in place) and the live bytes at peak, with the largest tensors
  the step made (the reference's ``largest_tensors``).

A DTensor op is left to DTensor (the mode returns ``NotImplemented``),
whose local ops and collectives then come back to the mode: every count is
a rank's local one.  The ops DTensor's sharding propagation runs to infer
an output's shape (on meta tensors, or on fake ones under a fake mode) and
any op on ``meta`` tensors are not counted: pass real or fake tensors,
never meta ones.  Eager
dispatch runs every loop iteration, so no trip count is needed
(``n_ops`` counts the ops).  An op the mode cannot classify raises.

No counterpart: ``normalize_cost_analysis``, ``cpu_bf16_promotion_bytes``
and its ``_serving`` variant read XLA:CPU artefacts (its cost-analysis
map, its f32 work copies of bf16 loop buffers) that a torch step does not
have.
"""
from __future__ import annotations

import dataclasses
import sys
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
LARGEST = 25                      # the largest tensors kept (hlo.largest_tensors' top)

aten = torch.ops.aten

# FLOPs: the reference's dot class, each op with its lhs's position
_MATMUL = {aten.mm.default: 0, aten.addmm.default: 1, aten.bmm.default: 0,
           aten.baddbmm.default: 1}
# metadata and allocation: no work launched
_NO_WORK = {"prim::device", "aten::sym_size", "aten::sym_stride", "aten::sym_numel",
            "aten::sym_storage_offset", "aten::is_same_size", "aten::empty",
            "aten::empty_strided", "aten::empty_like", "aten::new_empty",
            "aten::new_empty_strided", "aten::is_nonzero", "aten::_has_same_storage_numel",
            "aten::set_", "aten::resize_", "aten::record_stream", "aten::is_pinned",
            "_c10d_functional::wait_tensor", "_c10d_functional::_wrap_tensor_autograd"}
# a gather reads the rows it takes (operand 0 is the table)
_GATHERS = {"aten::index", "aten::_unsafe_index", "aten::index_select", "aten::gather",
            "aten::embedding", "aten::take"}
# an indexed write in place (operand 0 the destination): the rows written
_INDEXED_WRITES = {"aten::index_put_", "aten::_index_put_impl_", "aten::index_copy_",
                   "aten::index_add_", "aten::scatter_", "aten::scatter_add_",
                   "aten::scatter_reduce_", "aten::masked_scatter_"}
# collectives -> the reference's kind (None: counted at the other end)
_COLLECTIVE_OPS = {
    "_c10d_functional::all_gather_into_tensor": "all-gather",
    "_c10d_functional::all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional::all_reduce": "all-reduce",
    "_c10d_functional::all_reduce_": "all-reduce",
    "_c10d_functional::all_reduce_coalesced": "all-reduce",
    "_c10d_functional::reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional::reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional::all_to_all_single": "all-to-all",
    "c10d::allgather_": "all-gather",
    "c10d::_allgather_base_": "all-gather",
    "c10d::allgather_into_tensor_coalesced_": "all-gather",
    "c10d::allreduce_": "all-reduce",
    "c10d::allreduce_coalesced_": "all-reduce",
    "c10d::reduce_scatter_": "reduce-scatter",
    "c10d::_reduce_scatter_base_": "reduce-scatter",
    "c10d::reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "c10d::alltoall_": "all-to-all",
    "c10d::alltoall_base_": "all-to-all",
    "c10d::recv_": "collective-permute",
    "c10d::recv_any_source_": "collective-permute",
    "c10d::send": None,               # counted at the receiving device
}


@dataclasses.dataclass
class StepCost:
    """Per-device counts of one step: ``HloCost``'s fields, ``n_ops`` in
    place of its loop counts, and the memory of the step."""

    flops: float = 0.0
    bytes_hbm: float = 0.0
    collective_bytes: dict = dataclasses.field(default_factory=dict)
    collective_ops: list = dataclasses.field(default_factory=list)
    n_ops: int = 0
    argument_bytes: int = 0
    output_bytes: int = 0
    alias_bytes: int = 0
    peak_bytes: int = 0           # live bytes at peak, the arguments included
    largest_tensors: list = dataclasses.field(default_factory=list)
    ops: list = dataclasses.field(default_factory=list)   # (op, flops, bytes) with record_ops

    @property
    def total_collective_bytes(self):
        return sum(self.collective_bytes.values())

    @property
    def temp_bytes(self) -> int:
        """Live bytes at peak beyond the arguments and the outputs."""
        return max(self.peak_bytes - (self.argument_bytes + self.output_bytes
                                      - self.alias_bytes), 0)


def _tensors(tree) -> list:
    """Every tensor of a tree of arguments (dicts, lists and tuples), a
    DTensor as its local shard."""
    from torch.distributed.tensor import DTensor
    out = []
    if isinstance(tree, DTensor):
        return [tree.to_local()]
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for t in tree:
            out += _tensors(t)
    return out


def _storage(t: torch.Tensor):
    st = t.untyped_storage()
    return st._cdata, st


def _distinct_bytes(t: torch.Tensor) -> int:
    """The bytes an operand holds: an expanded (stride 0) dim counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_size(args) -> int:
    """The size of a collective's group: a ``c10d`` op takes the group
    object (boxed), a ``_c10d_functional`` one its registered name, last."""
    import torch.distributed as dist
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(a).size()
            except RuntimeError:            # another object (a ReduceOp)
                continue
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(next(a for a in reversed(args) if isinstance(a, str))).size()


# c10d's collectives that take (outputs, inputs, group, ...); the others
# take (tensors, group, ...), written in place
_C10D_OUT_IN = {"c10d::allgather_", "c10d::_allgather_base_",
                "c10d::allgather_into_tensor_coalesced_", "c10d::reduce_scatter_",
                "c10d::_reduce_scatter_base_", "c10d::reduce_scatter_tensor_coalesced_",
                "c10d::alltoall_", "c10d::alltoall_base_"}


def _collective_bytes(base: str, args, flat_in, flat_out) -> tuple[float, float]:
    """(input bytes, output bytes) of one device's part of a collective."""
    if base in _C10D_OUT_IN:
        return (sum(map(_nbytes, _tensors(args[1]))), sum(map(_nbytes, _tensors(args[0]))))
    if base.startswith("c10d::"):
        b = sum(map(_nbytes, _tensors(args[0])))
        return b, b
    return sum(map(_nbytes, flat_in)), sum(map(_nbytes, flat_out))


def _wire_bytes(kind: str, g: int, in_bytes: float, out_bytes: float) -> float:
    """Per-device bytes crossing links (ring model): the reference's
    ``_collective_wire_bytes``."""
    if g <= 1:
        return 0.0
    if kind == "all-gather":
        return out_bytes * (g - 1) / g
    if kind == "all-reduce":
        return 2.0 * out_bytes * (g - 1) / g
    if kind in ("reduce-scatter", "all-to-all"):
        return in_bytes * (g - 1) / g
    return out_bytes                      # collective-permute


def _is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


def _on_meta(tensors) -> bool:
    return any(t.device.type == "meta" and not _is_fake(t) for t in tensors)


def _in_sharding_propagation() -> bool:
    """Whether the op was dispatched by DTensor's sharding propagation,
    which runs an op on meta or fake tensors of its global shapes to learn
    its output's (shape inference, not the step's work)."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith("_sharding_prop.py"):
            return True
        f = f.f_back
    return False


class CostMode(TorchDispatchMode):
    """Counts the ops dispatched under it into :attr:`cost` (a
    :class:`StepCost`).  ``arguments``: the step's arguments, whose
    storages are live from the start; ``num_devices``: the devices of the
    step's mesh (a collective over more raises: each group size is read
    from the op).  ``record_ops``: keep each counted op
    as ``(name, flops, bytes)`` in ``cost.ops``.  On fake tensors a host
    read (``.item()``, ``float(t)``) gets 0 of the tensor's dtype: a fake
    tensor has no value."""

    def __init__(self, arguments=(), *, num_devices: int = 1, record_ops: bool = False):
        super().__init__()
        self.cost = StepCost()
        self.num_devices, self.record_ops = num_devices, record_ops
        self._live: dict = {}          # storage key -> bytes
        self._live_bytes = 0
        self._finalizers: list = []
        self._arg_keys: set = set()
        for t in _tensors(arguments):
            key, st = _storage(t)
            if key not in self._live:
                self._track(key, st)
                self._arg_keys.add(key)
        self.cost.argument_bytes = self.cost.peak_bytes = self._live_bytes

    # -- memory -------------------------------------------------------------------
    def _track(self, key, st) -> None:
        n = st.nbytes()
        self._live[key] = n
        self._live_bytes += n
        self._finalizers.append(weakref.finalize(st, self._free, key))

    def _free(self, key) -> None:
        self._live_bytes -= self._live.pop(key, 0)

    def _allocated(self, name: str, outs) -> None:
        for t in outs:
            key, st = _storage(t)
            if key not in self._live:
                self._track(key, st)
                if len(self.cost.largest_tensors) < LARGEST or \
                        st.nbytes() > self.cost.largest_tensors[-1][0]:
                    self.cost.largest_tensors.append((st.nbytes(), name, tuple(t.shape),
                                                      str(t.dtype)))
                    self.cost.largest_tensors.sort(key=lambda r: -r[0])
                    del self.cost.largest_tensors[LARGEST:]
        self.cost.peak_bytes = max(self.cost.peak_bytes, self._live_bytes)

    def outputs(self, result) -> None:
        """Record the step's result: its output bytes, and the alias bytes
        of those that share an argument's storage."""
        seen = set()
        for t in _tensors(result):
            key, st = _storage(t)
            if key in seen:
                continue
            seen.add(key)
            self.cost.output_bytes += st.nbytes()
            if key in self._arg_keys:
                self.cost.alias_bytes += st.nbytes()

    def close(self) -> None:
        """Stop tracking: later frees no longer touch this object."""
        for f in self._finalizers:
            f.detach()
        self._finalizers.clear()

    # -- dispatch ------------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented      # its local ops come back here
        flat_in = [a for a in tree_flatten((args, kwargs))[0] if isinstance(a, torch.Tensor)]
        if _on_meta(flat_in) or _in_sharding_propagation():
            return func(*args, **kwargs)
        if func is aten._local_scalar_dense.default and _is_fake(args[0]):
            dt = args[0].dtype
            out = False if dt == torch.bool else 0.0 if dt.is_floating_point else 0
        else:
            out = func(*args, **kwargs)
        flat_out = [o for o in tree_flatten(out)[0] if isinstance(o, torch.Tensor)]
        self._count(func, args, flat_in, flat_out)
        self._allocated(func.name(), flat_out)
        return out

    def _count(self, func, args, flat_in, flat_out) -> None:
        name = func.name()
        base = name.split(".")[0]
        cost = self.cost
        cost.n_ops += 1
        flops = 0.0
        nbytes = 0.0
        if base in _COLLECTIVE_OPS:
            kind = _COLLECTIVE_OPS[base]
            if kind is not None:
                in_b, out_b = _collective_bytes(base, args, flat_in, flat_out)
                g = _group_size(args)
                if g > self.num_devices:
                    raise ValueError(f"{name} over {g} ranks in a step on "
                                     f"{self.num_devices} devices")
                b = _wire_bytes(kind, g, in_b, out_b)
                cost.collective_bytes[kind] = cost.collective_bytes.get(kind, 0.0) + b
                cost.collective_ops.append((name, kind, tuple(flat_in[0].shape), b))
        elif base in _NO_WORK or _is_view(func):
            pass
        elif func in _MATMUL:
            # 2 * output elements * the contracted dim (the lhs's last)
            flops = 2.0 * flat_out[0].numel() * args[_MATMUL[func]].shape[-1]
            nbytes = sum(_distinct_bytes(t) for t in flat_in) + sum(map(_nbytes, flat_out))
        elif base == "aten::convolution":
            w, out = args[1], flat_out[0]
            flops = 2.0 * out.numel() * (w.numel() / max(w.shape[0], 1))
            nbytes = sum(_distinct_bytes(t) for t in flat_in) + _nbytes(out)
        elif base in _GATHERS:
            got = sum(map(_nbytes, flat_out))
            nbytes = sum(_distinct_bytes(t) for t in flat_in[1:]) + 2 * got
        elif base in _INDEXED_WRITES:
            rest = flat_in[1:]
            vals = _distinct_bytes(rest[-1]) if rest else 0
            nbytes = sum(_distinct_bytes(t) for t in rest) + vals
        elif base.split("::")[0] in ("aten", "prims"):
            nbytes = sum(_distinct_bytes(t) for t in flat_in) + sum(map(_nbytes, flat_out))
        else:
            raise NotImplementedError(f"CostMode cannot classify {name}")
        cost.flops += flops
        cost.bytes_hbm += nbytes
        if self.record_ops:
            cost.ops.append((name, flops, nbytes))


def _is_view(func) -> bool:
    """Whether every result of ``func`` aliases an input without writing
    it: a view, or ``detach``/``alias``."""
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None and not r.alias_info.is_write
                              for r in rets)


def analyze_step(fn, *args, num_devices: int = 1, record_ops: bool = False) -> StepCost:
    """Run ``fn(*args)`` once under a :class:`CostMode` and return its
    :class:`StepCost` (the reference's ``analyze_hlo_text``): per-device
    FLOPs, HBM bytes, collective wire bytes and memory.  ``args`` are real
    or fake tensors (or trees of them), on a mesh as DTensors or not."""
    mode = CostMode(args, num_devices=num_devices, record_ops=record_ops)
    try:
        with mode:
            out = fn(*args)
        mode.outputs(out)
    finally:
        mode.close()
    return mode.cost
