"""What a step costs one device: matmul flops, memory traffic, collectives
and live bytes, counted op by op as the step runs.

Port of ``src/repro/analysis/hlocost.py`` (``parse_hlo_cost``), of the
per-op accounting of ``collective_bytes_from_hlo`` and of the reference's
``compiled.memory_analysis()`` (``src/repro/launch/dryrun.py:323-331``).
The reference reads them from the optimized HLO of a compiled step; torch
has no such artifact, so ``CostCounter``, a ``TorchDispatchMode``, sees
every aten op the step dispatches, on fake tensors, ``meta`` tensors or
real CUDA tensors alike:

* ``matmul_flops`` — for every ``mm``, ``addmm``, ``bmm``, ``baddbmm``
  (what ``einsum``, ``matmul`` and ``linear`` lower to) and convolution:
  2 * prod(result dims) * prod(contracted dims), the reference's rule
  (``hlocost.py:3-9``).  Elementwise flops are left out, as there.
* ``traffic_bytes`` — operand bytes + result bytes of every op that
  touches memory.  Eager runs one kernel an op, so this is the eager HBM
  model, as "a fusion's operands/results are exactly its HBM traffic" is
  XLA's; it sits above XLA's count, which fuses chains of elementwise ops
  into one pass.  Views, aliases and other metadata ops (``view``,
  ``detach``, ``t``, ``permute``, ``expand``, every op whose schema
  returns a view), allocations without a write (``empty``) and the waits
  of collectives are skipped, the counterpart of ``_SKIP_TRAFFIC``
  (``hlocost.py:38``).  An in-place op counts its destination as read and
  written.
* ``collectives`` — each functional collective (what DTensor issues when
  it redistributes) as (kind, result bytes, group size), the kinds named
  as HLO names them; ``analysis.roofline.collective_bytes`` turns them
  into wire bytes.
* ``peak_bytes`` — the most bytes live at once: the storages of the
  tensors ``track`` was given (the step's arguments) and of every op's
  results, each counted from its op until its storage is freed, and the
  buffers a softmax backward holds while it runs on the card
  (``_TRANSIENT``: the one kernel-internal allocation found to matter).
  ``memory()`` gives the reference's ``memory`` dict.

An opaque op (``op``): a kernel launched through ``ctypes`` never
reaches the dispatcher, so its wrapper reports its own flops and bytes,
and the ops inside the region (the plain version's, on the CPU) are not
counted; their results' storages still are.  ``decode_attn`` is one such
op (``kernels/ops.py``).  With no counter active the hook is one list
test.

Ops that DTensor runs to plan (its sharding propagation's fake global
ops, its redistribution planner's arithmetic) are not the step's work and
are not counted: the counter is told when one runs.  On a CPU mesh
DTensor would stand an all-gather and a chunk in for an all-to-all; the
counter has it take its all-to-all op (``_patch_alltoall``).  A DTensor op
itself is passed on to DTensor, so the counter sees the local ops and
collectives of device ``rank`` (device (0, 0) of a fake group's mesh).
"""
from __future__ import annotations

import contextlib
import weakref
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakIdKeyDictionary

__all__ = ["CostCounter", "ACTIVE", "op", "COLLECTIVE_KINDS"]

# counters entered and not yet left, innermost last
ACTIVE: list["CostCounter"] = []

_MATMULS = {"mm": 0, "bmm": 0, "addmm": 1, "baddbmm": 1}
_CONVS = {"convolution"}
# ops that move no bytes (beside views, which the schema names)
_NO_TRAFFIC = {
    "detach", "t", "permute", "expand", "view", "_unsafe_view", "alias",
    "lift_fresh", "empty", "empty_strided", "empty_like", "new_empty",
    "new_empty_strided", "device", "sym_size", "sym_stride", "sym_numel",
    "sym_storage_offset", "dim", "is_same_size", "_local_scalar_dense",
    "wait_tensor", "_has_compatible_shallow_copy_type", "set_",
    "resize_", "record_stream",
}
# ops whose CUDA kernel copies a non-contiguous gradient (the first
# argument) into a contiguous buffer and writes its result through a proxy
# of the output's layout: two buffers of the gradient's size while it runs
# (measured on an H100: `_softmax_backward_data` of a permuted f32
# gradient held 2 x its bytes beyond its inputs and output)
_TRANSIENT = {"_softmax_backward_data", "_log_softmax_backward_data"}
# functional collectives -> the HLO op they are
COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional", "_dtensor")


def _tensors(tree):
    """Every tensor in a (nested) list, tuple or dict, or a module's
    parameters."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_size(func, args, kwargs) -> int:
    """The size of the group a functional collective runs over."""
    schema = func._schema
    named = dict(zip((a.name for a in schema.arguments), args))
    named.update(kwargs)
    if "group_size" in named:
        return int(named["group_size"])
    name = named.get("group_name", named.get("group"))
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name).size()


def _storage_key(t: torch.Tensor):
    """The tensor's storage, or None where it has none to count (a
    subclass wrapping another tensor, a sparse tensor)."""
    try:
        return t.untyped_storage()
    except (NotImplementedError, RuntimeError):
        return None


class CostCounter(TorchDispatchMode):
    """Counts one device's matmul flops, traffic, collectives and live
    bytes while it is entered (see the module's docstring).  ``ops``
    counts every op by name; an opaque op under its own name.
    ``device``: count only the ops that touch a tensor on this device type
    (the dry run's ``"meta"``: what DTensor computes on small host tensors
    to place shards is not the step's work); None counts every op."""

    # op and its arguments' metadata -> its outputs' on ``meta`` (shapes
    # follow from metadata alone, so every counter shares them)
    _meta: dict = {}

    def __init__(self, device: str | None = None) -> None:
        super().__init__()
        self.device = device
        self.matmul_flops = 0.0
        self.traffic_bytes = 0.0
        self.collectives: list[tuple[str, int, int]] = []
        self.ops: Counter = Counter()
        self.live_bytes = 0
        self.peak_bytes = 0
        self.argument_bytes = 0
        self._live = WeakIdKeyDictionary()
        self._args = WeakIdKeyDictionary()
        self._opaque = 0
        self._propagating = 0
        self._restore = []

    # ------------------------------------------------------------ memory
    def track(self, tensors) -> int:
        """Count the storages of ``tensors`` (a tensor, a DTensor, or a
        nested list / tuple / dict of them; a module's parameters) as live
        from now on: the step's arguments.  Returns the bytes added."""
        added = 0
        for t in _tensors(tensors):
            t = _local(t)
            added += self._hold(t)
            st = _storage_key(t)
            if st is not None:
                self._args[st] = True
        self.argument_bytes += added
        return added

    def _hold(self, t: torch.Tensor) -> int:
        st = _storage_key(t)
        if st is None or st in self._live:
            return 0
        n = st.nbytes()
        self._live[st] = n
        weakref.finalize(st, self._free, n)
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        return n

    def _free(self, n: int) -> None:
        self.live_bytes -= n

    def memory(self, outputs=None) -> dict:
        """The reference's ``memory`` dict: ``argument_bytes`` (what
        ``track`` counted), ``output_bytes`` (``outputs``' storages that
        are not arguments'), ``temp_bytes`` (the peak beyond the
        arguments) and ``peak_bytes``."""
        out = 0
        seen = set()
        for t in _tensors(outputs if outputs is not None else ()):
            st = _storage_key(_local(t))
            if st is not None and id(st) not in seen and st not in self._args:
                seen.add(id(st))
                out += st.nbytes()
        return {"argument_bytes": self.argument_bytes,
                "output_bytes": out,
                "temp_bytes": self.peak_bytes - self.argument_bytes,
                "peak_bytes": self.peak_bytes}

    # --------------------------------------------------------- dispatch
    def __enter__(self):
        self._patch_propagation()
        self._patch_alltoall()
        ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            ACTIVE.remove(self)
            for undo in reversed(self._restore):
                undo()
            self._restore.clear()

    def _patch_propagation(self) -> None:
        """Mark what DTensor runs to plan rather than to compute while this
        counter is entered, so that it is not counted: the fake global ops
        of its sharding propagation
        (``ShardingPropagator._propagate_tensor_meta_non_cached``) and the
        coordinate arithmetic of its redistribution planner
        (``_redistribute._gen_transform_infos_non_cached``).  Both are
        cached by DTensor, so they would count in a process's first step
        only."""
        import sys
        dt = sys.modules.get("torch.distributed.tensor")
        if dt is None:
            return
        self._mark(dt.DTensor._op_dispatcher.sharding_propagator,
                   "_propagate_tensor_meta_non_cached")
        self._mark(sys.modules["torch.distributed.tensor._redistribute"],
                   "_gen_transform_infos_non_cached")

    def _mark(self, owner, name: str) -> None:
        """Wrap ``owner.name`` so that the ops it runs are not counted,
        until this counter is left."""
        inner = getattr(owner, name, None)
        if inner is None:
            return

        def marked(*args, **kwargs):
            self._propagating += 1
            try:
                return inner(*args, **kwargs)
            finally:
                self._propagating -= 1

        setattr(owner, name, marked)
        self._restore.append(lambda: setattr(owner, name, inner))

    def _patch_alltoall(self) -> None:
        """A CPU mesh has no all-to-all in gloo, so DTensor redistributes
        Shard(i) -> Shard(j) on it by an all-gather and a chunk
        (``_collective_utils.shard_dim_alltoall``), which moves a group's
        size times the bytes.  The fake group has no data to move either
        way: while this counter is entered DTensor takes its all-to-all
        op, as it does on a card's group."""
        import sys
        cu = sys.modules.get("torch.distributed.tensor._collective_utils")
        if cu is None or not hasattr(cu, "local_tensor_mode"):
            return
        inner = cu.local_tensor_mode
        cu.local_tensor_mode = lambda: True
        self._restore.append(lambda: setattr(cu, "local_tensor_mode", inner))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(getattr(t, "__name__", "") == "DTensor" for t in types):
            return NotImplemented    # DTensor runs it; its local ops come back
        out = self._run(func, args, kwargs)
        if self._propagating or (self.device is not None and not any(
                t.device.type == self.device
                for t in _tensors([args, kwargs, out]))):
            return out
        for t in _tensors(out):
            self._hold(t)
        packet = func._overloadpacket.__name__
        if packet in _TRANSIENT and not args[0].is_contiguous():
            # held while the op runs, beside its inputs and output
            self.peak_bytes = max(self.peak_bytes,
                                  self.live_bytes + 2 * _nbytes(args[0]))
        if self._opaque or func.namespace == "prim":   # prim: metadata
            return out
        self.ops[packet] += 1
        if packet in _MATMULS:
            a = args[_MATMULS[packet]]
            self.matmul_flops += 2.0 * out.numel() * a.shape[-1]
        elif packet in _CONVS:
            from torch.utils.flop_counter import conv_flop_count
            self.matmul_flops += conv_flop_count(
                args[0].shape, args[1].shape, out.shape,
                transposed=bool(args[6]) if len(args) > 6 else False)
        kind = COLLECTIVE_KINDS.get(packet)
        if kind is not None and func.namespace in _COLLECTIVE_NAMESPACES:
            self.collectives.append((kind, _nbytes(next(_tensors(out))),
                                     _group_size(func, args, kwargs)))
        if packet in _NO_TRAFFIC or func.is_view:
            return out
        self.traffic_bytes += sum(_nbytes(t) for t in _tensors(args)) + sum(
            _nbytes(t) for t in _tensors(kwargs)) + sum(
            _nbytes(t) for t in _tensors(out))
        return out

    def _run(self, func, args, kwargs):
        """``func(*args, **kwargs)``; on ``meta`` tensors an op that writes
        no input and returns new tensors gets them from the shapes its last
        call with the same arguments' metadata returned (a meta kernel's
        only work; most are Python, and a step repeats its layers' ops)."""
        key = _meta_key(func, args, kwargs)
        if key is None:
            return func(*args, **kwargs)
        hit = self._meta.get(key)
        if hit is not None:
            made = [torch.empty_strided(shape, stride, dtype=dtype,
                                        device="meta")
                    for shape, stride, dtype in hit[1]]
            return made[0] if hit[0] is None else hit[0](made)
        out = func(*args, **kwargs)
        outs = [out] if isinstance(out, torch.Tensor) else out
        if isinstance(outs, (list, tuple)) and all(
                type(t) is torch.Tensor for t in outs):
            self._meta[key] = (None if isinstance(out, torch.Tensor)
                               else type(out),
                               [(t.shape, t.stride(), t.dtype)
                                for t in outs])
        return out

    # -------------------------------------------------------- opaque ops
    @contextlib.contextmanager
    def opaque(self, name: str, work):
        """Count one op ``name``; ``work()`` gives its (matmul flops,
        bytes) and is called inside the region.  The ops run inside are not
        counted (their results' storages are)."""
        self._opaque += 1
        try:
            flops, nbytes = work()
            self.ops[name] += 1
            self.matmul_flops += flops
            self.traffic_bytes += nbytes
            yield
        finally:
            self._opaque -= 1


def _sig(x):
    """A hashable stand-in for an op argument: a plain ``meta`` tensor by
    its metadata; None for anything else the cache does not take."""
    if isinstance(x, torch.Tensor):
        if type(x) is not torch.Tensor or x.device.type != "meta":
            return None
        return ("T", tuple(x.shape), x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        out = tuple(_sig(y) for y in x)
        return None if any(y is None for y in out) and x else ("L", out)
    if x is None or isinstance(x, (bool, int, float, str, torch.dtype,
                                   torch.device, torch.layout,
                                   torch.memory_format)):
        return ("V", type(x).__name__, x)
    return None


def _meta_key(func, args, kwargs):
    """The cache key of an op on ``meta`` tensors that writes no input and
    returns no view, or None."""
    schema = func._schema
    if func.is_view or schema.is_mutable or any(
            r.alias_info is not None for r in schema.returns) or \
            func._overloadpacket.__name__ in _NO_TRAFFIC:
        return None      # _unsafe_view, lift_fresh: aliases no schema names
    sig = _sig(list(args) + sorted(kwargs.items()))
    if sig is None or not any(isinstance(a, torch.Tensor) for a in args):
        return None
    return func, sig


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard; any other tensor as it is."""
    local = getattr(t, "_local_tensor", None)
    return t if local is None else local


@contextlib.contextmanager
def op(name: str, work):
    """The hook of an opaque op: count it on the innermost active counter
    (``CostCounter.opaque``), or do nothing when none is active."""
    if not ACTIVE:
        yield
        return
    with ACTIVE[-1].opaque(name, work):
        yield
