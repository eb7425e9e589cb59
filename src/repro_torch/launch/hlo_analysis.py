"""Cost analyzer: FLOPs, bytes and collective bytes of one eager step, per
rank (the port of ``repro.launch.hlo_analysis``).

PyTorch has no HLO text.  `CostRecorder` is a ``TorchDispatchMode`` that
records the aten ops and the c10d collectives that one eager step
dispatches, with the reference's cost model:

  * dots (every op of ``torch.utils.flop_counter.flop_registry``: mm, bmm,
    addmm, baddbmm, convolutions, attention) count their formula's FLOPs,
    ``2*numel(out)*K`` for a matmul; elementwise, reduce, sort and
    gather/scatter ops count ``numel(out)``;
  * bytes are operands plus outputs for each op that computes.  Views and
    factories of uninitialised memory are free, so a slice reads the slice
    and not the buffer; a gather reads and writes its output (2x out); a
    write into a slice of a larger tensor (``copy_``/``index_put_``) counts
    2x the update, as the reference bills a dynamic-update-slice;
  * collectives are sized per wire over the size g of their process group:
    all-gather moves (g-1)/g of its output, reduce-scatter (g-1)/g of its
    input, all-reduce 2(g-1)/g, all-to-all (g-1)/g, permute and broadcast
    1x.  ``wait_tensor`` is free.

Counted per rank: an op whose operands are ``DTensor``s is not recorded at
that level — the mode returns ``NotImplemented``, DTensor runs the op on
its local shards (and the collectives of any redistribution), and those
local ops are what the recorder sees.  Inside a ``local_map`` body the ops
are local already.  So no op is counted both at its global and its local
shape.  The global-shape ops that DTensor's sharding propagation runs under
a fake mode of its own are not recorded either.

Loops: eager runs every layer, so an L-layer model counts L layers.  A time
scan that repeats one body (the Mamba scans) may run the body once inside
`CostRecorder.repeat`, which multiplies its cost — and that of the
autograd nodes it creates, when the backward runs them — by the trip count,
and lists ``(name, trips)`` in ``while_trips``, as the reference multiplies
a ``while`` body.  `active_recorder` is None unless a recorder is active,
so the hook is off everywhere else.

The reference's HLO parsing (``parse_hlo``, ``Instruction``,
``Computation``, ``_trip_count``, ``_fusion_bytes`` ...) has no input here
and no counterpart.  ``temp_size`` (`CostRecorder.peak_bytes`) is the peak
of the bytes of the storages made during the step, which the step's
outputs count toward: eager has no buffer assignment.
"""
from __future__ import annotations

import contextlib
import contextvars
import weakref
from collections import defaultdict
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

_DTYPE_BYTES = {
    torch.bool: 1, torch.int8: 1, torch.uint8: 1, torch.int16: 2,
    torch.uint16: 2, torch.bfloat16: 2, torch.float16: 2,
    torch.float8_e4m3fn: 1, torch.float8_e5m2: 1, torch.int32: 4,
    torch.uint32: 4, torch.float32: 4, torch.int64: 8, torch.uint64: 8,
    torch.float64: 8, torch.complex64: 8, torch.complex128: 16,
}

COLLECTIVE_OPS = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute", "collective-broadcast", "ragged-all-to-all",
)

# op name (without namespace and overload) -> the reference's collective
_COLLECTIVE_OF = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-broadcast", "broadcast_": "collective-broadcast",
    "send": "collective-permute", "recv_": "collective-permute",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd",
                          "c10d", "_dtensor")
# in-place c10d ops: (output argument, input argument)
_C10D_OUT_IN = {
    "allreduce_": (0, 0), "allreduce_coalesced_": (0, 0),
    "broadcast_": (0, 0), "_allgather_base_": (0, 1), "allgather_": (0, 1),
    "allgather_into_tensor_coalesced_": (0, 1),
    "allgather_coalesced_": (0, 1), "_reduce_scatter_base_": (0, 1),
    "reduce_scatter_": (0, 1), "reduce_scatter_tensor_coalesced_": (0, 1),
    "alltoall_base_": (0, 1), "alltoall_": (0, 1), "send": (0, 0),
    "recv_": (0, 0),
}

# ops that move data and do no math (the reference's copy/transpose/
# concatenate/broadcast/iota class: bytes only)
_MOVE_OPS = frozenset({
    "clone", "contiguous", "cat", "stack", "repeat", "repeat_interleave",
    "constant_pad_nd", "pad", "flip", "roll", "zeros", "zeros_like", "ones",
    "ones_like", "full", "full_like", "fill", "fill_", "zero_", "arange",
    "scalar_tensor", "lift_fresh_copy", "new_zeros", "new_ones", "new_full",
    "tril", "triu", "_unsafe_index", "narrow_copy", "masked_fill",
    "masked_fill_", "randn", "rand", "randint", "normal_", "uniform_",
    "copy", "slice_scatter", "select_scatter", "index_copy",
})
# uninitialised memory and metadata: free
_FREE_OPS = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "detach", "lift_fresh", "alias", "wait_tensor", "_to_copy_noop",
    "resize_", "set_", "_local_scalar_dense", "sym_size", "sym_stride",
    "sym_numel", "sym_storage_offset", "is_same_size",
})
# ``torch.tensor(...)`` made inside a step: a real tensor lifted to a fake
_LIFT_OPS = frozenset({"lift_fresh", "lift_fresh_copy"})
# gathers: read and write their output (2x out), numel(out) operations
_GATHER_OPS = frozenset({
    "index", "index_select", "gather", "embedding", "take", "take_along_dim",
    "_embedding_bag", "scatter", "scatter_add", "scatter_reduce", "index_add",
    "index_put", "embedding_dense_backward", "index_select_backward",
    "scatter_", "scatter_add_", "index_add_",
})


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * _DTYPE_BYTES.get(t.dtype, t.element_size())


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _tree_bytes(tree) -> int:
    return sum(_nbytes(t) for t in _tensors(tree))


def _group_size(args, kwargs) -> int:
    """The size of the process group a collective runs over: its
    ``group_size`` argument, its ProcessGroup, or its group name."""
    from torch.distributed import ProcessGroup
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in tree_leaves((args, kwargs)):
        if isinstance(a, ProcessGroup):
            return a.size()
        if isinstance(a, torch.ScriptObject):   # a c10d op's boxed group
            try:
                return ProcessGroup.unbox(a).size()
            except RuntimeError:
                continue
    for a in reversed(tree_leaves((args, kwargs))):
        if isinstance(a, str):
            try:
                return _resolve_process_group(a).size()
            except (ValueError, RuntimeError, KeyError):
                continue
    return 1


def _desc(name: str, ts) -> str:
    return f"{name} " + " ".join(
        f"{str(t.dtype).replace('torch.', '')}{list(t.shape)}" for t in ts)


@dataclass
class Cost:
    dot_flops: float = 0.0
    elem_flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: dict[str, float] = field(default_factory=dict)   # raw buffer
    wire_bytes: dict[str, float] = field(default_factory=dict)   # per-wire
    top_dots: list = field(default_factory=list)          # (flops, desc, mult)
    top_colls: list = field(default_factory=list)         # (bytes, desc, mult)
    top_bytes: list = field(default_factory=list)         # (bytes, desc, mult)
    while_trips: list = field(default_factory=list)       # (name, trips)

    def add(self, other: "Cost", mult: float = 1.0) -> None:
        self.dot_flops += other.dot_flops * mult
        self.elem_flops += other.elem_flops * mult
        self.bytes += other.bytes * mult
        for k, v in other.coll_bytes.items():
            self.coll_bytes[k] = self.coll_bytes.get(k, 0.0) + v * mult
        for k, v in other.wire_bytes.items():
            self.wire_bytes[k] = self.wire_bytes.get(k, 0.0) + v * mult
        self.top_dots += [(f * mult, d, m * mult) for f, d, m in other.top_dots]
        self.top_colls += [(b * mult, d, m * mult) for b, d, m in other.top_colls]
        self.top_bytes += [(b * mult, d, m * mult) for b, d, m in other.top_bytes]
        self.while_trips += other.while_trips

    @property
    def coll_total(self) -> float:
        return sum(self.coll_bytes.values())

    @property
    def wire_total(self) -> float:
        return sum(self.wire_bytes.values())


_ACTIVE = contextvars.ContextVar("repro_torch_cost_recorder", default=None)


def active_recorder() -> "CostRecorder | None":
    """The innermost active `CostRecorder`, or None: the trip-count hook of
    a time scan is on only while one records."""
    return _ACTIVE.get()


def _next_sequence_nr() -> int:
    """The autograd sequence number the next node made on this thread
    gets (nodes number up in the order the forward makes them)."""
    with torch.enable_grad():
        leaf = torch.empty(0, device="meta", requires_grad=True)
        return leaf.view(0).grad_fn._sequence_nr() + 1


class CostRecorder(TorchDispatchMode):
    """Records the cost of the ops dispatched while it is active.

    ``fake_mode``: the ``FakeTensorMode`` the step's tensors belong to, or
    None for real tensors.  With a fake mode the step runs without it on
    the mode stack: factory ops (``arange``, ``zeros`` ...) are made fake
    here, and ops that run under another fake mode (DTensor's sharding
    propagation on global shapes) pass through unrecorded."""

    def __init__(self, fake_mode=None):
        super().__init__()
        self.fake_mode = fake_mode
        self.cost = Cost()
        self.n_collectives = 0
        self.coll_out_bytes: dict[str, float] = {}
        self._mult = 1.0
        self._node_mult: list[tuple[int, int, float]] = []
        self._storages: set[int] = set()
        self.live_bytes = 0
        self.peak_bytes = 0

    def __enter__(self):
        self._token = _ACTIVE.set(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.reset(self._token)
        return super().__exit__(*exc)

    @contextlib.contextmanager
    def repeat(self, name: str, trips: int):
        """Multiply the cost of the block, and of the autograd nodes it
        makes when the backward runs them, by ``trips``."""
        outer = self._mult
        first = _next_sequence_nr()
        self._mult = outer * trips
        try:
            yield
        finally:
            self._node_mult.append((first, _next_sequence_nr() - 1,
                                    self._mult))
            self._mult = outer
            self.cost.while_trips.append((name, int(trips)))

    def _multiplier(self) -> float:
        node = torch._C._current_autograd_node()
        if node is None:
            return self._mult
        seq = node._sequence_nr()
        for lo, hi, m in self._node_mult:
            if lo <= seq < hi:
                return m
        return self._mult

    # -- live bytes ---------------------------------------------------------
    def _freed(self, key: int, n: int) -> None:
        self._storages.discard(key)
        self.live_bytes -= n

    def _track(self, ins, out) -> None:
        """Count each storage an op makes (none of its inputs holds it:
        views and in-place results are not new) until it is freed."""
        held = {id(t.untyped_storage()) for t in ins}
        for t in _tensors(out):
            st = t.untyped_storage()
            key = id(st)
            if key in held or key in self._storages:
                continue
            n = st.nbytes()
            self._storages.add(key)
            self.live_bytes += n
            weakref.finalize(st, self._freed, key, n)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    # -- dispatch -----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # count DTensor's local ops
        cur = torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE)
        if cur is not None and cur is not self.fake_mode:
            return func(*args, **kwargs)   # sharding propagation
        ins = _tensors((args, kwargs))
        if self.fake_mode is not None and cur is None and (
                not ins or func._overloadpacket.__name__ in _LIFT_OPS):
            with self.fake_mode:           # a factory op: make it fake
                out = func(*args, **kwargs)
        else:
            out = func(*args, **kwargs)
        if any(t.device.type == "meta" for t in _tensors(out)):
            return out                     # shapes only: no work, no bytes
        self._record(func, args, kwargs, out)
        self._track(ins, out)
        return out

    def _record(self, func, args, kwargs, out) -> None:
        from torch.utils.flop_counter import flop_registry
        packet = func._overloadpacket
        ns = func.namespace
        name = packet.__name__
        mult = self._multiplier()
        c = self.cost
        if ns in _COLLECTIVE_NAMESPACES:
            kind = _COLLECTIVE_OF.get(name)
            if kind is not None:
                self._collective(kind, name, ns, args, kwargs, out, mult)
            return
        if func.is_view or name in _FREE_OPS or not _tensors(out):
            return
        out_t = _tensors(out)
        out_b = sum(_nbytes(t) for t in out_t)
        out_n = sum(t.numel() for t in out_t)
        in_t = _tensors((args, kwargs))
        if packet in flop_registry:
            f = float(flop_registry[packet](*args, **kwargs, out_val=out))
            b = sum(_nbytes(t) for t in in_t) + out_b
            c.dot_flops += f * mult
            c.bytes += b * mult
            c.top_dots.append((f * mult, _desc(name, in_t[:2]), mult))
            if b > (1 << 20):
                c.top_bytes.append((b * mult, _desc(name, out_t), mult))
            return
        if name in ("copy_", "index_put_", "_index_put_impl_"):
            upd = args[1] if name == "copy_" else args[2]
            b = 2.0 * _nbytes(upd)
            c.bytes += b * mult
            if b > (1 << 20):
                c.top_bytes.append((b * mult, _desc(name, [upd]), mult))
            return
        if name in _GATHER_OPS:
            b = 2.0 * out_b
            c.bytes += b * mult
            c.elem_flops += out_n * mult
        else:
            b = sum(_nbytes(t) for t in in_t) + out_b
            c.bytes += b * mult
            if name not in _MOVE_OPS and not (
                    name == "_to_copy" and out_t[0].dtype == in_t[0].dtype):
                c.elem_flops += out_n * mult
        if b > (1 << 20):
            c.top_bytes.append((b * mult, _desc(name, out_t), mult))

    def _collective(self, kind, name, ns, args, kwargs, out, mult) -> None:
        g = max(_group_size(args, kwargs), 1)
        if ns == "c10d":
            o, i = _C10D_OUT_IN.get(name, (0, 0))
            out_bytes, in_bytes = _tree_bytes(args[o]), _tree_bytes(args[i])
        else:
            out_bytes, in_bytes = _tree_bytes(out), _tree_bytes(args[0])
        buf = max(out_bytes, in_bytes)
        if kind == "all-gather":
            wire = out_bytes * (g - 1) / g
        elif kind == "reduce-scatter":
            wire = in_bytes * (g - 1) / g
        elif kind == "all-reduce":
            wire = out_bytes * 2.0 * (g - 1) / g
        elif kind in ("all-to-all", "ragged-all-to-all"):
            wire = out_bytes * (g - 1) / g
        else:  # collective-permute / broadcast
            wire = out_bytes
        c = self.cost
        self.coll_out_bytes[kind] = \
            self.coll_out_bytes.get(kind, 0.0) + out_bytes * mult
        c.coll_bytes[kind] = c.coll_bytes.get(kind, 0.0) + buf * mult
        c.wire_bytes[kind] = c.wire_bytes.get(kind, 0.0) + wire * mult
        c.bytes += (in_bytes + out_bytes) * mult
        shapes = " ".join(str(list(t.shape)) for t in _tensors(out))
        c.top_colls.append((wire * mult, f"{kind} {shapes} g={g}", mult))
        self.n_collectives += 1

    def analyze(self, top_k: int = 12) -> dict:
        """The reference's ``HloAnalyzer.analyze`` dict, per rank."""
        c = self.cost

        def top(entries):
            merged: dict[str, list] = defaultdict(lambda: [0.0, 0.0])
            for v, d, m in entries:
                merged[d][0] += v
                merged[d][1] += m
            return sorted(((v[0], k, v[1]) for k, v in merged.items()),
                          key=lambda t: -t[0])[:top_k]

        return {
            "dot_flops": c.dot_flops,
            "elem_flops": c.elem_flops,
            "flops": c.dot_flops + c.elem_flops,
            "bytes": c.bytes,
            "coll_bytes": dict(c.coll_bytes),
            "coll_bytes_total": c.coll_total,
            "wire_bytes": dict(c.wire_bytes),
            "wire_bytes_total": c.wire_total,
            "top_dots": [{"flops": f, "desc": d, "count": m}
                         for f, d, m in top(c.top_dots)],
            "top_collectives": [{"wire_bytes": b, "desc": d, "count": m}
                                for b, d, m in top(c.top_colls)],
            "top_bytes": [{"bytes": b, "desc": d, "count": m}
                          for b, d, m in top(c.top_bytes)],
            "while_trips": c.while_trips[:64],
        }


def analyze_step(step, *args, fake_mode=None, top_k: int = 12,
                 **kwargs) -> dict:
    """Run ``step(*args, **kwargs)`` once under a `CostRecorder` and return
    its `CostRecorder.analyze` dict (the counterpart of the reference's
    ``analyze_compiled``)."""
    rec = CostRecorder(fake_mode)
    with rec:
        step(*args, **kwargs)
    return rec.analyze(top_k)
