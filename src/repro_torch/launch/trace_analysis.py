"""Collective-traffic accounting from a ``torch.profiler`` trace
(counterpart of :mod:`repro.launch.hlo_analysis`: there is no HLO on the
card, so the trace of the run is read instead).

:func:`collective_bytes` sums the per-device wire bytes of every
collective and point-to-point op in the trace with the reference's ring
cost models:

  all_gather        (n-1)/n · result_bytes  = (n-1) · input_bytes
  reduce_scatter    (n-1)/n · operand_bytes
  all_reduce        2·(n-1)/n · operand_bytes     (reduce-scatter + all-gather)
  all_to_all        (n-1)/n · operand_bytes
  broadcast, send   operand_bytes           (the reference's collective-permute)
  recv              0                       (the sender counts the bytes)

Where the records are depends on the backend.  NCCL (and a gloo
build that has them) writes ``record_param_comms`` events whose
arguments carry the collective's name, its dtype, the input and output
element counts and the group size; those are read when the trace has
any.  Otherwise the backend's own annotations are read (``gloo:all_gather``
and the like, with ``record_shapes=True``: the input's dims and C++ type
name), which do not carry the group: ``n_devices`` stands in for it, as
the reference's parser takes its device count where an op has no
``replica_groups``.

``trace`` is a ``torch.profiler.profile`` that has stopped, the path of a
trace it exported (``export_chrome_trace``) or that trace's JSON as a
dict.  :func:`op_histogram` counts the trace's device kernels by name.

:class:`StepTally` reads a run as it dispatches instead (the dry run's
accounting, :mod:`repro_torch.launch.dryrun`, where the fake process
group and ``FakeTensorMode`` leave no trace to read): below DTensor, on
one rank's local tensors, it counts the operations of every op with a
``torch.utils.flop_counter`` formula (``FlopCounterMode``'s own, the
port's kernels' included), each op's input and output bytes, every
collective with the cost model above (the ops ``CommDebugMode`` counts,
with each one's group size and payload), and the live bytes of the
storages the run makes, and their peak.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import weakref
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# Bytes an element, by the names the records use: ScalarType names
# (record_param_comms) and C++ type names (the backends' annotations).
_DTYPE_BYTES = {
    "bool": 1, "byte": 1, "char": 1, "signed char": 1, "unsigned char": 1,
    "float8_e4m3fn": 1, "float8_e5m2": 1, "c10::float8_e4m3fn": 1, "c10::float8_e5m2": 1,
    "short": 2, "short int": 2, "half": 2, "bfloat16": 2, "c10::half": 2,
    "c10::bfloat16": 2, "int": 4, "float": 4, "long": 8, "long int": 8,
    "long long": 8, "double": 8, "complexfloat": 8, "c10::complex<float>": 8,
}

# what a record's name contains → the op it is
_KEYS = (("allgather", "all_gather"), ("reducescatter", "reduce_scatter"),
         ("allreduce", "all_reduce"), ("alltoall", "all_to_all"),
         ("broadcast", "broadcast"), ("send", "send"), ("recv", "recv"))


@dataclasses.dataclass
class CollectiveOp:
    op: str                 # all_gather, reduce_scatter, all_reduce, all_to_all,
                            # broadcast, send or recv
    wire_bytes: float       # per device, by the cost model above
    group_size: int
    dtype: str
    payload_bytes: int      # the input's bytes on this device


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_op: Dict[str, float]
    count_by_op: Dict[str, int]
    payload_by_op: Dict[str, int]
    total_wire_bytes: float
    ops: List[CollectiveOp]


def _op_name(name: str):
    key = name.lower().replace("_", "").replace("-", "").replace(" ", "")
    for k, op in _KEYS:
        if k in key:
            return op
    return None


def _dtype_bytes(name: str) -> int:
    key = str(name).strip().lower()
    if key not in _DTYPE_BYTES:
        raise ValueError(f"a collective on an element type the accounting does not "
                         f"know: {name!r}")
    return _DTYPE_BYTES[key]


def wire_bytes(op: str, n: int, in_bytes: int, out_bytes: int) -> float:
    """The cost model above, for one op over a group of ``n``."""
    if op == "all_gather":
        return (n - 1) / n * out_bytes
    if op in ("reduce_scatter", "all_to_all"):
        return (n - 1) / n * in_bytes
    if op == "all_reduce":
        return 2 * (n - 1) / n * in_bytes
    if op in ("broadcast", "send"):
        return float(in_bytes)
    return 0.0


def load_trace(trace: Any) -> Dict[str, Any]:
    """The trace's JSON (see the module's note on ``trace``)."""
    if isinstance(trace, dict):
        return trace
    if isinstance(trace, (str, os.PathLike)):
        with open(trace) as f:
            return json.load(f)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        trace.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)
    finally:
        os.unlink(path)


def _numel(dims) -> int:
    """Elements of a shape, or of the first shape of a tensor list's."""
    if dims and isinstance(dims[0], list):
        return _numel(dims[0])
    n = 1
    for d in dims:
        n *= int(d)
    return n


def _from_param_comms(args: Dict[str, Any], n_devices: int):
    op = _op_name(str(args.get("Collective name", "")))
    if op is None:
        return None
    size = _dtype_bytes(args["dtype"])
    n = int(args.get("Group size") or n_devices)
    # the input's elements, from the first input's dims where a record
    # lacks the count
    in_n = args.get("In msg nelems")
    if in_n is None:
        in_n = _numel((args.get("Input Dims") or [[]])[0])
    in_b = int(in_n) * size
    out_b = int(args.get("Out msg nelems", in_n)) * size
    return CollectiveOp(op, wire_bytes(op, n, in_b, out_b), n, str(args["dtype"]), in_b)


def _from_annotation(name: str, args: Dict[str, Any], n_devices: int):
    op = _op_name(name.split(":", 1)[1])
    dims, types = args.get("Input Dims") or [], args.get("Input type") or []
    if op is None or not dims or not types:
        return None
    in_b = _numel(dims[0]) * _dtype_bytes(types[0])
    n = n_devices
    out_b = n * in_b if op == "all_gather" else in_b
    return CollectiveOp(op, wire_bytes(op, n, in_b, out_b), n, str(types[0]), in_b)


def collective_bytes(trace: Any, n_devices: int) -> CollectiveStats:
    events = load_trace(trace).get("traceEvents", [])
    comms = [e for e in events if e.get("name") == "record_param_comms"]
    found: List[CollectiveOp] = []
    if comms:
        found = [_from_param_comms(e.get("args", {}), n_devices) for e in comms]
    else:
        found = [_from_annotation(e["name"], e.get("args", {}), n_devices)
                 for e in events
                 if str(e.get("name", "")).startswith(("gloo:", "nccl:"))
                 and e.get("cat") == "user_annotation"]
    ops = [o for o in found if o is not None]
    bytes_by_op: Dict[str, float] = defaultdict(float)
    count_by_op: Dict[str, int] = defaultdict(int)
    payload_by_op: Dict[str, int] = defaultdict(int)
    for o in ops:
        bytes_by_op[o.op] += o.wire_bytes
        count_by_op[o.op] += 1
        payload_by_op[o.op] += o.payload_bytes
    return CollectiveStats(dict(bytes_by_op), dict(count_by_op), dict(payload_by_op),
                           float(sum(bytes_by_op.values())), ops)


def op_histogram(trace: Any, top: int = 20) -> List[Tuple[str, int]]:
    """The trace's device kernels counted by name, most frequent first."""
    counts: Dict[str, int] = defaultdict(int)
    for e in load_trace(trace).get("traceEvents", []):
        if e.get("cat") == "kernel":
            counts[e["name"]] += 1
    return sorted(counts.items(), key=lambda kv: -kv[1])[:top]


# ---------------------------------------------------------------------------
# accounting of a run as it dispatches
# ---------------------------------------------------------------------------

# collective ops by their names in the functional (``_c10d_functional``) and
# the process-group (``c10d``) namespaces → (the op, the argument that is
# its input)
_FUNCTIONAL = {
    "all_gather_into_tensor": "all_gather", "all_gather_into_tensor_out": "all_gather",
    "all_gather_into_tensor_coalesced": "all_gather",
    "reduce_scatter_tensor": "reduce_scatter", "reduce_scatter_tensor_out": "reduce_scatter",
    "reduce_scatter_tensor_coalesced": "reduce_scatter",
    "all_reduce": "all_reduce", "all_reduce_": "all_reduce",
    "all_reduce_coalesced": "all_reduce", "all_reduce_coalesced_": "all_reduce",
    "all_to_all_single": "all_to_all", "broadcast": "broadcast", "broadcast_": "broadcast",
}
_C10D = {
    "allreduce_": ("all_reduce", 0), "allreduce_coalesced_": ("all_reduce", 0),
    "allgather_": ("all_gather", 1), "_allgather_base_": ("all_gather", 1),
    "allgather_into_tensor_coalesced_": ("all_gather", 1),
    "reduce_scatter_": ("reduce_scatter", 1), "_reduce_scatter_base_": ("reduce_scatter", 1),
    "reduce_scatter_tensor_coalesced_": ("reduce_scatter", 1),
    "alltoall_": ("all_to_all", 1), "alltoall_base_": ("all_to_all", 1),
    "broadcast_": ("broadcast", 0), "send": ("send", 0), "recv_": ("recv", 0),
}


def _tensor_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(t) for t in x)
    return 0


def _group_size(args, kwargs) -> Optional[int]:
    import torch.distributed as dist

    for a in (*args, *kwargs.values()):
        if isinstance(a, str):
            try:
                return dist.distributed_c10d._resolve_process_group(a).size()
            except (RuntimeError, ValueError, KeyError):
                continue
        if isinstance(a, torch.ScriptObject) and hasattr(a, "size"):
            return int(a.size())
    return None


def collective_op(func, args, kwargs) -> Optional[CollectiveOp]:
    """The collective an op of the dispatcher is, with its wire bytes by
    the cost model above, or None for any other op."""
    ns, name = func.namespace, func._schema.name.split("::")[-1]
    if ns == "_c10d_functional" and name in _FUNCTIONAL:
        op, src = _FUNCTIONAL[name], args[0]
    elif ns == "c10d" and name in _C10D:
        op, i = _C10D[name]
        src = args[i]
    else:
        return None
    n = _group_size(args, kwargs) or 1
    in_b = _tensor_bytes(src)
    out_b = n * in_b if op == "all_gather" else in_b
    first = src[0] if isinstance(src, (list, tuple)) and src else src
    while isinstance(first, (list, tuple)) and first:
        first = first[0]
    dtype = str(first.dtype).replace("torch.", "") if isinstance(first, torch.Tensor) else "?"
    return CollectiveOp(op, wire_bytes(op, n, in_b, out_b), n, dtype, in_b)


# shape and layout queries, which do no work
_QUERIES = frozenset(getattr(torch.ops.aten, n).default for n in (
    "is_contiguous", "is_strides_like_format", "is_non_overlapping_and_dense", "size",
    "sym_size", "stride", "sym_stride", "storage_offset", "sym_storage_offset", "numel",
    "sym_numel", "dim")) | {torch.ops.aten.is_contiguous.memory_format,
                            torch.ops.prim.layout.default, torch.ops.prim.device.default}

# The CUDA caching allocator hands out blocks in multiples of 512 bytes.
CUDA_BLOCK_BYTES = 512


class StepTally(TorchDispatchMode):
    """One rank's accounting of the ops run while it is active (see the
    module's note).  It lets DTensor's ops through to their local ops
    (``NotImplemented`` for a DTensor, as ``MemTracker`` does), and it
    counts only the ops of the fake mode active when it was entered
    (none for real tensors), and none of DTensor's sharding propagation
    (global-shape fake tensors that stand for no rank's work).

    * ``flops``: ``torch.utils.flop_counter``'s formula of every op that
      has one, ops without one decomposed first as ``FlopCounterMode``
      decomposes them, so the two count alike;
    * ``bytes_accessed``: each op's input and output tensors' bytes,
      views and collectives left out: an upper bound that assumes no
      fusion;
    * ``collectives``: :class:`CollectiveOp` records, as
      :func:`collective_bytes` gives them for a trace;
    * ``peak_bytes``: the largest sum of the live storages the run made
      (each counted once, from the op that made it to the moment it is
      freed; storages :meth:`hold` was given are not the run's), in
      :data:`CUDA_BLOCK_BYTES` blocks on ``"cuda"``;
    * ``peak_top`` (with ``top`` > 0): the ``top`` largest storages live at
      that peak, each ``{"bytes", "op", "at"}``: the op that made it and
      the innermost frame of the port's code that called it (a
      diagnostic: it walks the stack at every op).
    """

    def __init__(self, device_type: str = "cuda", top: int = 0):
        super().__init__()
        from torch.utils.weak import WeakIdKeyDictionary

        self.top = top
        self.peak_top: List[Dict[str, Any]] = []
        self._live: Dict[int, Dict[str, Any]] = {}
        self._op = ""
        self.block = CUDA_BLOCK_BYTES if device_type == "cuda" else 1
        self.flops = 0
        self.bytes_accessed = 0
        self.collectives: List[CollectiveOp] = []
        self.live_bytes = 0
        self.peak_bytes = 0
        self._known = WeakIdKeyDictionary()
        self._entry = None
        self._depth = 0
        self._quiet = 0

    def storage_bytes(self, st) -> int:
        n = st.nbytes()
        return -(-n // self.block) * self.block

    def tensor_bytes(self, tensors) -> int:
        """The bytes of the plain tensors of a tree (DTensors by their
        local shards), each tensor's own extent in whole blocks (a shard
        that views a larger tensor counts as its own allocation would)."""
        n = (t.numel() * t.element_size() for t in _plain(tensors))
        return sum(-(-b // self.block) * self.block for b in n)

    def hold(self, tensors) -> int:
        """Mark the storages of ``tensors`` (a tree) as the run's
        arguments, not its own; returns :meth:`tensor_bytes`."""
        for t in _plain(tensors):
            self._known.setdefault(t.untyped_storage(), None)
        return self.tensor_bytes(tensors)

    def _track(self, out) -> None:
        for t in _plain(out):
            if t.device.type == "meta":      # shapes alone: no memory
                continue
            st = t.untyped_storage()
            if st in self._known:
                continue
            n = self.storage_bytes(st)
            self._known[st] = n
            self.live_bytes += n
            key = id(st)
            if self.top:
                self._live[key] = {"bytes": n, "op": self._op, "at": _port_frame()}
            if self.live_bytes > self.peak_bytes and self.top:
                self.peak_top = sorted(self._live.values(), key=lambda r: -r["bytes"])[:self.top]
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._free, n, key)

    def _free(self, n: int, key: int) -> None:
        self.live_bytes -= n
        self._live.pop(key, None)

    def __enter__(self):
        from torch._guards import active_fake_mode
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        if self._depth == 0:
            # DTensor derives an op's global output shape by running the op
            # on global fake tensors, under the fake mode it finds active:
            # none of that is the rank's work
            self._entry = active_fake_mode()
            self._propagate = ShardingPropagator._propagate_tensor_meta_non_cached
            propagate, tally = self._propagate, self

            def quiet(prop, *args, **kwargs):
                tally._quiet += 1
                try:
                    return propagate(prop, *args, **kwargs)
                finally:
                    tally._quiet -= 1

            ShardingPropagator._propagate_tensor_meta_non_cached = quiet
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        self._depth -= 1
        if self._depth == 0:
            ShardingPropagator._propagate_tensor_meta_non_cached = self._propagate
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._guards import active_fake_mode
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        if func in _QUERIES or self._quiet or active_fake_mode() is not self._entry:
            return func(*args, **kwargs)
        packet = func._overloadpacket
        coll = collective_op(func, args, kwargs)
        if coll is None and packet not in flop_registry:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        if func is torch.ops._c10d_functional.wait_tensor.default:
            # a real wait returns its input; the fake one a new tensor
            return args[0] if self._entry is not None else func(*args, **kwargs)
        out = func(*args, **kwargs)
        self._op = str(packet)
        if coll is not None:
            self.collectives.append(coll)
        else:
            if packet in flop_registry:
                self.flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
            if not func.is_view:
                self.bytes_accessed += _tensor_bytes(list(_plain((args, kwargs, out))))
        self._track(out)
        return out

    def collective_stats(self) -> CollectiveStats:
        bytes_by_op: Dict[str, float] = defaultdict(float)
        count_by_op: Dict[str, int] = defaultdict(int)
        payload_by_op: Dict[str, int] = defaultdict(int)
        for o in self.collectives:
            bytes_by_op[o.op] += o.wire_bytes
            count_by_op[o.op] += 1
            payload_by_op[o.op] += o.payload_bytes
        return CollectiveStats(dict(bytes_by_op), dict(count_by_op), dict(payload_by_op),
                               float(sum(bytes_by_op.values())), list(self.collectives))


def _port_frame() -> str:
    """``file:line function`` of the innermost frame of the port's model,
    distributed or kernel code on the stack (the launch and training
    harness left out)."""
    import traceback

    for f in reversed(traceback.extract_stack()):
        if "repro_torch" in f.filename and "/launch/" not in f.filename:
            return f"{f.filename.split('repro_torch/')[-1]}:{f.lineno} {f.name}"
    return "?"


def _plain(tree):
    """The plain tensors of a tree of tuples, lists and dicts, each
    DTensor by its local shard."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, DTensor):
        yield tree._local_tensor
    elif isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _plain(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _plain(v)
