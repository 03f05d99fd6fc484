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
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from collections import defaultdict
from typing import Any, Dict, List, Tuple

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
