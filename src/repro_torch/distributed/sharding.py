"""Logical-axis sharding rules (counterpart of
:mod:`repro.distributed.sharding`, its bookkeeping half).

Every parameter dimension carries a *logical* name
(:func:`repro_torch.models.layers.with_axes`; the tree comes from
``Model.param_specs()``), and a rules table maps logical names to the
axes of a :class:`~torch.distributed.device_mesh.DeviceMesh`
(``("data", "model")``, or ``("pod", "data", "model")`` across pods:
:func:`repro_torch.launch.mesh.make_debug_mesh`).  Swapping the table
re-shards the model without touching model code.

The baseline scheme is 2-D "FSDP × TP": parameters ``embed → data`` and
``vocab/heads/mlp/experts/ssm_inner → model``; activations ``batch →
(pod, data)`` and their head and FF dimensions ``→ model``; optimizer
state inherits the parameters' layout.

:func:`logical_spec` resolves a tuple of logical names to one entry a
dimension, as ``PartitionSpec``'s entries are: a mesh axis name, a tuple
of names (the dimension split over their product), or ``None``.
:func:`param_shardings` turns those into DTensor placements (``Shard(dim)``
on each named mesh dimension, ``Replicate()`` on the others), which
:func:`place_state` places a tree with (the sharded step's state, and
:func:`repro_torch.distributed.elastic.reshard`'s host trees).

:func:`use_mesh` activates a mesh and its rules for the calling thread.
Inside it, :func:`shard` redistributes an activation (a DTensor) to the
placements of its logical axes, as the JAX package's ``shard()`` puts a
sharding constraint on it; outside it ``shard()`` is the identity, so the
model runs single-device unchanged.  :func:`logical_sharding` gives the
mesh and the placements of a tuple of logical axes.
:func:`repro_torch.train.train_step.make_train_step_sharded` is the
sharded (FSDP × TP) step that runs the model on DTensors under it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

Axes = Union[None, str, Tuple[str, ...]]

# Baseline logical→physical rules.  Values may be None (replicated), a mesh
# axis name, or a tuple of axes (dimension sharded over their product).
BASE_RULES: Dict[str, Axes] = {
    # --- activations ---
    "batch": ("pod", "data"),
    "act_seq": None,           # sequence kept whole (SP variants flip this)
    "act_embed": None,
    "act_heads": "model",
    "act_kv_heads": None,      # kv heads (GQA: few) — replicated
    "act_mlp": "model",
    "act_vocab": "model",
    "act_expert": "model",
    "act_ssm_inner": "model",
    "act_ssm_heads": "model",
    "kv_cache_seq": None,      # flipped to "model" for long-context decode
    # --- parameters ---
    "vocab": "model",
    "embed": "data",           # FSDP shard
    "heads": "model",
    "attn_flat": "model",      # flattened (H·Dh) projections (40/56-head archs)
    "kv_heads": None,
    "head_dim": None,
    "mlp": "model",
    "experts": "model",
    "expert_mlp": None,
    "kv_lora": None,
    "q_lora": None,
    "ssm_inner": "model",
    "ssm_state": None,
    "ssm_heads": "model",
    "conv_dim": None,
    "layers": None,            # stacked scan-over-layers dim
    "norm": None,
}


def axis_names(mesh) -> Tuple[str, ...]:
    """The mesh's axis names, in order."""
    return tuple(mesh.mesh_dim_names)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    table: Dict[str, Axes]

    def resolve(self, logical: Optional[str], mesh) -> Axes:
        if logical is None:
            return None
        if logical not in self.table:
            raise KeyError(f"unknown logical axis {logical!r}")
        axes = self.table[logical]
        names = axis_names(mesh)
        if axes is None:
            return None
        if isinstance(axes, str):
            return axes if axes in names else None
        # Tuple rules keep tuple form even when only one axis survives, so
        # specs compare stably across meshes with/without the 'pod' axis.
        present = tuple(a for a in axes if a in names)
        return present or None

    def override(self, **changes: Axes) -> "ShardingRules":
        t = dict(self.table)
        t.update(changes)
        return ShardingRules(t)

    def strip(self, axis: str) -> "ShardingRules":
        """Remove a mesh axis from every rule."""
        t: Dict[str, Axes] = {}
        for k, v in self.table.items():
            if v == axis:
                t[k] = None
            elif isinstance(v, tuple):
                vv = tuple(a for a in v if a != axis)
                t[k] = vv if vv else None
            else:
                t[k] = v
        return ShardingRules(t)


def logical_spec(axes: Sequence[Optional[str]], mesh, rules: ShardingRules
                 ) -> Tuple[Axes, ...]:
    """One entry a dimension: a mesh axis, a tuple of them, or ``None``;
    a tuple of one axis is that axis, as ``PartitionSpec`` keeps it."""
    entries = (rules.resolve(a, mesh) for a in axes)
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries)


def placements(spec: Sequence[Axes], mesh) -> Tuple[Any, ...]:
    """DTensor placements of a :func:`logical_spec` on ``mesh``:
    ``Shard(dim)`` on each mesh dimension that a tensor dimension names,
    ``Replicate()`` on the others.  A dimension split over a tuple of mesh
    axes takes them in the mesh's order (major to minor), as
    ``PartitionSpec`` does; another order, or one mesh axis named by two
    dimensions, raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    out: List[Any] = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        group = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in group]
        if idx != sorted(idx):
            raise ValueError(f"dimension {dim} splits over {group}, against the mesh's "
                             f"order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {names[i]!r} shards two dimensions of {spec}")
            out[i] = Shard(dim)
    return tuple(out)


# Logical axes of the model's inputs (the reference dry run's BATCH_AXES):
# the batch split over ("pod", "data"), the stubs' embeddings' widths
# whole, the decode position a replicated scalar.
BATCH_AXES: Dict[str, Tuple[Optional[str], ...]] = {
    "tokens": ("batch", "act_seq"),
    "targets": ("batch", "act_seq"),
    "media": ("batch", None, "act_embed"),
    "src_embeds": ("batch", "act_seq", "act_embed"),
    "pos": (),
}


def batch_shardings(specs: Dict[str, Any], mesh, rules: ShardingRules) -> Dict[str, Any]:
    """The placements of each model input named in ``specs`` (a dict keyed
    as :meth:`repro_torch.models.model.Model.input_specs` gives it), by
    :data:`BATCH_AXES` and ``rules``."""
    return {k: placements(logical_spec(BATCH_AXES[k], mesh, rules), mesh) for k in specs}


def param_shardings(specs: Any, mesh, rules: Optional[ShardingRules] = None) -> Any:
    """A tree of logical-axes tuples → a tree of DTensor placements."""
    from repro_torch.models.transformer import tree_map   # the models import shard()

    rules = rules or ShardingRules(BASE_RULES)
    return tree_map(lambda ax: placements(logical_spec(ax, mesh, rules), mesh), specs)


_CTX = threading.local()


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[ShardingRules] = None):
    """Activate ``mesh`` and ``rules`` (default :data:`BASE_RULES`) for
    :func:`shard` and :func:`logical_sharding` on this thread; ``mesh``
    ``None`` suspends an active one (a region that works on local
    shards)."""
    prev = getattr(_CTX, "state", None)
    _CTX.state = None if mesh is None else (mesh, rules or ShardingRules(BASE_RULES))
    try:
        yield
    finally:
        _CTX.state = prev


def _current() -> Optional[Tuple[Any, ShardingRules]]:
    return getattr(_CTX, "state", None)


def current_mesh():
    state = _current()
    return state[0] if state else None


def current_rules() -> ShardingRules:
    state = _current()
    return state[1] if state else ShardingRules(BASE_RULES)


@contextlib.contextmanager
def on_mesh(mesh, rules: Optional[ShardingRules] = None):
    """:func:`use_mesh` with DTensor's implicit replication: a plain
    tensor met beside DTensors (a constant, the rope positions) counts as
    replicated on the mesh.  What the sharded steps and the serving
    methods on a mesh run under."""
    from torch.distributed.tensor.experimental import implicit_replication

    with use_mesh(mesh, rules), implicit_replication():
        yield


def recompute_in_mesh(context_fn=None):
    """A ``torch.utils.checkpoint`` ``context_fn`` whose recompute runs
    under the mesh and rules active now (the backward of tensors on the
    card runs on autograd's own thread, which does not see this thread's
    :func:`use_mesh`), around ``context_fn``'s own pair if given; with no
    mesh active, ``context_fn`` as it is."""
    state = _current()
    if state is None:
        return context_fn

    @contextlib.contextmanager
    def both(inner):
        with use_mesh(*state), inner:
            yield

    def fn():
        fwd, rec = context_fn() if context_fn else (contextlib.nullcontext(),
                                                    contextlib.nullcontext())
        return fwd, both(rec)

    return fn


def logical_sharding(axes: Sequence[Optional[str]], mesh=None,
                     rules: Optional[ShardingRules] = None) -> Tuple[Any, Tuple[Any, ...]]:
    """``(mesh, placements)`` of a tensor whose dimensions carry the
    logical ``axes``: the given mesh and rules, else the active ones
    (:func:`use_mesh`; none active raises)."""
    if mesh is None:
        state = _current()
        if state is None:
            raise RuntimeError("logical_sharding: no mesh given and none active (use_mesh)")
        mesh, rules = state
    rules = rules or ShardingRules(BASE_RULES)
    return mesh, placements(logical_spec(axes, mesh, rules), mesh)


def shard(x, *axes: Optional[str]):
    """Redistribute the activation ``x`` (a DTensor) to the placements of
    its logical ``axes`` on the active mesh; the identity outside
    :func:`use_mesh`, and for a plain tensor (code that runs on each
    rank's own values, as expert parallelism's rank body does)."""
    from torch.distributed.tensor import DTensor

    state = _current()
    if state is None or not isinstance(x, DTensor):
        return x
    mesh, pl = logical_sharding(axes, *state)
    if tuple(x.placements) == pl:
        return x
    return x.redistribute(mesh, pl)


def from_global(t: "torch.Tensor", mesh, pl: Sequence[Any], device=None):
    """``t``, the global value every rank holds, as a DTensor with
    placements ``pl``: each rank keeps its shard, a view of ``t`` where
    that is contiguous (no copy, no communication; ``distribute_tensor``
    copies every shard), or with ``device`` its shard alone copied there
    (a host array placed on the card)."""
    from torch.distributed.tensor import DTensor

    shape, off = local_shape_and_offset(t.shape, mesh, pl)
    local = t[tuple(slice(o, o + n) for o, n in zip(off, shape))]
    if device is not None:
        local = local.to(device)
    return DTensor.from_local(local.contiguous(), mesh, pl, shape=t.shape,
                              stride=contiguous_stride(t.shape))


def local_shape_and_offset(shape: Sequence[int], mesh, pl: Sequence[Any]):
    """This rank's shard of a tensor of global ``shape`` with placements
    ``pl``: its shape and its offset in the global tensor (the rank's
    mesh coordinates are read outside any ``FakeTensorMode``)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    with unset_fake_temporarily():
        return compute_local_shape_and_global_offset(torch.Size(shape), mesh, pl)


def placed_empty(shape: Sequence[int], dtype, mesh, pl: Sequence[Any], device,
                 fill: Optional[float] = None):
    """A DTensor of global ``shape`` with placements ``pl`` whose local
    shard is made on each rank alone (``torch.empty``, or ``torch.full``
    of ``fill``): no rank holds the global value, nothing is
    communicated."""
    from torch.distributed.tensor import DTensor

    shape = torch.Size(shape)
    local, _ = local_shape_and_offset(shape, mesh, pl)
    t = (torch.empty(local, dtype=dtype, device=device) if fill is None
         else torch.full(local, fill, dtype=dtype, device=device))
    return DTensor.from_local(t, mesh, pl, shape=shape, stride=contiguous_stride(shape))


def write_slots(dst: "torch.Tensor", start: int, src: "torch.Tensor") -> None:
    """``dst[:, start:start + n] = src`` in place (``n = src.shape[1]``):
    a cache's slots written.  A DTensor ``dst`` whose slot dimension is
    split (``kv_cache_seq`` over a mesh axis) is written by each rank into
    the slots it holds, from ``src`` made whole along that dimension (no
    rank gathers the cache); a split along another dimension keeps
    ``src``'s rows as ``dst``'s.  DTensor's own slicing of a split
    dimension would write into a gathered copy."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    n = src.shape[1]
    if not isinstance(dst, DTensor):
        dst[:, start:start + n] = src
        return
    mesh, pl = dst.device_mesh, tuple(dst.placements)
    want = tuple(Replicate() if p == Shard(1) else p for p in pl)
    src = (src.redistribute(mesh, want) if isinstance(src, DTensor)
           else from_global(src, mesh, want))
    shape, off = local_shape_and_offset(dst.shape, mesh, pl)
    lo, hi = max(start, off[1]), min(start + n, off[1] + shape[1])
    if lo < hi:
        dst.to_local()[:, lo - off[1]:hi - off[1]] = src.to_local()[:, lo - start:hi - start]


def gather_fsdp(tree: Any) -> Any:
    """A layer's parameters (a tree of dicts and lists) with every DTensor
    leaf gathered over the mesh axes of the active rules' ``embed`` split
    (FSDP: ``embed → data``), its other splits (tensor parallelism over
    ``model``) kept: the reference's just-in-time weight gather.  Left to
    itself, DTensor's matmul may meet a weight split over ``data`` along
    the contracted dimension by moving the batch-split activation onto
    that split instead, which holds every rank's rows at once.  The
    identity outside :func:`use_mesh` and for plain tensors."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    state = _current()
    if state is None:
        return tree
    mesh, rules = state
    axes = rules.resolve("embed", mesh)
    if not axes:
        return tree
    names = axis_names(mesh)
    dims = {names.index(a) for a in ((axes,) if isinstance(axes, str) else axes)
            if mesh.size(names.index(a)) > 1}
    if not dims:
        return tree

    def gather(t):
        if isinstance(t, dict):
            return {k: gather(v) for k, v in t.items()}
        if isinstance(t, list):
            return [gather(v) for v in t]
        if not isinstance(t, DTensor):
            return t
        pl = tuple(Replicate() if i in dims and isinstance(p, Shard) else p
                   for i, p in enumerate(t.placements))
        return t if pl == tuple(t.placements) else t.redistribute(t.device_mesh, pl)

    return gather(tree)


def layer_at(t: "torch.Tensor", r: int) -> "torch.Tensor":
    """``t[r]``, the slice of a stacked leaf (a scanned stack's parameters
    or caches) at layer ``r``: for a DTensor whose first dimension is
    whole, a DTensor over each rank's own slice, a view (a write into it
    reaches ``t``; DTensor's own indexing would make a gathered copy)."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(t, DTensor) or any(p == Shard(0) for p in t.placements):
        return t[r]
    pl = tuple(Shard(p.dim - 1) if isinstance(p, Shard) else p for p in t.placements)
    shape = t.shape[1:]
    return DTensor.from_local(t.to_local()[r], t.device_mesh, pl, shape=shape,
                              stride=contiguous_stride(shape))


def copy_into(dst: "torch.Tensor", src: "torch.Tensor") -> None:
    """``dst.copy_(src)``, a DTensor ``src`` first placed as ``dst`` is."""
    from torch.distributed.tensor import DTensor

    if isinstance(dst, DTensor) and isinstance(src, DTensor) and src.placements != dst.placements:
        src = src.redistribute(dst.device_mesh, dst.placements)
    dst.copy_(src)


def place_state(tree: Any, placements: Any, mesh, device=None) -> Any:
    """Each leaf of ``tree`` as a DTensor on ``mesh`` with the placements
    at its place in ``placements`` (a tree as :func:`param_shardings`
    gives): a plain tensor is the global value every rank holds (each
    keeps its shard, :func:`from_global`, on ``device`` when one is
    given), a DTensor is redistributed when it lies otherwise.  The one
    way a tree goes onto a mesh: the sharded step places its state with
    it, :func:`repro_torch.distributed.elastic.reshard` a host tree."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models.transformer import tree_map   # the models import shard()

    def place(t, pl):
        if isinstance(t, DTensor):
            return t if tuple(t.placements) == pl else t.redistribute(mesh, pl)
        return from_global(t, mesh, pl, device)

    return tree_map(place, tree, placements)


def contiguous_stride(shape: Sequence[int]) -> Tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape`` (a DTensor's global
    strides, given to ``from_local`` beside an uneven shard's shape)."""
    return torch.empty(shape, device="meta").stride()


def rows_local(fn, *xs):
    """``fn`` of DTensors that share their first dimension, row by row on
    each rank's local rows: every mesh dimension keeps a split of the
    first dimension and gathers any other (``fn`` sees whole rows), and
    each output comes back split as the first input's rows (a plain
    input is the global value, split alike).  For ops whose
    rows are independent and which DTensor cannot propagate (the
    per-token loss over a vocabulary-split logit row)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = xs[0].device_mesh
    rows = tuple(p if p == Shard(0) else Replicate() for p in xs[0].placements)
    local = [(x.redistribute(mesh, rows) if isinstance(x, DTensor)
              else from_global(x, mesh, rows)).to_local() for x in xs]
    with use_mesh(None):
        outs = fn(*local)
    n = xs[0].shape[0]

    def wrap(t):
        shape = torch.Size((n, *t.shape[1:]))
        return DTensor.from_local(t, mesh, rows, shape=shape, stride=contiguous_stride(shape))

    return tuple(wrap(t) for t in outs) if isinstance(outs, tuple) else wrap(outs)


def row_chunks(size: int, *xs) -> List[Tuple[Any, ...]]:
    """``xs`` (sharing their first dimension) cut into chunks of ``size``
    rows, one tuple a chunk.  Plain tensors are cut in order.  DTensors
    whose rows split evenly over the mesh (every input placed as the
    first) are cut on each rank's own rows: chunk ``k`` holds local rows
    ``[k·size, (k+1)·size)`` of every rank, still split as the input, so
    no rank gathers another's rows (slicing a split dimension of a
    DTensor would gather it on every rank).  The chunks hold the same
    rows as the inputs in another order: for work whose rows are
    independent (the per-token loss).  Rows that split unevenly are cut
    in order, gathered."""
    from torch.distributed.tensor import DTensor, Shard

    n = xs[0].shape[0]
    if isinstance(xs[0], DTensor):
        mesh, pl = xs[0].device_mesh, tuple(xs[0].placements)
        split = math.prod(mesh.size(i) for i, p in enumerate(pl) if p == Shard(0))
        if split > 1 and n % split == 0 and all(
                isinstance(x, DTensor) and tuple(x.placements) == pl for x in xs):
            local = [x.to_local() for x in xs]

            def wrap(x, t):
                shape = torch.Size((t.shape[0] * split, *x.shape[1:]))
                return DTensor.from_local(t, mesh, pl, shape=shape,
                                          stride=contiguous_stride(shape))

            return [tuple(wrap(x, t[i:i + size]) for x, t in zip(xs, local))
                    for i in range(0, n // split, size)]
    return [tuple(x[i:i + size] for x in xs) for i in range(0, n, size)]


@dataclasses.dataclass(frozen=True)
class BatchRows:
    """Where a rank's own rows of a DTensor lie (:func:`batch_rows`):
    ``placements`` split the first dimension over the mesh dimensions
    ``dims`` (those of the active rules' ``batch`` axes) and replicate it
    over the others; this rank's rows begin at row ``offset`` of ``n``,
    one of ``ranks`` equal or near-equal shares."""

    mesh: Any
    placements: Tuple[Any, ...]
    dims: Tuple[int, ...]
    n: int
    offset: int
    ranks: int

    def wrap(self, t: "torch.Tensor", n: Optional[int] = None) -> "torch.Tensor":
        """``t``, this rank's rows of a tensor of ``n`` rows (default the
        rows'), as a DTensor split as the rows are."""
        from torch.distributed.tensor import DTensor

        shape = torch.Size((self.n if n is None else n, *t.shape[1:]))
        return DTensor.from_local(t, self.mesh, self.placements, shape=shape,
                                  stride=contiguous_stride(shape))

    def gather(self, t: "torch.Tensor", n: Optional[int] = None) -> "torch.Tensor":
        """Every rank's rows of ``t`` (this rank's rows of a tensor of ``n``
        rows, default the rows', split as they are), in order: an
        all-gather over ``dims``.  Its backward
        keeps this rank's rows of the gradient and sends nothing, so the
        gradient of every row must be whole on the rank that owns it (work
        that depends on all rows, as the router's load-balance loss, is
        computed alike on every rank and each keeps its own rows' share)."""
        from torch.distributed.tensor import Replicate

        if self.ranks == 1:
            return t
        whole = tuple(Replicate() for _ in self.placements)
        return self.wrap(t, n).redistribute(self.mesh, whole).to_local()


def batch_rows(x: "torch.Tensor") -> Tuple["torch.Tensor", BatchRows]:
    """``x`` (a DTensor) as each rank's own rows over the batch axes
    (the active rules' ``batch``, ``("pod", "data")`` by default),
    replicated over every other mesh dimension: the local rows and where
    they lie.  A split of another dimension is gathered, a split of the
    rows over a non-batch axis too.  For model code that works on plain
    tensors of its own tokens (the MoE dispatch): its outputs go back
    through :meth:`BatchRows.wrap`."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = x.device_mesh
    axes = current_rules().resolve("batch", mesh)
    names = axis_names(mesh)
    dims = tuple(sorted(names.index(a) for a in ((axes,) if isinstance(axes, str)
                                                  else axes or ())))
    pl = tuple(Shard(0) if i in dims else Replicate() for i in range(mesh.ndim))
    if tuple(x.placements) != pl:
        x = x.redistribute(mesh, pl)
    _, off = local_shape_and_offset(x.shape, mesh, pl)
    ranks = math.prod(mesh.size(i) for i in dims)
    return x.to_local(), BatchRows(mesh, pl, dims, x.shape[0], off[0], ranks)


class _CopyToGroup(torch.autograd.Function):
    """Megatron's "copy to the model-parallel region": the identity
    forward, the gradient summed over ``group`` backward (each rank's
    gradient of a replicated input covers its own share of the work)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _SumOverGroup(torch.autograd.Function):
    """Megatron's "reduce from the model-parallel region": the parts summed
    over ``group`` forward, the gradient passed on unchanged backward
    (every rank's part enters the sum once)."""

    @staticmethod
    def forward(ctx, t, group):
        t = t.contiguous().clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(t: "torch.Tensor", group) -> "torch.Tensor":
    """``t`` unchanged; its gradient summed over ``group``.  Where each
    element's gradient is non-zero on one rank at most (a dispatch hit
    that one expert's rank serves), that sum is exact."""
    return _CopyToGroup.apply(t, group)


def sum_over_group(t: "torch.Tensor", group) -> "torch.Tensor":
    """``t`` summed over ``group`` (an all-reduce in ``t``'s dtype); the
    gradient passes unchanged.  Where every element is filled by one rank
    and is zero on the others (the weighted hit rows of the experts a rank
    holds), the sum is that rank's value bit for bit: a value plus zeros
    is exact."""
    return _SumOverGroup.apply(t, group)


def axis_size(mesh, axes: Axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    names = axis_names(mesh)
    n = 1
    for a in axes:
        if a in names:
            n *= mesh.size(names.index(a))
    return n
