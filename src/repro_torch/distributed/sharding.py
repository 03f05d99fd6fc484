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
:func:`repro_torch.distributed.elastic.reshard` places a tree with.

``use_mesh`` (the active mesh and rules), ``shard()`` on activations
inside model code, ``logical_sharding`` and the sharded (FSDP × TP)
train step wait for ROADMAP A8 item 5's second half.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.models.transformer import tree_map

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


def param_shardings(specs: Any, mesh, rules: Optional[ShardingRules] = None) -> Any:
    """A tree of logical-axes tuples → a tree of DTensor placements."""
    rules = rules or ShardingRules(BASE_RULES)
    return tree_map(lambda ax: placements(logical_spec(ax, mesh, rules), mesh), specs)


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
