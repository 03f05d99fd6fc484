"""What each rank of the gloo world of 4 runs for
``tests/test_torch_mesh_local.py``: no JAX here (the ranks import this
module by name).

* :func:`run_world`: on the meshes (data, model) = (2, 2), (4, 1) and
  (1, 4) of one world, the reduced MoE archs' ``moe_forward`` on
  DTensors (weights placed by the base rules, x split over ``data``)
  grouped and plain, the routed experts alone and (deepseek) the whole
  layer with its shared experts: its output, aux and gradients whole,
  and the ``(emitted tokens, routed tokens, experts, capacity)`` of every
  dispatch call each rank made; the unsharded port's in the same
  process; the refusals; then a prefill and a decode over a cache whose
  slots split over ``model`` (``kv_shard="seq"``) on (1, 4) and (2, 2):
  the logits, and whether the decode all-gathered a tensor of a cache
  leaf's local shape.  A world of 1 runs the same on the (1, 1) mesh.
  Every rank writes ``w<world>_r<rank>.npz``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.base import get_reduced
from repro_torch.distributed import sharding
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as meshlib
from repro_torch.models import attention, moe
from repro_torch.models.model import build

MESHES = ((2, 2), (4, 1), (1, 4))
MOE_ARCHS = ("deepseek-v2-lite-16b", "phi3.5-moe-42b-a6.6b")
GROUPS = (0, 4, 8)
# x (B, S, D): 4 rows split over up to 4 data ranks, 128 tokens; at
# capacity factor 1.0 the plain path's capacity (deepseek 32, phi3.5 64)
# and the groups' (8 to 16) drop hits of the random router
B, S = 4, 32
CAPACITY_FACTOR = 1.0
SEED = 11
# the decode: a prefill of PROMPT tokens into SLOTS slots, one decode at
# slot PROMPT; on (1, 4) rank 2 holds slots [16, 24), which length 19
# cuts, and rank 3 [24, 32), none valid
SERVE_ARCHS = ("qwen3-1.7b", "deepseek-v2-lite-16b")
SERVE_MESHES = ((1, 4), (2, 2))
SLOTS, PROMPT = 32, 18


def mesh_tag(dm):
    return f"{dm[0]}x{dm[1]}"


def moe_cfg(arch, groups, cfg=None):
    """The reduced config (the port's, or ``cfg``: the JAX package's) with
    ``dispatch_groups`` and :data:`CAPACITY_FACTOR`."""
    cfg = get_reduced(arch) if cfg is None else cfg
    return cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch_groups=groups,
                                               capacity_factor=CAPACITY_FACTOR))


def moe_params(arch, shared=True):
    """The MoE layer's weights (f32); with ``shared`` the shared experts
    among them where the arch has them, else the routed experts alone."""
    p = moe.init_moe(torch.Generator().manual_seed(SEED), get_reduced(arch),
                     torch.device("cpu"))
    if not shared:
        p.pop("shared", None)
    return p


def moe_inputs(arch):
    rng = np.random.default_rng(SEED)
    d = get_reduced(arch).d_model
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    cot = rng.standard_normal((B, S, d)).astype(np.float32)
    return x, cot


def _flat(p, path=""):
    if isinstance(p, dict):
        return {k: v for key in p for k, v in _flat(p[key], f"{path}/{key}").items()}
    if isinstance(p, list):
        return {k: v for i, t in enumerate(p) for k, v in _flat(t, f"{path}/{i}").items()}
    return {path: p}


def unsharded(arch, groups, shared=True):
    """The port's path without a mesh: y, aux and every gradient."""
    p = {k: v.clone().requires_grad_(True)
         for k, v in _flat(moe_params(arch, shared)).items()}
    x, cot = (torch.from_numpy(a) for a in moe_inputs(arch))
    x.requires_grad_(True)
    tree = _unflat(p)
    y, aux = moe.moe_forward(tree, x, moe_cfg(arch, groups))
    ((y * cot).sum() + aux).backward()
    out = {"y": y.detach().numpy(), "aux": aux.detach().numpy(), "grad.x": x.grad.numpy()}
    out.update({f"grad{k}": v.grad.numpy() for k, v in p.items()})
    return out


def _unflat(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        keys = path.strip("/").split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v
    return tree


def sharded(arch, groups, mesh, shared=True):
    """The same on ``mesh``: weights and x as DTensors placed by the base
    rules, the outputs and gradients whole; and each dispatch call's
    ``(emitted, routed, experts, capacity)`` on this rank."""
    cfg = moe_cfg(arch, groups)
    metas = moe.init_moe(None, cfg, torch.device("meta"))
    axes = {k: v.logical_axes for k, v in _flat(metas).items()
            if shared or not k.startswith("/shared")}
    rules = sharding.ShardingRules(sharding.BASE_RULES)
    pl = {k: sharding.placements(sharding.logical_spec(a, mesh, rules), mesh)
          for k, a in axes.items()}
    p = {k: sharding.from_global(v, mesh, pl[k]).requires_grad_(True)
         for k, v in _flat(moe_params(arch, shared)).items()}
    x, cot = (torch.from_numpy(a) for a in moe_inputs(arch))
    x_pl = sharding.placements(sharding.logical_spec(("batch", "act_seq", "act_embed"),
                                                     mesh, rules), mesh)
    xd = sharding.from_global(x, mesh, x_pl).requires_grad_(True)
    calls, real = [], moe._dispatch_rows

    def spy(xs, gates, experts, w_gate, *rest, **kw):
        calls.append((xs.shape[0], experts.shape[0], w_gate.shape[0], rest[3]))
        return real(xs, gates, experts, w_gate, *rest, **kw)

    moe._dispatch_rows = spy
    try:
        with sharding.on_mesh(mesh, rules):
            y, aux = moe.moe_forward(_unflat(p), xd, cfg)
            loss = (y * sharding.from_global(cot, mesh, y.placements)).sum() + aux
            loss.full_tensor().backward()
    finally:
        moe._dispatch_rows = real
    out = {"y": y.full_tensor().detach().numpy(), "aux": aux.full_tensor().detach().numpy(),
           "grad.x": xd.grad.full_tensor().numpy(), "calls": np.array(calls)}
    out.update({f"grad{k}": v.grad.full_tensor().numpy() for k, v in p.items()})
    return out


def refusals(mesh):
    """``dispatch_groups`` not a multiple of the batch ranks (2 groups over
    4) and not a divisor of the tokens (3): their messages."""
    out = {}
    arch = MOE_ARCHS[0]
    for g in (2, 3):
        try:
            sharded(arch, g, mesh)
            out[f"refuse.g{g}"] = ""
        except ValueError as e:
            out[f"refuse.g{g}"] = str(e)
    return out


class _Gathers(TorchDispatchMode):
    """The local shapes of every all-gather's input while active."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if func is torch.ops._c10d_functional.all_gather_into_tensor.default:
            self.shapes.append(tuple(args[0].shape))
        return func(*args, **(kwargs or {}))


def serve(arch, mesh=None):
    """A prefill of PROMPT tokens into SLOTS slots and one decode at slot
    PROMPT: the prefill's last logits and the decode's, (B, 2, V); on
    ``mesh`` under ``kv_shard="seq"`` (the dry run's rules) also whether
    the decode all-gathered a tensor of a cache leaf's local shape, the
    valid slots this rank's decode attended to, and whether every cache
    leaf's slots are split."""
    from torch.distributed.tensor import Shard

    cfg = get_reduced(arch).replace(remat=False)
    model = build(cfg)
    params = model.init(SEED, device="cpu")
    rng = np.random.default_rng(SEED + 1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, size=(B, PROMPT + 1)).astype(np.int32))
    prompt, nxt = toks[:, :-1], toks[:, -1:]
    if mesh is None:
        caches = model.init_cache(B, SLOTS, device="cpu")
        lp, caches = model.prefill(params, {"tokens": prompt}, caches)
        ld, _ = model.decode_step(params, caches, nxt, PROMPT)
        return {"logits": torch.cat([lp, ld], dim=1).numpy()}
    shape = dryrun.cell_shape("decode_32k", dryrun.parser().parse_args(
        ["--batch", str(B), "--seq", str(SLOTS)]))
    opts = dryrun.parser().parse_args(["--kv-shard", "seq", "--device", "cpu"])
    rules = dryrun.make_rules(shape, mesh, opts)
    _, specs = model.abstract()
    with sharding.on_mesh(mesh, rules):
        p = sharding.place_state(params, sharding.param_shardings(specs, mesh, rules), mesh)
        pl = sharding.batch_shardings({"tokens": None}, mesh, rules)["tokens"]
        caches = model.init_cache(B, SLOTS, device="cpu")
        lp, caches = model.prefill(p, {"tokens": sharding.from_global(prompt, mesh, pl)}, caches)
        slots, real = [], (attention._decode_scores, attention._mla_scores)

        def gqa(q, k, v):
            slots.append(k.shape[1])
            return real[0](q, k, v)

        def mla(q_c, q_pe, c_kv, k_pe, scale):
            slots.append(c_kv.shape[1])
            return real[1](q_c, q_pe, c_kv, k_pe, scale)

        attention._decode_scores, attention._mla_scores = gqa, mla
        try:
            with _Gathers() as seen:
                ld, _ = model.decode_step(p, caches, sharding.from_global(nxt, mesh, pl), PROMPT)
        finally:
            attention._decode_scores, attention._mla_scores = real
    leaves = list(_flat(caches).values())
    local = {tuple(t.to_local().shape) for t in leaves}
    return {"logits": torch.cat([lp.full_tensor(), ld.full_tensor()], dim=1).numpy(),
            "gathered_cache": np.bool_(any(s in local for s in seen.shapes)),
            "slots": np.array(sorted(set(slots))),
            "split": np.bool_(all(Shard(1) in t.placements for t in leaves))}


def _moe_cases(out, mesh, tag, unsharded_too):
    for arch in MOE_ARCHS:
        variants = (False, True) if "shared" in moe_params(arch) else (False,)
        for shared in variants:
            for g in GROUPS:
                key = f"{arch}.{'layer' if shared else 'routed'}.g{g}"
                out.update({f"{tag}.{key}.{k}": v
                            for k, v in sharded(arch, g, mesh, shared).items()})
                if unsharded_too:
                    out.update({f"plain.{key}.{k}": v
                                for k, v in unsharded(arch, g, shared).items()})


def run_world(rank, world, out_dir):
    """Each rank of the gloo world of 4 (or of 1: the (1, 1) mesh alone)."""
    torch.set_num_threads(1)
    out = {}
    meshes = MESHES if world == 4 else ((1, 1),)
    for i, dm in enumerate(meshes):
        mesh = meshlib.make_debug_mesh(*dm)
        _moe_cases(out, mesh, mesh_tag(dm), i == 0)
        if dm == (4, 1):
            out.update(refusals(mesh))
    for dm in (SERVE_MESHES if world == 4 else ((1, 1),)):
        mesh = meshlib.make_debug_mesh(*dm)
        for arch in SERVE_ARCHS:
            out.update({f"serve.{mesh_tag(dm)}.{arch}.{k}": v
                        for k, v in serve(arch, mesh).items()})
    for arch in SERVE_ARCHS:
        out.update({f"serve.none.{arch}.{k}": v for k, v in serve(arch).items()})
    np.savez(f"{out_dir}/w{world}_r{rank}.npz", **out)
