"""What each rank of a gloo world runs for ``tests/test_torch_compression.py``,
``tests/test_torch_parallel.py`` and ``tests/test_torch_sharded.py``.

The worlds start with ``tests/_torch_dist_ranks.py:spawn_world``; the
ranks import this module by name, so it imports neither JAX nor the JAX
package.  Each rank loads the parent's npz, runs the port's functions and
writes ``<out>/<tag>_w<world>_r<rank>.npz`` for the parent to hold
against the JAX package and against the other ranks.
"""

import dataclasses
import json

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import get_reduced
from repro_torch.convert import lm_params_from_jax
from repro_torch.distributed import elastic, pipeline, sharding
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import trace_analysis
from repro_torch.models.model import build
from repro_torch.optim import adamw, compression
from repro_torch.train.train_step import make_sharded_parts, make_train_step_compressed

GRAD_KEYS = ("a", "b", "z", "h")
STEP_ARCH = "qwen3-1.7b"


def flat(tree, path=""):
    """``{path: leaf}`` of a tree of dicts and lists (a tuple is a leaf)."""
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in flat(tree[key], f"{path}/{key}").items()}
    if isinstance(tree, list):
        return {k: v for i, t in enumerate(tree) for k, v in flat(t, f"{path}/{i}").items()}
    return {path: tree}


def unflat(flat_np, like, path=""):
    """A tree shaped like ``like`` with the numpy leaves ``flat_np[path]``."""
    if isinstance(like, dict):
        return {k: unflat(flat_np, v, f"{path}/{k}") for k, v in like.items()}
    if isinstance(like, list):
        return [unflat(flat_np, v, f"{path}/{i}") for i, v in enumerate(like)]
    return flat_np[path]


def _np(t):
    return t.detach().float().cpu().numpy()


def _grads(inp, world, rank):
    g = {k: torch.from_numpy(inp[f"w{world}.grad.{k}"][rank]) for k in GRAD_KEYS}
    g["b"] = g["b"].to(torch.bfloat16)
    r = {k: torch.from_numpy(inp[f"w{world}.res.{k}"][rank]) for k in GRAD_KEYS}
    return g, r


def run_compression(rank, world, in_path, out_dir):
    inp = dict(np.load(in_path))
    out = {}
    g, r = _grads(inp, world, rank)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        mean, res = compression.compressed_psum_mean(g, r)
    stats = trace_analysis.collective_bytes(prof, world)
    out["trace.stats"] = np.array(json.dumps({
        "bytes_by_op": stats.bytes_by_op, "count_by_op": stats.count_by_op,
        "payload_by_op": stats.payload_by_op,
        "int8_wire": sum(o.wire_bytes for o in stats.ops if o.dtype == "signed char")}))
    for k in GRAD_KEYS:
        out[f"mean.{k}"] = _np(mean[k])
        out[f"mean_dtype.{k}"] = np.array(str(mean[k].dtype))
        out[f"res.{k}"] = _np(res[k])

    if world == 2 and int(inp["step.n"]):   # the compressed step on the reduced qwen3
        cfg = get_reduced(STEP_ARCH)
        model = build(cfg)
        init = {k[len("init"):]: v for k, v in inp.items() if k.startswith("init/")}
        params = lm_params_from_jax(unflat(init, model.init(0, device="cpu")), cfg,
                                    device="cpu")
        opt = adamw.AdamW(adamw.AdamWConfig(lr=1e-3, warmup_steps=2, decay_steps=3))
        state = opt.init(params)
        residual = compression.init_residual(params)
        step = make_train_step_compressed(model, opt, meshlib.make_debug_mesh(1, 1, n_pod=2))
        for i in range(int(inp["step.n"])):
            batch = {"tokens": torch.from_numpy(inp[f"step{i}.tokens"]).long(),
                     "targets": torch.from_numpy(inp[f"step{i}.targets"]).long()}
            params, state, residual, m = step(params, state, residual, batch)
            out.update({f"step{i}.metrics/{k}": _np(v) for k, v in m.items()})
            for tag, tree in (("params", params), ("mu", state["mu"]), ("nu", state["nu"]),
                              ("res", residual)):
                out.update({f"step{i}.{tag}{k}": _np(v) for k, v in flat(tree).items()})
        out["step.count"] = np.int64(int(state["step"]))
        _compressed_choice(out, inp, model, cfg)
    if world == 4 and int(inp["step.n"]):   # 2 pods of 2 ranks, (data, model) = (2, 1), (1, 2)
        torch.set_num_threads(1)
        for d, m in ((2, 1), (1, 2)):
            _compressed_sharded(out, inp, meshlib.make_debug_mesh(d, m, n_pod=2), f"pdm2{d}{m}.")
    np.savez(f"{out_dir}/compression_w{world}_r{rank}.npz", **out)


def _compressed_choice(out, inp, model, cfg):
    """Pods of one rank, (pod, data, model) = (2, 1, 1): plain params take
    the plain step (they come back plain), params placed on the pod's
    (data, model) mesh take the sharded one (they come back DTensors);
    each one step from the world-2 case's weights and first batch."""
    init = {k[len("init"):]: v for k, v in inp.items() if k.startswith("init/")}
    batch = {"tokens": torch.from_numpy(inp["step0.tokens"]).long(),
             "targets": torch.from_numpy(inp["step0.targets"]).long()}
    mesh = meshlib.make_debug_mesh(1, 1, n_pod=2)
    for tag in ("plain", "placed"):
        params = lm_params_from_jax(unflat(init, model.init(0, device="cpu")), cfg,
                                    device="cpu")
        opt = adamw.AdamW(adamw.AdamWConfig(lr=1e-3, warmup_steps=2, decay_steps=3))
        state, residual = opt.init(params), compression.init_residual(params)
        if tag == "placed":
            place = make_sharded_parts(model, opt, mesh["data", "model"],
                                       sharding.ShardingRules(sharding.BASE_RULES).strip("pod"))[0]
            params, state = place(params, state)
        step = make_train_step_compressed(model, opt, mesh)
        params, state, residual, _ = step(params, state, residual, batch)
        leaves = flat(params).values()
        out[f"choice.{tag}.dtensor"] = np.array([type(v).__name__ == "DTensor" for v in leaves])
        out.update({f"choice.{tag}.params{k}": _np(v.full_tensor() if tag == "placed" else v)
                    for k, v in flat(params).items()})


def _compressed_sharded(out, inp, mesh, prefix):
    """The compressed step with each pod's gradients sharded over its
    (data, model) ranks, from the world-2 case's weights and batches; the
    state whole after each step (every rank: the gathers need them all)."""
    cfg = get_reduced(STEP_ARCH)
    model = build(cfg)
    init = {k[len("init"):]: v for k, v in inp.items() if k.startswith("init/")}
    params = lm_params_from_jax(unflat(init, model.init(0, device="cpu")), cfg, device="cpu")
    opt = adamw.AdamW(adamw.AdamWConfig(lr=1e-3, warmup_steps=2, decay_steps=3))
    state, residual = opt.init(params), compression.init_residual(params)
    step = make_train_step_compressed(model, opt, mesh)
    for i in range(int(inp["step.n"])):
        batch = {"tokens": torch.from_numpy(inp[f"step{i}.tokens"]).long(),
                 "targets": torch.from_numpy(inp[f"step{i}.targets"]).long()}
        params, state, residual, m = step(params, state, residual, batch)
        out.update({f"{prefix}step{i}.metrics/{k}": _np(v) for k, v in m.items()})
        for tag, tree in (("params", params), ("mu", state["mu"]), ("nu", state["nu"]),
                          ("res", residual)):
            out.update({f"{prefix}step{i}.{tag}{k}": _np(v.full_tensor())
                        for k, v in flat(tree).items()})
        out[f"{prefix}placed"] = np.bool_(all(type(v).__name__ == "DTensor"
                                              for v in flat(params).values()))
    out[f"{prefix}step.count"] = np.int64(int(state["step"]))


def _spec_json(mesh, rules):
    """Every logical name resolved on ``mesh`` under ``rules``."""
    return {name: list(e) if isinstance(e, tuple) else e
            for name in sharding.BASE_RULES
            for e in [rules.resolve(name, mesh)]}


def _rules_report(mesh):
    base = sharding.ShardingRules(sharding.BASE_RULES)
    rep = {"base": _spec_json(mesh, base),
           "override": _spec_json(mesh, base.override(kv_cache_seq="model", embed=None)),
           "strip_pod": _spec_json(mesh, base.strip("pod")),
           "strip_data": _spec_json(mesh, base.strip("data")),
           "spec": [list(e) if isinstance(e, tuple) else e for e in sharding.logical_spec(
               ("batch", "act_seq", "vocab", "embed", None, "norm"), mesh, base)]}
    try:
        sharding.logical_spec(("nonsense",), mesh, base)
        rep["unknown_raises"] = False
    except KeyError:
        rep["unknown_raises"] = True
    return rep


def _placed_report(state, host, specs, mesh, rules, prefix):
    """For each leaf: its full tensor bitwise the host array, and its local
    shard's shape the one its logical spec gives."""
    out = {}
    names = tuple(mesh.mesh_dim_names)
    for path, dt in flat(state).items():
        ax = sharding.logical_spec(flat(specs)[path], mesh, rules)
        want = list(host[path].shape)
        for d, e in enumerate(ax):
            if e is not None:
                want[d] //= sharding.axis_size(mesh, e)
        full = dt.full_tensor().numpy()
        out[f"{prefix}.full_equal{path}"] = np.bool_(np.array_equal(full, host[path]))
        out[f"{prefix}.local_shape{path}"] = np.array(tuple(dt.to_local().shape))
        out[f"{prefix}.want_shape{path}"] = np.array(want)
        out[f"{prefix}.mesh"] = np.array(json.dumps(
            {"names": names, "ranks": mesh.mesh.tolist()}))
    return out


def run_parallel(rank, world, in_path, out_dir):
    inp = dict(np.load(in_path))
    out = {}
    if world == 1:
        out["rules.data_model"] = np.array(json.dumps(_rules_report(
            meshlib.make_debug_mesh(1, 1))))
        out["rules.pod_data_model"] = np.array(json.dumps(_rules_report(
            meshlib.make_debug_mesh(1, 1, n_pod=1))))
    if world in (1, 4):     # GPipe over every rank of the world
        from torch.profiler import ProfilerActivity, profile

        mesh = meshlib.make_debug_mesh(1, 1, n_pod=world)
        params = {"w": torch.from_numpy(inp[f"gpipe{world}.w"])}
        x = torch.from_numpy(inp[f"gpipe{world}.x"])
        fn = lambda p, xb: torch.tanh(xb @ p["w"])
        with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
            got = pipeline.gpipe(fn, params, x, mesh=mesh, axis="pod")
        out["gpipe.out"] = got.numpy()
        out["gpipe.ref"] = pipeline.reference_pipeline(fn, params, x).numpy()
        stats = trace_analysis.collective_bytes(prof, world)
        out["gpipe.trace"] = np.array(json.dumps({
            "bytes_by_op": stats.bytes_by_op, "count_by_op": stats.count_by_op}))
    if world == 4:          # reshard onto (2, 2); survive a rank taken out
        cfg = get_reduced(STEP_ARCH)
        model = build(cfg)
        host = {k: v.numpy() for k, v in flat(model.init(0, device="cpu")).items()}
        tree = unflat(host, model.init(0, device="cpu"))
        specs = model.param_specs()
        rules = sharding.ShardingRules(sharding.BASE_RULES)
        mesh = meshlib.make_debug_mesh(2, 2)
        out.update(_placed_report(elastic.reshard(tree, specs, mesh, rules), host, specs,
                                  mesh, rules, "reshard"))
        state, smesh = elastic.survive_failure(tree, specs, [3], rules, model_parallel=2)
        out["survive.none"] = np.bool_(state is None)
        if state is not None:
            out.update(_placed_report(state, host, specs, smesh, rules, "survive"))
        out["survive.mesh"] = np.array(json.dumps(
            {"names": smesh.mesh_dim_names, "ranks": smesh.mesh.tolist()}))
    if world == 8:
        m = elastic.best_mesh_from(range(8), model_parallel=2)
        out["best.mesh"] = np.array(json.dumps(
            {"names": m.mesh_dim_names, "ranks": m.mesh.tolist()}))
        try:
            meshlib.make_production_mesh()
            out["production.raises"] = np.bool_(False)
        except ValueError:
            out["production.raises"] = np.bool_(True)
    dist.barrier()
    np.savez(f"{out_dir}/parallel_w{world}_r{rank}.npz", **out)


# ---------------------------------------------------------------------------
# tests/test_torch_sharded.py: the sharded step, shard(), expert parallelism
# ---------------------------------------------------------------------------

SHAPE_MESHES = ((2, 2), (1, 4), (4, 1))
STEP_MESHES = {2: ((1, 2), (2, 1)), 4: ((2, 2), (1, 4))}
FAMILY_ARCHS = ("deepseek-v2-lite-16b", "mamba2-1.3b", "jamba-v0.1-52b",
                "llama-3.2-vision-90b", "seamless-m4t-large-v2")
EP_ARCHS = ("phi3.5-moe-42b-a6.6b", "deepseek-v2-lite-16b")
SHARD_AXES = (("batch", "act_seq", "act_heads", None), ("batch", "act_seq", "act_embed"),
              ("act_expert", None, None), ("batch", "act_seq", "act_vocab"),
              ("vocab", "embed"))


def sharded_arch_cfg(arch):
    """The reduced config a sharded-step case trains: deepseek with expert
    parallelism (``use_shard_map``), the others as they are."""
    cfg = get_reduced(arch)
    if arch == "deepseek-v2-lite-16b":
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, use_shard_map=True))
    return cfg


def step_batch(inp, arch):
    return {k[len(f"batch.{arch}."):]: torch.from_numpy(v) for k, v in inp.items()
            if k.startswith(f"batch.{arch}.")}


def _sharded_step_case(out, inp, arch, mesh, tag, rank):
    """One sharded step from the parent's weights: the loss, every
    gradient and the parameters after AdamW, whole (rank 0 keeps them)."""
    from repro_torch.train.train_step import make_sharded_parts

    cfg = sharded_arch_cfg(arch)
    model = build(cfg)
    init = {k[len(f"init.{arch}"):]: v for k, v in inp.items() if k.startswith(f"init.{arch}/")}
    params = unflat({k: torch.from_numpy(v) for k, v in init.items()}, model.init(0, "cpu"))
    opt = adamw.AdamW(adamw.AdamWConfig(lr=1e-3, warmup_steps=2, decay_steps=3))
    place, grads_only, update = make_sharded_parts(model, opt, mesh)
    params, state = place(params, opt.init(params))
    from repro_torch.models import model as model_mod

    cut, rows = model_mod.row_chunks, []

    def spy(size, x, *rest):     # the loss's chunks: this rank's rows of them
        chunks = cut(size, x, *rest)
        rows.append((x.shape[0], sum(c[0].to_local().shape[0] for c in chunks)))
        return chunks

    model_mod.row_chunks = spy
    try:
        grads, metrics = grads_only(params, step_batch(inp, arch))
    finally:
        model_mod.row_chunks = cut
    new, _, om = update(params, grads, state)
    whole = {f"grad{k}": v.full_tensor() for k, v in flat(grads).items()}
    whole.update({f"params{k}": v.full_tensor() for k, v in flat(new).items()})
    placed = all(type(v).__name__ == "DTensor" and tuple(v.placements) == pl
                 for v, pl in zip(flat(new).values(), flat(sharding.param_shardings(
                     model.param_specs(), mesh)).values()))
    if rank == 0:
        out.update({f"{tag}.{k}": _np(v) for k, v in whole.items()})
        for k in ("loss", "aux_loss", "grad_norm"):
            v = (metrics | om)[k]
            out[f"{tag}.{k}"] = _np(v.full_tensor() if hasattr(v, "full_tensor") else v)
        out[f"{tag}.placed"] = np.bool_(placed)
        out[f"{tag}.loss_rows"] = np.array(rows)


def _ep_case(out, inp, arch, mesh, n, rank):
    """Expert parallelism over ``model`` = n with the layer's global
    weights on every rank: the output, aux and the gradients of x, the
    router and every expert weight under a fixed cotangent."""
    from repro_torch.models import moe

    cfg = get_reduced(arch)
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, use_shard_map=True))
    p = {k: torch.from_numpy(inp[f"ep.{arch}.p.{k}"]).requires_grad_(True)
         for k in ("w_router", "w_gate", "w_up", "w_down")}
    x = torch.from_numpy(inp[f"ep.{arch}.x"]).requires_grad_(True)
    with sharding.use_mesh(mesh):
        y, aux = moe.moe_forward(p, x, cfg)
    (y * torch.from_numpy(inp[f"ep.{arch}.cot"])).sum().add(aux).backward()
    if rank == 0:
        out[f"ep.{arch}.n{n}.y"] = _np(y)
        out[f"ep.{arch}.n{n}.aux"] = _np(aux)
        out[f"ep.{arch}.n{n}.grad.x"] = _np(x.grad)
        out.update({f"ep.{arch}.n{n}.grad.{k}": _np(v.grad) for k, v in p.items()})
    bad = cfg.replace(moe=dataclasses.replace(cfg.moe, n_experts=2 * n - 1))
    try:
        with sharding.use_mesh(mesh):
            moe.moe_forward(p, x, bad)
        out[f"ep.n{n}.refuses_uneven"] = np.str_("")
    except ValueError as e:
        out[f"ep.n{n}.refuses_uneven"] = np.str_(str(e))


def _precedence(out, inp, world):
    """Which path ``moe_forward`` takes for every combination of
    ``dispatch_groups`` × ``use_shard_map`` × (no mesh, a mesh without
    ``model``, a mesh with it)."""
    from repro_torch.models import moe

    arch = EP_ARCHS[0]
    p = {k: torch.from_numpy(inp[f"ep.{arch}.p.{k}"]) for k in
         ("w_router", "w_gate", "w_up", "w_down")}
    x = torch.from_numpy(inp[f"ep.{arch}.x"])
    taken = []
    plain, ep = moe._moe_plain, moe._moe_expert_parallel

    def spy_plain(p, x, m, groups):
        taken.append(f"grouped{groups}" if groups else "plain")
        return plain(p, x, m, groups)

    def spy_ep(*a):
        taken.append("expert_parallel")
        return ep(*a)

    meshes = {"none": None, "data": meshlib.make_data_mesh("cpu"),
              "model": meshlib.make_debug_mesh(1, world)}
    moe._moe_plain, moe._moe_expert_parallel = spy_plain, spy_ep
    try:
        for groups in (0, 2):
            for use in (False, True):
                for name, mesh in meshes.items():
                    cfg = get_reduced(arch)
                    cfg = cfg.replace(moe=dataclasses.replace(
                        cfg.moe, dispatch_groups=groups, use_shard_map=use))
                    with sharding.use_mesh(mesh):
                        moe.moe_forward(p, x, cfg)
                    out[f"path.g{groups}.s{int(use)}.{name}"] = np.str_(taken[-1])
    finally:
        moe._moe_plain, moe._moe_expert_parallel = plain, ep


def _placements_report(out, mesh):
    """``shard()`` outside ``use_mesh`` (the same tensor) and inside it (a
    DTensor redistributed to the placements of each axes tuple's logical
    spec; a plain tensor unchanged)."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    x = torch.arange(4 * 8 * 4 * 4, dtype=torch.float32).reshape(4, 8, 4, 4)
    out["shard.identity"] = np.bool_(sharding.shard(x, *SHARD_AXES[0]) is x)
    rep = {}
    with sharding.use_mesh(mesh):
        for axes in SHARD_AXES:
            t = x[(slice(None),) * len(axes) + (0,) * (4 - len(axes))]
            d = sharding.shard(distribute_tensor(t, mesh, [Replicate()] * 2), *axes)
            plain = sharding.shard(t, *axes) is t
            again = sharding.shard(d.redistribute(mesh, d.placements[::-1]), *axes)
            rep[json.dumps(list(axes))] = {
                "placements": [repr(pl) for pl in d.placements],
                "again": [repr(pl) for pl in again.placements],
                "whole": bool(torch.equal(d.full_tensor(), t)), "plain": plain}
        out["shard.active_mesh"] = np.bool_(sharding.current_mesh() is mesh)
    out["shard.report"] = np.array(json.dumps(rep))
    out["shard.left"] = np.bool_(sharding.current_mesh() is None)


def _row_chunks_report(out, mesh):
    """``row_chunks`` on (data, model) = (2, 2): 10 rows split over
    ``data`` cut into chunks of 2 on each rank's own rows, and 9 rows
    (uneven) cut in order."""
    from torch.distributed.tensor import Replicate, Shard

    pl = (Shard(0), Replicate())
    x = torch.arange(10 * 3, dtype=torch.float32).reshape(10, 3)
    t = torch.arange(10)
    dx, dt = (sharding.from_global(v, mesh, pl) for v in (x, t))
    chunks = sharding.row_chunks(2, dx, dt)
    out["rows.placements"] = np.bool_(all(tuple(c.placements) == pl
                                          for ch in chunks for c in ch))
    out["rows.local"] = np.concatenate([ch[0].to_local().numpy() for ch in chunks])
    out["rows.own"] = dx.to_local().numpy()
    out["rows.whole_x"] = np.concatenate([ch[0].full_tensor().numpy() for ch in chunks])
    out["rows.whole_t"] = np.concatenate([ch[1].full_tensor().numpy() for ch in chunks])
    uneven = sharding.row_chunks(2, *(sharding.from_global(v[:9], mesh, pl) for v in (x, t)))
    out["rows.uneven_x"] = np.concatenate([ch[0].full_tensor().numpy() for ch in uneven])


def _cli_resume(out, out_dir, rank):
    """``launch/train.py --mesh 2x2`` in the world: 4 steps, and a run
    stopped by SIGTERM (every rank) after 2 and resumed to 4 from rank 0's
    checkpoint; the losses and the whole parameters and moments."""
    import signal

    from repro_torch.data.tokens import TokenStream
    from repro_torch.launch import train as launch_train

    argv = ["--arch", STEP_ARCH, "--reduced", "--device", "cpu", "--mesh", "2x2",
            "--steps", "4", "--batch", "4", "--seq", "16", "--ckpt-every", "2"]
    whole = launch_train.run(argv + ["--ckpt-dir", f"{out_dir}/cli_whole"])
    fetch = TokenStream.__next__

    def sigterm_at_batch_1(stream):     # a preemption: step 2 ends, then a save
        if stream.position == 1:
            signal.raise_signal(signal.SIGTERM)
        return fetch(stream)

    TokenStream.__next__ = sigterm_at_batch_1
    try:
        cut = launch_train.run(argv + ["--ckpt-dir", f"{out_dir}/cli_cut"])
    finally:
        TokenStream.__next__ = fetch
    resumed = launch_train.run(argv + ["--ckpt-dir", f"{out_dir}/cli_cut", "--resume"])
    out["cli.steps"] = np.array([cut.summary["step"], resumed.summary["step"],
                                 whole.summary["step"]])
    out["cli.losses"] = np.array([cut.losses + resumed.losses, whole.losses])
    for tag, run in (("whole", whole), ("resumed", resumed)):
        state = {"params": run.trainer.params, "mu": run.trainer.opt_state["mu"]}
        out.update({f"cli.{tag}{k}": _np(v.full_tensor()) for k, v in flat(state).items()})
        out[f"cli.{tag}.placed"] = np.bool_(all(type(v).__name__ == "DTensor"
                                                for v in flat(state).values()))


def run_sharded(rank, world, in_path, out_dir):
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    from repro_torch.configs.base import ARCH_IDS

    torch.set_num_threads(1)
    inp = dict(np.load(in_path))
    out = {}
    if world == 4:
        meshes = {dims: meshlib.make_debug_mesh(*dims) for dims in SHAPE_MESHES}
        for arch in ARCH_IDS:
            shapes, specs = build(get_reduced(arch)).abstract()
            for dims, mesh in meshes.items():
                pls = flat(sharding.param_shardings(specs, mesh))
                for k, t in flat(shapes).items():
                    local, _ = compute_local_shape_and_global_offset(t.shape, mesh, pls[k])
                    out[f"shape.{arch}.{dims[0]}x{dims[1]}{k}"] = np.array(local)
        _placements_report(out, meshes[(2, 2)])
        _row_chunks_report(out, meshes[(2, 2)])
        for arch in FAMILY_ARCHS:
            _sharded_step_case(out, inp, arch, meshes[(2, 2)], f"step.{arch}.2x2", rank)
        _cli_resume(out, out_dir, rank)
    for dims in STEP_MESHES[world]:
        mesh = meshlib.make_debug_mesh(*dims)
        _sharded_step_case(out, inp, STEP_ARCH, mesh, f"step.{STEP_ARCH}.{dims[0]}x{dims[1]}",
                           rank)
    ep_mesh = meshlib.make_debug_mesh(1, world)
    for arch in EP_ARCHS:
        _ep_case(out, inp, arch, ep_mesh, world, rank)
    if world == 2:
        _precedence(out, inp, world)
    dist.barrier()
    np.savez(f"{out_dir}/sharded_w{world}_r{rank}.npz", **out)
