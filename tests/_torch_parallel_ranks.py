"""What each rank of a gloo world runs for ``tests/test_torch_compression.py``
and ``tests/test_torch_parallel.py``.

The worlds start with ``tests/_torch_dist_ranks.py:spawn_world``; the
ranks import this module by name, so it imports neither JAX nor the JAX
package.  Each rank loads the parent's npz, runs the port's functions and
writes ``<out>/<tag>_w<world>_r<rank>.npz`` for the parent to hold
against the JAX package and against the other ranks.
"""

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
from repro_torch.train.train_step import make_train_step_compressed

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
        try:    # a pod of two ranks (data = 2) needs the sharded step
            make_train_step_compressed(model, opt, meshlib.make_debug_mesh(2, 1, n_pod=1))
            out["step.refuses_sharded_pod"] = np.bool_(False)
        except NotImplementedError:
            out["step.refuses_sharded_pod"] = np.bool_(True)
    np.savez(f"{out_dir}/compression_w{world}_r{rank}.npz", **out)


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
