"""The JAX package's multi-device references for ``tests/test_torch_compression.py``,
``tests/test_torch_parallel.py`` and ``tests/test_torch_sharded.py``, in a process of their own: JAX sees
4 host devices only when ``XLA_FLAGS`` is set before it starts.  Jitted,
XLA fuses the residual ``g32 − q·scale`` into one rounding, where the
reference's arithmetic op by op (eager JAX, and the port's elementwise
ops) rounds the product first.  So the bitwise references of the
compressed mean run eagerly; the train step's, held to tolerances, jitted.

    python tests/_torch_parallel_jax.py IN.npz OUT.npz compression|parallel|sharded

Reads the inputs the test drew with numpy, runs the reference functions
under ``repro.compat.shard_map`` over meshes of the first 1, 2 or 4
devices, and writes every result to ``OUT.npz`` under ``/``-joined key
paths.
"""

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.compat import shard_map  # noqa: E402

GRAD_KEYS = ("a", "b", "z", "h")


def flat(tree, path=""):
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in flat(tree[key], f"{path}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, t in enumerate(tree) for k, v in flat(t, f"{path}/{i}").items()}
    return {path: np.asarray(tree)}


def unflat(flat_np, like, path=""):
    """A tree shaped like ``like`` with the leaves ``flat_np[path]``."""
    if isinstance(like, dict):
        return {k: unflat(flat_np, v, f"{path}/{k}") for k, v in like.items()}
    if isinstance(like, list):
        return [unflat(flat_np, v, f"{path}/{i}") for i, v in enumerate(like)]
    return jnp.asarray(flat_np[path])


def pod_mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("pod",))


_PSUM = {}


def psum_mean_over(grads, residual, n, jit=True):
    """``compressed_psum_mean`` under ``shard_map`` over ``n`` pods, jitted
    once for each ``n`` (or eager); the trees' leaves carry a leading pod
    axis.  Returns (means, residuals), each leaf (n, ...): every pod's
    own."""
    from repro.optim.compression import compressed_psum_mean

    def body(g, r):
        g, r = jax.tree.map(lambda x: x[0], g), jax.tree.map(lambda x: x[0], r)
        m, nr = compressed_psum_mean(g, r, "pod")
        return jax.tree.map(lambda x: x[None], m), jax.tree.map(lambda x: x[None], nr)

    fn = shard_map(body, mesh=pod_mesh(n), axis_names={"pod"}, in_specs=(P("pod"), P("pod")),
                   out_specs=(P("pod"), P("pod")), check_vma=False)
    if not jit:
        return fn(grads, residual)
    if n not in _PSUM:
        _PSUM[n] = jax.jit(fn)
    return _PSUM[n](grads, residual)


def compression(inp, out):
    for n in (1, 2, 4):
        g = {k: jnp.asarray(inp[f"w{n}.grad.{k}"]) for k in GRAD_KEYS}
        g["b"] = g["b"].astype(jnp.bfloat16)
        r = {k: jnp.asarray(inp[f"w{n}.res.{k}"]) for k in GRAD_KEYS}
        m, nr = psum_mean_over(g, r, n, jit=False)
        for k in GRAD_KEYS:
            out[f"w{n}.mean.{k}"] = np.asarray(m[k].astype(jnp.float32))
            out[f"w{n}.res.{k}"] = np.asarray(nr[k])

    # the compressed step over 2 pods as the composition of the reference's
    # working parts: make_train_step_parts on each pod's slice, the
    # compressed mean under shard_map, AdamW.update
    from repro.configs.base import get_reduced
    from repro.models.model import build
    from repro.optim import adamw
    from repro.train.train_step import make_train_step_parts

    model = build(get_reduced("qwen3-1.7b"))
    opt = adamw.AdamW(adamw.AdamWConfig(lr=1e-3, warmup_steps=2, decay_steps=3))
    # the port's initial weights, drawn by the test (key paths "init/...")
    params = unflat({k[len("init"):]: v for k, v in inp.items() if k.startswith("init/")},
                    model.init(jax.random.key(0)))
    state = opt.init(params)
    residual = jax.tree.map(lambda p: jnp.zeros((2, *p.shape), jnp.float32), params)
    parts = jax.jit(make_train_step_parts(model, opt, 1))
    update = jax.jit(opt.update)
    for i in range(int(inp["step.n"])):
        tokens, targets = inp[f"step{i}.tokens"], inp[f"step{i}.targets"]
        half = tokens.shape[0] // 2
        gs, ms = [], []
        for pod in range(2):
            sl = slice(pod * half, (pod + 1) * half)
            g, m = parts(params, {"tokens": jnp.asarray(tokens[sl]),
                                  "targets": jnp.asarray(targets[sl])})
            gs.append(g)
            ms.append(m)
        stacked = jax.tree.map(lambda *x: jnp.stack(x), *gs)
        for pod in range(2):     # each pod's max |g32| (127 x its scale), and
            # the elements within NEAR code units of a rounding boundary
            g32 = flat(jax.tree.map(lambda g, r: g[pod] + r[pod], stacked, residual))
            for k, v in g32.items():
                amax = np.abs(v).max()
                u = v / (amax / np.float32(127.0) if amax > 0 else np.float32(1.0))
                out[f"step{i}.g32max{pod}{k}"] = amax
                out[f"step{i}.near{pod}{k}"] = np.abs(u - np.floor(u) - 0.5) < inp["near"]
        means, residual = psum_mean_over(stacked, residual, 2)
        params, state, om = update(params, jax.tree.map(lambda x: x[0], means), state)
        # host copies between steps: the same placement every step, so the
        # jitted functions compile once
        params, state, residual = jax.device_get((params, state, residual))
        out.update({f"step{i}.metrics/{k}": np.asarray(v) for k, v in ms[0].items()})
        out.update({f"step{i}.metrics/{k}": np.asarray(v) for k, v in om.items()})
        out.update({f"step{i}.params{k}": v for k, v in flat(params).items()})
        out.update({f"step{i}.mu{k}": v for k, v in flat(state["mu"]).items()})
        out.update({f"step{i}.nu{k}": v for k, v in flat(state["nu"]).items()})
        for pod in range(2):
            out.update({f"step{i}.res{pod}{k}": v for k, v in flat(
                jax.tree.map(lambda x: x[pod], residual)).items()})


def parallel(inp, out):
    from repro.distributed.pipeline import gpipe, reference_pipeline

    fn = lambda p, xb: jnp.tanh(xb @ p["w"])
    for n in (1, 4):
        params = {"w": jnp.asarray(inp[f"gpipe{n}.w"])}
        x = jnp.asarray(inp[f"gpipe{n}.x"])
        out[f"gpipe{n}.out"] = np.asarray(gpipe(fn, params, x, mesh=pod_mesh(n), axis="pod"))
        out[f"gpipe{n}.ref"] = np.asarray(reference_pipeline(fn, params, x))


def sharded(inp, out):
    """Every reduced arch's parameter shard shapes (``NamedSharding(mesh,
    logical_spec(...)).shard_shape``) on (data, model) = (2, 2), (1, 4)
    and (4, 1); the logical specs of a few activation axes on (2, 2); and
    expert parallelism's rank body composed eagerly (every token routed,
    each rank's experts dispatched with ``e_offset = rank·E/n`` and the
    whole call's capacity, the parts summed in f32) at n = 2 and 4."""
    import json

    from jax.sharding import NamedSharding

    from repro.configs.base import ARCH_IDS, get_reduced
    from repro.distributed.sharding import BASE_RULES, ShardingRules, logical_spec
    from repro.models import moe as jmoe
    from repro.models.transformer import abstract_model

    rules = ShardingRules(BASE_RULES)
    is_axes = lambda x: isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)
    for d, m in ((2, 2), (1, 4), (4, 1)):
        mesh = Mesh(np.array(jax.devices()[:4]).reshape(d, m), ("data", "model"))
        for arch in ARCH_IDS:
            shapes, specs = abstract_model(get_reduced(arch))
            axes = {}
            leaves, _ = jax.tree_util.tree_flatten_with_path(specs, is_leaf=is_axes)
            for path, ax in leaves:
                axes[jax.tree_util.keystr(path)] = ax
            for path, sds in jax.tree_util.tree_flatten_with_path(shapes)[0]:
                ax = axes[jax.tree_util.keystr(path)]
                key = "".join(f"/{getattr(e, 'key', getattr(e, 'idx', None))}" for e in path)
                out[f"shape.{arch}.{d}x{m}{key}"] = np.array(NamedSharding(
                    mesh, logical_spec(ax, mesh, rules)).shard_shape(sds.shape))
        if (d, m) == (2, 2):
            specs = {json.dumps(list(ax)): [list(e) if isinstance(e, tuple) else e
                                            for e in logical_spec(tuple(ax), mesh, rules)]
                     for ax in json.loads(str(inp["shard_axes"]))}
            out["shard.specs"] = np.array(json.dumps(specs))

    for arch in json.loads(str(inp["ep_archs"])):
        mcfg = get_reduced(arch).moe
        p = {k: jnp.asarray(inp[f"ep.{arch}.p.{k}"]) for k in
             ("w_router", "w_gate", "w_up", "w_down")}
        x = jnp.asarray(inp[f"ep.{arch}.x"])
        xf = x.reshape(-1, x.shape[-1])
        cap = max(8, int(xf.shape[0] * mcfg.top_k * mcfg.capacity_factor / mcfg.n_experts))
        gates, experts, aux, z = jmoe._route(xf.astype(jnp.float32), p["w_router"], mcfg.top_k)
        for n in (2, 4):
            el = mcfg.n_experts // n
            parts = [jmoe._dispatch_ffn(xf, gates, experts, *(p[k][r * el:(r + 1) * el] for k in
                                                             ("w_gate", "w_up", "w_down")),
                                        jnp.int32(r * el), cap).astype(jnp.float32)
                     for r in range(n)]
            y = sum(parts[1:], parts[0]).astype(x.dtype).reshape(x.shape)
            out[f"ep.{arch}.n{n}.y"] = np.asarray(y)
            out[f"ep.{arch}.n{n}.aux"] = np.asarray(
                mcfg.aux_coef * (aux + mcfg.z_coef / max(mcfg.aux_coef, 1e-9) * z))


if __name__ == "__main__":
    inp = dict(np.load(sys.argv[1]))
    out = {}
    {"compression": compression, "parallel": parallel, "sharded": sharded}[sys.argv[3]](inp, out)
    np.savez(sys.argv[2], **out)
    print("JAX_REFERENCE_OK")
