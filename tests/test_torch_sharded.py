"""The sharded (FSDP × TP) train step, ``shard()``, MoE expert parallelism,
``scan_layers=False`` and ``Model.input_specs`` against the JAX package
and against the port's own unsharded path.

Gloo worlds of 2 and 4 CPU ranks are spawned once for the module
(``tests/_torch_dist_ranks.py:spawn_world``), each rank running
``tests/_torch_parallel_ranks.py:run_sharded``; JAX's references that need
4 devices (``NamedSharding.shard_shape``, ``logical_spec`` on a 2 × 2 mesh)
and the expert-parallel rank body composed eagerly run in one subprocess
(``tests/_torch_parallel_jax.py ... sharded``).  JAX's own sharded step and
its ``shard_map`` expert parallelism fail on this JAX version ("can only
refer to Auto axes", "pass sharding to ``jnp.repeat`` via
``out_sharding``"), so the sharded step is held to the port's unsharded
step, which ``tests/test_torch_lm_train.py`` holds to JAX.

Tolerances, stated once:
* shard shapes, placements and the path taken: exact;
* the sharded step against the unsharded one (f32, sums split over the
  ranks in another order): the loss within ``rtol=1e-6``; every gradient
  leaf within ``1e-5`` of its max|g|; the parameters after one AdamW step
  within ``1e-5`` absolute, 1% of the step's ``lr``, except where the
  gradient is within ``1e-3`` of its leaf's max|g| of zero: AdamW's
  first step moves an element by ``lr · g/(|g| + eps)``, whose sign and
  size such a gradient's rounding sets, so there only the step's own
  bound, ``2 · lr``, holds;
* expert parallelism's output against JAX's rank body: ``1e-5`` of
  max|y| (f32 products in another order); its aux within ``rtol=1e-6``;
  its gradients against the port's single-device path within ``1e-5`` of
  each leaf's max (a gradient scaled by n would be off by ``(n−1)·max``);
* ``scan_layers=False`` against JAX: the loss within ``rtol=1e-5``, the
  last-token logits within ``1e-4`` of their max; against the port's
  scanned model on the same weights: bitwise.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

import _torch_dist_ranks as dist_ranks
import _torch_parallel_ranks as ranks
from repro.configs import base as jbase
from repro.models.model import build as jbuild
from repro_torch.configs.base import ARCH_IDS, SHAPES, Shape, get_reduced
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.models.model import build
from repro_torch.optim import adamw
from repro_torch.train.train_step import grads_of

WORLDS = (2, 4)
GROUP_TIMEOUT_S = 120.0
JAX_SCRIPT = Path(__file__).with_name("_torch_parallel_jax.py")
SEED = 7
GRAD_TOL = 1e-5
PARAM_ATOL = 1e-5
NEAR_ZERO = 1e-3
LR = 1e-3
EP_TOL = 1e-5


def _batch(cfg, rng, B=4, S=16):
    toks = rng.integers(0, cfg.vocab, size=(B, S + 1))
    out = {"tokens": toks[:, :-1].astype(np.int64), "targets": toks[:, 1:].astype(np.int64)}
    if cfg.family == "vlm":
        out["media"] = rng.standard_normal((B, cfg.n_media_tokens, cfg.d_model)).astype(
            np.float32)
    if cfg.family == "audio":
        out["src_embeds"] = rng.standard_normal((B, 12, cfg.d_model)).astype(np.float32)
    return out


def _draws():
    rng = np.random.default_rng(SEED)
    inp = {"shard_axes": np.array(json.dumps(ranks.SHARD_AXES)),
           "ep_archs": np.array(json.dumps(ranks.EP_ARCHS))}
    for arch in (ranks.STEP_ARCH, *ranks.FAMILY_ARCHS):
        cfg = ranks.sharded_arch_cfg(arch)
        params = build(cfg).init(SEED, device="cpu")
        inp.update({f"init.{arch}{k}": v.numpy() for k, v in ranks.flat(params).items()})
        inp.update({f"batch.{arch}.{k}": v for k, v in _batch(cfg, rng).items()})
    for arch in ranks.EP_ARCHS:
        cfg = get_reduced(arch)
        p = moe.init_moe(torch.Generator().manual_seed(SEED), cfg, torch.device("cpu"))
        inp.update({f"ep.{arch}.p.{k}": p[k].numpy() for k in
                    ("w_router", "w_gate", "w_up", "w_down")})
        inp[f"ep.{arch}.x"] = rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32)
        inp[f"ep.{arch}.cot"] = rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    return inp


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The draws, JAX's references and each world's rank outputs; the
    reference process runs while the worlds do."""
    root = tmp_path_factory.mktemp("sharded")
    inp = _draws()
    np.savez(root / "in.npz", **inp)
    proc = subprocess.Popen([sys.executable, str(JAX_SCRIPT), str(root / "in.npz"),
                             str(root / "jax_out.npz"), "sharded"],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        out = {}
        for world in WORLDS:
            dist_ranks.spawn_world(ranks.run_sharded, world, (str(root / "in.npz"), str(root)),
                                   str(root / f"rdv{world}"), GROUP_TIMEOUT_S)
            out[world] = [dict(np.load(root / f"sharded_w{world}_r{r}.npz"))
                          for r in range(world)]
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert "JAX_REFERENCE_OK" in stdout, stdout[-2000:] + stderr[-4000:]
    return inp, dict(np.load(root / "jax_out.npz")), out


# --------------------------------------------------------------------------- shard()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_shard_shapes_are_the_references(case, arch):
    """Every parameter's local shard on (data, model) = (2, 2), (1, 4) and
    (4, 1), on every rank, is ``NamedSharding(mesh, logical_spec(...))
    .shard_shape`` of its global shape."""
    _, ref, out = case
    want = {k: v for k, v in ref.items() if k.startswith(f"shape.{arch}.")}
    assert len(want) == 3 * len(ranks.flat(build(get_reduced(arch)).param_specs()))
    for o in out[4]:
        got = {k: v for k, v in o.items() if k.startswith(f"shape.{arch}.")}
        assert set(got) == set(want)
        for k, w in want.items():
            assert tuple(got[k]) == tuple(w), k


def test_shard_is_the_identity_outside_use_mesh_and_places_inside(case):
    """Outside ``use_mesh`` ``shard()`` returns its argument; inside it,
    on (2, 2), each activation takes the placements of the reference's
    ``logical_spec`` (``Shard(d)`` on the mesh axis that dimension ``d``
    names, ``Replicate()`` elsewhere) from a DTensor placed otherwise and
    keeps its value, and a plain tensor passes unchanged; ``current_mesh``
    is the active mesh, and ``None`` again after."""
    _, ref, out = case
    specs = json.loads(str(ref["shard.specs"]))
    names = ("data", "model")
    for o in out[4]:
        assert bool(o["shard.identity"]) and bool(o["shard.active_mesh"])
        assert bool(o["shard.left"])
        rep = json.loads(str(o["shard.report"]))
        assert set(rep) == set(specs)
        for axes, spec in specs.items():
            want = [Replicate()] * 2
            for d, e in enumerate(spec):
                for a in ([e] if isinstance(e, str) else e or []):
                    want[names.index(a)] = Shard(d)
            assert rep[axes]["placements"] == [repr(p) for p in want], axes
            assert rep[axes]["again"] == rep[axes]["placements"], axes
            assert rep[axes]["whole"] and rep[axes]["plain"], axes


def test_row_chunks_cut_each_ranks_own_rows(case):
    """``row_chunks`` on (data, model) = (2, 2): rows split over ``data``
    are cut on each rank's own rows (each chunk keeps the split; a rank's
    chunks are its rows in order), and together the chunks hold every row
    once, each beside its own target; rows that split unevenly are cut in
    order."""
    _, _, out = case
    x = np.arange(10 * 3, dtype=np.float32).reshape(10, 3)
    for o in out[4]:
        assert bool(o["rows.placements"])
        np.testing.assert_array_equal(o["rows.local"], o["rows.own"])
        whole, t = o["rows.whole_x"], o["rows.whole_t"]
        np.testing.assert_array_equal(whole[:, 0] // 3, t)
        np.testing.assert_array_equal(np.sort(t), np.arange(10))
        np.testing.assert_array_equal(whole, x[t])
        np.testing.assert_array_equal(o["rows.uneven_x"], x[:9])


# --------------------------------------------------------------------------- the step


def _unsharded(inp, arch):
    """The port's unsharded step from the same weights and batch: loss,
    gradients, the parameters after AdamW."""
    cfg = ranks.sharded_arch_cfg(arch)
    model = build(cfg)
    init = {k[len(f"init.{arch}"):]: torch.from_numpy(v) for k, v in inp.items()
            if k.startswith(f"init.{arch}/")}
    params = ranks.unflat(init, model.init(0, "cpu"))
    opt = adamw.AdamW(adamw.AdamWConfig(lr=LR, warmup_steps=2, decay_steps=3))
    batch = ranks.step_batch(inp, arch)
    grads, metrics = grads_of(model, params, batch)
    new, _, om = opt.update(params, grads, opt.init(params))
    return ({k: v.numpy() for k, v in ranks.flat(grads).items()},
            {k: v.numpy() for k, v in ranks.flat(new).items()}, metrics | om)


def _check_step(inp, o, arch, tag, data):
    grads, params, metrics = _unsharded(inp, arch)
    assert bool(o[f"{tag}.placed"])
    for rows, local in o[f"{tag}.loss_rows"]:    # the loss on each data rank's own rows
        assert local * data == rows, (rows, local)
    np.testing.assert_allclose(float(o[f"{tag}.loss"]), float(metrics["loss"]), rtol=1e-6)
    np.testing.assert_allclose(float(o[f"{tag}.aux_loss"]), float(metrics["aux_loss"]),
                               rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(float(o[f"{tag}.grad_norm"]), float(metrics["grad_norm"]),
                               rtol=1e-5)
    assert {k[len(tag) + 5:] for k in o if k.startswith(f"{tag}.grad/")} == set(grads)
    for k, g in grads.items():
        err = float(np.abs(o[f"{tag}.grad{k}"] - g).max())
        assert err <= GRAD_TOL * max(float(np.abs(g).max()), 1e-30), (k, err)
    for k, p in params.items():
        err = np.abs(o[f"{tag}.params{k}"] - p)
        small = np.abs(grads[k]) <= NEAR_ZERO * float(np.abs(grads[k]).max())
        assert float(err[~small].max(initial=0.0)) <= PARAM_ATOL, (k, err.max())
        assert float(err[small].max(initial=0.0)) <= 2 * LR + PARAM_ATOL, (k, err.max())


@pytest.mark.parametrize("dims", [(1, 2), (2, 1), (2, 2), (1, 4)],
                         ids=lambda d: f"{d[0]}x{d[1]}")
def test_sharded_step_matches_the_unsharded_step(case, dims):
    """qwen3-1.7b reduced (f32): one sharded step over (data, model) =
    ``dims`` against the unsharded step from the same weights and batch.
    At (1, 4) each rank holds one of the 4 query heads, half a kv group:
    its keys and values are the global GQA map's."""
    inp, _, out = case
    world = dims[0] * dims[1]
    _check_step(inp, out[world][0], ranks.STEP_ARCH,
                f"step.{ranks.STEP_ARCH}.{dims[0]}x{dims[1]}", dims[0])


@pytest.mark.parametrize("arch", ranks.FAMILY_ARCHS)
def test_sharded_step_of_each_family_matches_the_unsharded_step(case, arch):
    """One reduced arch of each other family on (2, 2): moe with MLA
    (deepseek, expert parallelism on), ssm, hybrid, vlm, audio."""
    inp, _, out = case
    _check_step(inp, out[4][0], arch, f"step.{arch}.2x2", 2)


def test_cli_mesh_2x2_resumes_bitwise(case):
    """``launch/train.py --mesh 2x2`` on a world of 4: a run stopped by
    SIGTERM after 2 steps and resumed to 4 from rank 0's checkpoint (whole
    tensors, placed again by the rules) ends bitwise the uninterrupted
    run, on every rank, and every rank holds the same state."""
    _, _, out = case
    for o in out[4]:
        assert o["cli.steps"].tolist() == [2, 4, 4]
        assert o["cli.losses"][0].tolist() == o["cli.losses"][1].tolist()
        assert bool(o["cli.whole.placed"]) and bool(o["cli.resumed.placed"])
        whole = {k[len("cli.whole"):]: v for k, v in o.items()
                 if k.startswith("cli.whole/")}
        assert whole
        for k, v in whole.items():
            assert o[f"cli.resumed{k}"].tobytes() == v.tobytes(), k
            assert out[4][0][f"cli.whole{k}"].tobytes() == v.tobytes(), k


# --------------------------------------------------------------------------- experts


def _single_device(inp, arch):
    cfg = get_reduced(arch)
    cfg = cfg.replace(moe=ranks.dataclasses.replace(cfg.moe, use_shard_map=True))
    p = {k: torch.from_numpy(inp[f"ep.{arch}.p.{k}"]).requires_grad_(True)
         for k in ("w_router", "w_gate", "w_up", "w_down")}
    x = torch.from_numpy(inp[f"ep.{arch}.x"]).requires_grad_(True)
    y, aux = moe.moe_forward(p, x, cfg)       # no mesh: the plain path
    (y * torch.from_numpy(inp[f"ep.{arch}.cot"])).sum().add(aux).backward()
    return y.detach().numpy(), {"x": x.grad.numpy(), **{k: v.grad.numpy() for k, v in p.items()}}


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("arch", ranks.EP_ARCHS)
def test_expert_parallel_matches_the_rank_body(case, arch, n):
    """``use_shard_map`` over ``model`` = n: the output and aux against
    JAX's rank body composed eagerly, the gradients of x, the router and
    every expert weight against the port's single-device path."""
    inp, ref, out = case
    o = out[n][0]
    y = ref[f"ep.{arch}.n{n}.y"]
    assert float(np.abs(o[f"ep.{arch}.n{n}.y"] - y).max()) <= EP_TOL * float(np.abs(y).max())
    np.testing.assert_allclose(float(o[f"ep.{arch}.n{n}.aux"]), float(ref[f"ep.{arch}.n{n}.aux"]),
                               rtol=1e-6)
    y1, grads = _single_device(inp, arch)
    assert float(np.abs(y1 - y).max()) <= EP_TOL * float(np.abs(y).max())
    for k, g in grads.items():
        err = float(np.abs(o[f"ep.{arch}.n{n}.grad.{k}"] - g).max())
        assert err <= EP_TOL * float(np.abs(g).max()), (k, err)


@pytest.mark.parametrize("n", WORLDS)
def test_expert_parallel_refuses_experts_that_do_not_divide(case, n):
    _, _, out = case
    assert str(out[n][0][f"ep.n{n}.refuses_uneven"]) == (
        f"{2 * n - 1} experts do not shard over model axis of {n}")


def test_moe_path_precedence_is_the_references(case):
    """Grouped dispatch when ``dispatch_groups`` is set and no mesh is
    active or ``use_shard_map`` is off; expert parallelism when the active
    mesh has ``model`` and ``use_shard_map`` is on; else the plain path
    (a mesh without ``model`` included, whatever ``dispatch_groups``)."""
    _, _, out = case
    o = out[2][0]
    for groups in (0, 2):
        for use in (False, True):
            for mesh in ("none", "data", "model"):
                if groups and (mesh == "none" or not use):
                    want = f"grouped{groups}"
                elif use and mesh == "model":
                    want = "expert_parallel"
                else:
                    want = "plain"
                assert str(o[f"path.g{groups}.s{int(use)}.{mesh}"]) == want, (groups, use, mesh)


# --------------------------------------------------------------------------- scan_layers


def _loss_and_grads(model, params, batch):
    grads, metrics = grads_of(model, params, batch)
    return metrics["loss"], grads


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-v2-lite-16b",
                                  "seamless-m4t-large-v2"])
def test_scan_layers_off_matches_the_reference(arch):
    """``scan_layers=False``: JAX's unscanned tree converts (``"scan"``
    empty there, ``None`` here), and its loss and prefill logits are
    JAX's; on the same weights the unscanned model is bitwise the scanned
    one (loss and every gradient)."""
    jcfg = jbase.get_reduced(arch).replace(scan_layers=False)
    cfg = get_reduced(arch).replace(scan_layers=False)
    assert not cfg.scan_layers and get_reduced(arch).scan_layers
    jmodel, model = jbuild(jcfg), build(cfg)
    assert model.plan.repeats == 0 and len(model.plan.prefix) == cfg.n_layers
    jparams = jmodel.init(jax.random.key(3))
    params = lm_params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    assert params["layers"]["scan"] is None and len(params["layers"]["prefix"]) == cfg.n_layers
    if cfg.encdec:
        assert len(params["encoder"]["prefix"]) == cfg.n_enc_layers
    b = _batch(cfg, np.random.default_rng(4), B=2, S=16)
    jb = {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    jloss, _ = jax.jit(jmodel.train_loss)(jparams, jb)
    loss, _ = model.train_loss(params, tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    pb = {k: v for k, v in jb.items() if k != "targets"}
    jlogits = np.asarray(jax.jit(jmodel.prefill)(jparams, pb)[0])
    logits = model.prefill(params, {k: v for k, v in tb.items() if k != "targets"})[0].numpy()
    assert float(np.abs(logits - jlogits).max()) <= 1e-4 * float(np.abs(jlogits).max())

    scfg = get_reduced(arch)
    scanned = build(scfg).init(SEED, device="cpu")
    unscanned = tf.unscan_params(scanned, scfg)
    sloss, sgrads = _loss_and_grads(build(scfg), scanned, tb)
    uloss, ugrads = _loss_and_grads(model, unscanned, tb)
    assert float(sloss) == float(uloss)
    want = ranks.flat(tf.unscan_params(sgrads, scfg))
    got = ranks.flat(ugrads)
    assert set(got) == set(want)
    for k in got:
        assert (got[k] is None and want[k] is None) or torch.equal(got[k], want[k]), k


def test_unscanned_specs_and_caches_have_no_scan():
    cfg = get_reduced("jamba-v0.1-52b").replace(scan_layers=False)
    model = build(cfg)
    specs = model.param_specs()
    assert specs["layers"]["scan"] is None and len(specs["layers"]["prefix"]) == cfg.n_layers
    assert model.cache_specs(2, 8)["scan"] is None
    assert len(model.cache_specs(2, 8)["prefix"]) == cfg.n_layers
    assert tf.count_params(cfg) == tf.count_params(get_reduced("jamba-v0.1-52b"))


# --------------------------------------------------------------------------- Shape


def test_shapes_are_the_references():
    assert set(SHAPES) == set(jbase.SHAPES)
    for k, s in SHAPES.items():
        j = jbase.SHAPES[k]
        assert (s.name, s.seq_len, s.global_batch, s.kind) == (
            j.name, j.seq_len, j.global_batch, j.kind)
    assert Shape("x", 1, 2, "train") == Shape("x", 1, 2, "train")


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_are_the_references(arch, shape):
    """``meta`` stand-ins with JAX's shapes and dtypes for every input."""
    from repro_torch.configs.base import get_config

    want = jbuild(jbase.get_config(arch)).input_specs(jbase.SHAPES[shape])
    got = build(get_config(arch)).input_specs(SHAPES[shape])
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == tuple(w.shape), k
        assert str(got[k].dtype).removeprefix("torch.") == str(w.dtype), k
