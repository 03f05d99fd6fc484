"""The port's ``ssm`` and ``hybrid`` families (Mamba2's SSD layer, the
layer plans, mamba2-1.3b and jamba-v0.1-52b) against the JAX package.

On the CPU the port's attention (jamba's) runs the flash kernel's plain
version; the JAX side runs its model through ``repro.models.model.build``
and its SSD through ``repro.models.mamba`` (plain JAX: the JAX package has
no Pallas kernel there).  Inputs come from NumPy with a seed; model weights
go across through ``lm_params_from_jax``.

Tolerances, stated once:
* ``_ssd_chunked`` in f32: ``1e-5`` of max|y| and of max|state| against
  JAX and against a per-step recurrence (measured below 5e-7: the same
  products, summed in another order, and the cross-chunk decays taken as
  ``exp`` of segment sums where JAX multiplies them in a scan);
* ``_ssd_chunked`` with ``compute_dtype="bfloat16"``: ``2^-7`` of max|y|
  against JAX's bf16 run (the two round the O(Q²) tensors at the same
  casts, but XLA may keep an elementwise chain in f32 between them, so a
  value can land on the neighbouring bf16: each such step is at most
  2^-8 of its size; measured 0.0022-0.0041; both are 0.7-4% from f32);
* ``mamba_forward`` in f32: ``1e-5`` of max|y|, caches ``1e-5`` of their
  max; in bf16: ``2^-6`` of max|y| (the bf16 projections and conv, a few
  roundings through the layer);
* the reduced models in f32: logits and caches ``1e-4`` (matmul sums in
  another order, through four or eight layers), the teacher-forcing
  identity ``2e-3`` (as ``tests/test_models.py`` holds the JAX package;
  jamba at ``capacity_factor=64``, where no token drops); ``generate``
  gives the same tokens.
"""

import dataclasses
import functools
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import mamba as jmb
from repro.models import transformer as jtf
from repro.models.model import build as jbuild
from repro.train import serve_step as jserve
from repro_torch.configs.base import PORTED_ARCHS, get_config, get_reduced
from repro_torch.convert import adamw_state_from_jax, lm_params_from_jax
from repro_torch.models import mamba as mb
from repro_torch.models import transformer as tf
from repro_torch.models.model import build
from repro_torch.models.transformer import tree_leaves, tree_map
from repro_torch.train import serve_step

SSM = ["mamba2-1.3b", "jamba-v0.1-52b"]
ROOT = Path(__file__).resolve().parents[1]
# the JAX functions compiled whole (op by op they compile every primitive)
jax_ssd = jax.jit(jmb._ssd_chunked, static_argnums=(5,), static_argnames=("compute_dtype",))


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, path=""):
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _flat(tree[key], f"{path}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, t in enumerate(tree) for k, v in _flat(t, f"{path}/{i}").items()}
    return {path: tree}


def _rel(got, want) -> float:
    """max |got - want| / max |want|."""
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def _ssd_inputs(S, seed, B=2, H=4, P=8, G=1, N=16, init=False):
    """``tests/test_mamba.py``'s inputs, drawn with NumPy."""
    rng = np.random.default_rng(seed)
    out = [rng.normal(size=(B, S, H, P)),
           np.log1p(np.exp(rng.normal(size=(B, S, H)))),          # softplus
           -np.exp(rng.normal(size=(H,)) * 0.3),
           rng.normal(size=(B, S, G, N)) * 0.5,
           rng.normal(size=(B, S, G, N)) * 0.5]
    s0 = rng.normal(size=(B, H, P, N)) * 0.3 if init else None
    return [a.astype(np.float32) for a in out], (
        None if s0 is None else s0.astype(np.float32))


def naive_ssd(xh, dt, a, B_, C_, init_state=None):
    """Token-by-token linear recurrence in torch (``tests/test_mamba.py``'s
    ``naive_ssd`` arithmetic)."""
    B, S, H, P = xh.shape
    G, N = B_.shape[2], B_.shape[3]
    state = (torch.zeros((B, H, P, N)) if init_state is None else init_state).float()
    ys = []
    for t in range(S):
        da = torch.exp(dt[:, t] * a)
        b_h = B_[:, t].repeat_interleave(H // G, dim=1)
        c_h = C_[:, t].repeat_interleave(H // G, dim=1)
        inc = torch.einsum("bhp,bhn->bhpn", dt[:, t][:, :, None] * xh[:, t].float(),
                           b_h.float())
        state = state * da[:, :, None, None] + inc
        ys.append(torch.einsum("bhpn,bhn->bhp", state, c_h.float()))
    return torch.stack(ys, dim=1), state


# ---------------------------------------------------------------------------
# _ssd_chunked
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S,chunk,init", [(16, 4, False), (32, 8, False), (24, 24, False),
                                          (21, 8, False), (8, 4, True), (37, 8, True)])
def test_ssd_chunked_matches_jax_and_the_recurrence(S, chunk, init):
    """``tests/test_mamba.py``'s (S, chunk) cases, ragged lengths (21, 37:
    padded with dt=0 steps) and an initial state."""
    args, s0 = _ssd_inputs(S, S + 100 * init, init=init)
    kw = {} if s0 is None else {"init_state": s0}
    yj, fj = jax_ssd(*map(jnp.asarray, args), chunk,
                     **{k: jnp.asarray(v) for k, v in kw.items()})
    tkw = {k: _t(v) for k, v in kw.items()}
    y, f = mb._ssd_chunked(*map(_t, args), chunk, **tkw)
    assert y.dtype == f.dtype == torch.float32
    assert _rel(y, yj) <= 1e-5 and _rel(f, fj) <= 1e-5
    yn, fn = naive_ssd(*map(_t, args), **tkw)
    assert _rel(y, yn.numpy()) <= 1e-5 and _rel(f, fn.numpy()) <= 1e-5


@pytest.mark.parametrize("S,chunk", [(32, 8), (128, 16)])
def test_ssd_chunked_bf16_compute_dtype_within_a_rounding_of_jax(S, chunk):
    args, _ = _ssd_inputs(S, 11)
    yj, fj = jax_ssd(*map(jnp.asarray, args), chunk, compute_dtype="bfloat16")
    y, f = mb._ssd_chunked(*map(_t, args), chunk, compute_dtype="bfloat16")
    assert _rel(y, yj) <= 2 ** -7
    # the cross-chunk states stay f32 on both sides
    assert _rel(f, fj) <= 1e-5
    # and, as tests/test_mamba.py holds JAX's, within 2% of the f32 run at (32, 8)
    if (S, chunk) == (32, 8):
        y32, _ = mb._ssd_chunked(*map(_t, args), chunk)
        assert _rel(y, y32.numpy()) < 0.02


def test_masked_exp_keeps_the_gradient_finite_where_the_reference_overflows():
    """One 64-step chunk at a = -1 (``a_log = 0``): at dt = 2.0 the chunk's
    decay sum is 128, past the f32 ``exp``'s 88.7.  The JAX package takes
    the ``exp`` of the whole (Q, Q) block before masking it, so its
    ``∂/∂dt`` is not finite; the port masks first: the same forward,
    finite gradients.  At dt = 0.5 (decay sum 32) both are finite and
    agree."""
    rng = np.random.default_rng(5)
    B, S, H, P, N = 1, 64, 2, 4, 8
    xh = rng.normal(size=(B, S, H, P)).astype(np.float32)
    b_ = (rng.normal(size=(B, S, 1, N)) * 0.5).astype(np.float32)
    c_ = (rng.normal(size=(B, S, 1, N)) * 0.5).astype(np.float32)
    w = rng.normal(size=(B, S, H, P)).astype(np.float32)
    a = -np.exp(np.zeros(H, np.float32))

    def jax_loss(dt):
        y, f = jax_ssd(jnp.asarray(xh), dt, jnp.asarray(a), jnp.asarray(b_),
                       jnp.asarray(c_), 64)
        return jnp.sum(y * w) + jnp.sum(f), y

    for dt_val, ref_finite in ((0.5, True), (2.0, False)):
        dt = np.full((B, S, H), dt_val, np.float32)
        (_, yj), gj = jax.value_and_grad(jax_loss, has_aux=True)(jnp.asarray(dt))
        assert np.isfinite(np.asarray(yj)).all()
        assert bool(np.isfinite(np.asarray(gj)).all()) == ref_finite, dt_val
        dt_t = _t(dt).requires_grad_()
        x_t = _t(xh).requires_grad_()
        y, f = mb._ssd_chunked(x_t, dt_t, _t(a), _t(b_), _t(c_), 64)
        g_dt, g_x = torch.autograd.grad((y * _t(w)).sum() + f.sum(), [dt_t, x_t])
        assert _rel(y, yj) <= 1e-5
        assert torch.isfinite(g_dt).all() and torch.isfinite(g_x).all()
        if ref_finite:
            assert _rel(g_dt, gj) <= 1e-4


# ---------------------------------------------------------------------------
# one Mamba layer: init, prefill with its cache, decode
# ---------------------------------------------------------------------------


def _layer_pair(dtype="float32", seed=0):
    """Layer 0's mixer of the reduced mamba2 (JAX params and their port
    copies) and the two configs."""
    jcfg = jbase.get_reduced("mamba2-1.3b").replace(dtype=dtype)
    cfg = get_reduced("mamba2-1.3b").replace(dtype=dtype)
    jparams = jax.jit(jbuild(jcfg).init)(jax.random.key(seed))
    params = lm_params_from_jax(_np(jparams), cfg, device="cpu")
    pick = lambda t: t[0]
    return (jcfg, jax.tree.map(pick, jparams["layers"]["scan"]["0"]["mixer"]),
            cfg, tree_map(pick, params["layers"]["scan"]["0"]["mixer"]))


def test_init_mamba_leaves_match_jax_and_are_seeded():
    jcfg, jp, cfg, _ = _layer_pair("bfloat16")
    p = mb.init_mamba(torch.Generator().manual_seed(4), cfg, torch.device("cpu"))
    again = mb.init_mamba(torch.Generator().manual_seed(4), cfg, torch.device("cpu"))
    assert set(p) == set(jp)
    for k, v in p.items():
        assert tuple(v.shape) == jp[k].shape, k
        assert str(v.dtype).removeprefix("torch.") == jp[k].dtype.name, k
        assert torch.equal(v, again[k]), k
    for k in ("dt_bias", "a_log", "d_skip"):
        assert p[k].dtype == torch.float32
    dt0 = torch.nn.functional.softplus(p["dt_bias"])   # the log-uniform draw
    assert float(dt0.min()) >= 1e-3 * (1 - 1e-5) and float(dt0.max()) <= 0.1 * (1 + 1e-5)
    assert float(p["a_log"].abs().max()) == 0 and float((p["d_skip"] - 1).abs().max()) == 0
    spec = mb.mamba_cache_spec(cfg, 3)
    jspec = jmb.mamba_cache_spec(jcfg, 3)
    assert {k: (tuple(v.shape), v.dtype) for k, v in spec.items()} == {
        k: (v.shape, getattr(torch, v.dtype.name)) for k, v in jspec.items()}


def test_mamba_forward_prefill_cache_and_decode_match_jax():
    jcfg, jp, cfg, p = _layer_pair()
    B, S = 2, 13                                        # ragged: chunk 8
    x = (np.random.default_rng(3).normal(size=(B, S + 1, cfg.d_model)) * 0.5
         ).astype(np.float32)
    yj, jc = jax.jit(functools.partial(jmb.mamba_forward, cfg=jcfg.replace(return_cache=True)))(
        jp, jnp.asarray(x[:, :S]))
    cache = tree_map(lambda t: torch.full(t.shape, float("nan"), dtype=t.dtype),
                     mb.mamba_cache_spec(cfg, B))       # every slot written
    y = mb.mamba_forward(p, _t(x[:, :S]), cfg, cache)
    assert _rel(y, yj) <= 1e-5
    assert set(cache) == set(jc) == {"conv_x", "conv_bc", "state"}
    for k in cache:
        assert cache[k].dtype == getattr(torch, np.asarray(jc[k]).dtype.name), k
        assert _rel(cache[k], jc[k]) <= 1e-5, k
    # decode one token: reads the old tails and state, then overwrites them
    yj2, jc2 = jax.jit(functools.partial(jmb.mamba_forward, cfg=jcfg))(
        jp, jnp.asarray(x[:, S:]), cache=jc, pos=jnp.int32(S))
    old = {k: v.clone() for k, v in cache.items()}
    y2 = mb.mamba_forward(p, _t(x[:, S:]), cfg, cache, pos=S)
    assert _rel(y2, yj2) <= 1e-5
    for k in cache:
        assert _rel(cache[k], jc2[k]) <= 1e-5, k
        assert not torch.equal(cache[k], old[k]), k
    # train mode: no cache, the prefill's output
    assert torch.equal(mb.mamba_forward(p, _t(x[:, :S]), cfg), y)
    with pytest.raises(ValueError, match="one token"):
        mb.mamba_forward(p, _t(x[:, :2]), cfg, cache, pos=S)


def test_mamba_forward_bf16_within_roundings_of_jax():
    jcfg, jp, cfg, p = _layer_pair("bfloat16", seed=2)
    x = (np.random.default_rng(8).normal(size=(2, 24, cfg.d_model)) * 0.5
         ).astype(ml_dtypes.bfloat16)
    yj, _ = jax.jit(functools.partial(jmb.mamba_forward, cfg=jcfg))(jp, jnp.asarray(x))
    y = mb.mamba_forward(p, _t(x.astype(np.float32)).to(torch.bfloat16), cfg)
    assert y.dtype == torch.bfloat16
    assert _rel(y, np.asarray(yj, np.float32)) <= 2 ** -6


# ---------------------------------------------------------------------------
# plans, configs, parameter counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", PORTED_ARCHS)
def test_layer_plans_match_jax(arch):
    for ours, theirs in ((get_config(arch), jbase.get_config(arch)),
                         (get_reduced(arch), jbase.get_reduced(arch))):
        a, b = tf.layer_plan(ours), jtf.layer_plan(theirs)
        assert (a.prefix, a.period, a.repeats) == (b.prefix, b.period, b.repeats)
        assert a.n_layers == ours.n_layers


def test_hybrid_plan_needs_whole_periods_and_puts_moe_on_odd_layers():
    cfg = get_config("jamba-v0.1-52b")
    plan = tf.layer_plan(cfg)
    assert [k[0] for k in plan.period].index("attn") == cfg.attn_offset == 3
    assert [i for i, k in enumerate(plan.period) if k[1] == "moe"] == [1, 3, 5, 7]
    with pytest.raises(ValueError, match="attn_every"):
        tf.layer_plan(cfg.replace(n_layers=12))
    with pytest.raises(ValueError, match="attn_every"):
        jtf.layer_plan(jbase.get_config("jamba-v0.1-52b").replace(n_layers=12))
    # the cross-attention and encoder kinds are ported: their leaves, and
    # a kind outside the plans' raises
    leaves = {("xattn", "dense"): {"ln1", "mixer", "ln2", "ffn"},
              ("attn_xattn", "dense"): {"ln1", "mixer", "ln_x", "xattn", "ln2", "ffn"},
              ("attn_enc", "dense"): {"ln1", "mixer", "ln2", "ffn"}}
    for kind, keys in leaves.items():
        layer = tf.init_layer(None, cfg, kind, torch.device("meta"))
        assert set(layer) == keys and "wq" in layer["mixer"]
    with pytest.raises(ValueError, match="unknown layer kind"):
        tf.init_layer(None, cfg, ("xattn", "moe"), torch.device("meta"))


@pytest.mark.parametrize("arch,total,active", [
    ("mamba2-1.3b", 1_343_581_184, 1_343_581_184),
    ("jamba-v0.1-52b", 51_459_770_368, 11_998_840_832)])
def test_full_size_param_counts_match_jax(arch, total, active):
    cfg, jcfg = get_config(arch), jbase.get_config(arch)
    assert cfg.param_count() == jtf.count_params(jcfg) == total
    assert cfg.active_param_count() == jtf.count_params(jcfg, active_only=True) == active
    # a layer without an FFN has no ln2 and no ffn leaves
    mamba_layer = tf.param_shapes(cfg)["layers"]["scan"]["0"]
    assert set(mamba_layer) == ({"ln1", "mixer"} if arch == "mamba2-1.3b"
                                else {"ln1", "mixer", "ln2", "ffn"})


def test_stack_caches_are_per_kind():
    """jamba's period: a {k, v} cache at slot 3, Mamba caches at the other
    seven, each stacked over the repeats; no length axis in a Mamba cache."""
    cfg = get_config("jamba-v0.1-52b")
    model = build(cfg)
    spec = model.cache_specs(4, 100)
    assert spec["prefix"] == []
    for j in range(8):
        leaves = spec["scan"][str(j)]["mixer"]
        if j == 3:
            assert {k: tuple(v.shape) for k, v in leaves.items()} == {
                "k": (4, 4, 100, 8, 128), "v": (4, 4, 100, 8, 128)}
        else:
            assert {k: (tuple(v.shape), v.dtype) for k, v in leaves.items()} == {
                "conv_x": ((4, 4, 3, 8192), torch.bfloat16),
                "conv_bc": ((4, 4, 3, 32), torch.bfloat16),
                "state": ((4, 4, 128, 64, 16), torch.float32)}
    # mamba2-1.3b's decode state: 8.4 MB a layer at B=4
    m = build(get_config("mamba2-1.3b")).cache_specs(4, 1)["scan"]["0"]["mixer"]
    assert m["state"][0].numel() * m["state"].element_size() == 8_388_608


# ---------------------------------------------------------------------------
# the reduced models
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=SSM)
def ssm_pair(request):
    """One reduced arch in f32 (jamba at capacity_factor=64: nothing
    drops): the JAX model and params, the port's model and the same
    params."""
    arch = request.param
    jcfg, cfg = jbase.get_reduced(arch), get_reduced(arch)
    if cfg.moe is not None:
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, capacity_factor=64.0))
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=64.0))
    jmodel = jbuild(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.key(0))
    params = lm_params_from_jax(_np(jparams), cfg, device="cpu")
    return arch, cfg, jmodel, jparams, build(cfg), params


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(B, S)).astype(np.int32)


def test_reduced_prefill_caches_and_decode_match_jax(ssm_pair):
    arch, cfg, jmodel, jparams, model, params = ssm_pair
    B, L, cache_len = 2, 12, 16
    toks = _tokens(cfg, B, L + 1, 6)
    jlogits, jc = jax.jit(jmodel.prefill)(jparams, {"tokens": jnp.asarray(toks[:, :L])})
    logits, c = model.prefill(params, {"tokens": _t(toks[:, :L]).long()},
                              model.init_cache(B, cache_len, device="cpu"))
    assert _rel(logits, jlogits) <= 1e-4
    ours, theirs = _flat(c), _flat(jc)
    assert set(ours) == set(theirs)
    kinds = {k.rsplit("/", 1)[1] for k in ours}
    assert kinds == ({"conv_x", "conv_bc", "state"} if arch == "mamba2-1.3b"
                     else {"conv_x", "conv_bc", "state", "k", "v"})
    for key, b in theirs.items():
        a = ours[key]
        if key.endswith(("/k", "/v")):       # only the attention caches have slots
            a = a.narrow(2, 0, L)
        assert _rel(a, b) <= 1e-4, key
    grown = jmodel.init_cache(B, cache_len)
    jc = jax.tree.map(lambda d, s: jnp.pad(s, [(0, x - y) for x, y in zip(d.shape, s.shape)]),
                      grown, jc)
    jl2, jc2 = jax.jit(jmodel.decode_step)(jparams, jc, jnp.asarray(toks[:, L:]), jnp.int32(L))
    l2, c2 = model.decode_step(params, c, _t(toks[:, L:]).long(), L)
    assert _rel(l2, jl2) <= 1e-4
    for key, b in _flat(jc2).items():
        assert _rel(_flat(c2)[key], b) <= 1e-4, key


def test_reduced_generate_and_teacher_forcing(ssm_pair):
    arch, cfg, jmodel, jparams, model, params = ssm_pair
    toks = _tokens(cfg, 2, 12, 7)
    want = jserve.generate(jmodel, jparams, {"tokens": jnp.asarray(toks)}, 6, 20)
    got = serve_step.generate(model, params, {"tokens": _t(toks).long()}, 6, 20)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    B, L = 2, 12
    t = _t(_tokens(cfg, B, L + 1, 3)).long()
    full, _ = model.prefill(params, {"tokens": t})
    _, caches = model.prefill(params, {"tokens": t[:, :L]},
                              model.init_cache(B, L + 1, device="cpu"))
    dec, _ = model.decode_step(params, caches, t[:, L:], L)
    np.testing.assert_allclose(dec[:, 0].numpy(), full[:, -1].numpy(), rtol=2e-3, atol=2e-3)


def test_bf16_jamba_tree_round_trips_with_its_f32_leaves():
    cfg = get_reduced("jamba-v0.1-52b").replace(dtype="bfloat16")
    jcfg = jbase.get_reduced("jamba-v0.1-52b").replace(dtype="bfloat16")
    jparams = _np(jax.jit(jbuild(jcfg).init)(jax.random.key(1)))
    params = lm_params_from_jax(jparams, cfg, device="cpu")
    ours, theirs = _flat(params), _flat(jparams)
    assert set(ours) == set(theirs)
    f32_leaves = ("/w_router", "/dt_bias", "/a_log", "/d_skip")
    for key, b in theirs.items():
        f32 = key.endswith(f32_leaves)
        assert ours[key].dtype == (torch.float32 if f32 else torch.bfloat16), key
        assert (b.dtype == np.float32) == f32, key
        np.testing.assert_array_equal(ours[key].float().numpy(), b.astype(np.float32))
    assert sum(key.endswith("/dt_bias") for key in ours) == 7     # the Mamba layers
    jstate = {"mu": jax.tree.map(lambda a: np.zeros(a.shape, np.float32), jparams),
              "nu": jax.tree.map(lambda a: np.ones(a.shape, np.float32), jparams),
              "step": np.int32(3)}
    state = adamw_state_from_jax(jstate, cfg, device="cpu")
    assert all(t.dtype == torch.float32 for t in tree_leaves(state["mu"]))
    mixer = jparams["layers"]["scan"]["0"]["mixer"]
    for key, leaf in (("dt_bias", mixer["dt_bias"].astype(ml_dtypes.bfloat16)),
                      ("w_x", mixer["w_x"].astype(np.float32)),
                      ("a_log", mixer["a_log"][:-1])):
        bad = jax.tree.map(lambda a: a, jparams)
        bad["layers"]["scan"]["0"]["mixer"] = dict(mixer, **{key: leaf})
        with pytest.raises(ValueError, match="shape" if key == "a_log" else "dtype"):
            lm_params_from_jax(bad, cfg, device="cpu")


def test_cli_trains_reduced_mamba2_on_the_cpu(tmp_path):
    """``python -m repro_torch.launch.train --arch mamba2-1.3b --reduced
    --steps 3 --device cpu``: three steps, none rejected, finite losses."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "mamba2-1.3b",
         "--reduced", "--steps", "3", "--device", "cpu", "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "'step': 3, 'rejected_steps': 0" in out.stdout, out.stdout
    first, last = map(float, re.search(r"loss: first=(\S+) last=(\S+)", out.stdout).groups())
    assert math.isfinite(first) and math.isfinite(last)
    # about ln(512) = 6.24 at the start: the tied embedding's logits are small
    assert abs(first - math.log(512)) < 0.5
