"""The port's ``moe`` family (MoE FFN, MLA, the prefix plan) against the JAX
package.

On the CPU the port's attention runs the flash kernels' plain versions;
the JAX side runs its model through ``repro.models.model.build``, and its
attention at unequal q/k and v widths through ``blocked_attention`` and
``jax.vjp`` of it (the Pallas kernel gives v the width of q, so it cannot
take MLA's (192, 128)).  Inputs come from NumPy with a seed; weights go
across through ``lm_params_from_jax``.

Tolerances, stated once (the dense family's, ``tests/test_torch_lm.py``
and ``tests/test_torch_lm_train.py``):
* attention in f32: ``1e-5`` of each tensor's max|.| (forward and
  gradients); in bf16 per row ``BF16_ROW_TOL`` / ``BWD_BF16_ROW_TOL``;
* ``_route``: gates ``1e-6``, experts equal (the same f32 softmax; ties
  broken toward the lower index on both sides), the aux and z losses
  ``1e-6``;
* ``moe_forward`` and the dense oracle in f32: ``1e-5`` of max|y| (f32
  matmul sums in another order); two calls bitwise;
* ``mla_forward`` in f32: ``1e-5`` of max|y|;
* the reduced models in f32: logits and caches ``1e-4``, the
  teacher-forcing identity ``2e-3`` (at ``capacity_factor=64``, where no
  token drops: drops depend on how many tokens a call routes);
  ``generate`` gives the same tokens.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.models.model import build as jbuild
from repro.train import serve_step as jserve
from repro_torch.configs.base import get_config, get_reduced
from repro_torch.convert import adamw_state_from_jax, lm_params_from_jax
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops, traffic
from repro_torch.kernels.launch import SMEM_PER_BLOCK
from repro_torch.models import attention, moe
from repro_torch.models import transformer as tf
from repro_torch.models.model import build
from repro_torch.models.transformer import tree_leaves
from repro_torch.optim import adamw
from repro_torch.train import serve_step

MOE = ["deepseek-v2-lite-16b", "phi3.5-moe-42b-a6.6b"]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, path=""):
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _flat(tree[key], f"{path}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, t in enumerate(tree) for k, v in _flat(t, f"{path}/{i}").items()}
    return {path: tree}


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= tol * max(float(np.abs(want).max()), 1e-30)


# ---------------------------------------------------------------------------
# configs and the layer plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE)
def test_moe_configs_and_param_counts_match_jax(arch):
    """Every field equal to the JAX config's (the MoE and MLA sub-configs
    field for field), at full size and reduced; full-size parameters and
    active parameters equal JAX's counts."""
    want_total = {"deepseek-v2-lite-16b": 15_706_484_224,
                  "phi3.5-moe-42b-a6.6b": 41_872_527_360}[arch]
    want_active = {"deepseek-v2-lite-16b": 2_658_061_824,
                   "phi3.5-moe-42b-a6.6b": 6_638_538_752}[arch]
    for ours, theirs in ((get_config(arch), jbase.get_config(arch)),
                         (get_reduced(arch), jbase.get_reduced(arch))):
        for f in dataclasses.fields(ours):
            a, b = getattr(ours, f.name), getattr(theirs, f.name)
            if dataclasses.is_dataclass(a) or dataclasses.is_dataclass(b):
                assert dataclasses.asdict(a) == dataclasses.asdict(b), f.name
            else:
                assert a == b, f.name
        assert ours.param_count() == jtf.count_params(theirs)
        assert ours.active_param_count() == jtf.count_params(theirs, active_only=True)
    assert get_config(arch).param_count() == want_total
    assert get_config(arch).active_param_count() == want_active


@pytest.mark.parametrize("arch", MOE + ["llama3-8b"])
def test_layer_plan_matches_jax(arch):
    ours, theirs = tf.layer_plan(get_config(arch)), jtf.layer_plan(jbase.get_config(arch))
    assert (ours.prefix, ours.period, ours.repeats) == (
        theirs.prefix, theirs.period, theirs.repeats)
    assert ours.n_layers == theirs.n_layers == get_config(arch).n_layers


def test_moe_shard_options_raise():
    """``use_shard_map`` with no mesh active takes the plain path, as the
    reference's does (bitwise the plain call; expert parallelism needs a
    mesh with ``model``: ``tests/test_torch_sharded.py``); dispatch groups
    that do not divide the tokens are refused with the reference's
    message."""
    cfg = get_reduced("phi3.5-moe-42b-a6.6b")
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg, torch.device("cpu"))
    x = torch.randn((2, 4, cfg.d_model), generator=torch.Generator().manual_seed(1))
    shard_map = cfg.replace(moe=dataclasses.replace(cfg.moe, use_shard_map=True))
    for got, want in zip(moe.moe_forward(p, x, shard_map), moe.moe_forward(p, x, cfg)):
        assert torch.equal(got, want)
    x = torch.zeros((1, 4, cfg.d_model))
    bad = cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch_groups=3))
    with pytest.raises(ValueError, match="4 tokens do not split into dispatch_groups=3"):
        moe.moe_forward(p, x, bad)


def _grouped_setup(n_experts=8, top_k=2, d=16, f=32, B=2, S=24, cf=8.0):
    """``tests/test_moe.py:_setup`` (key 7), and the same params and input
    as tensors."""
    from types import SimpleNamespace

    from repro.models.layers import split_tree

    jcfg = SimpleNamespace(d_model=d, np_dtype=jnp.float32, moe=jmoe.MoEConfig(
        n_experts=n_experts, top_k=top_k, d_ff_expert=f, capacity_factor=cf))
    key = jax.random.key(7)
    jp, _ = split_tree(jmoe.init_moe(key, jcfg))
    x = jax.random.normal(jax.random.fold_in(key, 1), (B, S, d)) * 0.5
    cfg = SimpleNamespace(moe=moe.MoEConfig(n_experts=n_experts, top_k=top_k,
                                            d_ff_expert=f, capacity_factor=cf))
    return jcfg, jp, x, cfg, jax.tree.map(lambda a: _t(np.asarray(a)), jp), _t(np.asarray(x))


def _groups(cfg, g):
    """``cfg`` (a namespace) with ``dispatch_groups=g``."""
    return type(cfg)(**{**vars(cfg), "moe": dataclasses.replace(cfg.moe, dispatch_groups=g)})


@pytest.mark.parametrize("groups", [8, 4, 48])
def test_grouped_dispatch_matches_global(groups):
    """``tests/test_moe.py::test_grouped_dispatch_matches_global`` mirrored
    (and at 4 and 48 groups): the grouped dispatch within ``2e-4`` of JAX's
    grouped and global outputs and of the port's global dispatch; its aux
    loss the mean of the groups', as JAX's."""
    jcfg, jp, jx, cfg, p, x = _grouped_setup()
    jy0, _ = jmoe.moe_forward(jp, jx, jcfg)
    jyg, jaux = jmoe.moe_forward(jp, jx, _groups(jcfg, groups))
    y0, _ = moe.moe_forward(p, x, cfg)
    yg, aux = moe.moe_forward(p, x, _groups(cfg, groups))
    for want in (np.asarray(jyg), np.asarray(jy0), y0.numpy()):
        np.testing.assert_allclose(yg.numpy(), want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def test_grouped_dispatch_routes_each_group_on_its_own():
    """One routing call a group (``pinned_routing`` logs G calls of n/G
    tokens), and at a capacity where tokens drop the groups' own
    capacities decide which: the result is JAX's grouped one."""
    jcfg, jp, jx, cfg, p, x = _grouped_setup(cf=0.5)
    jyg, _ = jmoe.moe_forward(jp, jx, _groups(jcfg, 4))
    with moe.pinned_routing() as pin:
        yg, _ = moe.moe_forward(p, x, _groups(cfg, 4))
    assert [tuple(c.shape) for c in pin.log] == [(12, 2)] * 4
    _close(yg, jyg, 1e-5)
    assert float((yg - moe.moe_forward(p, x, cfg)[0]).abs().max()) > 1e-3


# ---------------------------------------------------------------------------
# MoE: routing, dispatch, combine
# ---------------------------------------------------------------------------


def _jax_moe(arch, seed=0, dtype="float32", **moe_kw):
    """The JAX config and MoE params (the router f32 in every dtype), and
    the port's config with the same settings and the params as tensors."""
    from repro.models.layers import split_tree

    jcfg = jbase.get_reduced(arch).replace(dtype=dtype)
    cfg = get_reduced(arch).replace(dtype=dtype)
    if moe_kw:
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, **moe_kw))
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **moe_kw))
    jp, _ = split_tree(jmoe.init_moe(jax.random.key(seed), jcfg))
    p = jax.tree.map(lambda a: _t(np.asarray(a).astype(np.float32)).to(
        torch.float32 if a.dtype == jnp.float32 else torch.bfloat16), jp)
    return jcfg, jp, cfg, p


def test_route_matches_jax_with_planted_ties():
    """Router columns 1 and 2 equal and 5 and 6 equal: every token's
    probabilities tie there, and both sides put the lower expert first."""
    rng = np.random.default_rng(1)
    w = rng.normal(size=(16, 8)).astype(np.float32)
    w[:, 2] = w[:, 1]
    w[:, 6] = w[:, 5]
    x = rng.normal(size=(40, 16)).astype(np.float32)
    for k in (2, 3, 6):
        jg, je, jaux, jz = jmoe._route(jnp.asarray(x), jnp.asarray(w), k)
        g, e, aux, z = moe._route(_t(x), _t(w), k)
        np.testing.assert_array_equal(e.numpy(), np.asarray(je))
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0, atol=1e-6)
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
        np.testing.assert_allclose(float(z), float(jz), rtol=1e-6)
    # the ties were hit: some token has experts 1 and 2 (or 5 and 6) both
    _, e, _, _ = moe._route(_t(x), _t(w), 6)
    both = lambda a, b: ((e == a).any(-1) & (e == b).any(-1)).any()
    assert bool(both(1, 2)) or bool(both(5, 6))


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("capacity_factor", [1.25, 0.3, 64.0])
def test_moe_forward_matches_jax(arch, capacity_factor):
    """The dispatch at the config's capacity, at a capacity low enough that
    most hits drop (the sentinel row and the clamp in the combine), and at
    one where none does; the aux loss; two calls bitwise."""
    jcfg, jp, cfg, p = _jax_moe(arch, capacity_factor=capacity_factor)
    x = (np.random.default_rng(2).normal(size=(2, 24, cfg.d_model)) * 0.5).astype(np.float32)
    jy, jaux = jmoe.moe_forward(jp, jnp.asarray(x), jcfg)
    y, aux = moe.moe_forward(p, _t(x), cfg)
    _close(y, jy, 1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    y2, aux2 = moe.moe_forward(p, _t(x), cfg)
    assert torch.equal(y, y2) and torch.equal(aux, aux2)
    n = x.shape[0] * x.shape[1]
    assert moe.capacity_of(n, cfg.moe) == max(
        8, int(n * cfg.moe.top_k * capacity_factor / cfg.moe.n_experts))
    if capacity_factor == 0.3:   # drops happen: the result is not the dense oracle's
        dense = moe.moe_forward_dense_ref(p, _t(x), cfg)
        assert float((dense - y).abs().max()) > 1e-3


@pytest.mark.parametrize("arch", MOE)
def test_moe_dense_ref_matches_jax_and_the_dispatch(arch):
    jcfg, jp, cfg, p = _jax_moe(arch, capacity_factor=64.0)
    x = (np.random.default_rng(3).normal(size=(2, 10, cfg.d_model)) * 0.5).astype(np.float32)
    want = jmoe.moe_forward_dense_ref(jp, jnp.asarray(x), jcfg)
    got = moe.moe_forward_dense_ref(p, _t(x), cfg)
    _close(got, want, 1e-5)
    _close(moe.moe_forward(p, _t(x), cfg)[0], want, 1e-5)


def test_moe_forward_bf16_within_a_rounding_of_jax():
    """In bf16 both round the same values at the same points; each output
    row is held to 2^-6 of its largest element (a few bf16 roundings)."""
    jcfg, jp, cfg, p = _jax_moe("deepseek-v2-lite-16b", dtype="bfloat16")
    assert p["w_router"].dtype == torch.float32 and p["w_gate"].dtype == torch.bfloat16
    x = (np.random.default_rng(4).normal(size=(2, 16, cfg.d_model)) * 0.5)
    jy, _ = jmoe.moe_forward(jp, jnp.asarray(x, jnp.bfloat16), jcfg)
    y, _ = moe.moe_forward(p, _t(x.astype(np.float32)).to(torch.bfloat16), cfg)
    want = np.asarray(jy).astype(np.float32)
    d = np.abs(y.float().numpy() - want).max(-1)
    assert float((d / np.abs(want).max(-1)).max()) <= 2 ** -6


@pytest.mark.parametrize("arch", MOE)
def test_pinned_routing_replays_the_experts_alone(arch):
    """A run that records, then replays its own routing, is bitwise the
    unpinned run (the same gates and aux from the same arithmetic); a
    replay of other experts takes their probabilities, renormalised, and
    counts each token whose own choice differed."""
    _, _, cfg, p = _jax_moe(arch, capacity_factor=64.0)
    x = _t((np.random.default_rng(5).normal(size=(2, 12, cfg.d_model)) * 0.5)
           .astype(np.float32))
    y, aux = moe.moe_forward(p, x, cfg)
    with moe.pinned_routing() as pin:
        assert torch.equal(moe.moe_forward(p, x, cfg)[0], y)
        pin.replay()
        y2, aux2 = moe.moe_forward(p, x, cfg)
        assert pin.flips == 0 and torch.equal(y2, y) and torch.equal(aux2, aux)
        own = pin.log[0]
        other = torch.roll(own, 1, dims=0)   # each token takes its neighbour's experts
        pin.replay([other])
        g, e, _, _ = moe._route(x.reshape(-1, cfg.d_model), p["w_router"], cfg.moe.top_k)
    assert moe._pin is None
    changed = int((own.sort(-1).values != other.sort(-1).values).any(-1).sum())
    assert torch.equal(e, other) and pin.flips == changed > 0
    probs = torch.softmax(x.reshape(-1, cfg.d_model) @ p["w_router"], dim=-1)
    want = probs.gather(1, other)
    torch.testing.assert_close(g, want / want.sum(-1, keepdim=True), rtol=0, atol=1e-7)


# ---------------------------------------------------------------------------
# attention at unequal q/k and v widths
# ---------------------------------------------------------------------------


def _wide_inputs(S, DK, DV, dtype=np.float32, B=2, H=4, Hkv=2, seed=0):
    rng = np.random.default_rng(seed + S + DK)
    shapes = [((B, S, H, DK), 0.3), ((B, S, Hkv, DK), 0.3), ((B, S, Hkv, DV), 0.3),
              ((B, S, H, DV), 1.0)]
    return [(rng.normal(size=s) * sc).astype(np.float32).astype(dtype) for s, sc in shapes]


@pytest.mark.parametrize("DK,DV", [(48, 32), (192, 128)])
@pytest.mark.parametrize("S,causal", [(1, True), (130, True), (100, False)])
def test_plain_flash_at_unequal_widths_matches_jax_vjp(DK, DV, S, causal):
    q, k, v, do = _wide_inputs(S, DK, DV)
    f = lambda q, k, v: jattn.blocked_attention(q, k, v, causal=causal, q_block=64,
                                                kv_block=64)
    want_o, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    o = ops.flash_attention(tq, tk, tv, causal=causal)
    got = torch.autograd.grad(o, (tq, tk, tv), _t(do))
    assert o.shape == (2, S, 4, DV)
    _close(o, want_o, 1e-5)
    scale = max(float(np.abs(w).max()) for w in want)
    for name, g, w in zip("qkv", got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        limit = 1e-5 * (float(np.abs(w).max()) or scale)
        assert float(np.abs(g.numpy() - w).max()) <= limit, name


def test_plain_flash_at_192_128_bf16_within_the_row_gates():
    q, k, v, do = _wide_inputs(200, 192, 128, dtype=ml_dtypes.bfloat16, H=2, Hkv=2)
    f = lambda q, k, v: jattn.blocked_attention(q, k, v, causal=True)
    want_o, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    bf = lambda a: _t(a.astype(np.float32)).to(torch.bfloat16)
    tq, tk, tv = (bf(a).requires_grad_() for a in (q, k, v))
    o = ops.flash_attention(tq, tk, tv, causal=True)
    got = torch.autograd.grad(o, (tq, tk, tv), bf(do))
    j = lambda a: torch.from_numpy(np.asarray(a).astype(np.float32))
    assert FA.row_error(o, j(want_o)) <= FA.BF16_ROW_TOL
    for g, w in zip(got, want):
        assert FA.grad_row_error(g, j(w)) <= FA.BWD_BF16_ROW_TOL


def test_flash_shapes_and_card_checks_at_unequal_widths():
    q, k, v = torch.zeros(1, 8, 2, 192), torch.zeros(1, 8, 2, 192), torch.zeros(1, 8, 2, 128)
    assert FA.flash_attention_plain(q, k, v).shape == (1, 8, 2, 128)
    with pytest.raises(ValueError, match="expected q"):
        FA.flash_attention_plain(q, k, torch.zeros(1, 9, 2, 128))
    o, lse, _ = FA.flash_attention_plain(q, k, v, return_lse=True)
    with pytest.raises(ValueError, match="must be"):
        FA.flash_attention_bwd_plain(q, k, v, q, lse, q)
    assert (192, 128) in FA.KERNEL_HEAD_DIMS and (192, 192) not in FA.KERNEL_HEAD_DIMS


def test_unequal_width_plans_fit_a_block():
    """(192, 128): the forward's tiles (214,096 bytes: one block an SM),
    the backward's dK/dV block with q tiles of 32 queries and its dQ block
    of one head, each within the 227 KB a block may hold."""
    bf16 = torch.bfloat16
    assert FA.flash_smem_bytes(192, bf16, 128) == 214_096
    plan = FA.flash_bwd_plan(4, 2048, 2048, 16, 16, 192, bf16, 128)
    assert plan.q_tile == FA.BWD_QT_WIDE == 32 and plan.dq_heads == 1
    assert plan.dkdv_smem_bytes == 145_208 and plan.dq_smem_bytes == 205_880
    assert max(plan.dkdv_smem_bytes, plan.dq_smem_bytes) <= SMEM_PER_BLOCK
    assert plan.delta_rows == 128 // (128 // 8)
    # the dK/dV walk visits each (key tile, q tile) pair at or below the diagonal
    assert plan.dkdv_walk(1, 2048, True)[0] == 128
    assert len(plan.dkdv_walk(0, 2048, True)) == 2048 // 32


def test_traffic_at_unequal_widths():
    """At DK = DV the counts reduce to 4·B·H·D·Σ and 10·B·H·D·Σ; at
    deepseek's (192, 128) training shape the bounds are 85.9 and 223.5
    GFLOP (0.0869 and 0.2259 ms at 989 TFLOP/s)."""
    for D in (16, 128):
        n = traffic.attention_valid_keys(300, 300, True)
        assert traffic.flash_attention_flops(2, 300, 4, D, 300, True, D) == 4 * 2 * 4 * D * n
        assert traffic.flash_attention_bwd_flops(2, 300, 4, D, 300, True, D) == \
            10 * 2 * 4 * D * n
        assert traffic.flash_attention_bytes(2, 300, 300, 4, 2, D, 2, D) == \
            traffic.flash_attention_bytes(2, 300, 300, 4, 2, D, 2)
        assert traffic.flash_attention_bwd_bytes(2, 300, 300, 4, 2, D, 2, D) == \
            traffic.flash_attention_bwd_bytes(2, 300, 300, 4, 2, D, 2)
    f = traffic.flash_attention_flops(4, 2048, 16, 192, 2048, True, 128)
    b = traffic.flash_attention_bwd_flops(4, 2048, 16, 192, 2048, True, 128)
    assert 85.8e9 < f < 86.0e9 and 223.4e9 < b < 223.6e9
    assert round(f / 989e12 * 1e3, 4) == 0.0869 and round(b / 989e12 * 1e3, 4) == 0.2259
    assert traffic.flash_attention_bytes(4, 2048, 2048, 16, 16, 192, 2, 128) == \
        2 * (4 * 2048 * 16 * 320 * 2)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------


def _mla_pair(seed=0):
    from repro.models.layers import split_tree

    jcfg, cfg = jbase.get_reduced("deepseek-v2-lite-16b"), get_reduced("deepseek-v2-lite-16b")
    jp, _ = split_tree(jattn.init_mla(jax.random.key(seed), jcfg))
    return jcfg, jp, cfg, jax.tree.map(lambda a: _t(np.asarray(a)), jp)


def test_mla_prefill_and_decode_match_jax():
    jcfg, jp, cfg, p = _mla_pair()
    B, L = 2, 11
    x = (np.random.default_rng(5).normal(size=(B, L + 1, cfg.d_model))).astype(np.float32)
    jy, jc = jattn.mla_forward(jp, jnp.asarray(x[:, :L]), jcfg.replace(return_cache=True))
    cache = {k: torch.zeros(t.shape) for k, t in
             attention.mla_cache_spec(cfg, B, L + 4).items()}
    y = attention.mla_forward(p, _t(x[:, :L]), cfg, cache)
    _close(y, jy, 1e-5)
    for key in ("c_kv", "k_pe"):
        _close(cache[key][:, :L], jc[key], 1e-5)
        assert bool((cache[key][:, L:] == 0).all())
    # decode at slot L on the cache of L (JAX's cache grown to the same length)
    grown = {k: jnp.pad(v, ((0, 0), (0, 4), (0, 0))) for k, v in jc.items()}
    jd, jc2 = jattn.mla_forward(jp, jnp.asarray(x[:, L:]), jcfg, cache=grown,
                                pos=jnp.int32(L))
    d = attention.mla_forward(p, _t(x[:, L:]), cfg, cache, pos=L)
    _close(d, jd, 1e-5)
    for key in ("c_kv", "k_pe"):
        _close(cache[key], jc2[key], 1e-5)
    # the train path is differentiable through the plain flash versions
    xt = _t(x).requires_grad_()
    attention.mla_forward(p, xt, cfg).square().sum().backward()
    assert xt.grad is not None and torch.isfinite(xt.grad).all()


# ---------------------------------------------------------------------------
# the reduced models
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=MOE)
def moe_pair(request):
    """One reduced moe arch at capacity_factor=64 (nothing drops): the JAX
    model and params, the port's model and the same params."""
    arch = request.param
    jcfg = jbase.get_reduced(arch)
    jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, capacity_factor=64.0))
    cfg = get_reduced(arch)
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=64.0))
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    params = lm_params_from_jax(_np(jparams), cfg, device="cpu")
    return arch, cfg, jmodel, jparams, build(cfg), params


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(B, S)).astype(np.int32)


def test_reduced_moe_prefill_caches_and_decode_match_jax(moe_pair):
    arch, cfg, jmodel, jparams, model, params = moe_pair
    B, L, cache_len = 2, 12, 16
    toks = _tokens(cfg, B, L + 1, 6)
    jlogits, jc = jax.jit(jmodel.prefill)(jparams, {"tokens": jnp.asarray(toks[:, :L])})
    logits, c = model.prefill(params, {"tokens": _t(toks[:, :L]).long()},
                              model.init_cache(B, cache_len, device="cpu"))
    _close(logits, jlogits, 1e-4)
    ours, theirs = _flat(c), _flat(jc)
    assert set(ours) == set(theirs)
    want_keys = ({"c_kv", "k_pe"} if cfg.mla is not None else {"k", "v"})
    assert {k.rsplit("/", 1)[1] for k in ours} == want_keys
    assert any(k.startswith("/prefix/0/") for k in ours) == cfg.moe.first_dense
    for key, b in theirs.items():
        a = ours[key]
        L_axis = 2 if key.startswith("/scan") else 1
        _close(a.narrow(L_axis, 0, L), b, 1e-4)
    grown = jmodel.init_cache(B, cache_len)
    jc = jax.tree.map(lambda d, s: jnp.pad(s, [(0, a - b) for a, b in zip(d.shape, s.shape)]),
                      grown, jc)
    jl2, jc2 = jax.jit(jmodel.decode_step)(jparams, jc, jnp.asarray(toks[:, L:]), jnp.int32(L))
    l2, c2 = model.decode_step(params, c, _t(toks[:, L:]).long(), L)
    _close(l2, jl2, 1e-4)
    for key, b in _flat(jc2).items():
        _close(_flat(c2)[key], b, 1e-4)


def test_reduced_moe_generate_and_teacher_forcing(moe_pair):
    arch, cfg, jmodel, jparams, model, params = moe_pair
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


@pytest.mark.parametrize("arch", MOE)
def test_reduced_moe_train_loss_drops_tokens_like_jax(arch):
    """At the config's capacity factor (tokens drop at 48 tokens) the loss,
    its aux part and the gradients of the router and the experts agree."""
    cfg, jcfg = get_reduced(arch), jbase.get_reduced(arch)
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.key(2))
    toks = np.random.default_rng(9).integers(0, cfg.vocab, size=(2, 25)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks[:, :-1]), "targets": jnp.asarray(toks[:, 1:])}
    (jloss, jm), jg = jax.jit(jax.value_and_grad(jmodel.train_loss, has_aux=True))(
        jparams, jb)
    params = lm_params_from_jax(_np(jparams), cfg, device="cpu")
    live = _flat(params)
    for t in live.values():
        t.requires_grad_()
    loss, m = build(cfg).train_loss(params, {"tokens": _t(toks[:, :-1]).long(),
                                             "targets": _t(toks[:, 1:]).long()})
    grads = dict(zip(live, torch.autograd.grad(loss, list(live.values()))))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(m["aux_loss"]), float(jm["aux_loss"]), rtol=1e-5)
    assert float(m["aux_loss"]) > 0
    for key, w in _flat(_np(jg)).items():
        if "ffn" in key:
            _close(grads[key], w, 1e-4)


# ---------------------------------------------------------------------------
# conversion
# ---------------------------------------------------------------------------


def test_bf16_moe_tree_round_trips_with_an_f32_router():
    cfg = get_reduced("deepseek-v2-lite-16b").replace(dtype="bfloat16")
    jcfg = jbase.get_reduced("deepseek-v2-lite-16b").replace(dtype="bfloat16")
    jparams = _np(jbuild(jcfg).init(jax.random.key(1)))
    params = lm_params_from_jax(jparams, cfg, device="cpu")
    ours, theirs = _flat(params), _flat(jparams)
    assert set(ours) == set(theirs)
    for key, b in theirs.items():
        router = key.endswith("/w_router")
        assert ours[key].dtype == (torch.float32 if router else torch.bfloat16), key
        assert (b.dtype == np.float32) == router, key
        np.testing.assert_array_equal(ours[key].float().numpy(), b.astype(np.float32))
    assert any(k.startswith("/layers/prefix/0/") for k in ours)
    # f32 AdamW moments of that tree, the router's too
    jstate = {"mu": jax.tree.map(lambda a: np.zeros(a.shape, np.float32), jparams),
              "nu": jax.tree.map(lambda a: np.ones(a.shape, np.float32), jparams),
              "step": np.int32(3)}
    state = adamw_state_from_jax(jstate, cfg, device="cpu")
    assert all(t.dtype == torch.float32 for t in tree_leaves(state["mu"]))
    assert tree_leaves(adamw.AdamW(adamw.AdamWConfig()).init(params)["mu"])[0].dtype == \
        torch.float32
    # a wrong dtype or shape still raises
    first = jparams["layers"]["scan"]["0"]["ffn"]
    for key, leaf, match in (("w_router", first["w_router"].astype(ml_dtypes.bfloat16),
                              "dtype"),
                             ("w_gate", first["w_gate"].astype(np.float32), "dtype"),
                             ("w_up", first["w_up"][..., :-1], "shape")):
        bad = jax.tree.map(lambda a: a, jparams)
        bad["layers"]["scan"]["0"]["ffn"] = dict(first, **{key: leaf})
        with pytest.raises(ValueError, match=match):
            lm_params_from_jax(bad, cfg, device="cpu")
