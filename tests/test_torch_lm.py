"""The port's dense-LM serving path against the JAX package.

On the CPU the port's attention runs the flash kernel's plain PyTorch
version; the JAX side runs as its own tests run it: the Pallas kernel
through ``repro.kernels.ops.flash_attention`` in interpret mode, and the
model through ``repro.models.model.build``.  Inputs come from NumPy with a
seed, and the same arrays go to both packages; model weights go across
through ``lm_params_from_jax``.  Interpret-mode shapes stay at S <= 128.

Tolerances, stated once:
* attention in f32: ``3e-5`` against the Pallas kernel (as
  ``tests/test_kernels.py`` holds it against its reference), ``1e-5``
  against ``blocked_attention`` / ``decode_attention``: f32 sums of at
  most 128 terms in another order;
* attention in bf16: ``3e-2`` (``tests/test_kernels.py:98``): ``p`` is
  rounded to bf16 relative to a running max that depends on the tiles;
* ``rms_norm``, ``apply_rope``, ``mlp_forward`` in f32: ``1e-6``.  In bf16
  ``rms_norm`` is bitwise equal (the same cast order, and its f32 sums
  round to the same bf16); ``apply_rope`` and ``mlp_forward`` are within
  one bf16 ulp of the value (cos/sin and the matmul sums may differ in the
  last f32 bit, which can move a rounding across a bf16 boundary);
* the reduced models in f32: logits and caches ``1e-4`` (matmul sums in
  another order, through four layers); the teacher-forcing identity
  ``2e-3``, as ``tests/test_models.py`` holds the JAX package;
  ``generate`` gives the same tokens.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models.model import build as jbuild
from repro.train import serve_step as jserve
from repro_torch.configs.base import ARCH_IDS, PORTED_ARCHS, get_config, get_reduced
from repro_torch.convert import lm_params_from_jax
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.launch import H100_SMS, SMEM_PER_BLOCK
from repro_torch.kernels.traffic import attention_valid_keys, flash_attention_flops
from repro_torch.models import attention, layers
from repro_torch.models.model import build
from repro_torch.models.transformer import param_shapes, tree_leaves
from repro_torch.train import serve_step

DENSE = ["llama3-8b", "qwen3-1.7b", "qwen1.5-32b", "yi-34b"]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _flat(tree, path=""):
    """``{path: leaf}`` of a tree of dicts and lists (either package's)."""
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _flat(tree[key], f"{path}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, t in enumerate(tree) for k, v in _flat(t, f"{path}/{i}").items()}
    return {path: tree}


def _bf16_ulp(x):
    """One bf16 ulp at each element of ``x`` (f32 array)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,H,Hkv,S,D,bq,bk", [
    (1, 2, 1, 128, 32, 64, 64),
    (2, 4, 2, 128, 64, 32, 64),
    (1, 8, 8, 64, 16, 64, 64),   # MHA
])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_flash_matches_pallas_kernel(B, H, Hkv, S, D, bq, bk, causal):
    rng = np.random.default_rng(B * S + D)
    q = (rng.normal(size=(B, H, S, D)) * 0.3).astype(np.float32)
    k = (rng.normal(size=(B, Hkv, S, D)) * 0.3).astype(np.float32)
    v = (rng.normal(size=(B, Hkv, S, D)) * 0.3).astype(np.float32)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=causal, block_q=bq, block_k=bk)
    # the port's layout is (B, S, H, D): strided views of the same arrays
    got = ops.flash_attention(_t(q).transpose(1, 2), _t(k).transpose(1, 2),
                              _t(v).transpose(1, 2), causal=causal)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), np.asarray(want),
                               rtol=3e-5, atol=3e-5)


def test_plain_flash_matches_pallas_kernel_bf16():
    rng = np.random.default_rng(0)
    q, k, v = ((rng.normal(size=(1, 2, 64, 32)) * 0.3).astype(ml_dtypes.bfloat16)
               for _ in range(3))
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=True, block_q=32, block_k=32)
    tq, tk, tv = (_t(a.astype(np.float32)).to(torch.bfloat16).transpose(1, 2)
                  for a in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.transpose(1, 2).float().numpy(),
                               np.asarray(want, np.float32), rtol=3e-2, atol=3e-2)


def test_bf16_row_gate_accepts_roundings_and_rejects_planted_faults(monkeypatch):
    """``row_error`` at ``BF16_ROW_TOL``, the gate the kernel is held to in
    bf16: it accepts what only rounding separates (the plain version at
    other tile sizes; the Pallas kernel in interpret mode) and rejects a
    wrong output scale and a key tile lost from the later rows."""
    from repro_torch.kernels import flash_attention as FA

    rng = np.random.default_rng(12)
    B, S, H, Hkv, D = 2, 128, 4, 2, 64
    q, k, v = (_t((rng.normal(size=(B, S, h, D)) * 0.3).astype(np.float32))
               .to(torch.bfloat16) for h in (H, Hkv, Hkv))
    want = FA.flash_attention_plain(q, k, v, causal=True)
    monkeypatch.setattr(FA, "PLAIN_BLOCK", 32)
    retiled = FA.flash_attention_plain(q, k, v, causal=True)
    lost = v.clone()
    lost[:, 64:128] = 0
    tile_fault = want.clone()
    tile_fault[:, S // 2:] = FA.flash_attention_plain(q, k, lost, causal=True)[:, S // 2:]
    pallas = jops.flash_attention(
        *(jnp.asarray(t.transpose(1, 2).float().numpy()).astype(jnp.bfloat16)
          for t in (q, k, v)), causal=True, block_q=64, block_k=64)
    pallas = _t(np.asarray(pallas, np.float32)).transpose(1, 2)
    assert not torch.equal(retiled, want)
    assert FA.row_error(retiled, want) <= FA.BF16_ROW_TOL
    assert FA.row_error(pallas, want) <= FA.BF16_ROW_TOL
    assert FA.row_error((want.float() * 0.9).to(torch.bfloat16), want) > FA.BF16_ROW_TOL
    assert FA.row_error(tile_fault, want) > FA.BF16_ROW_TOL
    nan = want.clone()
    nan[0, 0, 0, 0] = float("nan")
    assert FA.row_error(nan, want) == float("inf")


@pytest.mark.parametrize("sq,skv,causal,prune", [
    (128, 128, True, False),
    (128, 128, True, True),
    (128, 128, False, False),
    (40, 70, True, False),     # ragged, more keys than queries
    (70, 33, True, False),     # ragged, more queries than keys
    (33, 70, False, False),
    (1, 45, False, False),
])
def test_blocked_attention_matches_jax(sq, skv, causal, prune):
    rng = np.random.default_rng(sq * 1000 + skv)
    q = (rng.normal(size=(2, sq, 4, 16)) * 0.4).astype(np.float32)
    k = (rng.normal(size=(2, skv, 2, 16)) * 0.4).astype(np.float32)
    v = (rng.normal(size=(2, skv, 2, 16)) * 0.4).astype(np.float32)
    want = jattn.blocked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   causal=causal, q_block=32, kv_block=32,
                                   prune_causal=prune)
    got = attention.blocked_attention(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_flash_kv_len_masks_the_cache_tail():
    """Keys past ``kv_len`` never count, even when they hold NaN."""
    rng = np.random.default_rng(4)
    q = _t((rng.normal(size=(2, 20, 4, 16)) * 0.4).astype(np.float32))
    k = _t((rng.normal(size=(2, 50, 2, 16)) * 0.4).astype(np.float32))
    v = _t((rng.normal(size=(2, 50, 2, 16)) * 0.4).astype(np.float32))
    want = flash_attention_plain(q, k[:, :31], v[:, :31], causal=False)
    k[:, 31:], v[:, 31:] = float("nan"), float("nan")
    got = ops.flash_attention(q, k, v, causal=False, kv_len=31)
    assert torch.equal(got, want)
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v, causal=False, kv_len=0)


def test_decode_attention_matches_jax():
    B, H, Hkv, Smax, D, L = 2, 4, 2, 32, 16, 9
    rng = np.random.default_rng(3)
    q = (rng.normal(size=(B, 1, H, D)) * 0.4).astype(np.float32)
    kc = (rng.normal(size=(B, Smax, Hkv, D)) * 0.4).astype(np.float32)
    vc = (rng.normal(size=(B, Smax, Hkv, D)) * 0.4).astype(np.float32)
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                  jnp.int32(L))
    got = attention.decode_attention(_t(q), _t(kc), _t(vc), L)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    kc[:, L:], vc[:, L:] = 1e4, float("nan")     # garbage in the unfilled tail
    assert torch.equal(attention.decode_attention(_t(q), _t(kc), _t(vc), L), got)


def test_flash_traffic_counts():
    assert attention_valid_keys(4, 4, True) == 10
    assert attention_valid_keys(6, 4, True) == 10 + 2 * 4
    assert attention_valid_keys(3, 7, False) == 21
    # llama3-8b's prefill shape: about 137 GFLOP
    f = flash_attention_flops(4, 2048, 32, 128, 2048, True)
    assert f == 4 * 4 * 32 * 128 * 2048 * 2049 // 2
    assert 137e9 < f < 138e9


@pytest.mark.parametrize("D,DV,dtype", [
    (d, dv, dt) for d, dv in FA.KERNEL_HEAD_DIMS
    for dt in ((torch.bfloat16, torch.float32) if d == dv else (torch.bfloat16,))])
def test_flash_plan_fits_a_block(D, DV, dtype):
    """Every (q/k, v) width pair's tiles fit the 227 KB a block may hold
    (the pair of two widths runs in bf16 only).  In bf16 that is the
    block's q tile of 128 queries and a ring of at least two stages of k
    and v tiles of 128 keys, swizzle-aligned, with two barriers for q and
    four a stage; the producer and two consumer warpgroups (24 and 240
    registers a thread) fill the SM's 65,536 registers, so one persistent
    block an SM."""
    smem = FA.flash_smem_bytes(D, dtype, DV)
    assert smem <= SMEM_PER_BLOCK
    plan = FA.flash_plan(4, 2048, 32, D, dtype, DV)
    assert plan.smem_bytes == smem
    if dtype == torch.bfloat16:
        assert plan.stages == FA.FWD_STAGES >= 2
        assert plan.threads == FA.FWD_THREADS == 3 * 128
        assert 128 * 24 + 2 * 128 * 240 <= 65536
        assert plan.q_block == FA.FWD_BLOCK == 2 * 64 and plan.key_tile == FA.FWD_KT
        stage = FA.FWD_KT * (D + DV) * 2                # a k and a v tile
        assert smem == (FA.SWIZZLE_PERIOD + FA.FWD_BLOCK * D * 2 + plan.stages * stage
                        + 8 * (2 + 4 * plan.stages))
        # every tile starts on the 128-byte swizzle's 1,024-byte period
        assert (FA.FWD_BLOCK * D * 2) % 1024 == 0 and (FA.FWD_KT * DV * 2) % 1024 == 0
    else:
        assert plan.stages == 0 and plan.threads == 128


@pytest.mark.parametrize("B,Sq,H", [(1, 1, 1), (2, 130, 4), (4, 2048, 32)])
def test_flash_tile_order_covers_each_tile_once(B, Sq, H):
    """The schedule holds every (q tile, batch·head) once.  In bf16 one
    persistent block an SM (or a tile, if fewer) takes every grid[0]-th
    tile; the tiles run heaviest first across heads: the first B·H take
    every head's last q tile (the one with the most keys under the causal
    mask) and no tile is a later one than the one before it.  In f32 each
    batch·head's first block takes its last tile."""
    plan = FA.flash_plan(B, Sq, H, 128, torch.bfloat16)
    nq = -(-Sq // FA.FWD_BLOCK)
    assert plan.grid == (min(nq * B * H, H100_SMS), 1) and plan.persistent
    tiles = plan.tiles()
    assert len(tiles) == len(set(tiles)) == nq * B * H
    assert set(tiles) == {(q, bh) for q in range(nq) for bh in range(B * H)}
    assert tiles[:B * H] == [(nq - 1, bh) for bh in range(B * H)]
    assert all(a[0] >= b[0] for a, b in zip(tiles, tiles[1:]))
    blocks = [plan.block_tiles(x) for x in range(plan.grid[0])]
    assert sorted(x for b in blocks for x in b) == sorted(tiles)
    assert max(map(len, blocks)) - min(map(len, blocks)) <= 1
    # under the causal mask q tile y reads y + 1 key tiles: the blocks'
    # sums stay within 1/32 of their mean
    loads = [sum(y + 1 for y, _ in b) for b in blocks]
    assert max(loads) <= 1.032 * sum(loads) / len(loads) or len(tiles) <= H100_SMS
    assert FA.flash_plan(B, Sq, H, 128, torch.bfloat16, sm_count=7).grid == \
        (min(nq * B * H, 7), 1)
    plan = FA.flash_plan(B, Sq, H, 128, torch.float32)
    nq = -(-Sq // FA.BLOCK_Q)
    assert plan.grid == (nq, B * H) and not plan.persistent
    tiles = plan.tiles()
    assert set(tiles) == {(q, bh) for q in range(nq) for bh in range(B * H)}
    assert all(tiles[bh * nq] == (nq - 1, bh) for bh in range(B * H))


@pytest.mark.parametrize("Sq,Skv,kv_len,causal,walk", [
    # llama3-8b's prefill, the last q tile: 16 whole tiles of 128 keys
    (2048, 2048, 2048, True, [(k, 128) for k in range(0, 2048, 128)]),
    # an unfilled cache tail: the maps end at kv_len = 237, so the second
    # tile reads 109 rows and TMA writes zeros for the other 19
    (150, 300, 237, False, [(0, 128), (128, 109)]),
    # one decode row over the vlm's 1,600 media keys: 13 tiles, the last
    # 64 rows read
    (1, 1600, 1600, False, [(k, min(128, 1600 - k)) for k in range(0, 1600, 128)]),
    # more queries than keys, causal: the keys end the walk first
    (130, 90, 90, True, [(0, 90)]),
])
def test_flash_key_walk(Sq, Skv, kv_len, causal, walk):
    """The bf16 forward's last q tile visits these key tiles, reading these
    rows of each (the rest of a tile past kv_len are zeros); under the
    causal mask the first q tile reads only its own key tile."""
    plan = FA.flash_plan(1, Sq, 4, 128, torch.bfloat16)
    assert plan.key_walk(plan.q_tiles - 1, Sq, kv_len, causal) == walk
    assert all(0 < n <= plan.key_tile and k0 + n <= kv_len for k0, n in walk)
    if causal:
        assert [k0 for k0, _ in plan.key_walk(0, Sq, kv_len, causal)] == [0]


@pytest.mark.parametrize("case,ok", [
    ("contiguous", True),
    ("head-major view", True),
    ("size-1 batch, odd batch stride", True),
    ("address off by one element", False),
    ("head stride of 68 elements", False),
])
def test_flash_copy_alignment_check(case, ok):
    """The bf16 kernel copies 16-byte pieces: a misaligned address or a
    stride that moves it by other than a multiple of 8 elements raises."""
    bf16 = torch.bfloat16
    x = {
        "contiguous": lambda: torch.zeros(2, 64, 4, 64, dtype=bf16),
        "head-major view": lambda: torch.zeros(2, 4, 64, 64, dtype=bf16).transpose(1, 2),
        "size-1 batch, odd batch stride": lambda: torch.zeros(1, 64, 4, 64, dtype=bf16)
        .as_strided((1, 64, 4, 64), (3, 256, 64, 1)),
        "address off by one element": lambda: torch.zeros(2 * 64 * 4 * 64 + 1, dtype=bf16)[1:]
        .view(2, 64, 4, 64),
        "head stride of 68 elements": lambda: torch.zeros(2, 64, 4, 68, dtype=bf16)[..., :64],
    }[case]()
    if ok:
        FA._check_copy_alignment("q", x)
    else:
        with pytest.raises(ValueError, match="16-byte"):
            FA._check_copy_alignment("q", x)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def _close(got, want, dtype, bitwise=False):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    elif bitwise:
        np.testing.assert_array_equal(got, want)
    else:
        assert np.all(np.abs(got - want) <= _bf16_ulp(want))


def _pair(a, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    if dtype == "float32":
        return jnp.asarray(a), _t(a)
    b = a.astype(ml_dtypes.bfloat16)
    return jnp.asarray(b), _t(b.astype(np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    rng = np.random.default_rng(1)
    jx, tx = _pair(rng.normal(size=(2, 5, 64)).astype(np.float32) * 3, dtype)
    jg, tg = _pair((1 + 0.1 * rng.normal(size=(64,))).astype(np.float32), dtype)
    _close(layers.rms_norm(tx, tg, 1e-5), jlayers.rms_norm(jx, jg, 1e-5), dtype,
           bitwise=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_matches_jax(dtype):
    rng = np.random.default_rng(2)
    jx, tx = _pair(rng.normal(size=(2, 9, 4, 16)).astype(np.float32), dtype)
    pos = np.arange(100, 109)[None, :]
    want = jlayers.apply_rope(jx, jnp.asarray(pos), 5e5)
    _close(layers.apply_rope(tx, _t(pos), 5e5), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_forward_matches_jax(dtype):
    rng = np.random.default_rng(3)
    jx, tx = _pair(rng.normal(size=(2, 3, 32)).astype(np.float32), dtype)
    jp, tp = {}, {}
    for name, shape in (("w_gate", (32, 64)), ("w_up", (32, 64)), ("w_down", (64, 32))):
        jp[name], tp[name] = _pair(
            (rng.normal(size=shape) / np.sqrt(shape[0])).astype(np.float32), dtype)
    _close(layers.mlp_forward(tp, tx), jlayers.mlp_forward(jp, jx), dtype)


# ---------------------------------------------------------------------------
# the slice as a whole: reduced dense archs in f32
# ---------------------------------------------------------------------------


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=DENSE)
def arch_pair(request):
    """One reduced dense arch: the JAX model and params, the port's model
    and the same params converted."""
    cfg = get_reduced(request.param)
    jmodel = jbuild(jbase.get_reduced(
        request.param))
    jparams = jmodel.init(jax.random.key(0))
    params = lm_params_from_jax(_tree_np(jparams), cfg, device="cpu")
    return request.param, cfg, jmodel, jparams, build(cfg), params


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(B, S)).astype(np.int32)


def test_reduced_prefill_and_caches_match_jax(arch_pair):
    arch, cfg, jmodel, jparams, model, params = arch_pair
    toks = _tokens(cfg, 2, 12, 5)
    jlogits, jcaches = jax.jit(jmodel.prefill)(jparams, {"tokens": jnp.asarray(toks)})
    logits, caches = model.prefill(params, {"tokens": _t(toks).long()})
    assert logits.shape == (2, 1, cfg.vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
    ours, theirs = _flat(caches), _flat(jcaches)
    assert set(ours) == set(theirs) == {"/scan/0/mixer/k", "/scan/0/mixer/v"}
    for key, b in theirs.items():
        a = ours[key]
        assert tuple(a.shape) == b.shape == (cfg.n_layers, 2, 12, cfg.n_kv_heads, cfg.d_head)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4)


def test_reduced_decode_step_matches_jax(arch_pair):
    arch, cfg, jmodel, jparams, model, params = arch_pair
    B, L, cache_len = 2, 12, 16
    toks = _tokens(cfg, B, L + 1, 6)
    _, jc = jax.jit(jmodel.prefill)(jparams, {"tokens": jnp.asarray(toks[:, :L])})
    grown = jmodel.init_cache(B, cache_len)
    jc = jax.tree.map(lambda d, s: jnp.pad(s, [(0, a - b) for a, b in zip(d.shape, s.shape)]),
                      grown, jc)
    jlogits, jc2 = jax.jit(jmodel.decode_step)(jparams, jc, jnp.asarray(toks[:, L:]),
                                               jnp.int32(L))
    _, c = model.prefill(params, {"tokens": _t(toks[:, :L]).long()},
                         model.init_cache(B, cache_len, device="cpu"))
    logits, c2 = model.decode_step(params, c, _t(toks[:, L:]).long(), L)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
    ours, theirs = _flat(c2), _flat(jc2)
    assert set(ours) == set(theirs)
    for key, b in theirs.items():
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(b), rtol=1e-4, atol=1e-4)


def test_reduced_generate_matches_jax(arch_pair):
    arch, cfg, jmodel, jparams, model, params = arch_pair
    toks = _tokens(cfg, 2, 12, 7)
    want = jserve.generate(jmodel, jparams, {"tokens": jnp.asarray(toks)}, 8, 24)
    got = serve_step.generate(model, params, {"tokens": _t(toks).long()}, 8, 24)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_reduced_teacher_forcing(arch_pair):
    """logits(decode @ pos L | prefill cache of L) == logits(prefill L+1)[-1]."""
    arch, cfg, _, _, model, params = arch_pair
    B, L = 2, 12
    toks = _t(_tokens(cfg, B, L + 1, 3)).long()
    full, _ = model.prefill(params, {"tokens": toks})
    _, caches = model.prefill(params, {"tokens": toks[:, :L]},
                              model.init_cache(B, L + 1, device="cpu"))
    dec, _ = model.decode_step(params, caches, toks[:, L:], L)
    np.testing.assert_allclose(dec[:, 0].numpy(), full[:, -1].numpy(), rtol=2e-3, atol=2e-3)


def test_prefill_writes_the_given_cache_in_place():
    """A prefill into a longer cache fills slots [0, L) with what a prefill
    into its own L-slot cache holds, leaves the rest untouched, and hands
    back the same tensors."""
    cfg = get_reduced("qwen1.5-32b")
    model = build(cfg)
    params = model.init(4, device="cpu")
    toks = _t(_tokens(cfg, 2, 10, 9)).long()
    want_logits, own = model.prefill(params, {"tokens": toks})
    given = model.init_cache(2, 16, device="cpu")
    leaves = tree_leaves(given)
    for t in leaves:
        t.fill_(7.0)
    logits, got = model.prefill(params, {"tokens": toks}, given)
    assert torch.equal(logits, want_logits)
    for a, g, o in zip(leaves, tree_leaves(got), tree_leaves(own)):
        assert a is g and o.shape[2] == 10 and g.shape[2] == 16
        assert torch.equal(g[:, :, :10], o)
        assert bool((g[:, :, 10:] == 7.0).all())


def test_temperature_sampling_uses_the_generator():
    cfg = get_reduced("llama3-8b")
    model = build(cfg)
    params = model.init(0, device="cpu")
    toks = torch.zeros((2, 4), dtype=torch.long)
    decode = serve_step.make_decode_step(model, sample="temperature", temperature=0.7)
    draws = []
    for _ in range(2):
        _, caches = model.prefill(params, {"tokens": toks},
                                  model.init_cache(2, 8, device="cpu"))
        nxt, _ = decode(params, caches, toks[:, -1:], 4,
                        generator=torch.Generator().manual_seed(9))
        draws.append(nxt)
    assert draws[0].shape == (2, 1) and torch.equal(draws[0], draws[1])


# ---------------------------------------------------------------------------
# configs, conversion, devices
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE + ["mamba2-1.3b", "jamba-v0.1-52b"])
def test_configs_and_param_counts_match_jax(arch):
    """Every field of the port's config equals the JAX config's (a
    sub-config, ``ssm`` or ``moe``, field for field); the JAX fields the
    port does not carry hold their defaults in these archs (so leaving
    them out changes nothing)."""
    import dataclasses

    from repro.models.transformer import count_params

    jfields = {f.name: f for f in dataclasses.fields(jbase.ModelConfig)}
    ours_only = {f.name for f in dataclasses.fields(get_config(arch))} - set(jfields)
    assert not ours_only
    for ours, theirs in ((get_config(arch), jbase.get_config(arch)),
                         (get_reduced(arch), jbase.get_reduced(arch))):
        for f in dataclasses.fields(ours):
            a, b = getattr(ours, f.name), getattr(theirs, f.name)
            if dataclasses.is_dataclass(a) or dataclasses.is_dataclass(b):
                assert dataclasses.asdict(a) == dataclasses.asdict(b), f.name
            else:
                assert a == b, f.name
        for name, f in jfields.items():
            if not hasattr(ours, name):
                assert getattr(theirs, name) == f.default, name
        assert ours.param_count() == count_params(theirs)


def test_unported_families_raise():
    """Every arch of ARCH_IDS is ported, the vlm and audio ones too: each
    config and reduced config loads with the JAX arch's family.  Only an
    arch outside ARCH_IDS raises."""
    assert sorted(PORTED_ARCHS) == sorted(ARCH_IDS)
    for arch in ARCH_IDS:
        assert get_config(arch).family == jbase.get_config(arch).family
        assert get_reduced(arch).family == get_config(arch).family
    assert {get_config(a).family for a in ("llama-3.2-vision-90b",
                                           "seamless-m4t-large-v2")} == {"vlm", "audio"}
    with pytest.raises(ValueError):
        get_config("gpt-2")


def test_model_init_is_seeded_and_shaped():
    cfg = get_reduced("qwen3-1.7b")
    a = build(cfg).init(3, device="cpu")
    b = build(cfg).init(3, device="cpu")
    for x, y, s in zip(tree_leaves(a), tree_leaves(b), tree_leaves(param_shapes(cfg))):
        assert torch.equal(x, y) and x.shape == s.shape and x.dtype == s.dtype
    assert "lm_head" not in a     # tied embeddings
    w = a["layers"]["scan"]["0"]["ffn"]["w_gate"]
    assert w.shape == (cfg.n_layers, cfg.d_model, cfg.d_ff)
    assert abs(float(w.std()) - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
    assert abs(float(a["embed"].std()) - 0.02) < 0.002


def test_lm_params_from_jax_bf16_round_trip_and_checks():
    cfg = get_reduced("qwen1.5-32b").replace(dtype="bfloat16")
    jparams = _tree_np(jbuild(
        jbase.get_reduced("qwen1.5-32b")
        .replace(dtype="bfloat16")).init(jax.random.key(1)))
    params = lm_params_from_jax(jparams, cfg, device="cpu")
    ours, theirs = _flat(params), _flat(jparams)
    assert set(ours) == set(theirs)
    for key, b in theirs.items():
        assert ours[key].dtype == torch.bfloat16
        np.testing.assert_array_equal(ours[key].float().numpy(), b.astype(np.float32))
    bad = dict(jparams, w_bogus=np.zeros(2, ml_dtypes.bfloat16))
    with pytest.raises(ValueError, match="unknown keys"):
        lm_params_from_jax(bad, cfg, device="cpu")
    bad = dict(jparams, ln_f=np.ones(cfg.d_model + 1, ml_dtypes.bfloat16))
    with pytest.raises(ValueError, match="shape"):
        lm_params_from_jax(bad, cfg, device="cpu")
    bad = dict(jparams, ln_f=np.ones(cfg.d_model, np.float32))
    with pytest.raises(ValueError, match="dtype"):
        lm_params_from_jax(bad, cfg, device="cpu")


def test_lm_entry_points_without_cuda_raise_unless_cpu_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_reduced("llama3-8b")
    model = build(cfg)
    jparams = _tree_np(jbuild(
        jbase.get_reduced("llama3-8b"))
        .init(jax.random.key(0)))
    for call in (lambda: model.init(0), lambda: model.init_cache(2, 8),
                 lambda: lm_params_from_jax(jparams, cfg)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert tree_leaves(model.init_cache(2, 8, device="cpu"))[0].device.type == "cpu"
