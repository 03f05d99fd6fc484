"""The port's dense-LM training path against the JAX package.

The JAX functions are called directly, outside any mesh (the JAX CLI,
``repro.launch.train``, fails under ``make_debug_mesh(1, 1)`` on this JAX
version: a reference-side failure).  Inputs are NumPy arrays from a seed;
weights and optimizer state go across through ``lm_params_from_jax`` and
``adamw_state_from_jax``.  On the CPU the port's attention runs the flash
kernels' plain versions, forward and backward
(``FlashAttentionFn``); the JAX side differentiates
``blocked_attention`` with ``jax.vjp`` / ``jax.grad``.

Tolerances, stated once:
* ``cross_entropy`` in f32: ``1e-6`` (the same f32 ``logsumexp``; in bf16
  both take the logits to f32 first);
* attention in f32: ``1e-5`` of each tensor's max|.| (f32 sums of at
  most 300 terms in another order, and the backward recomputes P from
  ``lse`` where JAX differentiates the online softmax); a gradient that
  is zero in theory (JAX gives exact zeros for dq and dk with one key)
  against the largest of the three;
* attention in bf16: per row, ``BWD_BF16_ROW_TOL`` of the row's scale
  (``kernels/flash_attention.py:grad_row_error``, justified there);
* the reduced models in f32: loss and metrics ``1e-5``, every gradient
  leaf ``1e-4`` of its max|g| (matmul sums in another order through four
  layers); ``make_train_step`` ``1e-4`` of each leaf's max|.| for params,
  ``mu``, ``nu`` and the metrics after each of 3 steps;
* AdamW alone: ``1e-6`` relative (``pow``, ``sqrt`` and ``cos`` may
  differ in the last f32 bit between XLA and PyTorch);
* the token stream, checkpoints, ``remat`` modes and a resumed CLI run:
  bitwise.
"""

import signal

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.data.tokens import TokenStream as JTokenStream
from repro.data.tokens import TokenStreamConfig as JTokenStreamConfig
from repro.distributed.checkpoint import CheckpointManager as JCheckpointManager
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models.model import build as jbuild
from repro.optim import adamw as jadamw
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch.configs.base import PORTED_ARCHS, get_reduced
from repro_torch.convert import adamw_state_from_jax, lm_params_from_jax
from repro_torch.data.tokens import TokenStream, TokenStreamConfig
from repro_torch.distributed.checkpoint import CheckpointManager, place_like
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.kernels.traffic import (
    attention_valid_keys,
    flash_attention_bwd_bytes,
    flash_attention_bwd_flops,
)
from repro_torch.launch import train as launch_train
from repro_torch.models import layers
from repro_torch.models.model import build
from repro_torch.models.transformer import tree_leaves
from repro_torch.optim import adamw
from repro_torch.train.train_step import abstract_opt_state, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype=np.float32)))


def _flat(tree, path=""):
    """``{path: leaf}`` of a tree of dicts and lists (either package's)."""
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _flat(tree[key], f"{path}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, t in enumerate(tree) for k, v in _flat(t, f"{path}/{i}").items()}
    return {path: tree}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close_leafwise(ours, theirs, tol, what=""):
    """Every leaf of ``ours`` within ``tol`` of the matching JAX leaf's
    max|.|, compared by key path."""
    a, b = _flat(ours), _flat(theirs)
    assert set(a) == set(b), what
    for key, want in b.items():
        want = np.asarray(want, np.float32)
        got = a[key].detach().float().numpy()
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(got - want).max()) <= tol * scale, f"{what}{key}"


# ---------------------------------------------------------------------------
# cross entropy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(dtype, masked):
    rng = np.random.default_rng(3)
    logits = (rng.normal(size=(3, 7, 50)) * 3).astype(np.float32)
    targets = rng.integers(0, 50, size=(3, 7)).astype(np.int32)
    targets[0, :3] = logits[0, :3].argmax(-1)          # some right answers
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32) if masked else None
    jl = jnp.asarray(logits).astype(dtype)
    want_loss, want = jlayers.cross_entropy(
        jl, jnp.asarray(targets), None if mask is None else jnp.asarray(mask))
    tl = _t(logits).to(getattr(torch, dtype))
    loss, got = layers.cross_entropy(tl, _t(targets).long(),
                                     None if mask is None else _t(mask))
    assert set(got) == set(want) == {"loss", "accuracy", "tokens"}
    assert got["loss"] is loss and loss.dtype == torch.float32
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, atol=1e-6)
    assert float(want["accuracy"]) > 0


# ---------------------------------------------------------------------------
# attention: forward with lse, backward, the autograd Function
# ---------------------------------------------------------------------------


def _attn_inputs(S, dtype=np.float32, seed=0, B=2, H=4, Hkv=2, D=32):
    rng = np.random.default_rng(seed + S)
    shapes = [((B, S, H, D), 0.3), ((B, S, Hkv, D), 0.3), ((B, S, Hkv, D), 0.3),
              ((B, S, H, D), 1.0)]
    return [(rng.normal(size=s) * sc).astype(np.float32).astype(dtype) for s, sc in shapes]


def _jax_vjp(q, k, v, do, causal):
    f = lambda q, k, v: jattn.blocked_attention(q, k, v, causal=causal)
    o, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return o, vjp(jnp.asarray(do))


def _port_grads(q, k, v, do, causal, dtype=torch.float32):
    tq, tk, tv = (_t(a).to(dtype).requires_grad_() for a in (q, k, v))
    o = ops.flash_attention(tq, tk, tv, causal=causal)
    return o, torch.autograd.grad(o, (tq, tk, tv), _t(do).to(dtype))


@pytest.mark.parametrize("S", [1, 64, 130])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_fn_matches_jax_vjp_f32(S, causal):
    q, k, v, do = _attn_inputs(S)
    want_o, want = _jax_vjp(q, k, v, do, causal)
    o, got = _port_grads(q, k, v, do, causal)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(want_o), rtol=0,
                               atol=1e-5 * float(np.abs(want_o).max()))
    scale = max(float(np.abs(w).max()) for w in want)
    for name, g, w in zip("qkv", got, want):
        w = np.asarray(w)
        limit = 1e-5 * (float(np.abs(w).max()) or scale)   # zero in theory: the largest
        assert float(np.abs(g.numpy() - w).max()) <= limit, name


def _drop_q_tile(q, k, v, o, lse, do, causal, grads):
    """dk and dv without the contributions of q tile 1 (rows 64-127)."""
    cut = do.clone()
    cut[:, FA.BLOCK_Q:2 * FA.BLOCK_Q] = 0
    _, dk, dv = FA.flash_attention_bwd_plain(q, k, v, o, lse, cut, causal=causal)
    return grads[0], dk, dv


@pytest.mark.parametrize("S,causal", [(64, True), (130, True), (130, False), (300, True)])
def test_flash_fn_bf16_within_the_row_gate_and_gate_rejects_faults(S, causal):
    bf = ml_dtypes.bfloat16
    q, k, v, do = _attn_inputs(S, dtype=bf)
    _, want = _jax_vjp(q, k, v, do, causal)
    _, got = _port_grads(q, k, v, do, causal, torch.bfloat16)
    want = [_t(w) for w in want]
    gate = lambda gs: max(FA.grad_row_error(g, w) for g, w in zip(gs, want))
    assert all(g.dtype == torch.bfloat16 for g in got)
    assert gate(got) <= FA.BWD_BF16_ROW_TOL
    assert gate((got[0], (got[1].float() * 0.9).to(torch.bfloat16), got[2])) > \
        FA.BWD_BF16_ROW_TOL
    if S > 2 * FA.BLOCK_Q:
        tq, tk, tv, tdo = (_t(a).to(torch.bfloat16) for a in (q, k, v, do))
        _, lse, o32 = FA.flash_attention_plain(tq, tk, tv, causal=causal, return_lse=True)
        assert gate(_drop_q_tile(tq, tk, tv, o32, lse, tdo, causal, got)) > \
            FA.BWD_BF16_ROW_TOL


@pytest.mark.parametrize("causal,kv_len", [(True, None), (False, None), (False, 90)])
def test_plain_lse_is_logsumexp_of_masked_scores(causal, kv_len):
    q, k, v, _ = _attn_inputs(130)
    tq, tk, tv = (_t(a) for a in (q, k, v))
    o, lse, o32 = FA.flash_attention_plain(tq, tk, tv, causal=causal, kv_len=kv_len,
                                           return_lse=True)
    assert o32 is o     # in f32 the output is its own unrounded output
    assert torch.equal(o, FA.flash_attention_plain(tq, tk, tv, causal=causal,
                                                   kv_len=kv_len))
    B, S, H, D = tq.shape
    kk = tk.repeat_interleave(H // tk.shape[2], dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", tq, kk) * D ** -0.5
    valid = torch.ones(S, S, dtype=torch.bool)
    if causal:
        valid = valid.tril()
    if kv_len is not None:
        valid[:, kv_len:] = False
    want = torch.logsumexp(s.masked_fill(~valid, float("-inf")), dim=-1)
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, want, rtol=0, atol=1e-5)


def test_flash_attention_differentiates_only_with_grad():
    q, k, v, do = (_t(a) for a in _attn_inputs(70))
    ops.reset_launch_counts()
    plain = ops.flash_attention(q, k, v, causal=True)
    q.requires_grad_()
    o = ops.flash_attention(q, k, v, causal=True)
    assert o.grad_fn is not None and torch.equal(o.detach(), plain)
    with torch.no_grad():
        assert ops.flash_attention(q, k, v, causal=True).grad_fn is None
    with pytest.raises(ValueError, match="kv_len"):
        ops.flash_attention(q, k, v, causal=True, kv_len=40)
    assert ops.launches["flash_attention_bwd"] == 0    # the CPU launches nothing
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    plan = FA.flash_bwd_plan(B, S, S, H, Hkv, D, torch.bfloat16)
    # one dK/dV block of 128 keys a KV head, one dQ block of 128 queries for
    # each pair of query heads of a KV head (G = 2)
    assert plan.dkdv_grid == (B * Hkv, 1) and plan.dq_grid == (B * H // 2, 1)
    assert plan.dq_heads == 2 and plan.threads == FA.BWD_THREADS
    assert plan.delta_grid == (B * S, -(-H // plan.delta_rows))
    assert plan.sq_pad % 128 == 0 and plan.sq_pad >= S


@pytest.mark.parametrize("D,DV,dtype", [
    (d, dv, dt) for d, dv in FA.KERNEL_HEAD_DIMS
    for dt in ((torch.bfloat16, torch.float32) if d == dv else (torch.bfloat16,))])
def test_flash_bwd_plan_fits_a_block(D, DV, dtype):
    """Every pair's blocks fit the 227 KB a block may hold: at (192, 128)
    with one head a dQ block, the plan's choice there (two heads would
    need 286,720 bytes)."""
    from repro_torch.kernels.launch import SMEM_PER_BLOCK

    for dq_heads in ((1, 2) if D <= 128 else (1,)):
        dkdv, dq = FA.flash_bwd_smem_bytes(D, dtype, dq_heads, DV)
        assert dkdv <= SMEM_PER_BLOCK and dq <= SMEM_PER_BLOCK
    if D > 128:
        assert FA.flash_bwd_smem_bytes(D, dtype, 2, DV)[1] == 286_720 + 1024 + 56
        assert FA.flash_bwd_plan(1, 256, 256, 16, 8, D, dtype, DV).dq_heads == 1
    if dtype == torch.bfloat16 and D == 128:
        # a bf16 block fills an SM: its 384 threads take the register file
        # (168 registers each) and more than half of the shared memory
        assert 2 * dkdv > 228 * 1024 and 2 * dq > 228 * 1024


def _pair_visits(plan, Sq, Skv, causal):
    """How often the dK/dV walk and the dQ walk of ``plan`` visit each
    (query, key) pair, and the (q tile, KV tile) pairs each visits."""
    dkdv = np.zeros((Sq, Skv), np.int64)
    dq = np.zeros((Sq, Skv), np.int64)
    tiles = {"dkdv": [], "dq": []}
    for x in range(plan.dkdv_grid[1]):
        k0 = x * plan.key_tile
        for q0 in plan.dkdv_walk(x, Sq, causal):
            dkdv[q0:q0 + plan.q_tile, k0:k0 + plan.key_tile] += 1
            tiles["dkdv"].append((q0, plan.q_tile, k0, plan.key_tile))
    for y in range(plan.dq_grid[1]):
        q0 = y * plan.q_block
        for k0 in plan.dq_walk(y, Sq, Skv, causal):
            dq[q0:q0 + plan.q_block, k0:k0 + plan.kv_tile] += 1
            tiles["dq"].append((q0, plan.q_block, k0, plan.kv_tile))
    return dkdv, dq, tiles


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("Sq,Skv,causal", [(1, 1, True), (70, 150, False), (70, 150, True),
                                           (150, 90, True), (200, 200, True),
                                           (330, 130, False), (1000, 1000, True),
                                           (1000, 1000, False)])
def test_flash_bwd_plan_covers_every_causal_pair(Sq, Skv, causal, dtype):
    """The dK/dV walk (KV tiles over q tiles) and the dQ walk (q blocks
    over KV tiles) each visit every unmasked (query, key) pair exactly
    once, and no (q tile, KV tile) without an unmasked pair."""
    plan = FA.flash_bwd_plan(2, Sq, Skv, 8, 2, 64, dtype)
    unmasked = np.ones((Sq, Skv), bool)
    if causal:
        unmasked = np.tril(unmasked)
    dkdv, dq, tiles = _pair_visits(plan, Sq, Skv, causal)
    for name, visits in (("dkdv", dkdv), ("dq", dq)):
        assert (visits[unmasked] == 1).all(), name
        for q0, nq, k0, nk in tiles[name]:
            assert unmasked[q0:q0 + nq, k0:k0 + nk].any(), (name, q0, k0)


# The views the card cases hand the backward (tests/test_torch_cuda.py
# BWD_CASES and chip_smoke.py BWD_CASES): B, Sq, Skv, H, Hkv, D, strided
# (q, k and v (B, S, heads, D) views of (B, heads, S, D) tensors)
CARD_BWD_VIEWS = [
    (2, 200, 200, 16, 4, 128, False), (2, 256, 256, 8, 8, 64, False),
    (1, 130, 130, 8, 2, 128, True), (1, 1, 1, 4, 2, 32, False),
    (1, 70, 150, 4, 1, 16, False), (1, 150, 90, 4, 2, 64, True),
    (2, 1000, 1000, 32, 4, 128, False), (1, 330, 330, 6, 2, 64, False),
    (4, 2048, 2048, 16, 8, 128, False), (4, 2048, 2048, 32, 8, 128, False),
    (2, 1000, 1000, 16, 8, 128, False), (2, 700, 700, 16, 8, 128, True),
]


@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D,strided", CARD_BWD_VIEWS)
def test_flash_bwd_tma_checks_accept_the_card_views(B, Sq, Skv, H, Hkv, D, strided):
    """The bf16 backward's tensor maps take every q, k and v view the card
    cases use (CPU tensors, no launch): their strides as they are."""
    def one(S, heads):
        if strided:
            return torch.empty(B, heads, S, D, dtype=torch.bfloat16).transpose(1, 2)
        return torch.empty(B, S, heads, D, dtype=torch.bfloat16)
    for name, t in (("q", one(Sq, H)), ("k", one(Skv, Hkv)), ("v", one(Skv, Hkv))):
        got = FA.tma_strides(name, t)
        assert all(g == s for g, s, n in zip(got, t.stride(), t.shape) if n > 1), name
        assert all(g * 2 % 16 == 0 for g in got), name


@pytest.mark.parametrize("case", ["head stride of 68 elements", "sequence stride of 3 heads",
                                  "address off by one element", "batch stride of 2^40 bytes",
                                  "odd stride of a length-1 dimension"])
def test_flash_bwd_tma_checks_refuse_misaligned_strides(case):
    """A stride that is not a multiple of 16 bytes (or too long for a
    tensor map), or an address off the 16-byte grid, raises before any
    launch; a length-1 dimension is never stepped, so its stride is free."""
    bf16 = torch.bfloat16
    x = {
        "head stride of 68 elements": lambda: torch.empty(2, 64, 4, 68, dtype=bf16)[..., :64],
        "sequence stride of 3 heads": lambda: torch.empty(2, 64, 3, 20, dtype=bf16)[..., :16],
        "address off by one element": lambda: torch.empty(2 * 64 * 4 * 64 + 1, dtype=bf16)[1:]
        .view(2, 64, 4, 64),
        "batch stride of 2^40 bytes": lambda: torch.empty(2, 64, 4, 64, dtype=bf16,
                                                          device="meta")
        .as_strided((2, 64, 4, 64), (2 ** 39, 256, 64, 1)),
        "odd stride of a length-1 dimension": lambda: torch.empty(1, 64, 4, 64, dtype=bf16)
        .as_strided((1, 64, 4, 64), (3, 256, 64, 1)),
    }[case]()
    if case.startswith("odd stride"):
        assert FA.tma_strides("q", x) == (64 * 4 * 64, 256, 64)
        return
    with pytest.raises(ValueError, match="16-byte"):
        FA.tma_strides("q", x)


def test_ptxas_report_reads_registers_and_spills():
    """``build.ptxas_report`` turns an ``-Xptxas -v`` log into registers and
    spill bytes per kernel (the card's no-spill check reads it)."""
    from repro_torch.kernels import build

    log = """ptxas info    : Compiling entry function '_Z3fooILi128EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z3fooILi128EEvv
    8 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 8 bytes cumulative stack size
ptxas info    : Compiling entry function '_Z3barv' for 'sm_90a'
ptxas info    : Function properties for _Z3barv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers"""
    assert build.ptxas_report(log) == {
        "_Z3fooILi128EEvv": dict(registers=255, spill_stores=8, spill_loads=12),
        "_Z3barv": dict(registers=168, spill_stores=0, spill_loads=0)}


def test_ptxas_log_reads_the_saved_report(tmp_path, monkeypatch):
    """A cached library's report comes from the file saved beside it, and
    ``build_log`` stays empty (the chaos workers report ``built`` from it)."""
    from repro_torch.kernels import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "build_log", {})
    assert build.ptxas_log() == ""
    build._library_path().with_suffix(".ptxas.txt").write_text("saved report")
    assert build.ptxas_log() == "saved report" and not build.build_log
    monkeypatch.setattr(build, "build_log", {"ptxas": "this build"})
    assert build.ptxas_log() == "this build"


@pytest.mark.parametrize("Sq,Skv,causal", [(5, 5, True), (7, 3, True), (3, 7, False),
                                           (130, 130, True)])
def test_flash_bwd_traffic_counts(Sq, Skv, causal):
    """Five products of 2·D operations per unmasked (query, key) pair, and
    q, k, v, o, dO, lse read, dq, dk, dv written once each."""
    B, H, Hkv, D = 2, 4, 2, 16
    pairs = sum(1 for i in range(Sq) for j in range(Skv) if not causal or j <= i)
    assert attention_valid_keys(Sq, Skv, causal) == pairs
    assert flash_attention_bwd_flops(B, Sq, H, D, Skv, causal) == 10 * B * H * D * pairs
    assert flash_attention_bwd_bytes(B, Sq, Skv, H, Hkv, D, 2) == (
        2 * 4 * B * Sq * H * D + 2 * 4 * B * Skv * Hkv * D + 4 * B * H * Sq)
    # qwen3-1.7b's training shape: 171.8 GFLOP
    f = flash_attention_bwd_flops(4, 2048, 16, 128, 2048, True)
    assert 171.7e9 < f < 171.9e9


# ---------------------------------------------------------------------------
# the reduced archs: train_loss and its gradients
# ---------------------------------------------------------------------------


def _batch(cfg, B, S, seed):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, size=(B, S + 1))
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)


@pytest.fixture(scope="module", params=PORTED_ARCHS)
def grads_pair(request):
    """One reduced arch: JAX's loss, metrics and gradients on one batch, and
    the port's model with the same params."""
    arch = request.param
    jmodel = jbuild(jbase.get_reduced(arch))
    jparams = jmodel.init(jax.random.key(0))
    cfg = get_reduced(arch)
    toks, tgts = _batch(cfg, 2, 24, 4)
    jb = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgts)}
    batch = {"tokens": _t(toks).long(), "targets": _t(tgts).long()}
    # the vlm's media and the audio's source frames (24 of them), the same
    # f32 arrays for both
    stub = {"vlm": ("media", cfg.n_media_tokens), "audio": ("src_embeds", 24)}
    if cfg.family in stub:
        key, n = stub[cfg.family]
        mem = np.random.default_rng(5).standard_normal((2, n, cfg.d_model)) * 0.02
        jb[key], batch[key] = jnp.asarray(mem, jnp.float32), _t(mem)
    (jloss, jm), jg = jax.jit(jax.value_and_grad(jmodel.train_loss, has_aux=True))(
        jparams, jb)
    params = lm_params_from_jax(_np_tree(jparams), cfg, device="cpu")
    return cfg, build(cfg), params, batch, float(jloss), _np_tree(jm), _np_tree(jg)


def _port_loss_and_grads(model, params, batch):
    live = {k: v for k, v in _flat(params).items()}
    for t in live.values():
        t.requires_grad_()
    loss, metrics = model.train_loss(params, batch)
    grads = torch.autograd.grad(loss, list(live.values()))
    for t in live.values():
        t.requires_grad_(False)
    return loss, metrics, dict(zip(live, grads))


@pytest.mark.parametrize("chunk", [None, 10])
def test_reduced_train_loss_and_grads_match_jax(grads_pair, chunk, monkeypatch):
    """``chunk`` 10 takes the 48 tokens' logits and loss in five checkpointed
    chunks (the last ragged), as the full-size vocabulary's 8,192 tokens
    go in chunks of ``LOSS_CHUNK``."""
    from repro_torch.models import model as model_mod

    if chunk is not None:
        monkeypatch.setattr(model_mod, "LOSS_CHUNK", chunk)
    cfg, model, params, batch, jloss, jm, jg = grads_pair
    loss, metrics, grads = _port_loss_and_grads(model, params, batch)
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=1e-5, atol=1e-5)
    assert set(metrics) == set(jm) == {"loss", "accuracy", "tokens", "aux_loss"}
    for k in jm:
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]), rtol=1e-5, atol=1e-5)
    for key, want in _flat(jg).items():
        scale = float(np.abs(want).max())
        assert float(np.abs(grads[key].numpy() - want).max()) <= 1e-4 * scale, key


def test_remat_modes_give_identical_gradients():
    """remat off, "full" and "dots" run the same arithmetic: the same bits.
    "dots" keeps the 2-D matmuls' outputs, so its backward runs fewer of
    them than "full"; another policy raises."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountMM(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += func is torch.ops.aten.mm.default
            return func(*args, **(kwargs or {}))

    cfg = get_reduced("qwen3-1.7b")
    params = build(cfg).init(2, device="cpu")
    toks, tgts = _batch(cfg, 2, 40, 5)
    batch = {"tokens": _t(toks).long(), "targets": _t(tgts).long()}
    grads, mms = {}, {}
    for remat, policy in [(False, "full"), (True, "full"), (True, "dots")]:
        model = build(cfg.replace(remat=remat, remat_policy=policy))
        live = list(_flat(params).values())
        for t in live:
            t.requires_grad_()
        loss, _ = model.train_loss(params, batch)
        count = CountMM()
        with count:
            grads[remat, policy] = torch.autograd.grad(loss, live)
        for t in live:
            t.requires_grad_(False)
        mms[remat, policy] = count.n
    base = grads[False, "full"]
    for key, g in grads.items():
        assert all(torch.equal(a, b) for a, b in zip(base, g)), key
    assert mms[True, "dots"] == mms[False, "full"] < mms[True, "full"]
    with pytest.raises(ValueError, match="remat_policy"):
        build(cfg.replace(remat_policy="offload")).train_loss(params, batch)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("clip", [None, 0.05])
def test_adamw_matches_jax_over_12_steps(clip):
    cfg = dict(lr=1e-2, warmup_steps=3, decay_steps=10, clip=clip)
    jopt, opt = jadamw.AdamW(jadamw.AdamWConfig(**cfg)), adamw.AdamW(adamw.AdamWConfig(**cfg))
    rng = np.random.default_rng(8)
    p0 = {"w": rng.normal(size=(3, 4)).astype(np.float32),
          "layers": {"b": rng.normal(size=(5,)).astype(np.float32)}}
    jp, jst = jax.tree.map(jnp.asarray, p0), None
    jst = jopt.init(jp)
    tp = jax.tree.map(_t, p0)
    st = opt.init(tp)
    assert st["step"].dtype == torch.int32
    for i in range(12):
        g = jax.tree.map(lambda a: (rng.normal(size=a.shape) * 0.1).astype(np.float32), p0)
        jp, jst, jm = jopt.update(jp, jax.tree.map(jnp.asarray, g), jst)
        tp, st, m = opt.update(tp, jax.tree.map(_t, g), st)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(
            float(adamw.schedule(opt.cfg, torch.tensor(i, dtype=torch.int32))),
            float(jadamw.schedule(jopt.cfg, jnp.int32(i))), rtol=1e-6, atol=1e-12)
        assert int(st["step"]) == int(jst["step"]) == i + 1
        for ours, theirs in ((tp, jp), (st["mu"], jst["mu"]), (st["nu"], jst["nu"])):
            _close_leafwise(ours, theirs, 1e-6, f"step {i} ")


def test_adamw_schedule_and_descent():
    cfg = adamw.AdamWConfig(lr=5e-2, warmup_steps=5, decay_steps=200, weight_decay=0.0,
                            clip=None)
    assert float(adamw.schedule(cfg, torch.tensor(0, dtype=torch.int32))) == 0.0
    assert abs(float(adamw.schedule(cfg, torch.tensor(5, dtype=torch.int32))) - 5e-2) < 1e-9
    opt = adamw.AdamW(cfg)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt.init(params)
    for _ in range(150):
        grads = {"w": 2 * params["w"]}
        params, state, m = opt.update(params, grads, state)
    assert float(params["w"].abs().max()) < 0.5
    assert np.isfinite(float(m["grad_norm"]))


def test_adamw_clip():
    opt = adamw.AdamW(adamw.AdamWConfig(clip=1.0, warmup_steps=0, decay_steps=10))
    params = {"w": torch.zeros(3)}
    state = opt.init(params)
    new, _, m = opt.update(params, {"w": torch.full((3,), 1e6)}, state)
    assert float(m["grad_norm"]) > 1e5   # reported pre-clip
    assert torch.equal(params["w"], torch.zeros(3))   # the inputs are left as they were
    assert new["w"].dtype == torch.float32


# ---------------------------------------------------------------------------
# make_train_step against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "llama3-8b"])
@pytest.mark.parametrize("n_micro", [1, 2])
def test_make_train_step_matches_jax(arch, n_micro):
    jcfg, cfg = jbase.get_reduced(arch), get_reduced(arch)
    jmodel = jbuild(jcfg)
    jopt = jadamw.AdamW(jadamw.AdamWConfig(lr=1e-3, warmup_steps=2, decay_steps=3))
    opt = adamw.AdamW(adamw.AdamWConfig(lr=1e-3, warmup_steps=2, decay_steps=3))
    jparams = jmodel.init(jax.random.key(1))
    jstate = jopt.init(jparams)
    params = lm_params_from_jax(_np_tree(jparams), cfg, device="cpu")
    state = adamw_state_from_jax(_np_tree(jstate), cfg, device="cpu")
    jstep = jax.jit(jmake_train_step(jmodel, jopt, n_micro=n_micro))
    step = make_train_step(build(cfg), opt, n_micro=n_micro)
    scfg = dict(vocab=cfg.vocab, batch=4, seq_len=16, seed=3)
    jstream = JTokenStream(JTokenStreamConfig(**scfg))
    stream = TokenStream(TokenStreamConfig(**scfg), device="cpu")
    for i in range(3):
        jparams, jstate, jm = jstep(jparams, jstate, next(jstream))
        params, state, m = step(params, state, next(stream))
        assert set(m) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {i} {k}")
        for ours, theirs, what in ((params, jparams, "params"), (state["mu"], jstate["mu"], "mu"),
                                   (state["nu"], jstate["nu"], "nu")):
            _close_leafwise(ours, _np_tree(theirs), 1e-4, f"step {i} {what}")
    assert int(state["step"]) == 3


def test_abstract_opt_state_is_meta_and_shaped():
    cfg = get_reduced("llama3-8b")
    params = build(cfg).init(0, device="cpu")
    spec = abstract_opt_state(params)
    real = adamw.AdamW(adamw.AdamWConfig()).init(params)
    for a, b in zip(tree_leaves(spec["mu"]), tree_leaves(real["mu"])):
        assert a.device.type == "meta" and a.shape == b.shape and a.dtype == torch.float32
    assert spec["step"].dtype == torch.int32


# ---------------------------------------------------------------------------
# token stream
# ---------------------------------------------------------------------------


def test_token_stream_is_the_jax_stream_bitwise():
    scfg = dict(vocab=151936, batch=2, seq_len=33, seed=4)
    jstream = JTokenStream(JTokenStreamConfig(**scfg))
    stream = TokenStream(TokenStreamConfig(**scfg), device="cpu")
    jb = [next(jstream) for _ in range(8)]
    b = [next(stream) for _ in range(8)]
    for pos in (0, 1, 7):
        for key in ("tokens", "targets"):
            assert b[pos][key].dtype == torch.int64
            np.testing.assert_array_equal(b[pos][key].numpy(), np.asarray(jb[pos][key]))
    resumed = TokenStream(TokenStreamConfig(**scfg), position=5, device="cpu")
    assert torch.equal(next(resumed)["tokens"], b[5]["tokens"])
    assert resumed.position == 6
    # the vlm family's stream: the same tokens, then the media stub
    vcfg = dict(scfg, family="vlm", d_model=8, n_media_tokens=3)
    jv, v = next(JTokenStream(JTokenStreamConfig(**vcfg))), next(
        TokenStream(TokenStreamConfig(**vcfg), device="cpu"))
    assert torch.equal(v["tokens"], b[0]["tokens"]) and v["media"].shape == (2, 3, 8)
    np.testing.assert_array_equal(v["media"].numpy(), np.asarray(jv["media"]))


def test_training_entry_points_need_the_card_unless_cpu_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TokenStream(TokenStreamConfig(vocab=10, batch=1, seq_len=4))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_train.main(["--arch", "qwen3-1.7b", "--reduced", "--steps", "1"])


# ---------------------------------------------------------------------------
# checkpoints: bf16 leaves
# ---------------------------------------------------------------------------


def _bf16_tree(seed):
    g = torch.Generator().manual_seed(seed)
    w = torch.randn(4, 6, generator=g).to(torch.bfloat16)
    w[0, :3] = torch.tensor([float("inf"), -0.0, float("nan")])
    return {"w": w, "n": torch.arange(5, dtype=torch.int32),
            "f": torch.randn(3, generator=g), "layers": [torch.randn(2, 2, generator=g)
                                                         .to(torch.bfloat16)]}


def _same_bits(a, b):
    if a.dtype == torch.bfloat16:
        return b.dtype == torch.bfloat16 and torch.equal(a.view(torch.int16),
                                                         b.view(torch.int16))
    return a.dtype == b.dtype and torch.equal(a, b)


def test_bf16_tree_round_trips_bitwise(tmp_path):
    tree = _bf16_tree(1)
    mgr = CheckpointManager(tmp_path)
    mgr.save(3, tree)
    host, manifest = mgr.restore(3, tree)
    back = place_like(tree, host)
    assert manifest["leaves"] == ["['f']", "['layers'][0]", "['n']", "['w']"]
    assert all(_same_bits(a, b) for a, b in zip(tree_leaves(tree), tree_leaves(back)))
    with np.load(tmp_path / "step_000000003" / "arrays.npz") as z:
        assert z["['w']"].dtype == np.dtype("V2") and z["['n']"].dtype == np.int32
    wrong = dict(tree, w=tree["w"].float())
    with pytest.raises(ValueError, match="template"):
        mgr.restore(3, wrong)


def test_jax_written_bf16_checkpoint_restores_with_the_same_bytes(tmp_path):
    rng = np.random.default_rng(2)
    jtree = {"w": rng.normal(size=(3, 5)).astype(ml_dtypes.bfloat16),
             "step": np.int32(7), "f": rng.normal(size=(4,)).astype(np.float32)}
    JCheckpointManager(tmp_path).save(11, jtree)
    template = {"w": torch.zeros(3, 5, dtype=torch.bfloat16),
                "step": torch.zeros((), dtype=torch.int32), "f": torch.zeros(4)}
    host, _ = CheckpointManager(tmp_path).restore(11, template)
    back = place_like(template, host)
    assert back["w"].dtype == torch.bfloat16
    assert back["w"].view(torch.int16).numpy().tobytes() == jtree["w"].tobytes()
    assert int(back["step"]) == 7 and back["f"].numpy().tobytes() == jtree["f"].tobytes()


def test_trainer_saves_and_restores_a_bf16_lm_bitwise(tmp_path):
    """The LM step through the Trainer in bf16: metrics as tensors, the
    final blocking save, restore onto a fresh Trainer bitwise (params and
    AdamW state), data_step back at the stream's position."""
    cfg = get_reduced("qwen3-1.7b").replace(dtype="bfloat16")
    run = launch_train.build_run(cfg, steps=3, batch=2, seq=16, device="cpu")
    tcfg = TrainerConfig(total_steps=3, ckpt_every=2, ckpt_dir=str(tmp_path))
    trainer = Trainer(run.step_fn, *run.init_state(), run.stream, tcfg)
    assert trainer.run()["step"] == 3
    assert tree_leaves(trainer.params)[0].dtype == torch.bfloat16
    assert CheckpointManager(tmp_path).manifest(3)["data_step"] == 3
    fresh = launch_train.build_run(cfg, steps=3, batch=2, seq=16, device="cpu")
    other = Trainer(fresh.step_fn, *fresh.init_state(), fresh.stream, tcfg)
    assert other.restore() and other.step == 3
    for ours, theirs in ((trainer.params, other.params), (trainer.opt_state, other.opt_state)):
        assert all(_same_bits(a, b) for a, b in zip(tree_leaves(ours), tree_leaves(theirs)))
    assert run.stream.position == 3


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _cli(tmp, *extra):
    return ["--arch", "qwen3-1.7b", "--reduced", "--device", "cpu", "--steps", "6",
            "--batch", "4", "--seq", "32", "--ckpt-dir", str(tmp), *extra]


def _sigterm_while_fetching(monkeypatch, position):
    """Raise SIGTERM while the stream hands out batch ``position``: the
    Trainer's handler lets that step finish, then checkpoints and stops."""
    fetch = TokenStream.__next__

    def next_batch(self):
        if self.position == position:
            signal.raise_signal(signal.SIGTERM)
        return fetch(self)

    monkeypatch.setattr(TokenStream, "__next__", next_batch)


def test_cli_trains_and_a_resumed_run_ends_bitwise(tmp_path, monkeypatch):
    whole = launch_train.run(_cli(tmp_path / "whole"))
    assert whole.summary["step"] == 6 and len(whole.losses) == 6
    assert all(np.isfinite(whole.losses)) and whole.losses[-1] < whole.losses[0]
    handler = signal.getsignal(signal.SIGTERM)
    _sigterm_while_fetching(monkeypatch, 3)
    cut = launch_train.run(_cli(tmp_path / "cut"))
    assert cut.summary["step"] == 4 and cut.summary["stopped_by_signal"]
    assert signal.getsignal(signal.SIGTERM) == handler   # the run's handlers are gone
    resumed = launch_train.run(_cli(tmp_path / "cut", "--resume"))
    assert resumed.summary["step"] == 6
    assert cut.losses + resumed.losses == whole.losses
    for ours, theirs in ((whole.trainer.params, resumed.trainer.params),
                         (whole.trainer.opt_state, resumed.trainer.opt_state)):
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(ours), tree_leaves(theirs)))
    assert launch_train.main(_cli(tmp_path / "again", "--steps", "1")) == 0


def test_cli_mesh_rank_takes_the_card_of_its_local_rank(monkeypatch):
    """Under ``torchrun`` over several machines, ``--mesh`` joins the world
    as ``RANK`` of ``WORLD_SIZE`` and takes card ``LOCAL_RANK`` of its own
    machine (rank 9 of 16 on a machine of 8 cards is card 1); a card
    index past the machine's cards still raises."""
    import torch.distributed as dist

    joined, cards = [], []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_device", cards.append)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: joined.append((backend, kw)))
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setenv("RANK", "9")
    monkeypatch.setenv("WORLD_SIZE", "16")
    monkeypatch.setenv("LOCAL_RANK", "1")
    with launch_train._world("cuda") as dev:
        assert dev == torch.device("cuda", 1)
    assert cards == [torch.device("cuda", 1)]
    (backend, kw), = joined
    assert (backend, kw["rank"], kw["world_size"], kw["init_method"]) == (
        "nccl", 9, 16, "env://")
    monkeypatch.setenv("LOCAL_RANK", "8")
    with pytest.raises(ValueError, match="one rank a card"):
        with launch_train._world("cuda"):
            pass


def test_cli_mesh_raises(tmp_path):
    """``--mesh`` reads as the reference's does (``16x16``/``2x16x16`` the
    production meshes, ``DxM`` and ``N`` debug ones); another three-part
    mesh raises ``ValueError``, where the reference drops its ``pod``; and
    ``--mesh 1x1`` (a world of one) trains bitwise the unsharded CLI."""
    assert launch_train.parse_mesh("16x16") == ("production", (16, 16))
    assert launch_train.parse_mesh("2x16x16") == ("production", (2, 16, 16))
    assert launch_train.parse_mesh("2x2") == ("debug", (2, 2))
    assert launch_train.parse_mesh("4") == ("debug", (4, 1))
    with pytest.raises(ValueError, match="drops its pod"):
        launch_train.main(["--arch", "qwen3-1.7b", "--reduced", "--device", "cpu",
                           "--mesh", "2x2x2"])
    args = ["--arch", "qwen3-1.7b", "--reduced", "--device", "cpu", "--steps", "3",
            "--batch", "2", "--seq", "16", "--ckpt-every", "2"]
    plain = launch_train.run(args + ["--ckpt-dir", str(tmp_path / "plain")])
    meshed = launch_train.run(args + ["--ckpt-dir", str(tmp_path / "mesh"), "--mesh", "1x1"])
    assert meshed.losses == plain.losses
    for name in ("plain", "mesh"):
        assert (tmp_path / name / "step_000000003").is_dir()
    with np.load(tmp_path / "plain" / "step_000000003" / "arrays.npz") as a, \
            np.load(tmp_path / "mesh" / "step_000000003" / "arrays.npz") as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].tobytes() == b[k].tobytes(), k
