"""The port's cross-attention and encoder (the ``vlm`` family,
llama-3.2-vision-90b, and the ``audio`` encoder-decoder family,
seamless-m4t-large-v2) against the JAX package.

On the CPU the port's attention runs the flash kernels' plain versions;
the JAX side runs its model through ``repro.models.model.build`` (its
attention is ``blocked_attention``, differentiated by ``jax.grad``) and
the Pallas flash kernel in interpret mode.  Inputs come from NumPy with a
seed, and the same arrays go to both packages; model weights go across
through ``lm_params_from_jax``.  Every memory here fills its cache
exactly (the only case where the reference is right), except in the
padded-memory demonstration.

Tolerances, stated once:
* attention in f32: ``3e-5`` against the Pallas kernel (as
  ``tests/test_torch_lm.py`` holds it), ``1e-5`` of max|y| for
  ``cross_attn_forward`` against JAX's (f32 sums of at most 24 terms and
  a 64-wide projection in another order);
* the reduced models in f32: logits and caches ``1e-4`` (matmul sums in
  another order through five layers, or two encoder and two decoder
  layers), ``generate`` the same tokens, loss and metrics ``1e-5``, every
  gradient leaf ``1e-4`` of its max|g|; ``remat`` modes and the token
  stream bitwise;
* the port's decode against its own prefill of one more token: ``1e-5``
  (f32, the same arithmetic but for the M=B against M=B·L matmuls);
* the bf16 backward's dq where it cancels: within 5 times JAX's own bf16
  distance from f32 (measured 2.0-4.1 times over four seeds; justified at
  the test);
* bf16 (weights and memory): the last logits within 4 bf16 ulps of the
  largest logit (each of the five layers rounds its residual stream and
  sublayer outputs to bf16 at the same points as JAX, but XLA may keep an
  elementwise chain in f32 between them, so a value can land on the
  neighbouring bf16 and be carried to the logits; measured 2 ulps).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.data.tokens import TokenStream as JTokenStream
from repro.data.tokens import TokenStreamConfig as JTokenStreamConfig
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro.models.model import build as jbuild
from repro.train import serve_step as jserve
from repro_torch.configs.base import get_config, get_reduced
from repro_torch.convert import lm_params_from_jax
from repro_torch.data.tokens import TokenStream, TokenStreamConfig
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.models import attention
from repro_torch.models import transformer as tf
from repro_torch.models.model import build
from repro_torch.models.transformer import tree_leaves
from repro_torch.train import serve_step
from repro_torch.train.train_step import grads_of

VLM, AUDIO = "llama-3.2-vision-90b", "seamless-m4t-large-v2"
MEMORY_KEY = {VLM: "media", AUDIO: "src_embeds"}


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _flat(tree, path=""):
    """``{path: leaf}`` of a tree of dicts and lists (either package's)."""
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _flat(tree[key], f"{path}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, t in enumerate(tree) for k, v in _flat(t, f"{path}/{i}").items()}
    return {path: tree}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _mem_len(cfg):
    return cfg.n_media_tokens if cfg.family == "vlm" else cfg.enc_seq


def _inputs(cfg, arch, B, L, seed, mem_len=None):
    """Prompt tokens (B, L + 1) and a memory (B, M, d_model) from a seed,
    as NumPy arrays: int32 and f32 at the stream's 0.02 scale."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(B, L + 1)).astype(np.int32)
    m = _mem_len(cfg) if mem_len is None else mem_len
    mem = (rng.standard_normal((B, m, cfg.d_model)) * 0.02).astype(np.float32)
    return toks, mem


def _batches(arch, toks, mem, targets=None):
    """The same batch for JAX and for the port."""
    key = MEMORY_KEY[arch]
    jb = {"tokens": jnp.asarray(toks), key: jnp.asarray(mem)}
    tb = {"tokens": torch.from_numpy(toks).long(), key: _t(mem)}
    if targets is not None:
        jb["targets"] = jnp.asarray(targets)
        tb["targets"] = torch.from_numpy(targets).long()
    return jb, tb


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sq,skv", [(32, 96), (1, 64)])
def test_plain_flash_matches_pallas_kernel_at_cross_shapes(sq, skv):
    """Non-causal, Sq != Skv, GQA (H=4 over Hkv=2): cross-attention's shapes
    in train and prefill (32 queries over 96 keys) and in decode (one
    query row over the memory)."""
    rng = np.random.default_rng(sq + skv)
    q = (rng.normal(size=(2, 4, sq, 16)) * 0.3).astype(np.float32)
    k = (rng.normal(size=(2, 2, skv, 16)) * 0.3).astype(np.float32)
    v = (rng.normal(size=(2, 2, skv, 16)) * 0.3).astype(np.float32)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=False, block_q=32, block_k=32)
    got = ops.flash_attention(_t(q).transpose(1, 2), _t(k).transpose(1, 2),
                              _t(v).transpose(1, 2), causal=False)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), np.asarray(want),
                               rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("qk_norm", [False, True])
def test_cross_attn_forward_matches_jax(qk_norm):
    """Without a cache (train), into a cache (prefill: the projected, and
    under qk_norm normed, memory in ``mk``/``mv``) and from it (decode:
    one query row over the cached memory, no k_norm again)."""
    jcfg = jbase.get_reduced(VLM).replace(qk_norm=qk_norm)
    cfg = get_reduced(VLM).replace(qk_norm=qk_norm)
    jp, _ = jlayers.split_tree(jattn.init_cross_attn(jax.random.key(3), jcfg))
    if qk_norm:   # norms away from 1, so that a missed or doubled norm shows
        rng = np.random.default_rng(1)
        for name in ("q_norm", "k_norm"):
            jp[name] = jnp.asarray(1 + 0.3 * rng.normal(size=jp[name].shape), jnp.float32)
    tp = {k: _t(v) for k, v in jp.items()}
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, cfg.d_model)).astype(np.float32)
    x1 = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    mem = rng.normal(size=(2, 24, cfg.d_model)).astype(np.float32)

    def close(got, want):
        want = np.asarray(want)
        assert float(np.abs(got.numpy() - want).max()) <= 1e-5 * float(np.abs(want).max())

    want, _ = jattn.cross_attn_forward(jp, jnp.asarray(x), jnp.asarray(mem), jcfg)
    close(attention.cross_attn_forward(tp, _t(x), _t(mem), cfg), want)
    want, jcache = jattn.cross_attn_forward(jp, jnp.asarray(x), jnp.asarray(mem),
                                            jcfg.replace(return_cache=True))
    cache = {k: torch.zeros((2, 24, cfg.n_kv_heads, cfg.d_head)) for k in ("mk", "mv")}
    close(attention.cross_attn_forward(tp, _t(x), _t(mem), cfg, cache), want)
    for key in ("mk", "mv"):
        close(cache[key], jcache[key])
    want, _ = jattn.cross_attn_forward(jp, jnp.asarray(x1), None, jcfg, cache=jcache)
    close(attention.cross_attn_forward(tp, _t(x1), None, cfg, cache, pos=7), want)
    short = {k: torch.zeros((2, 23, cfg.n_kv_heads, cfg.d_head)) for k in ("mk", "mv")}
    with pytest.raises(ValueError, match="memory of 24 positions for a cache of 23"):
        attention.cross_attn_forward(tp, _t(x), _t(mem), cfg, short)


def test_backward_delta_from_the_unrounded_output_keeps_a_cancelling_dq():
    """Keys and values that share a large part (as a cross-attention's
    memory does): dq = scale·Σ_j P_ij (dP_ij - δ_i) k_j cancels, and a δ
    taken from the bf16-rounded output is led by that rounding.  The
    autograd function (bf16, the plain versions) takes δ from the forward's
    f32 output: its dq lies within 5 times JAX's own bf16 distance from
    the f32 gradient, where the backward given the rounded output lies
    more than 10 times away (measured 0.068 and 0.85 of max|dq| against
    JAX's 0.034; over four seeds 2.0-4.1 and 25-51 times: what is left is
    the forward's p rounded to bf16 before p·V, which reaches δ through
    the output while dS takes the unrounded P; JAX differentiates the
    rounded computation itself)."""
    rng = np.random.default_rng(0)
    B, Sq, Skv, H, Hkv, D = 1, 64, 512, 4, 2, 64
    shared_k, shared_v = rng.normal(size=(2, 1, 1, Hkv, D))
    q = rng.normal(size=(B, Sq, H, D))
    k = shared_k + 0.3 * rng.normal(size=(B, Skv, Hkv, D))
    v = shared_v + 0.3 * rng.normal(size=(B, Skv, Hkv, D))
    do = rng.normal(size=(B, Sq, H, D))
    q, k, v, do = (a.astype(ml_dtypes.bfloat16) for a in (q, k, v, do))

    def jax_dq(dtype):
        f = lambda q, k, v: jattn.blocked_attention(q, k, v, causal=False, q_block=64,
                                                    kv_block=128)
        args = [jnp.asarray(a).astype(dtype) for a in (q, k, v)]
        _, vjp = jax.vjp(f, *args)
        return np.asarray(vjp(jnp.asarray(do).astype(dtype))[0], np.float32)

    want, jax_bf16 = jax_dq(jnp.float32), jax_dq(jnp.bfloat16)
    tq, tk, tv, tdo = (_t(a.astype(np.float32)).to(torch.bfloat16) for a in (q, k, v, do))
    tq.requires_grad_()
    out = ops.flash_attention(tq, tk, tv, causal=False)
    (dq,) = torch.autograd.grad(out, (tq,), tdo)
    o, lse, _ = FA.flash_attention_plain(tq.detach(), tk, tv, causal=False,
                                         return_lse=True)
    rounded_dq = FA.flash_attention_bwd_plain(tq.detach(), tk, tv, o.float(), lse, tdo,
                                              causal=False)[0]
    err = lambda g: float(np.abs(g.float().numpy() - want).max() / np.abs(want).max())
    jax_err = float(np.abs(jax_bf16 - want).max() / np.abs(want).max())
    assert err(dq) <= 5 * jax_err
    assert err(rounded_dq) > 10 * jax_err


# ---------------------------------------------------------------------------
# the two reduced archs in f32
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """One reduced arch: the JAX model and params, the port's model and the
    same params converted (the encoder's and the cross-attention leaves
    among them)."""
    cfg = get_reduced(arch)
    jmodel = jbuild(jbase.get_reduced(arch))
    jparams = jmodel.init(jax.random.key(0))
    params = lm_params_from_jax(_np_tree(jparams), cfg, device="cpu")
    return arch, cfg, jmodel, jparams, build(cfg), params


@pytest.fixture(scope="module", params=[VLM, AUDIO])
def arch_pair(request):
    return _pair(request.param)


def test_converted_tree_has_the_cross_attention_and_encoder_leaves(arch_pair):
    arch, cfg, _, jparams, model, params = arch_pair
    keys = set(_flat(params))
    assert keys == set(_flat(_np_tree(jparams)))
    if arch == VLM:
        assert "/layers/scan/0/mixer/wq" in keys
        assert not any(k.startswith(("/encoder", "/enc_ln_f")) for k in keys)
        assert tf.param_shapes(cfg)["layers"]["scan"]["0"]["mixer"]["wk"].shape == (
            1, cfg.d_model, cfg.n_kv_heads, cfg.d_head)
    else:
        assert {"/layers/scan/0/ln_x", "/layers/scan/0/xattn/wq", "/enc_ln_f",
                "/encoder/scan/0/mixer/wq"} <= keys
        assert params["encoder"]["scan"]["0"]["ffn"]["w_gate"].shape[0] == cfg.n_enc_layers
    plan, jplan = tf.encoder_plan(cfg), jtf.encoder_plan(jbase.get_reduced(arch))
    assert (plan is None) == (jplan is None)
    if plan is not None:
        assert (plan.prefix, plan.period, plan.repeats) == (
            jplan.prefix, jplan.period, jplan.repeats)


def test_reduced_prefill_and_caches_match_jax(arch_pair):
    arch, cfg, jmodel, jparams, model, params = arch_pair
    toks, mem = _inputs(cfg, arch, 2, 12, 5)
    jb, tb = _batches(arch, toks[:, :12], mem)
    jlogits, jcaches = jax.jit(jmodel.prefill)(jparams, jb)
    logits, caches = model.prefill(params, tb)
    assert logits.shape == (2, 1, cfg.vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
    ours, theirs = _flat(caches), _flat(jcaches)
    cross = {k for k in theirs if k.endswith(("/mk", "/mv"))}
    assert set(ours) == set(theirs) and cross
    for key, b in theirs.items():
        assert tuple(ours[key].shape) == b.shape
        assert b.shape[2] == (mem.shape[1] if key in cross else 12)
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(b), rtol=1e-4, atol=1e-4)


def test_reduced_decode_step_matches_jax(arch_pair):
    arch, cfg, jmodel, jparams, model, params = arch_pair
    B, L, cache_len = 2, 12, 16
    toks, mem = _inputs(cfg, arch, B, L, 6)
    jb, tb = _batches(arch, toks[:, :L], mem)
    _, jc = jax.jit(jmodel.prefill)(jparams, jb)
    grown = jmodel.init_cache(B, cache_len)
    jc = jax.tree.map(lambda d, s: jnp.pad(s, [(0, a - b) for a, b in zip(d.shape, s.shape)]),
                      grown, jc)
    jlogits, jc2 = jax.jit(jmodel.decode_step)(jparams, jc, jnp.asarray(toks[:, L:]),
                                               jnp.int32(L))
    _, c = model.prefill(params, tb, model.init_cache(B, cache_len, device="cpu"))
    logits, c2 = model.decode_step(params, c, torch.from_numpy(toks[:, L:]).long(), L)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
    ours, theirs = _flat(c2), _flat(jc2)
    assert set(ours) == set(theirs)
    for key, b in theirs.items():
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(b), rtol=1e-4, atol=1e-4)


def test_reduced_generate_matches_jax(arch_pair):
    arch, cfg, jmodel, jparams, model, params = arch_pair
    toks, mem = _inputs(cfg, arch, 2, 12, 7)
    jb, tb = _batches(arch, toks[:, :12], mem)
    want = jserve.generate(jmodel, jparams, jb, 8, 24)
    got = serve_step.generate(model, params, tb, 8, 24)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_reduced_train_loss_and_grads_match_jax(arch_pair):
    """Every gradient leaf, the encoder's (reached only through the
    decoder's cross-attention) and the cross-attention's included."""
    arch, cfg, jmodel, jparams, model, params = arch_pair
    toks, mem = _inputs(cfg, arch, 2, 24, 4, mem_len=24 if arch == AUDIO else None)
    jb, tb = _batches(arch, toks[:, :-1], mem, targets=toks[:, 1:])
    (jloss, jm), jg = jax.jit(jax.value_and_grad(jmodel.train_loss, has_aux=True))(
        jparams, jb)
    grads, metrics = grads_of(model, params, tb)
    np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]), rtol=1e-5,
                               atol=1e-5)
    for k in jm:
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]), rtol=1e-5, atol=1e-5)
    ours, theirs = _flat(grads), _flat(_np_tree(jg))
    assert set(ours) == set(theirs)
    assert any(k.startswith("/encoder/") for k in ours) == (arch == AUDIO)
    for key, want in theirs.items():
        scale = float(np.abs(want).max())
        assert scale > 0, key
        assert float(np.abs(ours[key].numpy() - want).max()) <= 1e-4 * scale, key


def test_remat_modes_give_identical_gradients_on_seamless():
    """remat off, "full" and "dots" run the same arithmetic through the
    encoder and the decoder's cross-attention: the same bits."""
    cfg = get_reduced(AUDIO)
    params = build(cfg).init(2, device="cpu")
    toks, mem = _inputs(cfg, AUDIO, 2, 20, 8, mem_len=20)
    _, batch = _batches(AUDIO, toks[:, :-1], mem, targets=toks[:, 1:])
    grads = [grads_of(build(cfg.replace(remat=remat, remat_policy=policy)), params,
                      batch)[0]
             for remat, policy in [(False, "full"), (True, "full"), (True, "dots")]]
    for other in grads[1:]:
        for a, b in zip(tree_leaves(grads[0]), tree_leaves(other)):
            assert torch.equal(a, b)
    assert float(grads[0]["encoder"]["scan"]["0"]["mixer"]["wq"].abs().max()) > 0


@pytest.mark.parametrize("family", ["vlm", "audio"])
def test_token_stream_stubs_are_the_jax_stream_bitwise(family):
    scfg = dict(vocab=512, batch=2, seq_len=9, seed=3, d_model=64, family=family,
                n_media_tokens=16 if family == "vlm" else 0)
    key = "media" if family == "vlm" else "src_embeds"
    jstream = JTokenStream(JTokenStreamConfig(**scfg))
    stream = TokenStream(TokenStreamConfig(**scfg), device="cpu")
    for _ in range(3):
        jb, b = next(jstream), next(stream)
        assert set(b) == set(jb) == {"tokens", "targets", key}
        for k in ("tokens", "targets"):
            np.testing.assert_array_equal(b[k].numpy(), np.asarray(jb[k]))
        assert b[key].dtype == torch.float32
        assert b[key].shape == (2, 16 if family == "vlm" else 9, 64)
        np.testing.assert_array_equal(b[key].numpy(), np.asarray(jb[key]))


def test_launcher_streams_the_media_of_a_vlm():
    """The launcher gives the stream ``n_media_tokens``: a vlm batch holds
    (B, n_media_tokens, d_model) media."""
    from repro_torch.launch import train as launch_train

    cfg = get_reduced(VLM)
    run = launch_train.build_run(cfg, steps=1, batch=2, seq=8, device="cpu")
    assert next(run.stream)["media"].shape == (2, cfg.n_media_tokens, cfg.d_model)


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_bf16_prefill_fed_bf16_memory_matches_jax(arch):
    """bf16 weights, and JAX fed bf16 memory (as its ``input_specs``
    declare it); the port is fed the f32 stream values and casts them
    itself, to the same bf16 values."""
    cfg = get_reduced(arch).replace(dtype="bfloat16")
    jmodel = jbuild(jbase.get_reduced(arch).replace(dtype="bfloat16"))
    jparams = jmodel.init(jax.random.key(1))
    params = lm_params_from_jax(_np_tree(jparams), cfg, device="cpu")
    toks, mem = _inputs(cfg, arch, 2, 10, 9)
    key = MEMORY_KEY[arch]
    jlogits, _ = jax.jit(jmodel.prefill)(jparams, {
        "tokens": jnp.asarray(toks[:, :10]),
        key: jnp.asarray(mem.astype(ml_dtypes.bfloat16))})
    logits, caches = build(cfg).prefill(params, {"tokens": torch.from_numpy(toks[:, :10])
                                                 .long(), key: _t(mem)})
    assert logits.dtype == torch.bfloat16
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(caches))
    want = np.asarray(jlogits, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert float(np.abs(logits.float().numpy() - want).max()) <= 4 * ulp


def test_padded_memory_dilutes_the_reference_and_the_port_refuses_it():
    """seamless ``reduced()`` (a 32-frame cache), JAX weights from seed 0,
    B=2: decode at position 3 on the prompt's cache against the last
    logits of a prefill of 4 tokens.  The reference pads a 16-frame
    source's cross cache to 32 slots of zero keys, which take a share of
    the decode's softmax: its decode lies 1.207 from its own prefill
    (largest logit 3.93), where a 32-frame source gives 1e-6.  The port
    sizes the cache to the memory and agrees with its own prefill within
    1e-5 either way, and its prefill refuses a memory of another length
    than the cache's slots."""
    arch, cfg, jmodel, jparams, model, params = _pair(AUDIO)
    B, L = 2, 3
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, size=(B, L + 1)).astype(np.int32)
    src = (rng.standard_normal((B, cfg.enc_seq, cfg.d_model)) * 0.02).astype(np.float32)
    gaps = {}
    prefill, decode = jax.jit(jmodel.prefill), jax.jit(jmodel.decode_step)
    for n in (cfg.enc_seq, cfg.enc_seq // 2):
        jb, tb = _batches(arch, toks, src[:, :n])
        full, _ = prefill(jparams, jb)
        _, c = prefill(jparams, dict(jb, tokens=jnp.asarray(toks[:, :L])))
        grown = jmodel.init_cache(B, L + 1)
        c = jax.tree.map(
            lambda d, s: jnp.pad(s, [(0, a - b) for a, b in zip(d.shape, s.shape)]), grown, c)
        dec, _ = decode(jparams, c, jnp.asarray(toks[:, L:]), jnp.int32(L))
        gaps[n] = float(jnp.abs(dec[:, 0] - full[:, -1]).max())
        ours_full, _ = model.prefill(params, tb)
        _, oc = model.prefill(params, dict(tb, tokens=tb["tokens"][:, :L]),
                              model.init_cache(B, L + 1, device="cpu", mem_len=n))
        assert oc["scan"]["0"]["xattn"]["mk"].shape[2] == n
        ours_dec, _ = model.decode_step(params, oc, tb["tokens"][:, L:], L)
        assert float((ours_dec[:, 0] - ours_full[:, -1]).abs().max()) <= 1e-5
    assert gaps[cfg.enc_seq] <= 1e-5
    assert 1.0 < gaps[cfg.enc_seq // 2] < 1.5       # 1.207 on this input
    with pytest.raises(ValueError, match="memory of 16 positions for a cache of 32"):
        model.prefill(params, dict(tb, tokens=tb["tokens"][:, :L]),
                      model.init_cache(B, L + 1, device="cpu"))


def test_reduced_teacher_forcing(arch_pair):
    """logits(decode @ pos L | prefill cache of L) == logits(prefill L+1)[-1],
    the memory's keys and values read from the cache in decode."""
    arch, cfg, _, _, model, params = arch_pair
    B, L = 2, 12
    toks, mem = _inputs(cfg, arch, B, L, 3)
    _, tb = _batches(arch, toks, mem)
    full, _ = model.prefill(params, tb)
    _, caches = model.prefill(params, dict(tb, tokens=tb["tokens"][:, :L]),
                              model.init_cache(B, L + 1, device="cpu"))
    dec, _ = model.decode_step(params, caches, tb["tokens"][:, L:], L)
    assert float((dec[:, 0] - full[:, -1]).abs().max()) <= 1e-5


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,total", [(VLM, 87_666_794_496), (AUDIO, 2_034_886_656)])
def test_full_size_configs_and_param_counts_match_jax(arch, total):
    ours, theirs = get_config(arch), jbase.get_config(arch)
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    assert ours.param_count() == jtf.count_params(theirs) == total
    plan, jplan = tf.layer_plan(ours), jtf.layer_plan(theirs)
    assert (plan.prefix, plan.period, plan.repeats) == (jplan.prefix, jplan.period,
                                                        jplan.repeats)
    with pytest.raises(ValueError, match="cross_attn_every"):
        tf.layer_plan(get_config(VLM).replace(n_layers=12))
