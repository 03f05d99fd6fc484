"""The port's int8 error-feedback gradient compression and its train steps
against the JAX package.

``quantize_int8``/``dequantize_int8`` and the wire-byte counts are held
bitwise in this process.  ``compressed_psum_mean`` runs in gloo worlds of
1, 2 and 4 ranks, spawned once for the module
(``tests/_torch_dist_ranks.py:spawn_world``, each rank running
``tests/_torch_parallel_ranks.py:run_compression``), against JAX's under
``repro.compat.shard_map`` over 1, 2 and 4 host devices, which JAX sees
only in a process of its own (``tests/_torch_parallel_jax.py``, started
once for the module with ``--xla_force_host_platform_device_count=4``).

Tolerances, stated once:
* the residuals: bitwise (the same f32 arithmetic, element by element);
* the means: bitwise at 1 and 2 ranks (one product, or two summed in the
  one order either side takes), within ``1e-6 · max|mean|`` at 4, where
  the sum's order may differ;
* ``make_train_step_parts`` and the compressed step (2 pods of 1 rank,
  and of 2 ranks sharded over ``data`` or ``model``, 3 steps of
  qwen3-1.7b ``reduced()``, held to the composition of JAX's working
  parts: ``make_train_step_parts`` on each pod's slice, the compressed
  mean under ``shard_map``, ``AdamW.update``; JAX's own
  ``make_train_step_compressed`` fails on this JAX version): the train
  step's tolerances of ``tests/test_torch_lm_train.py``, ``1e-4`` of each
  leaf's max|.| for params, ``mu``, ``nu`` and gradients, metrics at
  ``rtol=1e-4``; a residual (``g32 − deq``, which keeps g32's error where
  the codes agree) at ``1e-4`` of its pod's max|g32|.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import _torch_dist_ranks as dist_ranks
import _torch_parallel_ranks as ranks
from repro.configs import base as jbase
from repro.models.model import build as jbuild
from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro.train.train_step import make_train_step_parts as jmake_parts
from repro_torch.configs.base import get_reduced
from repro_torch.convert import lm_params_from_jax
from repro_torch.models.model import build
from repro_torch.optim import adamw, compression
from repro_torch.train.train_step import make_train_step_parts

WORLDS = (1, 2, 4)
STEPS = 3
GROUP_TIMEOUT_S = 60.0
JAX_SCRIPT = Path(__file__).with_name("_torch_parallel_jax.py")
STEP_TOL = 1e-4
# a gradient within STEP_TOL of max|g32| of another moves its code value
# g32 / scale by up to STEP_TOL * 127: elements that close to a rounding
# boundary may take either code
NEAR = STEP_TOL * 127
SEED = 41


def _draws():
    """Each world's per-rank gradients and residuals, 8 elements a leaf
    (one shape keeps the reference's eager run short): ``a`` f32, ``b``
    bf16 values (kept as f32 here), ``z`` all zero, ``h`` exact half-way
    points (scale 1.0: 127 is the max); and the compressed step's
    batches."""
    rng = np.random.default_rng(SEED)
    inp = {}
    half = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -126.5], np.float32)
    for n in WORLDS:
        a = rng.standard_normal((n, 8)).astype(np.float32)
        b = rng.standard_normal((n, 8)).astype(ml_dtypes.bfloat16).astype(np.float32)
        inp.update({f"w{n}.grad.a": a, f"w{n}.grad.b": b,
                    f"w{n}.grad.z": np.zeros((n, 8), np.float32),
                    f"w{n}.grad.h": np.tile(half, (n, 1))})
        inp.update({f"w{n}.res.a": (rng.standard_normal(a.shape) * 0.01).astype(np.float32),
                    f"w{n}.res.b": (rng.standard_normal(b.shape) * 0.01).astype(np.float32),
                    f"w{n}.res.z": np.zeros((n, 8), np.float32),
                    f"w{n}.res.h": np.zeros((n, 8), np.float32)})
    vocab = get_reduced(ranks.STEP_ARCH).vocab
    inp["step.n"] = np.int64(STEPS)
    inp["near"] = np.float32(NEAR)
    for i in range(STEPS):
        toks = rng.integers(0, vocab, size=(4, 17))
        inp[f"step{i}.tokens"] = toks[:, :-1].astype(np.int32)
        inp[f"step{i}.targets"] = toks[:, 1:].astype(np.int32)
    return inp


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The draws, JAX's references and each world's rank outputs.  The
    reference process runs while the worlds do: the compressed step's
    initial weights are the port's ``Model.init``, passed to both."""
    root = tmp_path_factory.mktemp("compression")
    inp = _draws()
    cfg = get_reduced(ranks.STEP_ARCH)
    inp.update({f"init{k}": v.numpy() for k, v in _flat(build(cfg).init(SEED, device="cpu")).items()})
    np.savez(root / "in.npz", **inp)
    proc = subprocess.Popen([sys.executable, str(JAX_SCRIPT), str(root / "in.npz"),
                             str(root / "jax_out.npz"), "compression"],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        out = {}
        for world in WORLDS:
            dist_ranks.spawn_world(ranks.run_compression, world,
                                   (str(root / "in.npz"), str(root)),
                                   str(root / f"rdv{world}"), GROUP_TIMEOUT_S)
            out[world] = [dict(np.load(root / f"compression_w{world}_r{r}.npz"))
                          for r in range(world)]
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert "JAX_REFERENCE_OK" in stdout, stdout[-2000:] + stderr[-4000:]
    return inp, dict(np.load(root / "jax_out.npz")), out


def _q_pair(x, dtype):
    jq, js = jcomp.quantize_int8(jnp.asarray(x, dtype=dtype))
    q, s = compression.quantize_int8(torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32))
    return (np.asarray(jq), np.asarray(js), np.asarray(jcomp.dequantize_int8(jq, js)),
            q.numpy(), s.numpy(), compression.dequantize_int8(q, s).numpy())


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("kind", ["normal", "zeros", "half_way", "tiny"])
def test_quantize_int8_is_the_reference_bitwise(dtype, kind):
    """The codes, the f32 scale and the dequantized values, bit for bit:
    ``g / scale`` in f32, half to even, ±127, a scale of 1 for zeros."""
    rng = np.random.default_rng(3)
    x = {"normal": rng.standard_normal((33, 7)) * 3.0,
         "zeros": np.zeros((5, 3)),
         "half_way": np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -126.5]),
         "tiny": rng.standard_normal(50) * 1e-30}[kind]
    jq, js, jd, q, s, d = _q_pair(x, dtype)
    assert q.dtype == np.int8 and s.dtype == np.float32 and s.shape == ()
    np.testing.assert_array_equal(q, jq)
    assert s.tobytes() == js.tobytes()
    assert d.tobytes() == jd.astype(np.float32).tobytes()
    if kind == "zeros":
        assert float(s) == 1.0 and not q.any()
    if kind == "half_way":       # half to even, as jnp.round
        np.testing.assert_array_equal(q, [127, 0, 2, 2, 0, -2, 4, -126])


def test_int8_quantization_error_bound():
    x = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    q, s = compression.quantize_int8(torch.from_numpy(x))
    err = np.abs(compression.dequantize_int8(q, s).numpy() - x)
    assert err.max() <= float(s) / 2 + 1e-6


def test_wire_bytes_match_the_reference():
    for n in (0, 1, 7, 1000, 1_000_003, 1_720_574_976, 2**31 + 5):
        for p in (1, 2, 3, 4, 8, 16, 512):
            assert compression.wire_bytes_f32_allreduce(n, p) == jcomp.wire_bytes_f32_allreduce(n, p)
            assert compression.wire_bytes_int8_allgather(n, p) == jcomp.wire_bytes_int8_allgather(n, p)
    assert (compression.wire_bytes_f32_allreduce(10**6, 2)
            / compression.wire_bytes_int8_allgather(10**6, 2)) >= 3.9


def test_compressed_mean_with_error_feedback_converges():
    """``tests/test_runtime.py``'s bound: the time-averaged compressed
    mean with error feedback lies within ``scale / steps + 1e-4``."""
    g = torch.from_numpy(np.random.default_rng(1).standard_normal(64).astype(np.float32))
    r, acc, steps = torch.zeros_like(g), torch.zeros_like(g), 50
    for _ in range(steps):
        g32 = g + r
        q, s = compression.quantize_int8(g32)
        deq = compression.dequantize_int8(q, s)
        r = g32 - deq
        acc = acc + deq
    np.testing.assert_allclose((acc / steps).numpy(), g.numpy(), atol=float(s) / steps + 1e-4)


def test_init_residual_is_f32_zeros_like_the_grads():
    grads = {"w": torch.ones((3, 2), dtype=torch.bfloat16), "l": [torch.ones(4)]}
    r = compression.init_residual(grads)
    assert r["w"].dtype == torch.float32 and r["w"].shape == (3, 2) and not r["w"].any()
    assert r["l"][0].shape == (4,)


@pytest.mark.parametrize("world", WORLDS)
def test_compressed_mean_matches_the_reference(case, world):
    inp, ref, out = case
    for r, o in enumerate(out[world]):
        for k in ranks.GRAD_KEYS:
            assert o[f"res.{k}"].tobytes() == ref[f"w{world}.res.{k}"][r].tobytes(), (r, k)
            want = ref[f"w{world}.mean.{k}"][r]
            if world <= 2:
                assert o[f"mean.{k}"].tobytes() == want.tobytes(), (r, k)
            else:
                np.testing.assert_allclose(o[f"mean.{k}"], want, rtol=0,
                                           atol=1e-6 * float(np.abs(want).max()))
            # every rank holds the same mean, in the gradient's dtype
            np.testing.assert_array_equal(o[f"mean.{k}"], out[world][0][f"mean.{k}"])
        assert str(o["mean_dtype.b"]) == "torch.bfloat16"
        assert str(o["mean_dtype.a"]) == "torch.float32"


@pytest.mark.parametrize("world", WORLDS)
def test_trace_reads_the_int8_all_gather(case, world):
    """``trace_analysis.collective_bytes`` over each rank's profiler trace
    (gloo: its ``gloo:all_gather`` records) reads two all-gathers a leaf,
    the int8 payload's wire bytes the reference's count, and the payload
    the int8 elements plus 4 bytes a leaf."""
    inp, _, out = case
    n_int8 = sum(inp[f"w{world}.grad.{k}"][0].size for k in ranks.GRAD_KEYS)
    leaves = len(ranks.GRAD_KEYS)
    for o in out[world]:
        stats = json.loads(str(o["trace.stats"]))
        assert stats["count_by_op"] == {"all_gather": 2 * leaves}
        assert stats["payload_by_op"]["all_gather"] == n_int8 + 4 * leaves
        assert stats["int8_wire"] == jcomp.wire_bytes_int8_allgather(n_int8, world)
        assert stats["bytes_by_op"]["all_gather"] == (world - 1) * (n_int8 + 4 * leaves)


def _flat(tree, path=""):
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _flat(tree[key], f"{path}/{key}").items()}
    if isinstance(tree, list):
        return {k: v for i, t in enumerate(tree) for k, v in _flat(t, f"{path}/{i}").items()}
    return {path: tree}


def _close_flat(got, want, what, exempt=None):
    """Every leaf within STEP_TOL of the JAX leaf's max|.|, but at the
    elements ``exempt`` marks."""
    assert set(got) == set(want), what
    for k, w in want.items():
        w = np.asarray(w, np.float32)
        scale = max(float(np.abs(w).max()), 1e-30)
        diff = np.abs(np.asarray(got[k], np.float32) - w)
        if exempt is not None:
            diff = diff[~exempt[k]]
        assert float(diff.max(initial=0.0)) <= STEP_TOL * scale, f"{what}{k}"


@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_step_parts_match_the_reference(n_micro):
    jcfg, cfg = jbase.get_reduced("qwen3-1.7b"), get_reduced("qwen3-1.7b")
    jmodel = jbuild(jcfg)
    jopt = jadamw.AdamW(jadamw.AdamWConfig())
    jparams = jmodel.init(jax.random.key(2))
    params = lm_params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    toks = np.random.default_rng(5).integers(0, cfg.vocab, size=(4, 17))
    jg, jm = jax.jit(jmake_parts(jmodel, jopt, n_micro))(
        jparams, {"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
                  "targets": jnp.asarray(toks[:, 1:], jnp.int32)})
    g, m = make_train_step_parts(build(cfg), n_micro)(
        params, {"tokens": torch.from_numpy(toks[:, :-1]), "targets": torch.from_numpy(
            toks[:, 1:])})
    assert set(m) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, atol=1e-6)
    _close_flat({k: v.numpy() for k, v in _flat(g).items()},
                {k: np.asarray(v) for k, v in _flat(jg).items()}, "grad")
    if n_micro > 1:
        assert all(t.dtype == torch.float32 for t in _flat(g).values())


def test_compressed_step_matches_the_reference_parts(case):
    """Two pods of one rank, 3 steps: rank 0 against JAX's pod 0 (metrics
    are a pod's own, as under the reference's replicated out spec), both
    ranks' params and moments alike, each rank's residual against its
    pod's.

    Quantization is discontinuous: an element whose code value lay within
    ``NEAR`` of a rounding boundary at some step, on either pod, may take
    the other code there (one scale apart), and its parameter, moments and
    residual follow that code.  Those elements (``step{i}.near``, a
    fraction of about ``2 * NEAR``) are left out of the leaf comparisons;
    every other element is held at the train step's tolerances."""
    _, ref, out = case
    _check_compressed(ref, *out[2])


def _check_compressed(ref, o0, o1, prefix=""):
    """``o0`` a rank of pod 0, ``o1`` one of pod 1 (their keys under
    ``prefix``) against the reference parts."""
    o0 = {k[len(prefix):]: v for k, v in o0.items() if k.startswith(prefix)}
    o1 = {k[len(prefix):]: v for k, v in o1.items() if k.startswith(prefix)}
    assert int(o0["step.count"]) == STEPS
    exempt = {}
    for i in range(STEPS):
        for k in ("loss", "accuracy", "tokens", "aux_loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(o0[f"step{i}.metrics/{k}"]),
                                       float(ref[f"step{i}.metrics/{k}"]), rtol=1e-4,
                                       atol=1e-6, err_msg=f"step {i} {k}")
        for pod in range(2):
            pre = f"step{i}.near{pod}"
            for k, v in ref.items():
                if k.startswith(pre + "/"):
                    path = k[len(pre):]
                    exempt[path] = exempt.get(path, False) | v
        for tag in ("params", "mu", "nu"):
            pre = f"step{i}.{tag}/"
            want = {k[len(pre) - 1:]: v for k, v in ref.items() if k.startswith(pre)}
            got = {k[len(pre) - 1:]: v for k, v in o0.items() if k.startswith(pre)}
            _close_flat(got, want, f"step {i} {tag}", exempt)
            for k in got:
                np.testing.assert_array_equal(o1[pre + k[1:]], got[k])
        for pod, o in enumerate((o0, o1)):
            # r = g32 - deq(q): where the codes agree its error is g32's, so
            # it is held at STEP_TOL of max|g32| (= 127 x the leaf's scale)
            pre = f"step{i}.res"
            want = {k[len(pre) + 1:]: v for k, v in ref.items() if k.startswith(f"{pre}{pod}/")}
            got = {k[len(pre):]: v for k, v in o.items() if k.startswith(f"{pre}/")}
            assert set(got) == set(want)
            for k, w in want.items():
                g32max = float(ref[f"step{i}.g32max{pod}{k}"])
                err = float(np.abs(got[k] - w)[~exempt[k]].max(initial=0.0))
                assert err <= STEP_TOL * g32max, f"step {i} pod {pod} residual {k}: {err}"
    n = sum(v.size for v in exempt.values())
    assert sum(int(v.sum()) for v in exempt.values()) <= 4 * NEAR * STEPS * n


def test_compressed_step_refuses_a_pod_of_several_ranks(case):
    """Which inner step the compressed step takes.  A pod of several ranks
    always runs its gradients sharded (the state comes back placed, on
    every rank; each layout below holds it to the reference).  Pods of one
    rank take the plain step for plain params and the sharded one for
    params already placed on the pod's (data, model) mesh; from the same
    weights and batch the two agree bitwise (a mesh of one rank runs the
    same ops)."""
    _, _, out = case
    for d, m in ((2, 1), (1, 2)):
        assert all(bool(o[f"pdm2{d}{m}.placed"]) for o in out[4])
    for o in out[2]:
        assert not o["choice.plain.dtensor"].any() and o["choice.placed.dtensor"].all()
        for k, v in o.items():
            if k.startswith("choice.plain.params"):
                np.testing.assert_array_equal(
                    o[k.replace("choice.plain.", "choice.placed.")], v, err_msg=k)


@pytest.mark.parametrize("layout", [(2, 1), (1, 2)], ids=["data2", "model2"])
def test_compressed_step_over_a_sharded_pod_matches_the_reference_parts(case, layout):
    """Two pods of two ranks, (pod, data, model) = (2, 2, 1) and (2, 1, 2):
    each pod's gradients from the sharded step on its (data, model) mesh,
    each leaf quantized with one scale over all its shards (the amax
    gathered over the pod's ranks), the codes crossing ``pod`` alone.
    Rank 0 (pod 0) and rank 2 (pod 1) against JAX's parts as above; every
    rank of a pod holds the same whole state."""
    _, ref, out = case
    d, m = layout
    prefix = f"pdm2{d}{m}."
    _check_compressed(ref, out[4][0], out[4][2], prefix)
    for o in out[4][1:]:
        for k, v in out[4][0].items():
            if k.startswith(prefix) and ".params/" in k:
                np.testing.assert_array_equal(o[k], v)

