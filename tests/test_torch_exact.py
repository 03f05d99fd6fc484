"""Exact-mode e-prop (``EpropConfig(mode="exact")``, the per-synapse
filtered eligibility of ReckOn's trace SRAM) through the port's backend,
against the JAX package's scan backend, which runs exact mode as one
compiled ``lax.scan`` a tile (``repro/core/backend.py:_train_impl`` →
``eprop.run_sample_exact``).

On the CPU the port's ``train_tile`` runs ``rsnn_train_exact``'s plain
version (:func:`repro_torch.kernels.eprop_update.rsnn_train_exact_plain`,
on the port's oracle :func:`repro_torch.core.eprop.exact_tile`); the card
runs the kernel (``tests/test_torch_cuda.py``).  All at the reduced Braille
config (12/16/3, T=32), inputs and weights made with numpy from a seed and
handed to both packages (weights through ``params_from_jax``).

Tolerances, stated once: ``dw`` within ``rtol = atol = DW_TOL`` (2e-4, as
``tests/test_quant_equivalence.py`` holds the JAX package's own modes to
each other: the error goes through ``exp`` and XLA fuses the trace
updates' multiply-adds, so the sums round apart by a few ulp), ``pred``
equal, ``acc_y`` within ``1e-4`` (bitwise when quantized), weights after
the optimizer within ``DW_TOL``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.backend import ExecutionBackend as JaxBackend
from repro.core.backend import RuntimeConfig as JaxRuntime
from repro.core.controller import make_batch_commit_train_fn as jax_end_b
from repro.core.controller import make_train_batch_fn as jax_end_s
from repro.core.quant import DW_COMMIT_SPEC as JAX_GRID
from repro.core.rsnn import Presets as JaxPresets
from repro.optim.eprop_opt import EpropSGD as JaxSGD
from repro.optim.eprop_opt import EpropSGDConfig as JaxSGDConfig
from repro_torch.convert import params_from_jax
from repro_torch.core import eprop
from repro_torch.core.backend import ExecutionBackend, RuntimeConfig
from repro_torch.core.controller import make_batch_commit_train_fn, make_train_batch_fn
from repro_torch.core.quant import DW_COMMIT_SPEC
from repro_torch.core.rsnn import Presets
from repro_torch.kernels import ops
from repro_torch.kernels.eprop_update import dw_codes, rsnn_train_exact_plain
from repro_torch.optim.eprop_opt import EpropSGD, EpropSGDConfig

DW_TOL = 2e-4
ACC_TOL = dict(rtol=1e-4, atol=1e-4)
T = 32
N_HID = 16


def _cfgs(quantized, reset="zero", feedback="symmetric", error="softmax", mode="exact"):
    """The JAX package's and the port's reduced Braille config."""
    out = []
    for presets in (JaxPresets, Presets):
        cfg = presets.braille(n_classes=3, n_hid=N_HID, num_ticks=T, quantized=quantized)
        out.append(dataclasses.replace(
            cfg, neuron=dataclasses.replace(cfg.neuron, reset=reset),
            eprop=dataclasses.replace(cfg.eprop, mode=mode, feedback=feedback,
                                      error=error)))
    return out


def _weights(rng, cfg, quantized, alpha=False):
    """numpy weights, on the Q(8,4) SRAM grid when quantized; with
    ``alpha`` one decay a neuron in [0.85, 1)."""
    n, h, o = cfg.n_in, cfg.n_hid, cfg.n_out
    w = {"w_in": 2.5 * rng.normal(size=(n, h)) / np.sqrt(n),
         "w_rec": 2.5 * rng.normal(size=(h, h)) / np.sqrt(h),
         "w_out": 2.5 * rng.normal(size=(h, o)) / np.sqrt(h),
         "b_fb": rng.normal(size=(h, o)) / np.sqrt(h)}
    if quantized:
        w = {k: np.clip(np.round(v * 16) / 16, -8, 127 / 16) for k, v in w.items()}
    if alpha:
        w["alpha"] = rng.uniform(0.85, 1.0, size=h)
    return {k: v.astype(np.float32) for k, v in w.items()}


def _tile(rng, cfg, B, density=0.3):
    raster = (rng.random((T, B, cfg.n_in)) < density).astype(np.float32)
    t = np.arange(T)[:, None]
    valid = ((t >= rng.integers(2, T // 2, size=B))
             & (t <= rng.integers(T // 2, T, size=B))).astype(np.float32)
    y_star = np.eye(cfg.n_out, dtype=np.float32)[rng.integers(0, cfg.n_out, size=B)]
    return raster, y_star, valid


def _jax_train(jcfg, w, tile, **rt):
    be = JaxBackend(jcfg, runtime=JaxRuntime(backend="scan", **rt))
    dw, m = be.train_tile({k: jnp.asarray(v) for k, v in w.items()},
                          *(jnp.asarray(x) for x in tile))
    return {k: np.asarray(v) for k, v in dw.items()}, {k: np.asarray(v) for k, v in m.items()}


def _port_train(tcfg, w, tile, **rt):
    be = ExecutionBackend(tcfg, device="cpu", runtime=RuntimeConfig(**rt))
    dw, m = be.train_tile(params_from_jax(w, device="cpu"),
                          *(torch.from_numpy(x) for x in tile))
    return {k: v.numpy() for k, v in dw.items()}, {k: v.numpy() for k, v in m.items()}


def _hold(jout, tout, quantized):
    (jdw, jm), (tdw, tm) = jout, tout
    for k in jdw:
        np.testing.assert_allclose(tdw[k], jdw[k], rtol=DW_TOL, atol=DW_TOL, err_msg=k)
    np.testing.assert_array_equal(tm["pred"], jm["pred"])
    if quantized:
        np.testing.assert_array_equal(tm["acc_y"], jm["acc_y"])
    else:
        np.testing.assert_allclose(tm["acc_y"], jm["acc_y"], **ACC_TOL)
    np.testing.assert_allclose(tm["spike_rate"], jm["spike_rate"], rtol=1e-6)


# Every value of each setting at least four times, each pair of two
# settings' values at least once (quantized, reset, feedback, error, B).
CASES = [
    (False, "sub", "symmetric", "softmax", 1),
    (False, "zero", "random", "direct", 6),
    (True, "zero", "symmetric", "softmax", 6),
    (True, "sub", "random", "direct", 1),
    (False, "sub", "random", "softmax", 6),
    (True, "zero", "random", "softmax", 1),
    (False, "zero", "symmetric", "direct", 1),
    (True, "sub", "symmetric", "direct", 6),
]


@pytest.mark.parametrize("quantized,reset,feedback,error,B", CASES)
def test_exact_train_tile_matches_jax_scan(quantized, reset, feedback, error, B):
    """The port's exact ``train_tile`` is the JAX scan backend's.  With one
    decay for all neurons the factored rule agrees with it to float order
    too, so these cases hold the exact path's arithmetic; the per-neuron
    alpha cases below are the ones the factored rule fails."""
    rng = np.random.default_rng(100 + CASES.index((quantized, reset, feedback, error, B)))
    jcfg, tcfg = _cfgs(quantized, reset, feedback, error)
    w = _weights(rng, tcfg, quantized)
    tile = _tile(rng, tcfg, B)
    _hold(_jax_train(jcfg, w, tile), _port_train(tcfg, w, tile), quantized)


@pytest.mark.parametrize("quantized", [False, True])
def test_per_neuron_alpha_trains_in_exact_mode(quantized):
    """A per-neuron ``alpha (H,)`` in the weights drives the eligibility
    traces (and the float membrane) as in the JAX scan; the backend's own
    alpha, or the factored rule, gives another ``dw``."""
    rng = np.random.default_rng(30 + quantized)
    jcfg, tcfg = _cfgs(quantized, "sub", "random")
    w = _weights(rng, tcfg, quantized, alpha=True)
    tile = _tile(rng, tcfg, 4)
    want = _jax_train(jcfg, w, tile)
    _hold(want, _port_train(tcfg, w, tile), quantized)
    scalar, _ = _port_train(tcfg, {k: v for k, v in w.items() if k != "alpha"}, tile)
    assert max(np.abs(scalar[k] - want[0][k]).max() for k in scalar) > 100 * DW_TOL


def test_per_neuron_alpha_is_refused_in_factored_mode():
    """Factored e-prop keeps one trace a presynaptic line: an ``(H,)``
    alpha raises ``ValueError`` in both packages; a scalar one trains."""
    rng = np.random.default_rng(32)
    jcfg, tcfg = _cfgs(False, mode="factored")
    w = _weights(rng, tcfg, False, alpha=True)
    tile = _tile(rng, tcfg, 2)
    with pytest.raises(ValueError, match="scalar alpha"):
        _jax_train(jcfg, w, tile)
    with pytest.raises(ValueError, match="scalar alpha"):
        _port_train(tcfg, w, tile)
    w["alpha"] = np.float32(0.93)
    _hold(_jax_train(jcfg, w, tile), _port_train(tcfg, w, tile), False)


def test_exact_train_tile_goes_through_rsnn_train_exact(monkeypatch):
    """Exact mode dispatches to ``ops.rsnn_train_exact`` and factored mode
    to ``ops.rsnn_train``; neither reaches the other."""
    rng = np.random.default_rng(34)
    _, tcfg = _cfgs(True)
    w, tile = _weights(rng, tcfg, True), _tile(rng, tcfg, 2)
    calls = []

    def count(name, fn):
        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return wrapped

    for name in ("rsnn_train", "rsnn_train_exact"):
        monkeypatch.setattr(ops, name, count(name, getattr(ops, name)))
    _port_train(tcfg, w, tile)
    _port_train(dataclasses.replace(tcfg, eprop=dataclasses.replace(
        tcfg.eprop, mode="factored")), w, tile)
    assert calls == ["rsnn_train_exact", "rsnn_train"]


def test_commit_grid_codes_match_jax_train_det():
    """On the integer commit grid (``DW_COMMIT_SPEC``) each side's codes are
    its own per-sample ``dw`` snapped and summed, bitwise, and the two
    sides' per-sample ``dw`` agree within ``DW_TOL``.  A code differs only
    where the two per-sample values lie on either side of a rounding
    boundary of the grid within that tolerance: XLA fuses the trace
    updates' multiply-adds (one rounding where the port takes two), so the
    values differ by a few ulp, and a value within those ulp of a half step
    rounds the other way.  Measured here: 1-4 codes of 496 a sample set
    (at most one step a sample)."""
    rng = np.random.default_rng(35)
    jcfg, tcfg = _cfgs(True)
    w = _weights(rng, tcfg, True)
    B = 8
    tile = _tile(rng, tcfg, B)
    jdw, jm = _jax_train(jcfg, w, tile, commit_grid=JAX_GRID)
    tdw, tm = _port_train(tcfg, w, tile, commit_grid=DW_COMMIT_SPEC)
    np.testing.assert_array_equal(tm["pred"], jm["pred"])
    np.testing.assert_array_equal(tm["acc_y"], jm["acc_y"])
    lsb = DW_COMMIT_SPEC.lsb
    raster, y_star, valid = tile
    rows = [(raster[:, b: b + 1], y_star[b: b + 1], valid[:, b: b + 1]) for b in range(B)]
    per_j = [_jax_train(jcfg, w, r)[0] for r in rows]
    per_t = [_port_train(tcfg, w, r)[0] for r in rows]
    flips = 0
    for k in jdw:
        cj = sum(dw_codes(torch.from_numpy(np.array(p[k])), DW_COMMIT_SPEC) for p in per_j)
        ct = sum(dw_codes(torch.from_numpy(p[k]), DW_COMMIT_SPEC) for p in per_t)
        np.testing.assert_array_equal(jdw[k] / lsb, cj.numpy(), err_msg=k)
        np.testing.assert_array_equal(tdw[k] / lsb, ct.numpy(), err_msg=k)
        for pj, pt in zip(per_j, per_t):
            a, b = pj[k] / lsb, pt[k] / lsb
            np.testing.assert_allclose(pt[k], pj[k], rtol=DW_TOL, atol=DW_TOL, err_msg=k)
            apart = np.round(a) != np.round(b)
            flips += int(apart.sum())
            # each flip straddles a half step, both values within the tolerance of it
            half = np.floor(np.minimum(a, b)[apart]) + 0.5
            tol = (DW_TOL * np.maximum(np.abs(pj[k][apart]), 1.0)) / lsb
            assert np.all(np.abs(a[apart] - half) <= tol) and np.all(np.abs(b[apart] - half) <= tol), k
    assert flips <= 0.02 * B * sum(v.size for v in jdw.values()), flips


def test_sharded_exact_train_tile_equals_unsharded(tmp_path):
    """On a gloo world of 2 the sharded exact ``train_tile`` (each rank its
    rows, the ``dw`` all-reduced) is the unsharded one: bitwise on the
    commit grid (int32 codes), within f32 order otherwise (the ranks' sums
    add in another grouping); ``acc_y`` and the spike rate bitwise."""
    import _torch_exact_ranks as ranks
    from _torch_dist_ranks import spawn_world

    rng = np.random.default_rng(36)
    inp = {}
    for tag, quantized in (("float", False), ("grid", True)):
        cfg = ranks.exact_cfg(T, quantized)
        w = _weights(rng, cfg, quantized, alpha=True)
        tile = _tile(rng, cfg, 7)       # odd: the second rank gets a padding row
        inp.update({f"{tag}.{k}": v for k, v in w.items()})
        inp.update({f"{tag}.{k}": v for k, v in zip(("raster", "y_star", "valid"), tile)})
    np.savez(tmp_path / "in.npz", **inp)
    spawn_world(ranks.run_exact, 2, (str(tmp_path / "in.npz"), str(tmp_path)),
                str(tmp_path / "rdv"), 60)
    outs = [dict(np.load(tmp_path / f"exact_w2_r{r}.npz")) for r in range(2)]
    for o in outs:
        for tag in ("float", "grid"):
            for k in ("w_in", "w_rec", "w_out"):
                got, want = o[f"{tag}.mesh.dw.{k}"], o[f"{tag}.one.dw.{k}"]
                if tag == "grid":
                    np.testing.assert_array_equal(got, want, err_msg=k)
                else:
                    np.testing.assert_allclose(got, want, rtol=1e-5,
                                               atol=1e-5 * np.abs(want).max(), err_msg=k)
                np.testing.assert_array_equal(got, outs[0][f"{tag}.mesh.dw.{k}"])
            for k in ("acc_y", "pred", "spike_rate"):
                np.testing.assert_array_equal(o[f"{tag}.mesh.{k}"], o[f"{tag}.one.{k}"])


def _learner_batch(rng, cfg, S):
    raster, y_star, valid = _tile(rng, cfg, S)
    return {"raster": raster.swapaxes(0, 1), "label": y_star.argmax(-1),
            "valid": valid.swapaxes(0, 1)}


def test_controller_end_s_and_end_b_in_exact_mode_match_jax():
    """Five END_S commits (``make_train_batch_fn`` over a 5-sample batch)
    and one END_B commit (``make_batch_commit_train_fn``) of the port's
    controller in exact mode, from the same weights, give the JAX
    controller's weights within ``DW_TOL`` (float SGD, lr 0.02, clip 10)."""
    import jax

    rng = np.random.default_rng(37)
    jcfg, tcfg = _cfgs(False, "sub", "random")
    w = _weights(rng, tcfg, False)
    batch = _learner_batch(rng, tcfg, 5)
    jopt = JaxSGD(JaxSGDConfig(lr=0.02, clip=10.0))
    topt = EpropSGD(EpropSGDConfig(lr=0.02, clip=10.0))
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tw = params_from_jax(w, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["label"] = tb["label"].to(torch.int64)
    be = ExecutionBackend(tcfg, device="cpu")
    for jfn, tfn in ((jax_end_s(jcfg, jopt, JaxBackend(jcfg, "scan")),
                      make_train_batch_fn(tcfg, topt, be)),
                     (jax_end_b(jcfg, jopt, JaxBackend(jcfg, "scan")),
                      make_batch_commit_train_fn(tcfg, topt, be))):
        jnew, _, jm = jfn(jw, jopt.init(jw), jb, jax.random.key(0))
        tnew, _, tm = tfn(tw, topt.init(tw), tb)
        for k in ("w_in", "w_rec", "w_out"):
            assert not np.array_equal(tnew[k].numpy(), w[k]), k
            np.testing.assert_allclose(tnew[k].numpy(), np.asarray(jnew[k]),
                                       rtol=DW_TOL, atol=DW_TOL, err_msg=k)
        assert int(tm["correct"]) == int(jm["correct"])


def test_exact_learner_resumes_bitwise(tmp_path, monkeypatch):
    """An ``OnlineLearner`` in exact mode (quantized, stochastic commits,
    END_S) interrupted at a commit and resumed from its checkpoint ends
    bitwise on the uninterrupted run, every commit through
    ``rsnn_train_exact`` (``rsnn_train`` is not reached)."""
    from repro_torch.configs.reckon_braille import QUANT_OPT
    from repro_torch.core.controller import ControllerConfig, OnlineLearner
    from repro_torch.data.braille import BrailleConfig, make_braille_dataset
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.distributed.checkpoint import CheckpointPolicy

    def refuse(*a, **k):
        raise AssertionError("factored rsnn_train reached in exact mode")

    monkeypatch.setattr(ops, "rsnn_train", refuse)
    _, tcfg = _cfgs(True)
    tcfg = dataclasses.replace(tcfg, num_ticks=24)
    data = make_braille_dataset("AEU", BrailleConfig(samples_per_class=4, num_ticks=24))

    def learner(ckpt):
        pipe = make_pipeline("arm", data, samples_per_batch=3, shuffle_train=True, seed=2,
                             device="cpu")
        policy = None if ckpt is None else CheckpointPolicy(str(ckpt), every=1,
                                                            async_save=False)
        return OnlineLearner(tcfg, ControllerConfig(num_epochs=1, commit="sample"),
                             QUANT_OPT, 5, device="cpu", checkpoint=policy), pipe

    gold, pipe = learner(None)
    start = {k: v.clone() for k, v in gold.weights.items()}
    gold.fit(pipe)
    assert any(not torch.equal(gold.weights[k], start[k]) for k in start)

    class Interrupt(Exception):
        pass

    def kill(lrn, commits):
        if commits >= 2:
            raise Interrupt

    a, pipe_a = learner(tmp_path)
    with pytest.raises(Interrupt):
        a.fit(pipe_a, on_commit=kill)
    b, pipe_b = learner(tmp_path)
    b.fit(pipe_b, resume=True)
    assert b.commits == gold.commits
    for k, v in gold.weights.items():
        assert torch.equal(b.weights[k], v), k
    assert torch.equal(b.generator.get_state(), gold.generator.get_state())


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("alpha", ["scalar", "per_neuron"])
def test_plain_version_is_the_oracle(quantized, alpha):
    """``rsnn_train_exact_plain`` on the datapath weights is
    :func:`repro_torch.core.eprop.run_sample_exact` on the raw ones,
    bitwise (``dw_rec`` masked by the caller), and its commit-grid path
    sums each row's ``B=1`` codes."""
    rng = np.random.default_rng(38 + 2 * quantized + (alpha == "per_neuron"))
    _, tcfg = _cfgs(quantized, "sub", "random", "direct")
    w = params_from_jax(_weights(rng, tcfg, quantized, alpha=alpha == "per_neuron"),
                        device="cpu")
    if alpha == "scalar":
        w["alpha"] = torch.tensor(tcfg.neuron.alpha if not quantized else 254 / 256)
    raster, y_star, valid = (torch.from_numpy(x) for x in _tile(rng, tcfg, 5))
    be = ExecutionBackend(tcfg, device="cpu")
    ncfg = be._ncfg
    kw = dict(alpha=w["alpha"], kappa=ncfg.kappa, v_th=ncfg.v_th, reset=ncfg.reset,
              boxcar_width=ncfg.boxcar_width, quant=be.quant, error=tcfg.eprop.error,
              target_amplitude=tcfg.eprop.target_amplitude,
              infer_window=tcfg.eprop.infer_window)
    args = (raster, y_star, valid, *be.datapath_weights(w), w["b_fb"])
    *dw, acc, nspk = rsnn_train_exact_plain(*args, **kw)
    odw, om = eprop.run_sample_exact(w, raster, y_star, valid, tcfg.neuron, tcfg.eprop)
    mask = be._mask
    for k, d in zip(("w_in", "w_rec", "w_out"), dw):
        assert torch.equal(d * mask if k == "w_rec" else d, odw[k]), k
    assert torch.equal(acc, om["acc_y"])
    codes = list(rsnn_train_exact_plain(*args, **kw, commit_grid=DW_COMMIT_SPEC))
    for b in range(5):
        one = rsnn_train_exact_plain(raster[:, b: b + 1], y_star[b: b + 1],
                                     valid[:, b: b + 1], *args[3:], **kw)
        for i in range(3):
            codes[i] = codes[i] - dw_codes(one[i], DW_COMMIT_SPEC)
        assert torch.equal(codes[3][b], one[3][0]) and torch.equal(codes[4][b], one[4][0])
    assert all(int(c.abs().max()) == 0 for c in codes[:3])
    assert codes[0].dtype == torch.int32


def test_params_from_jax_carries_a_per_neuron_alpha():
    h = np.linspace(0.9, 0.99, N_HID, dtype=np.float32)
    got = params_from_jax({"alpha": h, "w_in": np.zeros((12, N_HID), np.float32)},
                          device="cpu")
    assert got["alpha"].shape == (N_HID,) and got["alpha"].dtype == torch.float32
    np.testing.assert_array_equal(got["alpha"].numpy(), h)
    assert params_from_jax({"alpha": np.float32(0.9)}, device="cpu")["alpha"].ndim == 0


# (al)'s and (am)'s shapes (N, H, O, T, B), and the chip-maximum net at every
# tick count the chip allows a sample (T up to 4,096, core/rsnn.py)
EXACT_PLAN_SHAPES = [
    (12, 38, 3, 256, 1), (12, 38, 3, 128, 1), (12, 38, 3, 128, 70),
    (40, 100, 2, 150, 8), (256, 256, 16, 128, 4), (12, 38, 3, 256, 8),
    *((256, 256, 16, t, 1) for t in (1, 15, 16, 17, 1000, 4096)),
]


@pytest.mark.parametrize("N,H,O,T,B", EXACT_PLAN_SHAPES)
def test_train_exact_plan_fits_every_shape(N, H, O, T, B):
    """``rsnn_train_exact``'s plan fits a block's shared memory with one
    route at every shape: the ring of tick blocks does not grow with T, the
    walker threads carry every synapse in at most ``EXACT_MAX_LINES`` lines
    each, the row's clusters of 1 to 8 blocks (a cluster at B=1) fit the
    card's SMs at once, and the bytes are the kernel's layout."""
    from repro_torch.kernels import rsnn_step as K
    from repro_torch.kernels.launch import H100_SMS, SMEM_PER_BLOCK

    plan = K.train_exact_plan(T, N, H, O, B)
    assert plan.smem_bytes <= SMEM_PER_BLOCK
    assert plan.smem_bytes == K.exact_smem_bytes(N, H, O, plan.slots, plan.ticks,
                                                 plan.weights_smem)
    assert 1 <= plan.slots <= min(K.EXACT_MAX_SLOTS, -(-T // plan.ticks))
    assert plan.cluster in (1, 2, 4, 8) and B * plan.blocks <= H100_SMS
    assert B > 1 or plan.cluster > 1
    k = plan.lines
    assert k in (1, 2, 4, 8, K.EXACT_MAX_LINES)
    assert plan.g_in * k >= N and plan.g_rec * k >= H and plan.g_out * k >= O
    assert H * (plan.g_in + plan.g_rec + plan.g_out) <= (
        plan.groups * K.cluster_walkers(plan.cluster, plan.inputs))
    if T >= K.EXACT_MAX_SLOTS * plan.ticks:
        assert plan == K.train_exact_plan(4096, N, H, O, B)
