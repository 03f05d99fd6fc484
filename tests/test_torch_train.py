"""The port's training path against the JAX package.

On the CPU the port's ops run the kernels' plain PyTorch versions; the JAX
kernels run as the JAX package's own tests run them (``ExecutionBackend(cfg,
"kernel")``, Pallas in interpret mode).  Inputs and weights are made with
numpy from a seed and handed to both packages (weights through
``params_from_jax``).  Kept at T <= 32 and B <= 8: interpret mode is slow.

Tolerances, stated once:
* quantized mode: ``acc_y``, ``n_spk``, the boxcar ``h`` and the
  ``dynamics`` trajectories bitwise (integers on the membrane grid).  The
  filtered traces ``xbar, pbar, zbar`` are bitwise against a NumPy
  recurrence that rounds each product before the add, as the port does
  (plain and CUDA, built with ``-fmad=false``); XLA's CPU compiler fuses
  ``alpha * x + s`` into one multiply-add, so against JAX they are held to
  ``TRACE_TOL`` (a few ulp);
* ``dw``: ``max |Δdw| <= DW_TOL * max |dw|`` per matrix, in both modes (the
  error goes through ``exp``, and the products sum in another order);
* float mode: everything else to ``atol = rtol = 1e-4``; the readout error
  ``err`` to ``atol = 1e-6``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant_ref
from repro.core.backend import ExecutionBackend as JaxBackend
from repro.core.rsnn import Presets as JaxPresets
from repro.kernels.rsnn_step import fused_train_bytes
from repro_torch.convert import params_from_jax
from repro_torch.core import eprop
from repro_torch.core.backend import ExecutionBackend
from repro_torch.core.neuron import lif_step, lif_step_surrogate, pseudo_derivative
from repro_torch.core.quant import WEIGHT_SPEC, QuantSpec, QuantState
from repro_torch.core.rsnn import Presets, merge_trainable, sram_bytes, trainable
from repro_torch.kernels import ops
from repro_torch.optim.eprop_opt import EpropSGD, EpropSGDConfig

DW_TOL = 1e-4
FLOAT_TOL = dict(atol=1e-4, rtol=1e-4)
ERR_TOL = dict(atol=1e-6, rtol=0)
TRACE_TOL = dict(atol=1e-6, rtol=1e-6)


def _replace(cfg, *, reset=None, feedback=None, error=None):
    if reset is not None:
        cfg = dataclasses.replace(cfg, neuron=dataclasses.replace(cfg.neuron, reset=reset))
    if feedback is not None:
        cfg = dataclasses.replace(cfg, eprop=dataclasses.replace(cfg.eprop, feedback=feedback))
    if error is not None:
        cfg = dataclasses.replace(cfg, eprop=dataclasses.replace(cfg.eprop, error=error))
    return cfg


def _case(seed, T, B, quantized, reset="zero", feedback="symmetric",
          label_delay=0, error="softmax", gain=2.5, density=0.3):
    """Both packages' configs, numpy weights (with ``b_fb`` for random
    feedback) and one training tile."""
    rng = np.random.default_rng(seed)
    kw = dict(num_ticks=T, quantized=quantized, label_delay=label_delay)
    jcfg = _replace(JaxPresets.braille(**kw), reset=reset, feedback=feedback, error=error)
    tcfg = _replace(Presets.braille(**kw), reset=reset, feedback=feedback, error=error)
    n, h, o = tcfg.n_in, tcfg.n_hid, tcfg.n_out
    w = {"w_in": gain * rng.normal(size=(n, h)) / np.sqrt(n),
         "w_rec": gain * rng.normal(size=(h, h)) / np.sqrt(h),
         "w_out": gain * rng.normal(size=(h, o)) / np.sqrt(h)}
    if feedback == "random":
        w["b_fb"] = rng.normal(size=(h, o)) / np.sqrt(h)
    w = {k: v.astype(np.float32) for k, v in w.items()}
    raster = (rng.random((T, B, n)) < density).astype(np.float32)
    label_tick = rng.integers(0, T // 2, size=B)
    end_tick = rng.integers(T // 2, T, size=B)
    t = np.arange(T)[:, None]
    valid = ((t >= label_tick + label_delay) & (t <= end_tick)).astype(np.float32)
    y_star = np.eye(o, dtype=np.float32)[rng.integers(0, o, size=B)]
    return jcfg, tcfg, w, raster, valid, y_star


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _torch(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _check(a, b, quantized, tol=FLOAT_TOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    if quantized:
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(a, b, **tol)


def _check_dw(jdw, tdw):
    for k in ("w_in", "w_rec", "w_out"):
        a, b = np.asarray(jdw[k]), np.asarray(tdw[k])
        assert a.shape == b.shape, k
        scale = max(float(np.abs(a).max()), 1e-30)
        assert float(np.abs(a - b).max()) <= DW_TOL * scale, k


# (seed, T, B, quantized, reset, feedback, label_delay, ragged JAX tiles)
CASES = [
    pytest.param(1, 24, 8, True, "zero", "symmetric", 0, True, id="quant-zero-sym-ragged"),
    pytest.param(2, 24, 1, True, "sub", "random", 4, False, id="quant-sub-random-d4-B1"),
    pytest.param(3, 24, 5, True, "zero", "random", 4, False, id="quant-zero-random-d4"),
    pytest.param(4, 24, 8, False, "sub", "symmetric", 4, True, id="float-sub-sym-d4-ragged"),
    pytest.param(5, 24, 1, False, "zero", "random", 0, False, id="float-zero-random-B1"),
]


def _ragged_budget(T, cfg):
    """A JAX VMEM budget that cuts the batch into 3-row train tiles, so
    B = 8 ends in a ragged, zero-padded last tile."""
    return fused_train_bytes(T, 3, cfg.n_in, cfg.n_hid, cfg.n_out)


@pytest.mark.parametrize("seed,T,B,quantized,reset,feedback,delay,ragged", CASES)
def test_train_tile_plain_matches_jax_kernel(seed, T, B, quantized, reset,
                                             feedback, delay, ragged):
    jcfg, tcfg, w, raster, valid, y_star = _case(
        seed, T, B, quantized, reset, feedback, delay)
    budget = _ragged_budget(T, tcfg) if ragged else None
    jdw, jm = JaxBackend(jcfg, "kernel", vmem_budget=budget).train_tile(
        {k: jnp.asarray(v) for k, v in w.items()}, *_jax(raster, y_star, valid))
    tdw, tm = ExecutionBackend(tcfg, device="cpu").train_tile(
        params_from_jax(w, device="cpu"), *_torch(raster, y_star, valid))
    _check_dw(jdw, tdw)
    _check(jm["acc_y"], tm["acc_y"], quantized)
    np.testing.assert_array_equal(np.asarray(jm["pred"]), tm["pred"].numpy())
    np.testing.assert_allclose(float(jm["spike_rate"]), float(tm["spike_rate"]),
                               rtol=1e-6)


@pytest.mark.parametrize("seed,T,B,quantized,reset,feedback,delay,ragged", CASES)
def test_split_pipeline_plain_matches_jax_kernel(seed, T, B, quantized, reset,
                                                 feedback, delay, ragged):
    """``forward_traces`` then ``eprop_update``: ``h`` held bitwise in
    quantized mode, the filtered traces to ``TRACE_TOL``, ``dw`` to the
    stated tolerance, and the split pipeline's ``dw`` equal to the fused
    ``train_tile``'s within it."""
    jcfg, tcfg, w, raster, valid, y_star = _case(
        seed, T, B, quantized, reset, feedback, delay)
    # 8056 + 3 * 2404 bytes: 3-row JAX forward / update tiles at Braille width
    budget = 8056 + 3 * 2404 if ragged else None
    jbe = JaxBackend(jcfg, "kernel", vmem_budget=budget)
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    jtr = jbe.forward_traces(jw, *_jax(raster, y_star, valid))
    be = ExecutionBackend(tcfg, device="cpu")
    tw = params_from_jax(w, device="cpu")
    ttr = be.forward_traces(tw, *_torch(raster, y_star, valid))
    for k in ("h", "y_inf", "n_spk"):
        _check(jtr[k], ttr[k], quantized)
    for k in ("xbar", "pbar", "zbar"):
        np.testing.assert_allclose(np.asarray(jtr[k]), ttr[k].numpy(),
                                   **(TRACE_TOL if quantized else FLOAT_TOL))
    np.testing.assert_allclose(np.asarray(jtr["err"]), ttr["err"].numpy(), **ERR_TOL)
    tdw = be.eprop_update(tw, ttr)
    _check_dw(jbe.eprop_update(jw, jtr), tdw)
    fused, _ = be.train_tile(tw, *_torch(raster, y_star, valid))
    _check_dw(fused, tdw)


@pytest.mark.parametrize("seed,T,B,quantized,reset,feedback,delay,ragged", CASES)
def test_train_plain_traces_match_jax_forward_traces(seed, T, B, quantized, reset,
                                                     feedback, delay, ragged):
    """The trace set ``rsnn_train`` returns on request (what the card tests
    hold the kernel to) is the JAX package's ``forward_traces``: ``h`` held
    bitwise in quantized mode, the filtered traces to ``TRACE_TOL``,
    ``err`` to ``ERR_TOL``."""
    from repro_torch.kernels import eprop_update as E

    jcfg, tcfg, w, raster, valid, y_star = _case(
        seed, T, B, quantized, reset, feedback, delay)
    jtr = JaxBackend(jcfg, "kernel").forward_traces(
        {k: jnp.asarray(v) for k, v in w.items()}, *_jax(raster, y_star, valid))
    be = ExecutionBackend(tcfg, device="cpu")
    tw = params_from_jax(w, device="cpu")
    ecfg = tcfg.eprop
    out = E.rsnn_train_plain(
        *_torch(raster, y_star, valid), *be.datapath_weights(tw), be._feedback(tw),
        error=ecfg.error, target_amplitude=ecfg.target_amplitude,
        infer_window=ecfg.infer_window, return_traces=True, **be._trace_kw())
    assert len(out) == 6
    tr = out[5]
    assert set(tr) == set(E.TRACE_KEYS)
    _check(jtr["h"], tr["h"], quantized)
    for k in ("xbar", "pbar", "zbar"):
        np.testing.assert_allclose(np.asarray(jtr[k]), tr[k].numpy(),
                                   **(TRACE_TOL if quantized else FLOAT_TOL))
    np.testing.assert_allclose(np.asarray(jtr["err"]), tr["err"].numpy(), **ERR_TOL)


@pytest.mark.parametrize("quantized,reset", [(True, "zero"), (True, "sub"),
                                             (False, "sub")])
def test_dynamics_plain_matches_jax_kernel(quantized, reset):
    jcfg, tcfg, w, raster, _, _ = _case(6, 32, 6, quantized, reset, gain=4.0,
                                        density=0.5)
    jout = JaxBackend(jcfg, "kernel").dynamics(
        {k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(raster))
    tout = ExecutionBackend(tcfg, device="cpu").dynamics(
        params_from_jax(w, device="cpu"), torch.from_numpy(raster))
    for k in ("v", "z", "y"):
        _check(jout[k], tout[k], quantized)


@pytest.mark.parametrize("reset", ["zero", "sub"])
def test_quantized_dynamics_match_golden_reference(reset):
    """Spikes, post-reset membranes, readout and the boxcar ``h`` of the
    quantized plain path equal the int64 golden reference, saturation
    included."""
    jcfg, tcfg, w, raster, valid, y_star = _case(7, 32, 8, True, reset, gain=4.0,
                                                 density=0.6)
    be = ExecutionBackend(tcfg, device="cpu")
    tw = params_from_jax(w, device="cpu")
    mask = 1.0 - np.eye(tcfg.n_hid, dtype=np.float32)
    g = quant_ref.golden_forward(raster, w["w_in"], w["w_rec"] * mask, w["w_out"],
                                 jcfg.neuron.quant, reset=reset,
                                 boxcar_width=jcfg.neuron.boxcar_width, valid=valid)
    q = jcfg.neuron.quant
    assert (g["v_pre"] == q.v_max).any() or (g["v_pre"] == q.v_min).any()
    out = be.dynamics(tw, torch.from_numpy(raster))
    for k in ("v", "z", "y"):
        np.testing.assert_array_equal(out[k].numpy(), g[k].astype(np.float32))
    tr = be.forward_traces(tw, *_torch(raster, y_star, valid))
    np.testing.assert_array_equal(tr["h"].numpy(), g["h"].astype(np.float32))
    # the filters over the golden spikes, each product rounded before the add
    a, k = np.float32(q.alpha), np.float32(q.kappa)
    z = g["z"].astype(np.float32)
    xbar, pbar, zbar = (np.zeros_like(x) for x in (raster[0], z[0], z[0]))
    for t in range(raster.shape[0]):
        xbar = np.float32(a * xbar) + raster[t]
        pbar = np.float32(a * pbar) + (z[t - 1] if t else 0 * z[0])
        zbar = np.float32(k * zbar) + z[t]
        for name, ref in (("xbar", xbar), ("pbar", pbar), ("zbar", zbar)):
            np.testing.assert_array_equal(tr[name][t].numpy(), ref)
    _, m = be.train_tile(tw, *_torch(raster, y_star, valid))
    np.testing.assert_array_equal(m["acc_y"].numpy(), g["acc_y"].astype(np.float32))


def test_train_tile_matches_scan_oracle():
    """The backend's plain ``rsnn_train`` against the port's own factored
    oracle (:func:`repro_torch.core.eprop.run_sample`)."""
    _, tcfg, w, raster, valid, y_star = _case(8, 20, 4, False, "sub", "random", 2)
    tw = params_from_jax(w, device="cpu")
    dw, m = ExecutionBackend(tcfg, device="cpu").train_tile(
        tw, *_torch(raster, y_star, valid))
    params = dict(tw, alpha=torch.tensor(tcfg.neuron.alpha))
    odw, om = eprop.run_sample(params, *_torch(raster, y_star, valid),
                               tcfg.neuron, tcfg.eprop)
    _check_dw(odw, dw)
    np.testing.assert_allclose(om["acc_y"].numpy(), m["acc_y"].numpy(), **FLOAT_TOL)


@pytest.mark.parametrize("reset", ["sub", "zero"])
@pytest.mark.parametrize("error", ["softmax", "direct"])
def test_exact_equals_factored(reset, error):
    """The per-synapse eligibility path and the factored path give the same
    ``dw`` (the swap of the two sums is exact up to float order)."""
    _, tcfg, w, raster, valid, y_star = _case(9, 25, 2, False, reset,
                                              error=error, gain=1.5)
    params = dict(params_from_jax(w, device="cpu"), alpha=torch.tensor(0.9))
    ncfg = dataclasses.replace(tcfg.neuron, alpha=0.9, kappa=0.4)
    args = (params, *_torch(raster, y_star, valid), ncfg)
    dw1, m1 = eprop.run_sample_exact(*args, dataclasses.replace(tcfg.eprop, mode="exact"))
    dw2, m2 = eprop.run_sample(*args, tcfg.eprop)
    for k in dw1:
        np.testing.assert_allclose(dw1[k].numpy(), dw2[k].numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(m1["acc_y"].numpy(), m2["acc_y"].numpy(), rtol=1e-5)
    assert float(dw1["w_rec"].diagonal().abs().max()) == 0.0


def test_oracle_matches_jax_scan():
    """The port's exact-mode oracle against the JAX scan on one tile."""
    from repro.core import eprop as jeprop

    jcfg, tcfg, w, raster, valid, y_star = _case(10, 16, 3, False, "sub",
                                                 "random", gain=1.5)
    ecfg_j = dataclasses.replace(jcfg.eprop, mode="exact")
    ecfg_t = dataclasses.replace(tcfg.eprop, mode="exact")
    jp = dict({k: jnp.asarray(v) for k, v in w.items()}, alpha=jnp.asarray(0.95))
    tp = dict(params_from_jax(w, device="cpu"), alpha=torch.tensor(0.95))
    jdw, jm = jeprop.run_sample(jp, *_jax(raster, y_star, valid), jcfg.neuron, ecfg_j)
    tdw, tm = eprop.run_sample(tp, *_torch(raster, y_star, valid), tcfg.neuron, ecfg_t)
    _check_dw(jdw, tdw)
    np.testing.assert_allclose(np.asarray(jm["acc_y"]), tm["acc_y"].numpy(), **FLOAT_TOL)


def test_forward_dynamics_oracle_matches_backend():
    _, tcfg, w, raster, _, _ = _case(11, 20, 3, True, "zero", gain=3.0)
    tw = params_from_jax(w, device="cpu")
    params = dict(tw, alpha=torch.tensor(tcfg.neuron.alpha))
    o = eprop.forward_dynamics(params, torch.from_numpy(raster), tcfg.neuron, tcfg.eprop)
    b = ExecutionBackend(tcfg, device="cpu").dynamics(tw, torch.from_numpy(raster))
    for k in ("v", "z", "y"):
        assert torch.equal(o[k], b[k])


def test_surrogate_spike_gradient_is_pseudo_derivative():
    """The BPTT reference path: forward equals :func:`lif_step`, and the
    gradient through the spike is the surrogate, as JAX's ``custom_vjp``."""
    from repro.core.neuron import lif_step_surrogate as jlif

    cfg = Presets.braille(num_ticks=8).neuron
    cfg = dataclasses.replace(cfg, reset="sub", surrogate="triangular")
    rng = np.random.default_rng(12)
    v = rng.normal(size=(4, 38)).astype(np.float32)
    cur = rng.normal(size=(4, 38)).astype(np.float32)
    tv = torch.from_numpy(v).requires_grad_(True)
    v_new, z, v_pre = lif_step_surrogate(tv, torch.from_numpy(cur), 0.9, cfg)
    ref = lif_step(torch.from_numpy(v), torch.from_numpy(cur), 0.9, cfg)
    for a, b in zip((v_new, z, v_pre), ref):
        assert torch.equal(a.detach(), b)
    z.sum().backward()
    np.testing.assert_allclose(
        tv.grad.numpy(), 0.9 * pseudo_derivative(v_pre.detach(), cfg).numpy(), rtol=1e-6)
    jcfg = dataclasses.replace(JaxPresets.braille(num_ticks=8).neuron, reset="sub",
                               surrogate="triangular")
    jg = jax.grad(lambda x: jlif(x, jnp.asarray(cur), 0.9, jcfg)[1].sum())(jnp.asarray(v))
    np.testing.assert_allclose(np.asarray(jg), tv.grad.numpy(), rtol=1e-6)
    with pytest.raises(ValueError, match="float-only"):
        lif_step_surrogate(tv, torch.from_numpy(cur), 0.9,
                           Presets.braille(quantized=True).neuron)


def test_rsnn_helpers():
    cfg = Presets.braille()
    p = {"w_in": torch.zeros(1), "w_rec": torch.ones(1), "w_out": torch.ones(2),
         "alpha": torch.tensor(0.5), "b_fb": torch.zeros(3)}
    assert set(trainable(p)) == {"w_in", "w_rec", "w_out"}
    merged = merge_trainable({"alpha": p["alpha"]}, trainable(p))
    assert set(merged) == {"alpha", "w_in", "w_rec", "w_out"}
    assert sram_bytes(cfg) == 12 * 38 + 38 * 38 + 38 * 3


# --------------------------------------------------------------------------
# optimizer and quantized storage
# --------------------------------------------------------------------------


def _opt_cases():
    return [
        dict(lr=0.1, clip=None, quant=WEIGHT_SPEC),
        dict(lr=0.01, clip=10.0, decay_tau=50.0, quant=WEIGHT_SPEC),
        dict(lr=0.05, clip=1.0, lr_out_scale=0.5, momentum=0.9, quant=WEIGHT_SPEC),
        dict(lr=0.02, clip=2.0, decay_tau=10.0),
    ]


@pytest.mark.parametrize("kw", _opt_cases())
@pytest.mark.parametrize("num_updates", [1.0, 70.0])
def test_eprop_sgd_update_matches_jax(kw, num_updates):
    """The same ``dw`` through both optimizers, three commits in a row:
    nearest-round commits give the same grid codes, residuals, counter and
    momentum; float commits agree to float rounding."""
    from repro.core.quant import WEIGHT_SPEC as JW
    from repro.optim.eprop_opt import EpropSGD as JSGD
    from repro.optim.eprop_opt import EpropSGDConfig as JCfg

    rng = np.random.default_rng(13)
    shapes = {"w_in": (12, 38), "w_rec": (38, 38), "w_out": (38, 3)}
    w0 = {k: (np.round(rng.normal(size=s) * 16) / 16).astype(np.float32)
          for k, s in shapes.items()}
    w0["b_fb"] = rng.normal(size=(38, 3)).astype(np.float32)
    jkw = dict(kw, quant=JW) if "quant" in kw else kw
    jopt, topt = JSGD(JCfg(**jkw)), EpropSGD(EpropSGDConfig(**kw))
    jw = {k: jnp.asarray(v) for k, v in w0.items()}
    tw = params_from_jax(w0, device="cpu")
    js, ts = jopt.init(jw), topt.init(tw)
    for step in range(3):
        dw = {k: (rng.normal(size=s) * 3.0).astype(np.float32) for k, s in shapes.items()}
        jw, js = jopt.update(jw, {k: jnp.asarray(v) for k, v in dw.items()}, js,
                             num_updates=num_updates)
        tw, ts = topt.update(tw, params_from_jax(dw, device="cpu"), ts,
                             num_updates=num_updates)
        assert int(js["count"]) == int(ts["count"]) == round(num_updates) * (step + 1)
        assert ts["count"].dtype == torch.int32
        for k in w0:
            a, b = np.asarray(jw[k]), tw[k].numpy()
            if "quant" in kw:
                np.testing.assert_array_equal(a * 16, b * 16)     # grid codes
            else:
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
        if "quant" in kw:
            for k in shapes:
                np.testing.assert_allclose(np.asarray(js["acc"][k]), ts["acc"][k].numpy(),
                                           atol=1e-6)
    np.testing.assert_array_equal(np.asarray(jw["b_fb"]), tw["b_fb"].numpy())


def test_stochastic_commits_are_unbiased():
    """Stochastic END_B commits land on the two neighbouring grid points and
    their mean is the float update (as ``tests/test_quant.py`` holds the
    JAX optimizer); the residual reconciles each commit exactly."""
    quant = EpropSGD(EpropSGDConfig(lr=0.1, quant=WEIGHT_SPEC, stochastic_round=True))
    flt = EpropSGD(EpropSGDConfig(lr=0.1))
    w = {"w_in": torch.zeros(256)}
    dw = {"w_in": torch.full((256,), 0.3 * WEIGHT_SPEC.lsb / 0.1)}
    f_w, _ = flt.update(w, dw, flt.init(w), num_updates=2.0)
    target = float(f_w["w_in"][0])                      # -0.3 lsb
    commits = []
    for seed in range(64):
        gen = torch.Generator().manual_seed(seed)
        q_w, q_state = quant.update(w, dw, quant.init(w), gen, num_updates=2.0)
        vals = q_w["w_in"].numpy()
        assert set(np.unique(vals)) <= {0.0, -WEIGHT_SPEC.lsb}
        commits.append(vals.mean())
        np.testing.assert_allclose(vals + q_state["acc"]["w_in"].numpy(), target,
                                   rtol=1e-5)
    assert abs(np.mean(commits) - target) < 0.03 * WEIGHT_SPEC.lsb
    with pytest.raises(ValueError, match="Generator"):
        quant.update(w, dw, quant.init(w))


def test_quant_state_and_stochastic_rounding():
    spec = QuantSpec(8, 4)
    gen = torch.Generator().manual_seed(0)
    x = torch.full((20000,), 0.3 * spec.lsb)
    r = spec.round_stochastic(x, gen)
    assert set(torch.unique(r).tolist()) <= {0.0, spec.lsb}
    assert abs(float(r.mean()) - 0.3 * spec.lsb) < 0.02 * spec.lsb
    s = QuantState.init({"a": torch.tensor([0.51, -0.02])})
    s = QuantState.accumulate(s, {"a": torch.tensor([0.03, 0.0])})
    s = QuantState.commit(s)
    np.testing.assert_allclose((s["q"]["a"] + s["acc"]["a"]).numpy(), [0.53, 0.0], atol=1e-6)
    assert torch.equal(s["q"]["a"], spec.round_nearest(s["q"]["a"]))
    ste = torch.tensor([0.33], requires_grad=True)
    spec.ste(ste).sum().backward()
    assert float(ste.grad) == 1.0


# --------------------------------------------------------------------------
# datasets, pipelines, controller
# --------------------------------------------------------------------------


def test_cue_dataset_byte_identical_to_jax():
    from repro.data.cue import CueConfig as JCue
    from repro.data.cue import make_cue_dataset as jmake
    from repro_torch.data.cue import CueConfig, make_cue_dataset

    for seed in (0, 3):
        a = jmake(6, 4, 2, cfg=JCue(seed=seed))
        b = make_cue_dataset(6, 4, 2, cfg=CueConfig(seed=seed))
        assert set(a) == set(b)
        for split in a:
            assert a[split]["events"].dtype == b[split]["events"].dtype == np.uint32
            np.testing.assert_array_equal(a[split]["events"], b[split]["events"])
            assert a[split]["event_density"] == b[split]["event_density"]
            assert a[split]["num_ticks"] == b[split]["num_ticks"]


@pytest.mark.parametrize("mode", ["resident", "arm"])
@pytest.mark.parametrize("label_delay", [0, 3])
def test_pipelines_give_jax_batches(mode, label_delay):
    from repro.data.braille import BrailleConfig as JBC
    from repro.data.braille import make_braille_dataset as jmake
    from repro.data.pipeline import make_pipeline as jpipe
    from repro_torch.data.braille import BrailleConfig, make_braille_dataset
    from repro_torch.data.pipeline import make_pipeline

    jdata = jmake("AEU", JBC(num_ticks=24, samples_per_class=5))
    tdata = make_braille_dataset("AEU", BrailleConfig(num_ticks=24, samples_per_class=5))
    kw = dict(samples_per_batch=4) if mode == "arm" else {}
    jp = jpipe(mode, jdata, label_delay=label_delay, **kw)
    tp = make_pipeline(mode, tdata, label_delay=label_delay, device="cpu", **kw)
    for split in ("train", "val", "test"):
        jb, tb = list(jp.batches(split, 0)), list(tp.batches(split, 0))
        assert len(jb) == len(tb) > 0
        for a, b in zip(jb, tb):
            for k in ("raster", "label", "valid"):
                np.testing.assert_array_equal(np.asarray(a[k]), b[k].numpy())
    if mode == "arm":
        skipped = list(tp.batches("train", 0, start_batch=1))
        assert len(skipped) == len(list(tp.batches("train", 0))) - 1
        assert tp.stats.transfers > 0


def test_learner_needs_the_card(monkeypatch):
    from repro_torch.core.controller import ControllerConfig, OnlineLearner

    cfg = Presets.braille(num_ticks=8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        OnlineLearner(cfg, ControllerConfig(), EpropSGDConfig(), 0)


def test_batch_commit_learns_cue_task():
    """END_B training learns the cue task on the CPU plain path (the JAX
    package's ``test_batch_commit_learns_cue_task``), and the learner's
    weights serve through ``BatchedEngine.from_learner`` on its own backend
    with the predictions of the one-sample inference oracle."""
    from repro_torch.core.controller import ControllerConfig, OnlineLearner, make_infer_fn
    from repro_torch.data.cue import CueConfig, make_cue_dataset
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.serve import BatchedEngine
    from repro_torch.serve.batching import decode_events_host, trim_padding

    ccfg = CueConfig(seed=3)
    data = make_cue_dataset(30, 20, 6, cfg=ccfg)
    cfg = Presets.cue_accumulation(num_ticks=ccfg.num_ticks)
    pipe = make_pipeline("arm", data, samples_per_batch=10, device="cpu")
    ops.reset_launch_counts()
    learner = OnlineLearner(cfg, ControllerConfig(num_epochs=12, commit="batch"),
                            EpropSGDConfig(lr=0.01, clip=10.0), 0, device="cpu")
    log = learner.fit(pipe)
    assert max(log.val_acc) >= 0.8
    assert all(n == 0 for n in ops.launches.values())     # plain path only
    eng = BatchedEngine.from_learner(learner, max_batch=8)
    assert eng.engine is learner.backend
    reqs = [trim_padding(r) for r in data["test"]["events"]]
    res, _ = eng.serve(iter(reqs))
    infer = make_infer_fn(cfg)
    for r, ev in zip(res, reqs):
        raster, valid, _ = decode_events_host([ev], cfg.n_in, r.bucket_ticks,
                                              cfg.label_delay)
        o = infer(trainable(learner.weights), torch.from_numpy(raster[:, 0]),
                  torch.from_numpy(valid[:, 0]))
        np.testing.assert_allclose(r.logits, o["acc_y"].numpy(), **FLOAT_TOL)
        assert r.pred == int(o["pred"])


def test_end_s_and_end_b_learners_on_quantized_braille():
    """A reduced quantized Braille run through both commit modes: weights
    stay on the 8-bit SRAM grid, the sample counter advances per sample in
    both modes, and END_S commits once per sample."""
    from repro_torch.configs.reckon_braille import QUANT_OPT
    from repro_torch.core.controller import ControllerConfig, OnlineLearner
    from repro_torch.data.braille import BrailleConfig, make_braille_dataset
    from repro_torch.data.pipeline import make_pipeline

    data = make_braille_dataset("AEU", BrailleConfig(num_ticks=24, samples_per_class=6))
    cfg = Presets.braille(num_ticks=24, quantized=True)
    pipe = make_pipeline("arm", data, samples_per_batch=6, device="cpu")
    n_train = data["train"]["events"].shape[0]
    for commit in ("batch", "sample"):
        learner = OnlineLearner(cfg, ControllerConfig(num_epochs=2, commit=commit),
                                QUANT_OPT, torch.Generator().manual_seed(4), device="cpu")
        log = learner.fit(pipe)
        assert len(log.train_acc) == len(log.val_acc) == 2
        assert int(learner.opt_state["count"]) == 2 * n_train
        for k, v in trainable(learner.weights).items():
            assert torch.equal(v, WEIGHT_SPEC.round_nearest(v)), k
        assert 0.0 <= learner.eval_epoch(pipe, 0, "test") <= 1.0
