"""e-prop under ``cfg.neuron.surrogate`` (the boxcar or Bellec's triangular
pseudo-derivative) through the port's backend, against the JAX package's
scan backend, which follows the surrogate in both e-prop modes
(``repro/core/eprop.py``: ``pseudo_derivative`` in the exact and the
factored tick).

On the CPU the port's ``train_tile`` runs ``rsnn_train``'s and
``rsnn_train_exact``'s plain versions, ``forward_traces`` runs
``rsnn_forward``'s; the card runs the kernels (``tests/test_torch_cuda.py``).
The reduced Braille config (12/16/3, T=32) of ``tests/test_torch_exact.py``,
its inputs and weights made with numpy from a seed.

Tolerances, stated once (``tests/test_torch_exact.py``'s): ``dw`` within
``rtol = atol = DW_TOL`` (2e-4), ``pred`` equal, ``acc_y`` within 1e-4
(bitwise when quantized), weights after the optimizer within ``DW_TOL``.
The triangular ``h`` of ``forward_traces`` is bitwise the reference's in
quantized mode: the compiled scan multiplies by ``f32(1/v_th)`` and rounds
``1 - d * r`` once (a fused multiply-add), and so does the port
(``kernels/rsnn_step.py:pseudo_h``); in float mode the membranes round
apart already (XLA fuses the leak's multiply-add), so ``h`` is held within
1e-5.
"""

import dataclasses
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_exact as ex
from repro.core.backend import ExecutionBackend as JaxBackend
from repro.core.backend import RuntimeConfig as JaxRuntime
from repro.core.controller import make_batch_commit_train_fn as jax_end_b
from repro.core.controller import make_train_batch_fn as jax_end_s
from repro.core.neuron import pseudo_derivative as jax_pseudo_derivative
from repro.core.quant import DW_COMMIT_SPEC as JAX_GRID
from repro.optim.eprop_opt import EpropSGD as JaxSGD
from repro.optim.eprop_opt import EpropSGDConfig as JaxSGDConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.backend import ExecutionBackend
from repro_torch.core.controller import make_batch_commit_train_fn, make_train_batch_fn
from repro_torch.core.quant import DW_COMMIT_SPEC
from repro_torch.kernels import ops
from repro_torch.kernels.eprop_update import dw_codes
from repro_torch.kernels.rsnn_step import inv_threshold, pseudo_h
from repro_torch.optim.eprop_opt import EpropSGD, EpropSGDConfig

DW_TOL = ex.DW_TOL
H_FLOAT_TOL = 1e-5

# name: the NeuronConfig fields that set the surrogate
SURROGATES = {
    "triangular": dict(surrogate="triangular"),
    "triangular_g05": dict(surrogate="triangular", gamma=0.5),
    "boxcar_w025": dict(surrogate="boxcar", boxcar_width=0.25),
}


def _cfgs(quantized, reset, surrogate, mode="factored", feedback="symmetric"):
    """``test_torch_exact``'s reduced Braille pair under ``surrogate`` (a
    key of :data:`SURROGATES`, or a surrogate name)."""
    fields = SURROGATES.get(surrogate, dict(surrogate=surrogate))
    return [dataclasses.replace(c, neuron=dataclasses.replace(c.neuron, **fields))
            for c in ex._cfgs(quantized, reset, feedback, "softmax", mode)]


# (mode, quantized, reset, B) under every surrogate: each value of each
# setting at least four times, each pair of two settings' values at least
# once.
TILE_CASES = [
    ("factored", True, "sub", 1),
    ("factored", True, "zero", 6),
    ("factored", False, "sub", 6),
    ("factored", False, "zero", 1),
    ("exact", True, "zero", 1),
    ("exact", True, "sub", 6),
    ("exact", False, "zero", 6),
    ("exact", False, "sub", 1),
]


@pytest.mark.parametrize("surrogate", list(SURROGATES))
@pytest.mark.parametrize("mode,quantized,reset,B", TILE_CASES)
def test_train_tile_follows_the_surrogate(mode, quantized, reset, B, surrogate):
    """``train_tile`` in both e-prop modes gives the JAX scan backend's
    ``dw`` and metrics under each surrogate, and another ``dw`` than the
    default boxcar would: the surrogate reaches the rule."""
    rng = np.random.default_rng(200 + TILE_CASES.index((mode, quantized, reset, B)))
    jcfg, tcfg = _cfgs(quantized, reset, surrogate, mode)
    w = ex._weights(rng, tcfg, quantized)
    tile = ex._tile(rng, tcfg, B)
    want = ex._jax_train(jcfg, w, tile)
    ex._hold(want, ex._port_train(tcfg, w, tile), quantized)
    _, boxcar = _cfgs(quantized, reset, "boxcar", mode)
    other, _ = ex._port_train(boxcar, w, tile)
    assert max(np.abs(other[k] - want[0][k]).max() for k in other) > 100 * DW_TOL


@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("reset", ["sub", "zero"])
def test_forward_traces_h_follows_the_surrogate(quantized, reset):
    """``forward_traces``' triangular ``h`` is the JAX scan backend's:
    bitwise in quantized mode, within ``H_FLOAT_TOL`` in float mode; the
    other traces as ``tests/test_torch_train.py`` holds them."""
    rng = np.random.default_rng(220 + 2 * quantized + (reset == "sub"))
    jcfg, tcfg = _cfgs(quantized, reset, "triangular")
    w = ex._weights(rng, tcfg, quantized)
    tile = ex._tile(rng, tcfg, 6)
    jb = JaxBackend(jcfg, runtime=JaxRuntime(backend="scan"))
    want = jb.forward_traces({k: jnp.asarray(v) for k, v in w.items()},
                             *(jnp.asarray(x) for x in tile))
    tb = ExecutionBackend(tcfg, device="cpu")
    got = tb.forward_traces(params_from_jax(w, device="cpu"),
                            *(torch.from_numpy(x) for x in tile))
    h, jh = got["h"].numpy(), np.asarray(want["h"])
    assert np.count_nonzero(jh) > 0 and np.any((jh > 0) & (jh < jcfg.neuron.gamma))
    if quantized:
        np.testing.assert_array_equal(h, jh)
    else:
        np.testing.assert_allclose(h, jh, rtol=0, atol=H_FLOAT_TOL)
    for k in ("xbar", "pbar", "zbar"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def _f32_round(x: Fraction) -> np.float32:
    """``x`` rounded once to the nearest f32 (ties to even)."""
    near = np.float32(float(x))
    lo, hi = sorted((near, np.nextafter(near, np.float32(np.inf) if Fraction(float(near)) < x
                                        else np.float32(-np.inf))))
    dlo, dhi = abs(x - Fraction(float(lo))), abs(x - Fraction(float(hi)))
    if dlo != dhi:
        return lo if dlo < dhi else hi
    return lo if (lo.view(np.int32) & 1) == 0 else hi


def test_pseudo_h_is_the_compiled_reference_on_the_membrane_grid():
    """Over the whole quantized membrane grid (-4096..4095 around the
    1,008 register) ``pseudo_h``'s triangular form is ``gamma * max(0,
    fma(-d, r, 1))`` rounded once exactly, and bitwise the reference's
    ``pseudo_derivative`` under ``jax.jit``; the reference's eager form
    (a true division) differs at some membranes."""
    _, tcfg = _cfgs(True, "sub", "triangular")
    jcfg, _ = _cfgs(True, "sub", "triangular")
    ncfg = tcfg.neuron
    v_th = ncfg.effective_v_th()
    grid = np.arange(-4096, 4096, dtype=np.float32)
    got = pseudo_h(torch.from_numpy(grid), v_th, surrogate="triangular",
                   gamma=ncfg.gamma).numpy()
    r, g = Fraction(inv_threshold(v_th)), np.float32(ncfg.gamma)
    fused = np.array([_f32_round(1 - Fraction(abs(int(v) - int(v_th))) * r) for v in grid],
                     dtype=np.float32)
    np.testing.assert_array_equal(got, g * np.maximum(np.float32(0), fused))
    jitted = jax.jit(lambda v: jax_pseudo_derivative(v, jcfg.neuron))(jnp.asarray(grid))
    np.testing.assert_array_equal(got, np.asarray(jitted))
    eager = (g * np.maximum(np.float32(0), np.float32(1) - np.abs(grid - np.float32(v_th))
                            / np.float32(v_th))).astype(np.float32)
    assert np.any(eager != got)


@pytest.mark.parametrize("mode", ["factored", "exact"])
def test_commit_grid_codes_under_the_triangular_surrogate(mode):
    """On the integer commit grid under the triangular surrogate, each
    side's codes are its own per-sample ``dw`` snapped and summed, bitwise,
    and the two sides' per-sample ``dw`` agree within ``DW_TOL``; a code
    differs only where the two values straddle a half step within that
    tolerance (as ``test_commit_grid_codes_match_jax_train_det``)."""
    rng = np.random.default_rng(230 + (mode == "exact"))
    jcfg, tcfg = _cfgs(True, "zero", "triangular", mode)
    w = ex._weights(rng, tcfg, True)
    B = 5
    tile = ex._tile(rng, tcfg, B)
    jdw, jm = ex._jax_train(jcfg, w, tile, commit_grid=JAX_GRID)
    tdw, tm = ex._port_train(tcfg, w, tile, commit_grid=DW_COMMIT_SPEC)
    np.testing.assert_array_equal(tm["pred"], jm["pred"])
    np.testing.assert_array_equal(tm["acc_y"], jm["acc_y"])
    lsb = DW_COMMIT_SPEC.lsb
    raster, y_star, valid = tile
    rows = [(raster[:, b: b + 1], y_star[b: b + 1], valid[:, b: b + 1]) for b in range(B)]
    per_j = [ex._jax_train(jcfg, w, r)[0] for r in rows]
    per_t = [ex._port_train(tcfg, w, r)[0] for r in rows]
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
            half = np.floor(np.minimum(a, b)[apart]) + 0.5
            tol = (DW_TOL * np.maximum(np.abs(pj[k][apart]), 1.0)) / lsb
            assert np.all(np.abs(a[apart] - half) <= tol) and np.all(np.abs(b[apart] - half) <= tol), k
    assert flips <= 0.02 * B * sum(v.size for v in jdw.values()), flips


@pytest.mark.parametrize("mode", ["factored", "exact"])
def test_controller_end_s_and_end_b_under_the_triangular_surrogate(mode):
    """Five END_S commits and one END_B commit of the port's controller
    under the triangular surrogate, from the same weights, give the JAX
    controller's weights within ``DW_TOL`` (float SGD, lr 0.02, clip 10)."""
    rng = np.random.default_rng(240 + (mode == "exact"))
    jcfg, tcfg = _cfgs(False, "sub", "triangular", mode, feedback="random")
    w = ex._weights(rng, tcfg, False)
    batch = ex._learner_batch(rng, tcfg, 5)
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


@pytest.mark.parametrize("mode", ["factored", "exact"])
def test_unknown_surrogate_raises_in_both_packages(mode):
    """A surrogate neither package computes raises ``ValueError`` in the
    JAX ``train_tile`` and in the port's ``train_tile`` and
    ``forward_traces``, and the three ``ops`` entry points raise it before
    they run anything."""
    rng = np.random.default_rng(250)
    jcfg, tcfg = _cfgs(True, "sub", "sigmoid", mode)
    w = ex._weights(rng, tcfg, True)
    tile = ex._tile(rng, tcfg, 2)
    with pytest.raises(ValueError, match="surrogate"):
        ex._jax_train(jcfg, w, tile)
    with pytest.raises(ValueError, match="surrogate"):
        ex._port_train(tcfg, w, tile)
    be = ExecutionBackend(tcfg, device="cpu")
    weights = params_from_jax(w, device="cpu")
    raster, y_star, valid = (torch.from_numpy(x) for x in tile)
    with pytest.raises(ValueError, match="surrogate"):
        be.forward_traces(weights, raster, y_star, valid)
    kw = dict(be._trace_kw(), alpha=be.alpha)
    wd = be.datapath_weights(weights)
    with pytest.raises(ValueError, match="surrogate"):
        ops.rsnn_forward(raster, *wd, **kw)
    for op in (ops.rsnn_train, ops.rsnn_train_exact):
        with pytest.raises(ValueError, match="surrogate"):
            op(raster, y_star, valid, *wd, be._feedback(weights), **kw)
