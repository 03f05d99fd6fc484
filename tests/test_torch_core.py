"""The port's core modules against the JAX package: AER codec, fixed-point
numerics, neuron steps, configs, parameter conversion and the plain
inference loops.  Inputs are made with numpy from a seed and handed to
both packages; quantized results are held bitwise, float results to
``atol = rtol = 1e-5`` (elementwise float32 ops, no reductions) or
``1e-4`` where a matmul's reduction order differs between XLA and PyTorch.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aer as jaer
from repro.core import eprop as jeprop
from repro.core import neuron as jneuron
from repro.core.quant import QuantizedMode as JaxQuant
from repro.core.rsnn import Presets as JaxPresets
from repro_torch.configs import reckon_braille
from repro_torch.convert import params_from_jax
from repro_torch.core import aer, eprop, neuron
from repro_torch.core.quant import MEMBRANE_SPEC, WEIGHT_SPEC, QuantizedMode
from repro_torch.core.rsnn import Presets, RSNNConfig, init_params, param_count


def _raster(rng, T, N, density=0.3):
    return (rng.random((T, N)) < density).astype(np.float32)


@pytest.mark.parametrize("T,N,label,label_tick", [
    (32, 12, 2, 5), (256, 12, 0, 76), (1, 1, 4095, 0), (17, 256, 15, 16),
])
def test_encode_sample_words_byte_identical(T, N, label, label_tick):
    raster = _raster(np.random.default_rng(T * N), T, N)
    a = aer.encode_sample(raster, label, label_tick)
    b = jaer.encode_sample(raster, label, label_tick)
    assert a.dtype == b.dtype == np.uint32
    assert a.tobytes() == b.tobytes()


def test_encode_sample_rejects_out_of_range_fields():
    raster = np.zeros((4, 3), np.float32)
    for kw in (dict(label=4096, label_tick=0), dict(label=0, label_tick=4096),
               dict(label=0, label_tick=0, end_tick=-1)):
        with pytest.raises(aer.AEREncodingError):
            aer.encode_sample(raster, **kw)


def test_decode_and_masks_match_jax():
    rng = np.random.default_rng(3)
    raster = _raster(rng, 20, 12)
    words = aer.encode_sample(raster, 2, 6, end_tick=17)
    padded = aer.pad_events([words, words[:5]], len(words) + 3)
    np.testing.assert_array_equal(padded, jaer.pad_events([words, words[:5]],
                                                           len(words) + 3))
    s = aer.decode_sample(padded[0], 12, 20)
    j = jaer.decode_sample(jnp.asarray(padded[0]), 12, 20)
    np.testing.assert_array_equal(s.raster.numpy(), np.asarray(j.raster))
    for f in ("label", "label_tick", "end_tick"):
        assert int(getattr(s, f)) == int(getattr(j, f))
    m = aer.supervision_mask(s.label_tick, s.end_tick, 20, label_delay=2)
    jm = jaer.supervision_mask(j.label_tick, j.end_tick, 20, label_delay=2)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    k, a, t = aer.unpack(aer.pack([3, 2, 1], [7, 4095, 0], [4095, 9, 3]))
    jk, ja, jt = jaer.unpack(jaer.pack(jnp.array([3, 2, 1]),
                                       jnp.array([7, 4095, 0]),
                                       jnp.array([4095, 9, 3])))
    for x, y in ((k, jk), (a, ja), (t, jt)):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_quantized_mode_contract_round_trips():
    q = QuantizedMode(threshold=0x0100, alpha_reg=0x1F0, kappa_reg=0xC8)
    d = q.contract()
    assert d == JaxQuant(threshold=0x0100, alpha_reg=0x1F0,
                         kappa_reg=0xC8).contract()
    assert QuantizedMode.from_contract(d) == q
    assert QuantizedMode.from_contract(QuantizedMode().contract()) == QuantizedMode()
    with pytest.raises(ValueError):
        QuantizedMode(threshold=0x03F1)          # not on the weight grid
    with pytest.raises(ValueError):
        QuantizedMode(threshold=4096)            # off the 12-bit grid
    assert MEMBRANE_SPEC.bits == 12 and WEIGHT_SPEC.frac == 4


@pytest.mark.parametrize("reg", [0x0FE, 0x37, 0xC8, 0x1FF])
def test_leak_sat_to_membrane_match_jax_elementwise(reg):
    q, jq = QuantizedMode(), JaxQuant()
    rng = np.random.default_rng(reg)
    # negative floors, saturation edges and out-of-grid values
    v = np.concatenate([np.arange(-2100, 2100, 7), [-2049, -2048, 2047, 2048,
                                                   -1, -3, 5000, -5000]])
    v = v.astype(np.float32)
    np.testing.assert_array_equal(q.leak(torch.from_numpy(v), reg).numpy(),
                                  np.asarray(jq.leak(jnp.asarray(v), reg)))
    np.testing.assert_array_equal(q.sat(torch.from_numpy(v)).numpy(),
                                  np.asarray(jq.sat(jnp.asarray(v))))
    # half-way weights round to even on both sides
    w = np.concatenate([rng.normal(size=200) * 3,
                        (np.arange(-20, 20) + 0.5) / 16]).astype(np.float32)
    np.testing.assert_array_equal(q.to_membrane(torch.from_numpy(w)).numpy(),
                                  np.asarray(jq.to_membrane(jnp.asarray(w))))
    np.testing.assert_array_equal(
        WEIGHT_SPEC.round_nearest(torch.from_numpy(w)).numpy(),
        np.asarray(jq.weight_spec.round_nearest(jnp.asarray(w))))
    assert q.w_gain == jq.w_gain == 63


@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("reset", ["sub", "zero"])
def test_lif_and_li_steps_match_jax(quantized, reset):
    q = QuantizedMode() if quantized else None
    jq = JaxQuant() if quantized else None
    cfg = neuron.NeuronConfig(reset=reset, quant=q)
    jcfg = jneuron.NeuronConfig(reset=reset, quant=jq)
    rng = np.random.default_rng(1)
    scale = 1500.0 if quantized else 1.0
    v = np.round(rng.normal(size=(4, 38)) * scale).astype(np.float32)
    cur = np.round(rng.normal(size=(4, 38)) * scale).astype(np.float32)
    out = neuron.lif_step(torch.from_numpy(v), torch.from_numpy(cur), cfg.alpha, cfg)
    jout = jneuron.lif_step(jnp.asarray(v), jnp.asarray(cur), jcfg.alpha, jcfg)
    for a, b in zip(out, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    h = neuron.pseudo_derivative(out[2], cfg)
    np.testing.assert_array_equal(h.numpy(), np.asarray(
        jneuron.pseudo_derivative(jout[2], jcfg)))
    y = neuron.li_step(torch.from_numpy(v), torch.from_numpy(cur), cfg.kappa, cfg)
    jy = jneuron.li_step(jnp.asarray(v), jnp.asarray(cur), jcfg.kappa, jcfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-6, atol=1e-6)


def test_configs_mirror_jax_presets():
    for quantized in (False, True):
        t, j = Presets.braille(quantized=quantized), JaxPresets.braille(quantized=quantized)
        assert (t.n_in, t.n_hid, t.n_out, t.num_ticks) == (j.n_in, j.n_hid, j.n_out,
                                                          j.num_ticks)
        assert t.neuron.reset == j.neuron.reset and t.neuron.kappa == j.neuron.kappa
        if quantized:
            assert t.neuron.quant.contract() == j.neuron.quant.contract()
    assert reckon_braille.CONFIG_QUANT.neuron.quant == reckon_braille.SPI_REGS
    assert reckon_braille.config_for(4).n_out == 4
    assert reckon_braille.reduced().n_hid == 16
    assert Presets.cue_accumulation().n_in == 40
    with pytest.raises(ValueError):
        RSNNConfig(n_in=257)
    with pytest.raises(ValueError):
        RSNNConfig(num_ticks=4097)


def test_init_params_seeded_by_generator():
    cfg = Presets.braille(eprop=dataclasses.replace(
        Presets.braille().eprop, feedback="random"))
    a = init_params(torch.Generator().manual_seed(5), cfg, device="cpu")
    b = init_params(torch.Generator().manual_seed(5), cfg, device="cpu")
    c = init_params(torch.Generator().manual_seed(6), cfg, device="cpu")
    assert set(a) == {"w_in", "w_rec", "w_out", "alpha", "b_fb"}
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["w_in"], c["w_in"])
    assert a["w_rec"].shape == (38, 38) and float(a["alpha"]) == cfg.neuron.alpha
    assert param_count(cfg) == 12 * 38 + 38 * 38 + 38 * 3


def test_params_from_jax_copies_every_key():
    rng = np.random.default_rng(0)
    p = {"w_in": rng.normal(size=(3, 4)), "w_rec": rng.normal(size=(4, 4)),
         "w_out": rng.normal(size=(4, 2)), "alpha": np.float32(0.9)}
    t = params_from_jax(p, device="cpu")
    for k, v in p.items():
        assert t[k].dtype == torch.float32
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(v, np.float32))
    with pytest.raises(ValueError):
        params_from_jax({"w_bogus": np.zeros(2)}, device="cpu")


@pytest.mark.parametrize("quantized", [True, False])
def test_plain_inference_loops_match_jax_scan(quantized):
    T, B = 24, 5
    rng = np.random.default_rng(8)
    jcfg = JaxPresets.braille(num_ticks=T, quantized=quantized)
    tcfg = Presets.braille(num_ticks=T, quantized=quantized)
    w = {"w_in": 2.5 * rng.normal(size=(12, 38)) / np.sqrt(12),
         "w_rec": 2.5 * rng.normal(size=(38, 38)) / np.sqrt(38),
         "w_out": 2.5 * rng.normal(size=(38, 3)) / np.sqrt(38),
         "alpha": np.float32(tcfg.neuron.alpha)}
    w = {k: np.asarray(v, np.float32) for k, v in w.items()}
    raster = (rng.random((T, B, 12)) < 0.3).astype(np.float32)
    valid = (rng.random((T, B)) < 0.7).astype(np.float32)
    live = np.ones((T, B), np.float32)
    live[10:, 1] = 0.0
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    tw = params_from_jax(w, device="cpu")
    chk = ((lambda a, b: np.testing.assert_array_equal(a, b)) if quantized else
           (lambda a, b: np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)))

    j = jeprop.run_sample_inference(jw, jnp.asarray(raster), jnp.asarray(valid),
                                    jcfg.neuron, jcfg.eprop)
    t = eprop.run_sample_inference(tw, torch.from_numpy(raster),
                                   torch.from_numpy(valid), tcfg.neuron, tcfg.eprop)
    chk(np.asarray(j["acc_y"]), t["acc_y"].numpy())
    np.testing.assert_allclose(float(j["spike_rate"]), float(t["spike_rate"]),
                               rtol=1e-6)

    state = {"v": np.zeros((B, 38), np.float32), "z": np.zeros((B, 38), np.float32),
             "y": np.zeros((B, 3), np.float32), "acc_y": np.zeros((B, 3), np.float32),
             "n_spk": np.zeros((B, 1), np.float32)}
    j = jeprop.run_stream_inference(
        jw, jnp.asarray(raster), jnp.asarray(live), jnp.asarray(valid * live),
        {k: jnp.asarray(v) for k, v in state.items()}, jcfg.neuron, jcfg.eprop)
    t = eprop.run_stream_inference(
        tw, torch.from_numpy(raster), torch.from_numpy(live),
        torch.from_numpy(valid * live), {k: torch.from_numpy(v) for k, v in state.items()},
        tcfg.neuron, tcfg.eprop)
    for k in state:
        chk(np.asarray(j[k]), t[k].numpy())
