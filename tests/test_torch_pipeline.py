"""The port's learning-while-serving feed against the JAX package, on the CPU.

``EventStream`` must hand out the same buffers, byte for byte and in the
same order, as ``repro.data.pipeline.EventStream`` (``repeat``,
``shuffle``, the ``state`` / ``seek`` cursor, the guard's ``raise`` and
``skip`` policies); ``interleave_train_serve`` must yield the same item
kinds in the same order, its training batches equal and its requests
byte-identical.  An ``OnlineLearner`` attached to a ``ModelRegistry``
shares its backend with the registry's engines and publishes every commit;
started from the JAX learner's weights (carried across by
``params_from_jax``) and fed the same batches, its published images and
served logits stay within ``1e-4`` of the JAX learner's (float mode, END_B
commits).  The SPI register decode ``from_reckon_regs`` is exact.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import aer as jaer
from repro.core.controller import ControllerConfig as JaxCtrl
from repro.core.controller import OnlineLearner as JaxLearner
from repro.core.quant import from_reckon_regs as jax_regs
from repro.core.rsnn import Presets as JaxPresets
from repro.data import pipeline as jpipe
from repro.data.braille import BrailleConfig, make_braille_dataset
from repro.optim.eprop_opt import EpropSGDConfig as JaxOptCfg
from repro.serve import BatchedEngine as JaxEngine
from repro.serve import GuardConfig as JaxGuard
from repro.serve import GuardError as JaxGuardError
from repro.serve import ModelRegistry as JaxRegistry
from repro_torch.convert import params_from_jax
from repro_torch.core.controller import ControllerConfig, OnlineLearner
from repro_torch.core.quant import ReckonRegs, from_reckon_regs
from repro_torch.core.rsnn import Presets
from repro_torch.data import pipeline as tpipe
from repro_torch.optim.eprop_opt import EpropSGDConfig
from repro_torch.serve import BatchedEngine, GuardConfig, GuardError, ModelRegistry

FLOAT_TOL = dict(atol=1e-4, rtol=1e-4)


def _data(T=32, per_class=6):
    return make_braille_dataset("AEU", BrailleConfig(num_ticks=T, samples_per_class=per_class))


def _tiny_split(n_in=4):
    spike = (jaer.EVT_SPIKE << 24) | (1 << 12) | 2
    end = (jaer.EVT_END << 24) | 3
    good = np.array([spike, end, 0, 0], np.uint32)
    bad = np.array([0x7F000000, end, 0, 0], np.uint32)
    return {"test": {"events": np.stack([good, bad, good]), "n_in": n_in,
                     "num_ticks": 8}}


def _same_buffers(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype == np.uint32
        assert x.tobytes() == y.tobytes()


# --------------------------------------------------------------------------
# EventStream
# --------------------------------------------------------------------------


@pytest.mark.parametrize("repeat,shuffle,seed", [(1, False, 0), (2, True, 5),
                                                 (3, True, 0), (2, False, 7)])
def test_event_stream_buffers_byte_identical(repeat, shuffle, seed):
    data = _data(per_class=20)
    kw = dict(repeat=repeat, shuffle=shuffle, seed=seed)
    j = jpipe.EventStream(data, "test", **kw)
    t = tpipe.EventStream(data, "test", **kw)
    assert len(t) == len(j) == data["test"]["events"].shape[0] * repeat
    _same_buffers(list(j), list(t))
    assert t.state() == j.state()
    assert list(t) == []          # drained until reset
    t.reset()
    assert len(list(t)) == len(j)


def test_event_stream_cursor_roundtrip_and_seed_mismatch():
    data = _data(per_class=20)
    kw = dict(repeat=2, shuffle=True, seed=5)
    states = []
    for pkg in (jpipe, tpipe):
        s1 = pkg.EventStream(data, "test", **kw)
        it = iter(s1)
        consumed = [next(it) for _ in range(7)]
        assert len(consumed) == 7
        state = s1.state()
        states.append(state)
        s2 = pkg.EventStream(data, "test", **kw)
        s2.seek(state)
        replayed, original = list(s2), list(it)
        assert len(replayed) == len(original) == len(s1) - 7
        _same_buffers(original, replayed)
        with pytest.raises(ValueError, match="seed"):
            pkg.EventStream(data, "test", seed=6).seek(state)
    assert states[0] == states[1]
    # a cursor taken on one package's stream resumes the other's alike
    j = jpipe.EventStream(data, "test", **kw)
    t = tpipe.EventStream(data, "test", **kw)
    j.seek(states[0])
    t.seek(states[0])
    _same_buffers(list(j), list(t))


@pytest.mark.parametrize("policy", [None, "skip", "raise"])
def test_event_stream_guard_policies(policy):
    def drain(pkg, guard_cls, err):
        kw = {} if policy is None else dict(guard=guard_cls(n_in=4), on_invalid=policy)
        s = pkg.EventStream(_tiny_split(), **kw)
        got, raised = [], 0
        while True:
            try:
                for buf in s:
                    got.append(buf)
                break
            except err:
                raised += 1   # the cursor is past the bad sample already
        return got, raised, s.invalid

    jgot, jraised, jinvalid = drain(jpipe, JaxGuard, JaxGuardError)
    tgot, traised, tinvalid = drain(tpipe, GuardConfig, GuardError)
    _same_buffers(jgot, tgot)
    assert (traised, tinvalid) == (jraised, jinvalid)
    want = {None: (3, 0, 0), "skip": (2, 0, 1), "raise": (2, 1, 1)}[policy]
    assert (len(tgot), traised, tinvalid) == want


def test_event_stream_rejects_unknown_split_and_policy():
    data = _data()
    with pytest.raises(KeyError):
        tpipe.EventStream(data, "nope")
    with pytest.raises(ValueError, match="on_invalid"):
        tpipe.EventStream(data, on_invalid="ignore")


# --------------------------------------------------------------------------
# interleave_train_serve
# --------------------------------------------------------------------------


@pytest.mark.parametrize("serve_per_batch", [0, 3, 8, 100])
def test_interleave_yields_the_same_items_in_the_same_order(serve_per_batch):
    data = _data(per_class=20)
    jitems = list(jpipe.interleave_train_serve(
        jpipe.make_pipeline("arm", data, 8), jpipe.EventStream(data, "test"),
        serve_per_batch=serve_per_batch))
    titems = list(tpipe.interleave_train_serve(
        tpipe.make_pipeline("arm", data, 8, device="cpu"),
        tpipe.EventStream(data, "test"), serve_per_batch=serve_per_batch))
    assert [k for k, _ in titems] == [k for k, _ in jitems]
    for (kind, j), (_, t) in zip(jitems, titems):
        if kind == "serve":
            assert j.tobytes() == t.tobytes()
        else:
            for key in ("raster", "label", "valid"):
                np.testing.assert_array_equal(t[key].numpy(), np.asarray(j[key]))


def _twin_learners(data, T, **kw):
    """A JAX learner and a port learner on the same initial weights."""
    jcfg = JaxPresets.braille(n_classes=3, num_ticks=T)
    tcfg = Presets.braille(n_classes=3, num_ticks=T)
    jreg = kw.pop("jreg", None)
    treg = kw.pop("treg", None)
    jl = JaxLearner(jcfg, JaxCtrl(num_epochs=1, commit="batch"),
                    JaxOptCfg(lr=0.01, clip=10.0), jax.random.key(1),
                    backend="scan", registry=jreg, **kw)
    tl = OnlineLearner(tcfg, ControllerConfig(num_epochs=1, commit="batch"),
                       EpropSGDConfig(lr=0.01, clip=10.0), 1, device="cpu",
                       registry=treg, **kw)
    tl.weights = params_from_jax({k: np.asarray(v) for k, v in jl.weights.items()},
                                 device="cpu")
    tl.opt_state = tl.opt.init(tl.weights)
    if treg is not None:
        tl.publish()
    return jl, tl


def test_interleaved_train_serve_feed():
    """The learning-while-serving loop (the JAX package's
    ``test_interleaved_train_serve_feed``): commits and requests interleave
    through one backend, every request is answered, and the answers follow
    the JAX loop's within the float tolerance."""
    data = _data()
    jl, tl = _twin_learners(data, 32)
    out = {}
    for name, learner, pkg, eng_cls, kw in (
            ("jax", jl, jpipe, JaxEngine, {}),
            ("port", tl, tpipe, BatchedEngine, dict(device="cpu"))):
        pipe = pkg.make_pipeline("arm", data, samples_per_batch=8, **kw)
        eng = eng_cls.from_learner(learner, max_batch=4, tick_granularity=32)
        assert eng.engine is learner.backend
        stream = pkg.EventStream(data, "test")
        trained, results = 0, []
        for kind, item in pkg.interleave_train_serve(pipe, stream, serve_per_batch=3):
            if kind == "train":
                m = learner.train_batch(item)
                eng.update_weights(learner.weights)
                trained += int(m["count"])
            else:
                eng.submit(item)
                for tile in eng.scheduler.ready_tiles():
                    results.extend(eng.run_tile(tile))
        for tile in eng.scheduler.drain():
            results.extend(eng.run_tile(tile))
        assert trained == data["train"]["events"].shape[0]
        assert len(results) == len(stream)
        assert all(np.isfinite(r.logits).all() for r in results)
        out[name] = results
    for j, t in zip(out["jax"], out["port"]):
        assert (t.rid, t.label, t.bucket_ticks) == (j.rid, j.label, j.bucket_ticks)
        np.testing.assert_allclose(t.logits, np.asarray(j.logits), **FLOAT_TOL)


def test_learner_publishes_into_registry():
    """An OnlineLearner attached to a registry shares its backend (pool
    adoption) and publishes its weights every commit; a registry engine
    serves the published image (the JAX package's
    ``test_learner_publishes_into_registry``)."""
    data = _data()
    jreg, treg = JaxRegistry(), ModelRegistry()
    jl, tl = _twin_learners(data, 32, jreg=jreg, treg=treg, model_id="live")
    rng = np.random.default_rng(1)
    reqs = []
    for i in range(4):
        raster = (rng.random((32, 12)) < 0.25).astype(np.float32)
        reqs.append(np.asarray(jaer.encode_sample(raster, i % 3, label_tick=8,
                                                  end_tick=31), np.uint32))
    served = {}
    for name, learner, reg, pkg, eng_cls, kw in (
            ("jax", jl, jreg, jpipe, JaxEngine, {}),
            ("port", tl, treg, tpipe, BatchedEngine, dict(device="cpu"))):
        assert "live" in reg
        spec = reg.get("live")
        assert spec.backend is learner.backend   # adopted: one backend
        w0 = np.asarray(spec.weights["w_out"]).copy()
        swaps0 = spec.swaps
        learner.train_epoch(pkg.make_pipeline("arm", data, samples_per_batch=6, **kw), 0)
        n_batches = -(-data["train"]["events"].shape[0] // 6)
        assert spec.swaps - swaps0 == n_batches >= 1
        assert not np.array_equal(np.asarray(spec.weights["w_out"]), w0)
        np.testing.assert_array_equal(np.asarray(spec.weights["w_out"]),
                                      np.asarray(learner.weights["w_out"]))
        eng = eng_cls(registry=reg, max_batch=4, **({} if name == "jax" else kw))
        assert eng.engine is learner.backend
        res, _ = eng.serve(iter(reqs))
        assert len(res) == 4 and all(r.model_id == "live" for r in res)
        served[name] = res
    np.testing.assert_allclose(treg.get("live").weights["w_out"].numpy(),
                               np.asarray(jreg.get("live").weights["w_out"]),
                               **FLOAT_TOL)
    for j, t in zip(served["jax"], served["port"]):
        np.testing.assert_allclose(t.logits, np.asarray(j.logits), **FLOAT_TOL)
    # publish() without a registry is a loud error, not a silent no-op
    solo = OnlineLearner(Presets.braille(num_ticks=32), ControllerConfig(),
                         EpropSGDConfig(lr=0.01), 1, device="cpu")
    with pytest.raises(ValueError, match="registry"):
        solo.publish()


@pytest.mark.parametrize("publish_every", [1, 2, 3])
def test_learner_publishes_every_nth_commit(publish_every):
    data = _data()
    reg = ModelRegistry()
    learner = OnlineLearner(Presets.braille(num_ticks=32),
                            ControllerConfig(commit="batch"),
                            EpropSGDConfig(lr=0.01), 1, device="cpu",
                            registry=reg, model_id="live",
                            publish_every=publish_every)
    spec = reg.get("live")
    assert spec.swaps == 0
    learner.train_epoch(tpipe.make_pipeline("arm", data, 6, device="cpu"), 0)
    assert spec.swaps == learner.commits // publish_every


def test_published_image_is_not_aliased_to_the_learners_weights():
    """The registry loads a published image into tensors of its own: a
    later in-place write to the learner's weights never reaches it."""
    reg = ModelRegistry()
    learner = OnlineLearner(Presets.braille(num_ticks=32), ControllerConfig(),
                            EpropSGDConfig(lr=0.01), 1, device="cpu",
                            registry=reg, model_id="live")
    learner.publish()
    image = {k: v.clone() for k, v in reg.get("live").weights.items()}
    for v in learner.weights.values():
        v.add_(1.0)
    for k, v in reg.get("live").weights.items():
        assert torch.equal(v, image[k]), k


def test_learner_rejoins_a_registered_model():
    """A learner attached under a model id that is already registered
    publishes its weights there instead of registering again."""
    reg = ModelRegistry()
    cfg = Presets.braille(num_ticks=32)
    first = OnlineLearner(cfg, ControllerConfig(), EpropSGDConfig(lr=0.01), 1,
                          device="cpu", registry=reg, model_id="live")
    second = OnlineLearner(cfg, ControllerConfig(), EpropSGDConfig(lr=0.01), 2,
                           device="cpu", registry=reg, model_id="live")
    assert reg.ids() == ("live",) and reg.get("live").swaps == 1
    assert reg.get("live").backend is first.backend
    assert torch.equal(reg.get("live").weights["w_in"], second.weights["w_in"])


# --------------------------------------------------------------------------
# SPI register decode
# --------------------------------------------------------------------------


@pytest.mark.parametrize("regs", [
    dict(threshold=0x03F0, alpha_lsb=0x0FE, kappa=0x37),
    dict(),
    dict(threshold=0x0200, alpha_lsb=0x1F0, kappa=0x1FF),
    dict(threshold=0x0100, alpha_lsb=0x080, kappa=0x40, membrane_scale=0.5),
])
def test_reckon_register_decoding(regs):
    got = from_reckon_regs(**regs)
    want = jax_regs(**regs)
    assert isinstance(got, ReckonRegs)
    assert (got.threshold, got.alpha, got.kappa) == (want.threshold, want.alpha,
                                                     want.kappa)
    if not regs or regs.get("threshold") == 0x03F0:
        assert got.alpha == 254.0 / 256.0
        assert got.kappa == 55.0 / 256.0
        assert abs(got.threshold - 1.0) < 1e-9        # normalised grid
