"""The port's serving slice end to end on the CPU, against the JAX package:
``BatchedEngine(..., device="cpu")`` whole-sample ``serve()`` and streaming
sessions against the JAX ``BatchedEngine`` (bitwise in quantized mode,
``atol = rtol = 1e-4`` in float mode) and, quantized, against the integer
golden reference ``repro.core.quant_ref.golden_forward``; plus the host
pieces (data generator, guard, batching, scheduler, pool, registry).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import quant_ref
from repro.core.rsnn import Presets as JaxPresets
from repro.core.rsnn import init_params as jax_init
from repro.data import braille as jbraille
from repro.kernels import traffic as jtraffic
from repro.serve import BatchedEngine as JaxEngine
from repro.serve import batching as jbatching
from repro.serve import guard as jguard
from repro.serve.scheduler import BucketingScheduler as JaxScheduler
from repro_torch.convert import params_from_jax
from repro_torch.core import aer
from repro_torch.core.rsnn import Presets
from repro_torch.data import braille
from repro_torch.kernels import traffic
from repro_torch.serve import (
    BatchedEngine,
    BucketingScheduler,
    GuardError,
    ModelRegistry,
    ServeStatus,
    SessionPool,
    StreamPacker,
    batching,
    guard,
)
from repro_torch.serve.session import _Session

FLOAT_TOL = dict(atol=1e-4, rtol=1e-4)


def _request(rng, n_in, ticks, label=1):
    raster = (rng.random((ticks, n_in)) < 0.25).astype(np.float32)
    return aer.encode_sample(raster, label, label_tick=max(0, ticks // 4),
                             end_tick=ticks - 1)


def _setup(seed=0, n=5, T=32, quantized=False):
    jcfg = JaxPresets.braille(num_ticks=T, quantized=quantized)
    tcfg = Presets.braille(num_ticks=T, quantized=quantized)
    jp = jax_init(jax.random.key(seed), jcfg)
    # a gain of 2.5 makes the quantized datapath fire at this width
    jp = {k: (v * 2.5 if k.startswith("w_") else v) for k, v in jp.items()}
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, device="cpu")
    rng = np.random.default_rng(seed)
    reqs = [_request(rng, tcfg.n_in, int(rng.integers(12, T + 1)), label=i % 3)
            for i in range(n)]
    return jcfg, tcfg, jp, tp, reqs


def _check(a, b, quantized):
    if quantized:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    else:
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **FLOAT_TOL)


def _golden(cfg, weights, ev, ticks):
    raster, valid, _ = batching.decode_events_host([ev], cfg.n_in, ticks,
                                                   cfg.label_delay)
    mask = 1.0 - np.eye(cfg.n_hid, dtype=np.float32)
    return quant_ref.golden_forward(
        raster, weights["w_in"].numpy(), weights["w_rec"].numpy() * mask,
        weights["w_out"].numpy(), quant_ref.QuantizedMode(), reset=cfg.neuron.reset,
        valid=valid)


@pytest.mark.parametrize("quantized,backend", [(True, "kernel"), (False, "scan")])
def test_serve_matches_jax_engine_and_golden(quantized, backend):
    jcfg, tcfg, jp, tp, reqs = _setup(n=5, quantized=quantized)
    jres, _ = JaxEngine(jcfg, jp, backend=backend, max_batch=4).serve(iter(reqs))
    eng = BatchedEngine(tcfg, tp, device="cpu", max_batch=4)
    tres, stats = eng.serve(iter(reqs))
    assert stats.requests == len(reqs) and stats.batches >= 2
    for j, t in zip(jres, tres):
        assert (j.rid, j.label, j.bucket_ticks) == (t.rid, t.label, t.bucket_ticks)
        _check(j.logits, t.logits, quantized)
        if quantized:
            assert j.pred == t.pred
            g = _golden(tcfg, eng._weights, reqs[t.rid], t.bucket_ticks)
            np.testing.assert_array_equal(t.logits.astype(np.int64), g["acc_y"][0])
            assert t.pred == int(g["pred"][0])
    assert stats.hbm_bytes_streamed > 0


@pytest.mark.parametrize("pattern", ["ragged", "word"])
def test_sessions_match_jax_engine_and_golden(pattern):
    """Quantized sessions fed in ragged or word-sized chunks, with pool
    evictions, equal the JAX engine's sessions and the golden reference."""
    jcfg, tcfg, jp, tp, reqs = _setup(seed=3, n=4, quantized=True)
    kw = dict(max_batch=2, max_sessions=2, tick_tile=8)
    jeng = JaxEngine(jcfg, jp, backend="scan", **kw)
    teng = BatchedEngine(tcfg, tp, device="cpu", **kw)
    rng = np.random.default_rng(7)
    feeds = []
    for ev in reqs:
        if pattern == "word":
            feeds.append([ev[i:i + 1] for i in range(len(ev))])
        else:
            cuts = np.sort(rng.integers(0, len(ev) + 1, size=3))
            feeds.append([ev[a:b] for a, b in zip([0, *cuts], [*cuts, len(ev)])])
    for eng in (jeng, teng):
        hs = [eng.open_session() for _ in reqs]
        for step in range(max(len(f) for f in feeds)):
            for h, f in zip(hs, feeds):
                if step < len(f):
                    h.feed(f[step])
            eng.pump()
        eng.results = [h.result() for h in hs]
    assert teng.pool.evictions > 0 and teng.pool.readmissions > 0
    for j, t, ev in zip(jeng.results, teng.results, reqs):
        assert t.final and (j.ticks, j.label, j.pred) == (t.ticks, t.label, t.pred)
        np.testing.assert_array_equal(j.logits, t.logits)
        g = _golden(tcfg, teng._weights, ev, t.ticks)
        np.testing.assert_array_equal(t.logits.astype(np.int64), g["acc_y"][0])


def test_float_sessions_match_jax_and_port_serve():
    jcfg, tcfg, jp, tp, reqs = _setup(seed=5, n=4)
    whole, _ = BatchedEngine(tcfg, tp, device="cpu", max_batch=4).serve(iter(reqs))
    eng = BatchedEngine(tcfg, tp, device="cpu", max_batch=4, tick_tile=8)
    jeng = JaxEngine(jcfg, jp, backend="scan", max_batch=4, tick_tile=8)
    for e in (eng, jeng):
        hs = [e.open_session() for _ in reqs]
        for h, ev in zip(hs, reqs):
            for i in range(0, len(ev), 9):
                h.feed(ev[i:i + 9])
            e.pump()
        e.results = [h.result() for h in hs]
    for w, t, j in zip(whole, eng.results, jeng.results):
        np.testing.assert_allclose(t.logits, w.logits, **FLOAT_TOL)
        np.testing.assert_allclose(t.logits, j.logits, **FLOAT_TOL)


def test_run_tile_warmup_and_weight_swap():
    _, tcfg, _, tp, reqs = _setup(seed=2, n=3, quantized=True)
    eng = BatchedEngine(tcfg, tp, device="cpu", max_batch=4)
    served, _ = eng.serve(iter(reqs))
    for ev in reqs:
        eng.submit(ev)
    tiles = list(eng.scheduler.drain())
    direct = [r for tl in tiles for r in eng.run_tile(tl)]
    for a, b in zip(sorted(direct, key=lambda r: r.rid), served):
        np.testing.assert_array_equal(a.logits, b.logits)
    eng.warmup(32, batch=2)
    be = eng.engine
    n0 = be.rebuilds
    eng.serve(iter(reqs))
    assert be.rebuilds == n0                 # same image: nothing rebuilt
    eng.update_weights({k: -v for k, v in tp.items() if k.startswith("w_")})
    # the SRAM load snaps onto the 8-bit grid
    spec = tcfg.neuron.quant.weight_spec
    for k in ("w_in", "w_rec", "w_out"):
        assert torch.equal(eng._weights[k], spec.round_nearest(eng._weights[k]))
    swapped, _ = eng.serve(iter(reqs))
    assert be.rebuilds == n0 + 1
    assert any(not np.array_equal(a.logits, b.logits)
               for a, b in zip(served, swapped))


def test_engine_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg, _, tp, _ = _setup(n=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BatchedEngine(tcfg, tp)
    assert BatchedEngine(tcfg, tp, device="cpu").device.type == "cpu"


def test_guard_rejections_become_results_and_match_jax():
    _, tcfg, _, tp, reqs = _setup(n=3)
    bad = np.array([0x05000000, 0x03001001], np.uint32)       # unknown type byte
    eng = BatchedEngine(tcfg, tp, device="cpu", max_batch=4)
    res, stats = eng.serve(iter([reqs[0], bad, reqs[1]]))
    assert [r.status for r in res] == [ServeStatus.OK, ServeStatus.REJECTED,
                                       ServeStatus.OK]
    assert stats.rejected == 1
    with pytest.raises(GuardError):
        eng.open_session().feed(np.array([0x03FFF001], np.uint32))   # addr >= n_in
    cases = [bad, np.array([0x00000005], np.uint32), np.array([-1]),
             np.array([0x03001005, 0x03001002], np.uint32), np.array([1.5]),
             reqs[2]]
    gc, jgc = guard.GuardConfig(n_in=12), jguard.GuardConfig(n_in=12)
    for words in cases:
        try:
            want = jguard.validate_events(words, jgc)
        except jguard.GuardError as e:
            with pytest.raises(getattr(guard, type(e).__name__)):
                guard.validate_events(words, gc)
        else:
            np.testing.assert_array_equal(guard.validate_events(words, gc), want)
    acc = np.array([[1.0, 2.0], [np.nan, 0.0], [1e9, 0.0]], np.float32)
    for q in (None, tcfg.neuron.quant):
        jq = None if q is None else JaxPresets.braille(quantized=True).neuron.quant
        for a, b in zip(guard.bad_rows(acc, quant=q, ticks=32),
                        jguard.bad_rows(acc, quant=jq, ticks=32)):
            np.testing.assert_array_equal(a, b)


def test_braille_buffers_byte_identical_to_jax():
    cfg_kw = dict(num_ticks=48, samples_per_class=5, seed=13)
    a = braille.make_braille_dataset("AEU", braille.BrailleConfig(**cfg_kw))
    b = jbraille.make_braille_dataset("AEU", jbraille.BrailleConfig(**cfg_kw))
    for split in ("train", "val", "test"):
        assert a[split]["events"].tobytes() == b[split]["events"].tobytes()
        assert a[split]["event_density"] == b[split]["event_density"]
        assert a[split]["classes"] == b[split]["classes"]


def test_batching_decode_matches_jax():
    rng = np.random.default_rng(4)
    reqs = [_request(rng, 12, t) for t in (5, 17, 32)]
    for a, b in zip(batching.decode_events_host(reqs, 12, 32, 2),
                    jbatching.decode_events_host(reqs, 12, 32, 2)):
        np.testing.assert_array_equal(a, b)
    sessions = []
    for ev in reqs:
        s = _Session(len(sessions), 0.0)
        s.feed(ev[: len(ev) // 2])
        sessions.append(s)
    chunks = [s.take_chunk(8) for s in sessions]
    for a, b in zip(batching.decode_session_chunks(chunks, 12, 8, 1, b_pad=4),
                    jbatching.decode_session_chunks(chunks, 12, 8, 1, b_pad=4)):
        np.testing.assert_array_equal(a, b)
    assert batching.padded_batch_size(5, 64) == 8
    assert batching.bucket_ticks(33, 32) == 64
    assert batching.request_ticks(reqs[1]) == 17
    assert batching.max_sessions_for(Presets.braille()) == jbatching.max_sessions_for(
        JaxPresets.braille())


def test_bucketing_scheduler_tiles_match_jax():
    rng = np.random.default_rng(6)
    reqs = [_request(rng, 12, int(rng.integers(5, 100))) for _ in range(23)]
    ours, theirs = BucketingScheduler(4, 32), JaxScheduler(4, 32)
    for ev in reqs:
        ours.submit(ev)
        theirs.submit(ev)
    full = [(t.num_ticks, [r.rid for r in t.requests]) for t in ours.ready_tiles()]
    jfull = [(t.num_ticks, [r.rid for r in t.requests]) for t in theirs.ready_tiles()]
    assert full == jfull and ours.pending == theirs.pending
    rest = [(t.num_ticks, [r.rid for r in t.requests]) for t in ours.drain()]
    jrest = [(t.num_ticks, [r.rid for r in t.requests]) for t in theirs.drain()]
    assert rest == jrest and ours.pending == 0


def test_pool_lru_idle_timeout_and_packer():
    from repro_torch.core.backend import ExecutionBackend

    now = [0.0]
    be = ExecutionBackend(Presets.braille(num_ticks=8), device="cpu")
    pool = SessionPool(be, 2, idle_timeout=5.0, clock=lambda: now[0])
    s = [_Session(i, 0.0) for i in range(3)]
    pool.place([s[0]])
    now[0] = 1.0
    pool.place([s[1]])
    pool.state["v"][s[0].slot] = 7.0
    now[0] = 2.0
    slots, rows = pool.place([s[2]])            # evicts s[0], the LRU
    assert s[0].slot is None and s[0].offloaded["v"][0] == 7.0
    assert rows["idx"].tolist() == [s[2].slot]
    with pytest.raises(RuntimeError):
        SessionPool(be, 1).place([_Session(8, 0.0), _Session(9, 0.0)])
    now[0] = 6.5
    assert pool.sweep() == 1 and s[1].slot is None   # idle since t=1
    pk = StreamPacker(2, tick_tile=4)
    for x in s:
        x.end_seen, x.end_tick = True, 3
        pk.enqueue(x)
    chosen, ticks = pk.next_tile()
    assert [x.sid for x in chosen] == [0, 1] and ticks == 4 and pk.pending == 1


def test_registry_shapes_and_traffic():
    _, tcfg, _, tp, _ = _setup(n=1)
    reg = ModelRegistry()
    spec = reg.register("a", tcfg, tp, device="cpu")
    reg.register("b", tcfg, tp, device="cpu")
    assert reg.get("b").backend is spec.backend and len(reg.pool) == 1
    with pytest.raises(ValueError, match="w_rec"):
        reg.update_weights("a", {"w_rec": torch.zeros(3, 3)})
    with pytest.raises(KeyError):
        reg.get("nope")
    with pytest.raises(ValueError):
        reg.register("a", tcfg, tp, device="cpu")
    eng = BatchedEngine(registry=reg)
    assert eng.model_ids() == ("a", "b") and eng.default_model == "a"
    cue = dataclasses.replace(Presets.cue_accumulation(num_ticks=8))
    for T, B, dims in ((32, 4, (12, 38, 3)), (8, 1, (cue.n_in, cue.n_hid, cue.n_out))):
        assert traffic.infer_fused_tiled_bytes(T, B, *dims) == \
            jtraffic.infer_fused_tiled_bytes(T, B, *dims, batch_tile=B)
        assert traffic.stream_step_tiled_bytes(T, B, *dims) == \
            jtraffic.stream_step_tiled_bytes(T, B, *dims, batch_tile=B)
