"""The port's hardened serving engine against the JAX engine, on the CPU.

Each of the JAX package's robustness scenarios (``tests/test_robustness.py``:
guards, bounded admission with ``reject`` / ``shed``, deadlines,
whole-sample and streaming launch faults, fault-budget exhaustion, the NaN
quarantine, the quantized saturation storm, inline pumping, the error
counters, the dead-result drain) runs twice on the same inputs, made from
a numpy seed: once through ``repro.serve.BatchedEngine(backend="scan")``
and once through ``repro_torch.serve.BatchedEngine(device="cpu")`` with the
weights carried across by ``params_from_jax``.  Each run keeps the
scenario's own assertions; then statuses, rids, preds and every counter
must be equal, and logits bitwise equal in quantized mode and within
``1e-4`` in float mode.  Faults are scripted by launch index, so the two
engines must launch the same tiles in the same order.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.serve as jserve
import repro_torch.serve as tserve
from repro.core import aer as jaer
from repro.core.rsnn import Presets as JaxPresets
from repro.core.rsnn import init_params as jax_init
from repro_torch.convert import params_from_jax
from repro_torch.core.rsnn import Presets
from repro_torch.kernels.launch import KernelLaunchError

FLOAT_TOL = dict(atol=1e-4, rtol=1e-4)
SERVE_COUNTERS = ("requests", "batches", "rejected", "expired", "quarantined",
                  "shed", "lane_restarts")
STREAM_COUNTERS = ("tiles", "events", "ticks", "mean_lanes", "evictions",
                   "readmissions", "rejected", "expired", "shed", "quarantined",
                   "lane_restarts", "saturation_storms")


def _request(rng, n_in, ticks, label=1):
    raster = (rng.random((ticks, n_in)) < 0.25).astype(np.float32)
    ev = jaer.encode_sample(raster, label, label_tick=max(0, ticks // 4),
                            end_tick=ticks - 1)
    ev = np.asarray(ev, np.uint32)
    return ev[np.argsort(ev & jaer.MAX_TICK, kind="stable")]


def _spike_word(addr, tick):
    return (0x03 << 24) | (addr << 12) | tick


class Clock:
    """Scripted monotonic clock for deadline scenarios."""

    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def _flaky_hook(fail_on, kinds=("tile", "stream"), exc=None):
    """A fault_hook raising on scripted launch indices (engine-wide)."""
    count = [0]

    def hook(model_id, kind):
        if kind not in kinds:
            return
        count[0] += 1
        if count[0] in fail_on:
            raise exc if exc is not None else RuntimeError(
                f"injected launch fault #{count[0]}")

    return hook


@dataclasses.dataclass
class Side:
    """One package's engine, errors and weights for a scenario."""

    port: bool
    cfg: object
    params: dict
    reqs: list

    @property
    def serve(self):
        return tserve if self.port else jserve

    def engine(self, **kw):
        where = {"device": "cpu"} if self.port else {"backend": "scan"}
        return self.serve.BatchedEngine(self.cfg, self.params, **where, **kw)

    def status(self, name):
        return getattr(self.serve.ServeStatus, name)

    def set_row(self, acc, i, value):
        """``acc`` with row ``i`` set to ``value`` (a new array)."""
        if self.port:
            acc = acc.clone()
            acc[i] = value
            return acc
        return acc.at[i].set(value)


def _sides(seed=0, n=6, T=48, quantized=False):
    jcfg = JaxPresets.braille(n_classes=3, num_ticks=T, quantized=quantized)
    tcfg = Presets.braille(n_classes=3, num_ticks=T, quantized=quantized)
    jp = jax_init(jax.random.key(seed), jcfg)
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, device="cpu")
    rng = np.random.default_rng(seed)
    reqs = [_request(rng, jcfg.n_in, int(rng.integers(12, T + 1)), label=i % 3)
            for i in range(n)]
    return Side(False, jcfg, jp, reqs), Side(True, tcfg, tp, reqs)


def _results(res):
    return [{"rid": r.rid, "status": r.status.value, "pred": r.pred,
             "label": r.label, "bucket": r.bucket_ticks,
             "logits": np.asarray(r.logits)} for r in res]


def _snaps(snaps):
    return [{"sid": s.sid, "status": s.status.value, "pred": s.pred,
             "ticks": s.ticks, "events": s.events, "final": s.final,
             "logits": np.asarray(s.logits)} for s in snaps]


def _counters(stats, keys):
    return {k: getattr(stats, k) for k in keys}


# --------------------------------------------------------------------------
# the scenarios: each runs on one side, asserts what the JAX package's own
# test asserts, and returns what the two sides must agree on
# --------------------------------------------------------------------------


def submit_rejects_malformed_and_keeps_serving(sd: Side):
    eng = sd.engine(max_batch=4)
    errs = sd.serve
    for bad in (np.array([0x7F000000], np.uint32),       # unknown type byte
                np.array([1.5, 2.5]),                     # float dtype
                np.array([_spike_word(sd.cfg.n_in, 0)], np.uint32)):  # addr >= n_in
        with pytest.raises(errs.MalformedEventError):
            eng.submit(bad)
    assert eng.scheduler.pending == 0
    res, stats = eng.serve(iter(sd.reqs[:3]))
    assert all(r.status is sd.status("OK") for r in res)
    assert stats.rejected == 0
    return {"results": _results(res), "stats": _counters(stats, SERVE_COUNTERS)}


def serve_turns_bad_items_into_rejected_results(sd: Side):
    reqs = sd.reqs[:4]
    clean, _ = sd.engine(max_batch=4).serve(iter(reqs))
    poisoned = [reqs[0], np.array([0xFF123456], np.uint32), *reqs[1:]]
    res, stats = sd.engine(max_batch=4).serve(iter(poisoned))
    assert len(res) == len(poisoned)
    bad = [r for r in res if r.status is sd.status("REJECTED")]
    ok = [r for r in res if r.status is sd.status("OK")]
    assert len(bad) == 1 and bad[0].pred == -1
    assert stats.rejected == 1 and stats.requests == len(poisoned)
    for got, want in zip(ok, clean):
        assert got.pred == want.pred
        np.testing.assert_array_equal(got.logits, want.logits)
    return {"results": _results(res), "stats": _counters(stats, SERVE_COUNTERS)}


def guard_false_disables_validation(sd: Side):
    eng = sd.engine(guard=False)
    rid = eng.submit(np.array([0x03000000 | (999 << 12)], np.uint32))
    return {"rid": rid, "pending": eng.scheduler.pending}


def feed_guard_contract_and_quota(sd: Side):
    errs = sd.serve
    eng = sd.engine(tick_tile=8, guard=errs.GuardConfig(max_pending_events=200))
    h = eng.open_session()
    ev = sd.reqs[0]
    h.feed(ev[: len(ev) // 2])
    before = eng._sessions[h.sid].n_events
    with pytest.raises(errs.StreamContractError):
        h.feed(np.array([_spike_word(0, 0)], np.uint32))
    assert eng._sessions[h.sid].n_events == before
    assert h.status is sd.status("OK")
    t = eng._sessions[h.sid].max_fed_tick
    flood = np.array([_spike_word(0, min(t + 1, jaer.MAX_TICK))] * 201, np.uint32)
    with pytest.raises(errs.QuotaExceededError):
        h.feed(flood)
    with pytest.raises(errs.StreamContractError):
        h.close()
        h.feed(ev)
    return {"before": before, "max_fed_tick": t,
            "stats": _counters(eng.stream_stats(1.0), STREAM_COUNTERS)}


def bounded_queue_rejects_new_work(sd: Side):
    eng = sd.engine(max_batch=4, max_pending=2)
    rids = [eng.submit(sd.reqs[0]), eng.submit(sd.reqs[1])]
    with pytest.raises(sd.serve.OverloadError):
        eng.submit(sd.reqs[2])
    assert eng.scheduler.pending == 2
    return {"rids": rids, "pending": eng.scheduler.pending}


def shed_policy_drops_oldest_as_rejected_result(sd: Side):
    eng = sd.engine(max_batch=4, max_pending=2, admission="shed")
    rid0 = eng.submit(sd.reqs[0])
    eng.submit(sd.reqs[1])
    eng.submit(sd.reqs[2])   # sheds rid0, admits
    dead = eng.take_dead_results()
    assert [r.rid for r in dead] == [rid0]
    assert dead[0].status is sd.status("REJECTED")
    assert eng.scheduler.pending == 2
    return {"results": _results(dead), "pending": eng.scheduler.pending}


def serve_under_shed_storm_stays_bounded_and_typed(sd: Side):
    rng = np.random.default_rng(3)
    # distinct tick lengths land in distinct buckets: no tile fills
    # mid-stream, so the bounded queue must shed to keep admitting
    reqs = [_request(rng, sd.cfg.n_in, 8 * (i % 5 + 1), label=i % 3)
            for i in range(12)]
    eng = sd.engine(max_batch=4, tick_granularity=8, max_pending=2,
                    admission="shed", max_inflight_tiles=1)
    res, stats = eng.serve(iter(reqs))
    assert len(res) == len(reqs) and stats.requests == len(reqs)
    by = {s: sum(1 for r in res if r.status is sd.status(s))
          for s in ("OK", "REJECTED")}
    assert by["OK"] + by["REJECTED"] == len(reqs)
    assert stats.shed == by["REJECTED"] > 0
    return {"results": _results(res), "stats": _counters(stats, SERVE_COUNTERS)}


def deadline_expires_before_launch(sd: Side):
    clk = Clock()
    eng = sd.engine(max_batch=4, clock=clk, default_deadline_s=5.0)
    rid = eng.submit(sd.reqs[0])
    clk.now = 10.0   # past the deadline before anything packs
    survivor = eng.submit(sd.reqs[1], deadline_s=100.0)
    dead = eng.take_dead_results()
    assert [r.rid for r in dead] == [rid]
    assert dead[0].status is sd.status("EXPIRED")
    tiles = list(eng.scheduler.drain())
    assert sum(len(t.requests) for t in tiles) == 1
    return {"results": _results(dead), "survivor": survivor,
            "tiles": [[r.rid for r in t.requests] for t in tiles]}


def session_deadline_drops_at_pack_time(sd: Side):
    clk = Clock()
    eng = sd.engine(tick_tile=8, clock=clk)
    doomed = eng.open_session(deadline_s=5.0)
    healthy = eng.open_session()
    doomed.feed(sd.reqs[0])
    healthy.feed(sd.reqs[1])
    clk.now = 10.0
    eng.pump(drain=True)
    assert doomed.status is sd.status("EXPIRED")
    snap = doomed.result()
    assert snap.final and snap.status is sd.status("EXPIRED") and snap.pred == -1
    ok = healthy.result()
    assert ok.status is sd.status("OK") and ok.pred >= 0
    stats = eng.stream_stats(wall_s=1.0)
    assert stats.expired == 1
    return {"snaps": _snaps([snap, ok]), "stats": _counters(stats, STREAM_COUNTERS)}


def whole_sample_launch_fault_recovers_bitwise(sd: Side):
    clean, _ = sd.engine(max_batch=4).serve(iter(sd.reqs))
    eng = sd.engine(max_batch=4, fault_hook=_flaky_hook({1}))
    res, stats = eng.serve(iter(sd.reqs))
    assert stats.lane_restarts == 1
    assert all(r.status is sd.status("OK") for r in res)
    for got, want in zip(res, clean):
        assert got.pred == want.pred
        np.testing.assert_array_equal(got.logits, want.logits)
    return {"results": _results(res), "stats": _counters(stats, SERVE_COUNTERS)}


def whole_sample_fault_budget_exhaustion_faults_tile(sd: Side):
    reqs = sd.reqs[:2]
    eng = sd.engine(max_batch=4, max_tile_retries=1,
                    fault_hook=_flaky_hook(set(range(1, 100))))
    res, stats = eng.serve(iter(reqs))
    assert len(res) == len(reqs)
    assert all(r.status is sd.status("FAULT") and r.pred == -1 for r in res)
    assert stats.quarantined == len(reqs)
    eng._fault_hook = None   # the engine serves cleanly once faults stop
    res2, stats2 = eng.serve(iter(reqs))
    assert all(r.status is sd.status("OK") for r in res2)
    return {"results": _results(res) + _results(res2),
            "stats": _counters(stats, SERVE_COUNTERS),
            "stats2": _counters(stats2, SERVE_COUNTERS)}


def _fed_in_halves(sd: Side, hook, reqs):
    eng = sd.engine(max_batch=4, tick_tile=8, fault_hook=hook)
    handles = [eng.open_session() for _ in reqs]
    for h, ev in zip(handles, reqs):
        mid = len(ev) // 2
        h.feed(ev[:mid])
        h.feed(ev[mid:])
    eng.pump(drain=True)
    return eng, [h.result() for h in handles]


def stream_launch_fault_rewinds_and_recovers_bitwise(sd: Side):
    _, clean = _fed_in_halves(sd, None, sd.reqs)
    eng, got = _fed_in_halves(sd, _flaky_hook({2}, kinds=("stream",)), sd.reqs)
    stats = eng.stream_stats(1.0)
    assert stats.lane_restarts == 1
    for g, w in zip(got, clean):
        assert g.status is sd.status("OK")
        assert (g.pred, g.ticks, g.events) == (w.pred, w.ticks, w.events)
        np.testing.assert_array_equal(g.logits, w.logits)
    return {"snaps": _snaps(got), "stats": _counters(stats, STREAM_COUNTERS)}


def stream_fault_budget_quarantines_sessions(sd: Side):
    eng = sd.engine(max_batch=4, tick_tile=8, max_tile_retries=0,
                    fault_hook=_flaky_hook(set(range(1, 100)), kinds=("stream",)))
    h = eng.open_session()
    h.feed(sd.reqs[0])
    eng.pump(drain=True)
    assert h.status is sd.status("FAULT")
    snap = h.result()
    assert snap.final and snap.status is sd.status("FAULT") and snap.pred == -1
    stats = eng.stream_stats(1.0)
    assert stats.quarantined == 1 and stats.lane_restarts >= 1
    eng._fault_hook = None   # fresh sessions on the rebuilt lane serve
    h2 = eng.open_session()
    h2.feed(sd.reqs[1])
    snap2 = h2.result()
    assert snap2.status is sd.status("OK")
    return {"snaps": _snaps([snap, snap2]), "stats": _counters(stats, STREAM_COUNTERS)}


def _poisoned_run(sd: Side, reqs, victim, value, **kw):
    eng = sd.engine(tick_tile=8, **kw)
    handles = [eng.open_session() for _ in reqs]
    if victim is not None:
        victim_sid = handles[victim].sid
        orig = eng._launch_chunks

        def poisoned(lane, sessions, chunks, num_ticks):
            out = orig(lane, sessions, chunks, num_ticks)
            for i, s in enumerate(sessions):
                if s.sid == victim_sid:
                    out = dict(out)
                    out["acc_y"] = sd.set_row(out["acc_y"], i, value)
            return out

        eng._launch_chunks = poisoned
    for h, ev in zip(handles, reqs):
        h.feed(ev)
    eng.pump(drain=True)
    return eng, handles


def harvest_nan_quarantines_one_session_tile_mates_unchanged(sd: Side):
    reqs = sd.reqs[:3]
    _, clean = _poisoned_run(sd, reqs, None, None, max_batch=4)
    clean_snaps = [h.result() for h in clean]
    eng, handles = _poisoned_run(sd, reqs, 1, float("nan"), max_batch=4)
    assert handles[1].status is sd.status("FAULT")
    snaps = [h.result() for h in handles]
    assert snaps[1].status is sd.status("FAULT") and snaps[1].pred == -1
    assert not snaps[1].logits.any()
    for i in (0, 2):
        assert snaps[i].status is sd.status("OK")
        np.testing.assert_array_equal(snaps[i].logits, clean_snaps[i].logits)
    stats = eng.stream_stats(1.0)
    assert stats.quarantined == 1
    return {"snaps": _snaps(snaps), "stats": _counters(stats, STREAM_COUNTERS)}


def quantized_saturation_storm_quarantines(sd: Side):
    eng, handles = _poisoned_run(sd, sd.reqs[:2], 0, 1e12)
    assert handles[0].status is sd.status("FAULT")
    assert handles[1].status is sd.status("OK")
    stats = eng.stream_stats(1.0)
    assert stats.saturation_storms >= 1 and stats.quarantined == 1
    return {"snaps": _snaps([h.result() for h in handles]),
            "stats": _counters(stats, STREAM_COUNTERS)}


def bounded_packer_pumps_inline_and_accounts_wait(sd: Side):
    reqs = sd.reqs[:4]
    eng = sd.engine(max_batch=2, tick_tile=8, max_pending_sessions=1)
    eng.reset_stream_stats()
    handles = [eng.open_session() for _ in reqs]
    for h, ev in zip(handles, reqs):
        h.feed(ev)   # overflows the 1-deep ready queue: the engine pumps inline
    eng.pump(drain=True)
    snaps = [h.result() for h in handles]
    assert all(s.status is sd.status("OK") for s in snaps)
    stats = eng.stream_stats(wall_s=1.0)
    assert stats.admission_wait_s >= 0.0 and stats.events_per_sec > 0
    # bitwise equal to an unbounded engine: backpressure only reorders
    eng2 = sd.engine(max_batch=2, tick_tile=8)
    h2 = [eng2.open_session() for _ in reqs]
    for h, ev in zip(h2, reqs):
        h.feed(ev)
    for s, t in zip(snaps, (h.result() for h in h2)):
        np.testing.assert_array_equal(s.logits, t.logits)
    return {"snaps": _snaps(snaps), "stats": _counters(stats, STREAM_COUNTERS)}


def stats_carry_error_counters(sd: Side):
    reqs = sd.reqs[:3]
    eng = sd.engine(max_batch=4, fault_hook=_flaky_hook({1}))
    res, stats = eng.serve(iter([*reqs, np.array([0xAA000000], np.uint32)]))
    assert stats.requests == len(reqs) + 1
    assert stats.rejected == 1 and stats.lane_restarts == 1
    ok = [r for r in res if r.status is sd.status("OK")]
    assert stats.samples_per_sec >= 0 and len(ok) == len(reqs)
    return {"results": _results(res), "stats": _counters(stats, SERVE_COUNTERS)}


def dead_results_drain_once(sd: Side):
    eng = sd.engine(max_pending=1, admission="shed")
    eng.submit(sd.reqs[0])
    eng.submit(sd.reqs[1])
    first = eng.take_dead_results()
    assert len(first) == 1
    assert eng.take_dead_results() == []
    return {"results": _results(first)}


# (scenario, _sides keyword arguments)
SCENARIOS = [
    (submit_rejects_malformed_and_keeps_serving, dict(n=3)),
    (serve_turns_bad_items_into_rejected_results, dict(n=4)),
    (guard_false_disables_validation, dict(n=1)),
    (feed_guard_contract_and_quota, dict(n=1)),
    (bounded_queue_rejects_new_work, dict(n=6)),
    (shed_policy_drops_oldest_as_rejected_result, dict(n=6)),
    (serve_under_shed_storm_stays_bounded_and_typed, dict(n=0)),
    (deadline_expires_before_launch, dict(n=3)),
    (session_deadline_drops_at_pack_time, dict(n=2)),
    (whole_sample_launch_fault_recovers_bitwise, dict(n=6)),
    (whole_sample_fault_budget_exhaustion_faults_tile, dict(n=2)),
    (stream_launch_fault_rewinds_and_recovers_bitwise, dict(n=4, T=32)),
    (stream_fault_budget_quarantines_sessions, dict(n=2, T=32)),
    (harvest_nan_quarantines_one_session_tile_mates_unchanged, dict(n=3, T=32)),
    (quantized_saturation_storm_quarantines, dict(n=2, T=32, quantized=True)),
    (bounded_packer_pumps_inline_and_accounts_wait, dict(n=4, T=32)),
    (stats_carry_error_counters, dict(n=3)),
    (dead_results_drain_once, dict(n=3)),
]


def _agree(want, got, quantized, path="obs"):
    if isinstance(want, dict):
        assert set(want) == set(got), path
        for k in want:
            _agree(want[k], got[k], quantized, f"{path}.{k}")
    elif isinstance(want, list):
        assert len(want) == len(got), path
        for i, (w, g) in enumerate(zip(want, got)):
            _agree(w, g, quantized, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        if quantized:
            np.testing.assert_array_equal(got, want, err_msg=path)
        else:
            np.testing.assert_allclose(got, want, err_msg=path, **FLOAT_TOL)
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=1e-12), path
    else:
        assert got == want, path


@pytest.mark.parametrize(
    "scenario,kw", SCENARIOS, ids=[fn.__name__ for fn, _ in SCENARIOS])
def test_robustness_matches_jax_engine(scenario, kw):
    jside, tside = _sides(**kw)
    want = scenario(jside)
    got = scenario(tside)
    _agree(want, got, kw.get("quantized", False))


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("kind", ["tile", "stream"])
def test_nonsticky_launch_error_recovers_sticky_one_reaches_caller(kind, quantized):
    """Only recoverable faults restart a lane: a launcher error code that
    leaves the CUDA context usable (here raised by the fault hook) is
    recovered bitwise, a sticky one (an illegal address) is re-raised with
    no quarantine and no restart."""
    _, sd = _sides(n=4, T=32, quantized=quantized)

    def run(exc):
        eng = sd.engine(max_batch=4, tick_tile=8,
                        fault_hook=_flaky_hook({1}, kinds=(kind,), exc=exc))
        if kind == "tile":
            res, _ = eng.serve(iter(sd.reqs))
            return eng, [r.logits for r in res]
        hs = [eng.open_session() for _ in sd.reqs]
        for h, ev in zip(hs, sd.reqs):
            h.feed(ev)
        return eng, [h.result().logits for h in hs]

    _, clean = run(None)
    eng, got = run(KernelLaunchError("rsnn_step_sessions", 1, "invalid argument"))
    assert eng.stream_stats(1.0).lane_restarts == 1
    for g, w in zip(got, clean):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(KernelLaunchError, match="CUDA error 700"):
        run(KernelLaunchError("rsnn_step_sessions", 700, "an illegal memory access"))


@pytest.mark.parametrize("code,recovered", [(1, True), (701, True), (700, False),
                                            (719, False)])
def test_launcher_error_from_the_op_is_classified_by_code(code, recovered):
    """The backend op itself raising a launcher error (what
    ``kernels.launch.raise_on`` raises on the card): a code that leaves the
    context usable restarts the lane and the relaunch on the fresh backend
    is bitwise equal; a sticky code reaches the caller."""
    _, sd = _sides(n=3, T=32, quantized=True)
    clean, _ = sd.engine(max_batch=4).serve(iter(sd.reqs))
    eng = sd.engine(max_batch=4)
    old = eng.engine
    orig = old.step_sessions

    def fail_once(*args, **kw):
        old.step_sessions = orig
        raise KernelLaunchError("rsnn_step_sessions", code, "stand-in")

    old.step_sessions = fail_once
    if not recovered:
        with pytest.raises(KernelLaunchError):
            eng.serve(iter(sd.reqs))
        assert eng.stream_stats(1.0).lane_restarts == 0
        return
    res, stats = eng.serve(iter(sd.reqs))
    assert stats.lane_restarts == 1 and eng.engine is not old
    for g, w in zip(res, clean):
        assert g.status is tserve.ServeStatus.OK
        np.testing.assert_array_equal(g.logits, w.logits)


def test_unrecoverable_backend_error_is_not_absorbed():
    """An exception that neither the fault hook nor a launcher's non-sticky
    code raised (a bug, a torch-side CUDA error) propagates out of the
    engine: no restart, no FAULT results in its place."""
    _, sd = _sides(n=2, T=32)
    eng = sd.engine(max_batch=4, tick_tile=8)

    def broken(*args, **kw):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    eng.engine.step_sessions = broken
    with pytest.raises(RuntimeError, match="illegal memory access"):
        eng.serve(iter(sd.reqs))
    assert eng.stream_stats(1.0).lane_restarts == 0


def test_restart_rebuilds_backend_on_the_same_device_and_shares_it():
    """A lane restart discards the pooled backend and builds a fresh one for
    the same bucket (same device, same datapath), re-points every model
    that shared it, and re-loads their images bit for bit."""
    _, sd = _sides(n=2, quantized=True)
    reg = tserve.ModelRegistry()
    reg.register("a", sd.cfg, sd.params, device="cpu")
    reg.register("b", sd.cfg, sd.params, device="cpu")
    old = reg.get("a").backend
    assert reg.get("b").backend is old
    before = {k: v.clone() for k, v in reg.get("b").weights.items()}
    reg.rebuild_backend("a")
    fresh = reg.get("a").backend
    assert fresh is not old and reg.get("b").backend is fresh
    assert fresh.device == old.device and fresh.quant == old.quant
    assert reg.pool.backends() == (fresh,)
    for k, v in reg.get("b").weights.items():
        assert torch.equal(v, before[k])
