"""What each rank of a gloo world runs for ``tests/test_torch_distributed.py``.

:func:`spawn_world` starts a world from one process with
``torch.multiprocessing`` and a ``file://`` rendezvous (no TCP port to
collide with a neighbour's).  The spawned ranks import this module by
name, so it imports neither JAX nor the JAX package: the ranks load their inputs
from the parent's npz, run the port's data-parallel ops on a ``("data",)``
mesh over the whole world, and each rank writes its outputs to
``<out>/w<world>_r<rank>.npz`` for the parent to hold against the JAX
package (and against the other ranks: every output is replicated).

The engine's per-rank decisions (:data:`AGREE_SCENARIOS`) run here too,
generic over a side (:class:`PortSide` here, the JAX engine in the
parent): deadlines, session deadlines and an idle sweep on a scripted
clock that reads rank 0's time plus ``SKEW_S`` seconds a rank once the
scenario has moved it, and whole-sample and streaming launch faults from
a fault hook armed on the last rank alone or on every rank.
"""

import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.convert import params_from_jax
from repro_torch.core.backend import ExecutionBackend, RankFaultError, RuntimeConfig, as_backend
from repro_torch.core.controller import make_batch_commit_train_fn
from repro_torch.core.quant import DW_COMMIT_SPEC
from repro_torch.core.rsnn import EpropConfig, NeuronConfig, Presets, RSNNConfig
from repro_torch.distributed.elastic import survive_data_failure
from repro_torch.kernels import ops
from repro_torch.kernels.launch import KernelLaunchError
from repro_torch.launch.mesh import join_world, leave_world, make_data_mesh, mesh_over
from repro_torch.optim.eprop_opt import EpropSGD, EpropSGDConfig
from repro_torch.serve import BatchedEngine, ServeStatus
from repro_torch.serve.batching import max_batch_for

STATE_KEYS = ("v", "z", "y", "acc_y", "n_spk")


def _world_entry(rank, fn, world_size, init_method, timeout_s, args):
    join_world(rank, world_size, init_method, device="cpu", timeout_s=timeout_s)
    try:
        fn(rank, world_size, *args)
        dist.barrier()      # no rank tears down its connections while a peer works
    finally:
        leave_world()


def spawn_world(fn, world_size, args, rendezvous_dir, timeout_s):
    """Run ``fn(rank, world_size, *args)`` on ``world_size`` fresh gloo
    ranks (``spawn``: each imports ``fn``'s module by name) and wait for
    them; raises when a rank fails, after terminating the others."""
    os.makedirs(rendezvous_dir, exist_ok=True)
    fd, path = tempfile.mkstemp(prefix="rendezvous-", dir=rendezvous_dir)
    os.close(fd)
    os.unlink(path)            # the file store creates it
    mp.spawn(_world_entry, args=(fn, world_size, f"file://{path}", timeout_s, tuple(args)),
             nprocs=world_size, join=True)


def float_cfg(T=18):
    """``tests/test_backend.py:_cfg()``."""
    return RSNNConfig(n_in=10, n_hid=16, n_out=3, num_ticks=T,
                      neuron=NeuronConfig(alpha=0.9, kappa=0.45, reset="zero"),
                      eprop=EpropConfig(mode="factored", feedback="symmetric"))


def quant_cfg(T=24):
    return Presets.braille(n_classes=3, num_ticks=T, quantized=True)


def braille_cfg(T=32):
    return Presets.braille(n_classes=3, num_ticks=T)


def _t(a):
    return torch.from_numpy(np.array(a))


def _weights(inp, prefix):
    return {k: _t(inp[f"{prefix}.{k}"]) for k in ("w_in", "w_rec", "w_out")}


def _np(t):
    return t.detach().cpu().numpy()


def sessions(eng, reqs):
    """One streaming session per request, fed in two halves with a pump
    after each, so every session runs two tiles, the second from carries."""
    hs = [eng.open_session() for _ in reqs]
    for part in (0, 1):
        for h, ev in zip(hs, reqs):
            mid = len(ev) // 2
            h.feed(ev[:mid] if part == 0 else ev[mid:])
        eng.pump()
    return [h.result() for h in hs]


# --------------------------------------------------------------------------
# the engine's per-rank decisions: scenarios generic over a side, each
# returning what rank 0 must share with every rank and with the JAX engine
# --------------------------------------------------------------------------

SKEW_S = 7.0
SERVE_COUNTERS = ("requests", "batches", "rejected", "expired", "quarantined",
                  "shed", "lane_restarts")
STREAM_COUNTERS = ("tiles", "events", "ticks", "mean_lanes", "evictions",
                   "readmissions", "rejected", "expired", "shed", "quarantined",
                   "lane_restarts", "saturation_storms")


class Clock:
    """A scripted clock.  The scenario sets ``now`` (rank 0's time); rank
    ``r`` reads ``now + SKEW_S * r`` once ``now`` has moved from 0, so
    stamps taken at the start agree and every later reading is skewed: a
    deadline or idle limit within ``SKEW_S`` of a scripted time would pass
    on the other ranks first if their clocks decided."""

    def __init__(self, rank: int = 0):
        self.rank = rank
        self.now = 0.0

    def __call__(self) -> float:
        return self.now + (SKEW_S * self.rank if self.now > 0 else 0.0)


def flaky_hook(fail_on, kinds=("tile", "stream")):
    """A fault_hook raising on scripted launch indices (engine-wide)."""
    count = [0]

    def hook(model_id, kind):
        if kind not in kinds:
            return
        count[0] += 1
        if count[0] in fail_on:
            raise RuntimeError(f"injected launch fault #{count[0]}")

    return hook


class PortSide:
    """The port's engine over ``mesh`` (``None``: one device) for a
    scenario; the parent holds a JAX counterpart with the same face."""

    def __init__(self, cfg, params, reqs, mesh):
        self.cfg, self.params, self.reqs, self.mesh = cfg, params, reqs, mesh

    def engine(self, **kw):
        return BatchedEngine(self.cfg, self.params, device="cpu",
                             runtime=RuntimeConfig(mesh=self.mesh), **kw)

    def status(self, name):
        return getattr(ServeStatus, name)


def _results(res):
    return [{"rid": r.rid, "status": r.status.value, "pred": r.pred,
             "label": r.label, "bucket": r.bucket_ticks,
             "logits": np.asarray(r.logits)} for r in res]


def _snaps(snaps):
    return [{"sid": x.sid, "status": x.status.value, "pred": x.pred,
             "ticks": x.ticks, "events": x.events, "final": x.final,
             "logits": np.asarray(x.logits)} for x in snaps]


def _counters(stats, keys):
    return {k: getattr(stats, k) for k in keys}


def deadlines(sd, clk, hook):
    """Request deadlines by rank 0's clock: one expired, one 2 s past the
    scripted time (expired on every other rank's clock), one far off; the
    survivors served through run_tile and the rest through serve()."""
    eng = sd.engine(max_batch=4, clock=clk, default_deadline_s=5.0)
    rid = eng.submit(sd.reqs[0])
    border = eng.submit(sd.reqs[1], deadline_s=12.0)
    clk.now = 10.0
    survivor = eng.submit(sd.reqs[2], deadline_s=100.0)
    dead = eng.take_dead_results()
    assert [r.rid for r in dead] == [rid]
    assert dead[0].status is sd.status("EXPIRED")
    tiles = list(eng.scheduler.drain())
    assert sorted(r.rid for t in tiles for r in t.requests) == [border, survivor]
    served = [r for t in tiles for r in eng.run_tile(t)]
    res, stats = eng.serve(iter(sd.reqs[3:]), deadline_s=1.0)
    return {"dead": _results(dead), "served": _results(served), "serve": _results(res),
            "stats": _counters(stats, SERVE_COUNTERS)}


def session_deadlines(sd, clk, hook):
    """Session deadlines at pack time by rank 0's clock: one passed, one
    within ``SKEW_S`` of the scripted time, one without."""
    eng = sd.engine(max_batch=4, tick_tile=8, clock=clk)
    doomed = eng.open_session(deadline_s=5.0)
    border = eng.open_session(deadline_s=12.0)
    healthy = eng.open_session()
    for h, ev in zip((doomed, border, healthy), sd.reqs):
        h.feed(ev)
    clk.now = 10.0
    eng.pump(drain=True)
    assert doomed.status is sd.status("EXPIRED")
    snaps = [h.result() for h in (doomed, border, healthy)]
    assert [x.status for x in snaps] == [sd.status(n) for n in ("EXPIRED", "OK", "OK")]
    stats = eng.stream_stats(wall_s=1.0)
    assert stats.expired == 1
    return {"snaps": _snaps(snaps), "stats": _counters(stats, STREAM_COUNTERS)}


def idle_sweep(sd, clk, hook):
    """The idle offload by rank 0's clock, then the readmission: two
    sessions run at t=0; at t=5 one is fed again (the other has been idle
    5 s on rank 0, more than the 8 s limit on every other rank's clock); at
    t=10 the idle one is offloaded, then fed and readmitted."""
    eng = sd.engine(max_batch=4, tick_tile=8, clock=clk, idle_timeout=8.0)
    a, b = eng.open_session(), eng.open_session()
    halves = [np.array_split(ev, 2) for ev in sd.reqs[:2]]
    a.feed(halves[0][0])
    b.feed(halves[1][0])
    eng.pump()
    clk.now = 5.0
    a.feed(halves[0][1])
    eng.pump()
    mid = eng.stream_stats(1.0).evictions
    clk.now = 10.0
    eng.pump()
    swept = eng.stream_stats(1.0).evictions
    b.feed(halves[1][1])
    eng.pump(drain=True)
    snaps = [a.result(), b.result()]
    stats = eng.stream_stats(1.0)
    assert (mid, swept, stats.readmissions) == (0, 1, 1), (mid, swept, stats.readmissions)
    return {"mid": mid, "swept": swept, "snaps": _snaps(snaps),
            "stats": _counters(stats, STREAM_COUNTERS)}


def tile_fault(sd, clk, hook):
    """A whole-sample launch fault recovers bitwise through one restart."""
    clean, _ = sd.engine(max_batch=4).serve(iter(sd.reqs))
    eng = sd.engine(max_batch=4, fault_hook=hook({1}))
    res, stats = eng.serve(iter(sd.reqs))
    assert stats.lane_restarts == 1
    assert all(r.status is sd.status("OK") for r in res)
    for got, want in zip(res, clean):
        assert got.pred == want.pred
        np.testing.assert_array_equal(got.logits, want.logits)
    return {"results": _results(res), "stats": _counters(stats, SERVE_COUNTERS)}


def tile_budget(sd, clk, hook):
    """An exhausted fault budget FAULTs the tile; the engine serves again
    once the faults stop."""
    eng = sd.engine(max_batch=4, max_tile_retries=1, fault_hook=hook(set(range(1, 100))))
    res, stats = eng.serve(iter(sd.reqs[:2]))
    assert all(r.status is sd.status("FAULT") and r.pred == -1 for r in res)
    assert stats.quarantined == 2
    eng._fault_hook = None
    res2, stats2 = eng.serve(iter(sd.reqs[:2]))
    assert all(r.status is sd.status("OK") for r in res2)
    return {"results": _results(res) + _results(res2),
            "stats": _counters(stats, SERVE_COUNTERS),
            "stats2": _counters(stats2, SERVE_COUNTERS)}


def _fed_in_halves(sd, fault_hook, reqs):
    eng = sd.engine(max_batch=4, tick_tile=8, fault_hook=fault_hook)
    handles = [eng.open_session() for _ in reqs]
    for h, ev in zip(handles, reqs):
        mid = len(ev) // 2
        h.feed(ev[:mid])
        h.feed(ev[mid:])
    eng.pump(drain=True)
    return eng, [h.result() for h in handles]


def stream_fault(sd, clk, hook):
    """A streaming launch fault rewinds the chunks and recovers bitwise."""
    _, clean = _fed_in_halves(sd, None, sd.reqs)
    eng, got = _fed_in_halves(sd, hook({2}, ("stream",)), sd.reqs)
    stats = eng.stream_stats(1.0)
    assert stats.lane_restarts == 1
    for g, w in zip(got, clean):
        assert g.status is sd.status("OK")
        assert (g.pred, g.ticks, g.events) == (w.pred, w.ticks, w.events)
        np.testing.assert_array_equal(g.logits, w.logits)
    return {"snaps": _snaps(got), "stats": _counters(stats, STREAM_COUNTERS)}


def stream_budget(sd, clk, hook):
    """A session past its streaming fault budget is quarantined; fresh
    sessions on the rebuilt lane serve."""
    eng = sd.engine(max_batch=4, tick_tile=8, max_tile_retries=0,
                    fault_hook=hook(set(range(1, 100)), ("stream",)))
    h = eng.open_session()
    h.feed(sd.reqs[0])
    eng.pump(drain=True)
    assert h.status is sd.status("FAULT")
    snap = h.result()
    stats = eng.stream_stats(1.0)
    assert stats.quarantined == 1 and stats.lane_restarts >= 1
    eng._fault_hook = None
    h2 = eng.open_session()
    h2.feed(sd.reqs[1])
    snap2 = h2.result()
    assert snap2.status is sd.status("OK")
    return {"snaps": _snaps([snap, snap2]), "stats": _counters(stats, STREAM_COUNTERS)}


# (name, scenario, (num_ticks, quantized), the hook's arming: "none" for a
# scenario without a hook, "last" on the last rank alone, "every" rank)
AGREE_SCENARIOS = [
    ("deadlines", deadlines, (48, False), ("none",)),
    ("session_deadlines", session_deadlines, (32, False), ("none",)),
    ("idle_sweep", idle_sweep, (32, True), ("none",)),
    ("tile_fault", tile_fault, (48, True), ("last", "every")),
    ("tile_budget", tile_budget, (48, False), ("last", "every")),
    ("stream_fault", stream_fault, (32, True), ("last", "every")),
    ("stream_budget", stream_budget, (32, False), ("last", "every")),
]
AGREE_SHAPES = sorted({shape for _, _, shape, _ in AGREE_SCENARIOS})
AGREE_REQUESTS = 6


def shape_tag(shape):
    return f"T{shape[0]}{'q' if shape[1] else 'f'}"


def flat(obs, prefix):
    """A nested observation as flat npz entries ``prefix.key[i]...``."""
    out = {}
    if isinstance(obs, dict):
        for k, v in obs.items():
            out.update(flat(v, f"{prefix}.{k}"))
    elif isinstance(obs, list):
        out[f"{prefix}.len"] = np.int64(len(obs))
        for i, v in enumerate(obs):
            out.update(flat(v, f"{prefix}[{i}]"))
    else:
        out[prefix] = np.asarray(obs)
    return out


def run_agreement(sides, rank, world):
    """Every scenario of :data:`AGREE_SCENARIOS` on ``sides[shape]``, with
    this rank's skewed clock and its hook (armed as the case says; an
    unarmed rank passes no hook); the flat observations."""
    out = {}
    for name, fn, shape, arms in AGREE_SCENARIOS:
        for arm in arms:
            armed = arm == "every" or rank == world - 1

            def hook(fail_on, kinds=("tile", "stream")):
                return flaky_hook(fail_on, kinds) if armed else None

            out.update(flat(fn(sides[shape], Clock(rank), hook), f"agree.{name}.{arm}"))
    return out


def run_sticky(side, rank, world):
    """A sticky launcher error (CUDA error 700) from the last rank's
    ``rsnn_step_sessions`` under serve() and under sessions: every rank
    must raise, the last its own error and the others
    :class:`RankFaultError` naming it, well inside the group timeout."""
    out = {}
    for kind in ("tile", "stream"):
        eng = side.engine(max_batch=4, tick_tile=8)
        orig = ops.rsnn_step_sessions

        def broken(*args, **kw):
            raise KernelLaunchError("rsnn_step_sessions", 700, "an illegal memory access")

        if rank == world - 1:
            ops.rsnn_step_sessions = broken
        raised, named, sticky = "", -1, False
        t0 = time.monotonic()
        try:
            if kind == "tile":
                eng.serve(iter(side.reqs))
            else:
                sessions(eng, side.reqs)
        except RankFaultError as exc:
            raised, named, sticky = type(exc).__name__, exc.rank, exc.sticky
        except KernelLaunchError as exc:
            raised, sticky = type(exc).__name__, exc.sticky
        finally:
            ops.rsnn_step_sessions = orig
        out.update({f"sticky.{kind}.raised": np.str_(raised),
                    f"sticky.{kind}.rank": np.int64(named),
                    f"sticky.{kind}.sticky": np.bool_(sticky),
                    f"sticky.{kind}.seconds": np.float64(time.monotonic() - t0)})
    return out


def run_cases(rank, world, in_path, out_dir):
    inp = dict(np.load(in_path))
    mesh = make_data_mesh(device="cpu")
    out = {"num_devices": np.int64(0)}

    # sharded train_tile, float config: B=11 at label_delay 0 and 4, B=8
    fcfg = float_cfg()
    w = _weights(inp, "float")
    sh = ExecutionBackend(fcfg, device="cpu", runtime=RuntimeConfig(mesh=mesh))
    out["num_devices"] = np.int64(sh.num_devices)
    for tag in ("train_d0", "train_d4", "train_b8"):
        dw, m = sh.train_tile(w, _t(inp[f"{tag}.raster"]), _t(inp[f"{tag}.y_star"]),
                              _t(inp[f"{tag}.valid"]))
        for k, v in dw.items():
            out[f"{tag}.dw.{k}"] = _np(v)
        for k, v in m.items():
            out[f"{tag}.{k}"] = _np(v)

    # inference, float at B=13; quantized at B=8
    m = sh.inference(w, _t(inp["infer.raster"]), _t(inp["infer.valid"]))
    for k, v in m.items():
        out[f"infer.{k}"] = _np(v)
    qcfg = quant_cfg()
    qw = _weights(inp, "quant")
    qsh = ExecutionBackend(qcfg, device="cpu", runtime=RuntimeConfig(mesh=mesh))
    m = qsh.inference(qw, _t(inp["qinfer.raster"]), _t(inp["qinfer.valid"]))
    out["qinfer.acc_y"] = _np(m["acc_y"])

    # one END_B commit through the sharded backend (B=6)
    opt = EpropSGD(EpropSGDConfig(lr=0.02, clip=10.0))
    fn = make_batch_commit_train_fn(fcfg, opt, sh)
    batch = {"raster": _t(inp["commit.raster"]).transpose(0, 1).contiguous(),
             "label": _t(inp["commit.label"]),
             "valid": _t(inp["commit.valid"]).transpose(0, 1).contiguous()}
    new_w, _, cm = fn(w, opt.init(w), batch)
    for k, v in new_w.items():
        out[f"commit.w.{k}"] = _np(v)
    out["commit.count"] = np.int64(cm["count"])

    # the integer commit grid, quantized Braille at B=8
    gsh = ExecutionBackend(qcfg, device="cpu", runtime=RuntimeConfig(
        mesh=mesh, commit_grid=DW_COMMIT_SPEC))
    args = [_t(inp[f"grid.{k}"]) for k in ("raster", "y_star", "valid")]
    dw, m = gsh.train_tile(qw, *args)
    for k, v in dw.items():
        out[f"grid.dw.{k}"] = _np(v)
    out["grid.spike_rate"] = _np(m["spike_rate"])

    # sessions: two chained tiles, sharded and unsharded, both modes
    for mode, cfg, wts in (("q", qcfg, qw), ("f", braille_cfg(24), _weights(inp, "braille"))):
        one = ExecutionBackend(cfg, device="cpu")
        many = ExecutionBackend(cfg, device="cpu", runtime=RuntimeConfig(mesh=mesh))
        B = inp["sess.live"].shape[1]
        for tag, be in (("sharded", many), ("single", one)):
            st = be.init_session_state(B)
            for i in (0, 1):
                st = be.step_sessions(wts, _t(inp[f"sess.raster{i}"]), _t(inp["sess.live"]),
                                      _t(inp["sess.valid"]), st)
            for k in STATE_KEYS:
                out[f"sess.{mode}.{tag}.{k}"] = _np(st[k])

    # the engine over the mesh
    params = dict(_weights(inp, "braille"), alpha=_t(inp["braille.alpha"]))
    reqs = [inp[f"req.{i}"] for i in range(int(inp["req.n"]))]
    bcfg = braille_cfg()
    eng = BatchedEngine(bcfg, params, device="cpu", runtime=RuntimeConfig(mesh=mesh),
                        max_batch=8, tick_granularity=32)
    res, _ = eng.serve(iter(reqs))
    out["engine.rid"] = np.array([r.rid for r in res])
    out["engine.pred"] = np.array([r.pred for r in res])
    out["engine.logits"] = np.stack([np.asarray(r.logits) for r in res])
    out["engine.num_devices"] = np.int64(eng.engine.num_devices)
    snaps = sessions(eng, reqs)
    out["engine.sess.logits"] = np.stack([np.asarray(x.logits) for x in snaps])
    out["engine.sess.pred"] = np.array([x.pred for x in snaps])
    eng2 = BatchedEngine(bcfg, params, device="cpu", runtime=RuntimeConfig(mesh=mesh))
    out["engine.max_batch"] = np.int64(eng2.max_batch)
    out["engine.max_batch_for"] = np.int64(max_batch_for(
        bcfg, num_devices=eng2.engine.num_devices))

    # the per-rank decisions taken once over the mesh, then a sticky fault
    # on the last rank
    sides = {}
    for shape in AGREE_SHAPES:
        tag = shape_tag(shape)
        cfg = Presets.braille(n_classes=3, num_ticks=shape[0], quantized=shape[1])
        p = params_from_jax({k[len(f"agree.w.{tag}."):]: v for k, v in inp.items()
                             if k.startswith(f"agree.w.{tag}.")}, device="cpu")
        sides[shape] = PortSide(cfg, p, [inp[f"agree.req.T{shape[0]}.{i}"]
                                         for i in range(AGREE_REQUESTS)], mesh)
    out.update(run_agreement(sides, rank, world))
    out.update(run_sticky(sides[AGREE_SHAPES[0]], rank, world))
    out["control.exchanges"] = np.int64(eng2.engine.control.exchanges)

    if world > 1:
        # sharing: an equal (distinct) mesh shares, another mesh is refused
        be = ExecutionBackend(fcfg, device="cpu", runtime=RuntimeConfig(mesh=mesh))
        other = mesh_over(range(world - 1), "cpu")
        out["share.equal"] = np.bool_(as_backend(fcfg, be, runtime=RuntimeConfig(
            mesh=make_data_mesh(device="cpu"))) is be)
        try:
            as_backend(fcfg, be, runtime=RuntimeConfig(mesh=other))
            out["share.other_refused"] = np.bool_(False)
        except ValueError:
            out["share.other_refused"] = np.bool_(True)
        # resize and the elastic drop of the last rank, grid commits alike
        single = ExecutionBackend(qcfg, device="cpu", runtime=RuntimeConfig(
            commit_grid=DW_COMMIT_SPEC))
        out["resize.num_devices"] = np.int64(single.resize(mesh).num_devices)
        out["resize.same"] = np.bool_(gsh.resize(mesh) is gsh)
        resized, smesh = survive_data_failure(gsh, [world - 1])
        out["survive.mesh_size"] = np.int64(smesh.size() if smesh is not None else 1)
        if resized is None:
            out["survive.dropped"] = np.bool_(True)
        else:
            out["survive.dropped"] = np.bool_(False)
            out["survive.num_devices"] = np.int64(resized.num_devices)
            dw, _ = resized.train_tile(qw, *args)
            for k, v in dw.items():
                out[f"survive.dw.{k}"] = _np(v)
    np.savez(f"{out_dir}/w{world}_r{rank}.npz", **out)
