"""What each rank of a gloo world runs for ``tests/test_torch_distributed.py``.

:func:`spawn_world` starts a world from one process with
``torch.multiprocessing`` and a ``file://`` rendezvous (no TCP port to
collide with a neighbour's).  The spawned ranks import this module by
name, so it imports neither JAX nor the JAX package: the ranks load their inputs
from the parent's npz, run the port's data-parallel ops on a ``("data",)``
mesh over the whole world, and each rank writes its outputs to
``<out>/w<world>_r<rank>.npz`` for the parent to hold against the JAX
package (and against the other ranks: every output is replicated).
"""

import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core.backend import ExecutionBackend, RuntimeConfig, as_backend
from repro_torch.core.controller import make_batch_commit_train_fn
from repro_torch.core.quant import DW_COMMIT_SPEC
from repro_torch.core.rsnn import EpropConfig, NeuronConfig, Presets, RSNNConfig
from repro_torch.distributed.elastic import survive_data_failure
from repro_torch.kernels.launch import KernelLaunchError
from repro_torch.launch.mesh import join_world, leave_world, make_data_mesh, mesh_over
from repro_torch.optim.eprop_opt import EpropSGD, EpropSGDConfig
from repro_torch.serve import BatchedEngine
from repro_torch.serve.batching import max_batch_for
from repro_torch.serve.engine import PER_RANK_OPTIONS

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


def _refused(fn) -> np.bool_:
    try:
        fn()
    except ValueError:
        return np.bool_(True)
    return np.bool_(False)


def _refusals(cfg, params, mesh, eng, events):
    """Which per-rank decisions the engine over ``mesh`` refuses: each of
    ``PER_RANK_OPTIONS``, a per-call deadline, and a lane restart after a
    (recoverable on one device) launch fault."""
    out = {}
    for name in PER_RANK_OPTIONS:
        value = (lambda model_id, kind: None) if name == "fault_hook" else 1.0
        out[f"refuse.{name}"] = _refused(lambda: BatchedEngine(
            cfg, params, device="cpu", runtime=RuntimeConfig(mesh=mesh), **{name: value}))
    out["refuse.submit.deadline_s"] = _refused(lambda: eng.submit(events, deadline_s=1.0))
    out["refuse.open_session.deadline_s"] = _refused(
        lambda: eng.open_session(deadline_s=1.0))
    fault = KernelLaunchError("rsnn_infer", 1, "invalid value")
    out["refuse.launch_fault"] = np.bool_(not eng._recoverable(eng._lane(), fault))
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
    out.update(_refusals(bcfg, params, mesh, eng2, reqs[0]))

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
