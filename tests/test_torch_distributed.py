"""The port's data-parallel slice against the JAX package, on gloo worlds of
1, 4 and 8 CPU ranks.

One world of each size is spawned once for the module
(``tests/_torch_dist_ranks.py:spawn_world``: ``torch.multiprocessing`` with
a ``file://`` rendezvous in ``tmp_path``, so no TCP port can collide, and
a group timeout of ``GROUP_TIMEOUT_S``); every rank runs
``tests/_torch_dist_ranks.py:run_cases`` on the same inputs, drawn here
from a numpy seed at a small size, and writes its outputs.  Every output
is replicated: each rank's must equal rank 0's bitwise.  Rank 0's are held
to the JAX package's single-device ``ExecutionBackend`` (the scan backend;
the Pallas kernel in interpret mode at T <= 32, B <= 8) with the
tolerances of the JAX tests they mirror (``tests/test_backend.py:340-476``):

* sharded ``train_tile`` at a ragged B=11 (label delay 0 and 4): ``dw`` at
  ``rtol=2e-5, atol=1e-6``, ``acc_y`` at ``rtol=1e-5, atol=1e-6``, ``pred``
  equal, ``spike_rate`` at ``rtol=1e-6``;
* inference at B=13, the same; quantized inference bitwise;
* one END_B commit's weights at ``rtol=1e-5, atol=1e-6``;
* the engine over the mesh, request for request, admission
  ``max_batch_for(cfg, num_devices)``;
* the sharing check on an equal mesh.

The integer commit grid (``tests/test_fault_tolerance.py:236-264``): a
5 + 3 split commits bitwise like the whole; the 1-, 4- and 8-rank grid
commits are bitwise equal within the port (and to the unsharded commit);
the grid commit is within the float commit's ``dw`` tolerance plus
``B * lsb`` of JAX's ``commit_grid=DW_COMMIT_SPEC`` commit (each of the B
samples' codes may round the other way).  Sessions: sharded equal
unsharded bitwise when quantized, to ``FLOAT_TOL`` in float mode (the
reference's float chunk claims are the known failures of ROADMAP C).

The engine's per-rank decisions (``ranks.AGREE_SCENARIOS``): request and
session deadlines and an idle sweep on clocks skewed by ``ranks.SKEW_S``
seconds a rank, whole-sample and streaming launch faults (recovered, and
the budget exhausted) from a fault hook armed on the last rank alone or on
every rank.  Every rank's observations equal rank 0's bitwise, and rank
0's equal the same scenario on the JAX engine on one device with rank 0's
clock and the union of the hooks' faults: statuses, ids, preds and
counters equal, logits bitwise when quantized and to ``FLOAT_TOL``
otherwise.  A sticky launcher error on the last rank makes every rank
raise (the last its own error, the others ``RankFaultError`` naming it)
well inside ``GROUP_TIMEOUT_S``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import aer as jaer
from repro.core.backend import ExecutionBackend as JaxBackend
from repro.core.backend import RuntimeConfig as JaxRuntime
from repro.core.controller import make_batch_commit_train_fn as jax_commit_fn
from repro.core.quant import DW_COMMIT_SPEC as JAX_DW_COMMIT_SPEC
from repro.core.rsnn import Presets as JaxPresets
from repro.core.rsnn import RSNNConfig as JaxRSNNConfig
from repro.core.rsnn import init_params as jax_init
from repro.core.rsnn import trainable as jax_trainable
from repro.core.eprop import EpropConfig as JaxEpropConfig
from repro.core.neuron import NeuronConfig as JaxNeuronConfig
from repro.data.braille import BrailleConfig, make_braille_dataset
from repro.data.pipeline import EventStream
from repro.optim.eprop_opt import EpropSGD as JaxEpropSGD
from repro.optim.eprop_opt import EpropSGDConfig as JaxEpropSGDConfig
from repro.serve import BatchedEngine as JaxEngine
from repro.serve import ServeStatus as JaxServeStatus

import _torch_dist_ranks as ranks
from repro_torch.core.backend import ExecutionBackend, RuntimeConfig
from repro_torch.core.quant import DW_COMMIT_SPEC
from repro_torch.distributed.elastic import best_data_mesh_from, survive_data_failure
from repro_torch.launch import mesh as meshlib
from repro_torch.serve.batching import max_batch_for

WORLDS = (1, 4, 8)
GROUP_TIMEOUT_S = 60.0
FLOAT_TOL = dict(rtol=1e-4, atol=1e-4)
DW_TOL = 1e-4       # tests/test_torch_train.py: max|Δdw| <= DW_TOL * max|dw|
SEED = 31


def _supervision(T, B, delay=0):
    t = np.arange(T)[:, None]
    return (((t >= T // 4 + delay) & (t <= T - 1)).astype(np.float32)
            * np.ones((T, B), np.float32))


def _train_tile(rng, T, B, n_in, n_out, delay=0):
    raster = (rng.random((T, B, n_in)) < 0.3).astype(np.float32)
    label = rng.integers(0, n_out, B)
    return raster, label, np.eye(n_out, dtype=np.float32)[label], _supervision(T, B, delay)


def _jax_float_cfg():
    return JaxRSNNConfig(n_in=10, n_hid=16, n_out=3, num_ticks=18,
                         neuron=JaxNeuronConfig(alpha=0.9, kappa=0.45, reset="zero"),
                         eprop=JaxEpropConfig(mode="factored", feedback="symmetric"))


def _np_tree(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _j(x):
    return jnp.asarray(x)


class _JaxSide:
    """The JAX engine on one device, with the face of ``ranks.PortSide``."""

    def __init__(self, cfg, params, reqs):
        self.cfg, self.params, self.reqs = cfg, params, reqs

    def engine(self, **kw):
        return JaxEngine(self.cfg, self.params, backend="scan", **kw)

    def status(self, name):
        return getattr(JaxServeStatus, name)


def _agreement_inputs(inp):
    """The per-rank-decision scenarios' weights and requests (into ``inp``)
    and their run on the JAX engine with rank 0's clock and the armed hook
    (the union of the ranks' hook faults in every case)."""
    rng = np.random.default_rng(SEED + 1)
    reqs = {}
    for T in sorted({shape[0] for shape in ranks.AGREE_SHAPES}):
        reqs[T] = []
        for i in range(ranks.AGREE_REQUESTS):
            ticks = int(rng.integers(12, T + 1))
            raster = (rng.random((ticks, 12)) < 0.25).astype(np.float32)
            ev = np.asarray(jaer.encode_sample(raster, i % 3, label_tick=ticks // 4,
                                               end_tick=ticks - 1), np.uint32)
            reqs[T].append(ev[np.argsort(ev & jaer.MAX_TICK, kind="stable")])
            inp[f"agree.req.T{T}.{i}"] = reqs[T][-1]
    sides = {}
    for n, shape in enumerate(ranks.AGREE_SHAPES):
        cfg = JaxPresets.braille(n_classes=3, num_ticks=shape[0], quantized=shape[1])
        params = jax_init(jax.random.key(40 + n), cfg)
        inp.update({f"agree.w.{ranks.shape_tag(shape)}.{k}": np.asarray(v)
                    for k, v in params.items()})
        sides[shape] = _JaxSide(cfg, params, reqs[shape[0]])
    ref = {}
    for name, fn, shape, arms in ranks.AGREE_SCENARIOS:
        # one run serves every arming: the union of the faults is the
        # armed hook's in each
        obs = fn(sides[shape], ranks.Clock(0),
                 lambda fail_on, kinds=("tile", "stream"): ranks.flaky_hook(fail_on, kinds))
        for arm in arms:
            ref[name, arm] = ranks.flat(obs, f"agree.{name}.{arm}")
    return ref


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The inputs, the JAX references, and each world's rank outputs."""
    root = tmp_path_factory.mktemp("dist")
    rng = np.random.default_rng(SEED)
    inp, ref = {}, {}
    fcfg = _jax_float_cfg()
    fw = _np_tree(jax_trainable(jax_init(jax.random.key(20), fcfg)))
    inp.update({f"float.{k}": v for k, v in fw.items()})
    jw = {k: _j(v) for k, v in fw.items()}
    scan = JaxBackend(fcfg, "scan")
    for tag, B, delay, be in (("train_d0", 11, 0, scan), ("train_d4", 11, 4, scan),
                              ("train_b8", 8, 0, JaxBackend(fcfg, "kernel"))):
        raster, _, y_star, valid = _train_tile(rng, 18, B, 10, 3, delay)
        inp.update({f"{tag}.raster": raster, f"{tag}.y_star": y_star,
                    f"{tag}.valid": valid})
        dw, m = be.train_tile(jw, _j(raster), _j(y_star), _j(valid))
        ref[tag] = (_np_tree(dw), _np_tree(m))
    raster, _, _, valid = _train_tile(rng, 18, 13, 10, 3)
    inp.update({"infer.raster": raster, "infer.valid": valid})
    ref["infer"] = _np_tree(scan.inference(jw, _j(raster), _j(valid)))

    qcfg = JaxPresets.braille(n_classes=3, num_ticks=24, quantized=True)
    qw = {k: np.asarray(v) * 4.0 for k, v in jax_trainable(
        jax_init(jax.random.key(24), qcfg)).items()}
    inp.update({f"quant.{k}": v for k, v in qw.items()})
    raster = (rng.random((24, 8, qcfg.n_in)) < 0.5).astype(np.float32)
    valid = ((np.arange(24)[:, None] >= 6) * np.ones((24, 8))).astype(np.float32)
    inp.update({"qinfer.raster": raster, "qinfer.valid": valid})
    ref["qinfer"] = {name: np.asarray(JaxBackend(qcfg, name).inference(
        {k: _j(v) for k, v in qw.items()}, _j(raster), _j(valid))["acc_y"])
        for name in ("scan", "kernel")}

    raster, label, _, valid = _train_tile(rng, 18, 6, 10, 3)
    inp.update({"commit.raster": raster, "commit.label": label, "commit.valid": valid})
    opt = JaxEpropSGD(JaxEpropSGDConfig(lr=0.02, clip=10.0))
    batch = {"raster": _j(raster.swapaxes(0, 1)), "label": _j(label),
             "valid": _j(valid.swapaxes(0, 1))}
    new_w, _, _ = jax_commit_fn(fcfg, opt, scan)(jw, opt.init(jw), batch,
                                                jax.random.key(0))
    ref["commit"] = _np_tree(new_w)

    grid = {"raster": (rng.random((24, 8, qcfg.n_in)) < 0.08).astype(np.float32),
            "y_star": np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)],
            "valid": np.ones((24, 8), np.float32)}
    inp.update({f"grid.{k}": v for k, v in grid.items()})
    jgrid = JaxBackend(qcfg, runtime=JaxRuntime(backend="scan",
                                                commit_grid=JAX_DW_COMMIT_SPEC))
    ref["grid"] = _np_tree(jgrid.train_tile({k: _j(v) for k, v in qw.items()},
                                            *(_j(grid[k]) for k in ("raster", "y_star",
                                                                    "valid")))[0])

    bcfg = JaxPresets.braille(n_classes=3, num_ticks=32)
    bparams = _np_tree(jax_init(jax.random.key(28), bcfg))
    inp.update({f"braille.{k}": bparams[k] for k in ("w_in", "w_rec", "w_out", "alpha")})
    B = 11
    live = np.ones((24, B), np.float32)
    live[5:9, ::3] = 0.0
    live[18:, 1::4] = 0.0
    inp.update({"sess.raster0": (rng.random((24, B, 12)) < 0.2).astype(np.float32),
                "sess.raster1": (rng.random((24, B, 12)) < 0.2).astype(np.float32),
                "sess.live": live, "sess.valid": live * (rng.random((24, B)) < 0.8)})

    data = make_braille_dataset("AEU", BrailleConfig(num_ticks=32, samples_per_class=10))
    reqs = list(EventStream(data, "test"))
    inp.update({f"req.{i}": r for i, r in enumerate(reqs)})
    inp["req.n"] = np.int64(len(reqs))
    res, _ = JaxEngine(bcfg, {k: _j(v) for k, v in bparams.items()}, backend="scan",
                       max_batch=8, tick_granularity=32).serve(iter(reqs))
    ref["engine"] = res

    ref["agree"] = _agreement_inputs(inp)

    in_path = root / "inputs.npz"
    np.savez(in_path, **inp)
    out = {}
    for world in WORLDS:
        ranks.spawn_world(ranks.run_cases, world, (str(in_path), str(root)),
                          str(root / f"rdv{world}"), GROUP_TIMEOUT_S)
        out[world] = [dict(np.load(root / f"w{world}_r{r}.npz")) for r in range(world)]
    return {"inp": inp, "ref": ref, "out": out}


def _rank0(case, world):
    return case["out"][world][0]


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_holds_the_same_outputs(case, world):
    outs = case["out"][world]
    assert int(outs[0]["num_devices"]) == world
    for r, o in enumerate(outs[1:], start=1):
        for k in outs[0]:
            if not k.startswith(("survive.", "share.", "sticky.")):
                np.testing.assert_array_equal(o[k], outs[0][k], err_msg=f"rank {r}: {k}")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("tag", ["train_d0", "train_d4", "train_b8"])
def test_sharded_train_tile_matches_single_device(case, world, tag):
    """train_tile over a data mesh == the JAX single-device op (scan at
    B=11 with label delay 0 and 4; the Pallas kernel in interpret mode at
    B=8): the ranks' summed dw, the gathered acc_y and pred, the global
    spike rate."""
    o = _rank0(case, world)
    dw0, m0 = case["ref"][tag]
    for k in dw0:
        np.testing.assert_allclose(o[f"{tag}.dw.{k}"], dw0[k], rtol=2e-5, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(o[f"{tag}.acc_y"], m0["acc_y"], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(o[f"{tag}.pred"], m0["pred"])
    np.testing.assert_allclose(float(o[f"{tag}.spike_rate"]), float(m0["spike_rate"]),
                               rtol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_inference_matches_single_device(case, world):
    o, r = _rank0(case, world), case["ref"]["infer"]
    np.testing.assert_allclose(o["infer.acc_y"], r["acc_y"], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(o["infer.pred"], r["pred"])
    np.testing.assert_allclose(float(o["infer.spike_rate"]), float(r["spike_rate"]),
                               rtol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_outputs_equal_the_unsharded_port_bitwise(case, world):
    """The gathered per-sample outputs and the spike rate (the ranks'
    integer counts summed) are bitwise the unsharded port's."""
    inp = case["inp"]
    be = ExecutionBackend(ranks.float_cfg(), device="cpu")
    w = {k: torch.tensor(inp[f"float.{k}"]) for k in ("w_in", "w_rec", "w_out")}
    m = be.inference(w, torch.tensor(inp["infer.raster"]), torch.tensor(inp["infer.valid"]))
    o = _rank0(case, world)
    for k in ("acc_y", "pred", "spike_rate"):
        np.testing.assert_array_equal(o[f"infer.{k}"], m[k].numpy(), err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["scan", "kernel"])
def test_sharded_quantized_inference_bit_exact(case, world, name):
    np.testing.assert_array_equal(_rank0(case, world)["qinfer.acc_y"],
                                  case["ref"]["qinfer"][name])


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_batch_commit_matches_single_device_weights(case, world):
    o = _rank0(case, world)
    assert int(o["commit.count"]) == 6
    for k, w in case["ref"]["commit"].items():
        np.testing.assert_allclose(o[f"commit.w.{k}"], w, rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_engine_serves_stream(case, world):
    """BatchedEngine over the mesh: results match the JAX engine request
    for request; default admission is one full launch a rank."""
    o, res = _rank0(case, world), case["ref"]["engine"]
    assert len(o["engine.rid"]) == len(res) > 0
    np.testing.assert_array_equal(o["engine.rid"], [r.rid for r in res])
    np.testing.assert_array_equal(o["engine.pred"], [r.pred for r in res])
    np.testing.assert_allclose(o["engine.logits"], np.stack([r.logits for r in res]),
                               rtol=1e-5, atol=1e-6)
    assert int(o["engine.num_devices"]) == world
    assert int(o["engine.max_batch"]) == int(o["engine.max_batch_for"])
    assert int(o["engine.max_batch"]) == max_batch_for(ranks.braille_cfg()) * world


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_engine_sessions_match_one_device(case, world):
    """Streaming sessions through the engine over the mesh (each fed in two
    halves; the pool scatters the gathered carries) against the same
    sessions on an unsharded port engine: the same predictions, logits to
    FLOAT_TOL (the rows' sums run in another split of the batch)."""
    from repro_torch.serve import BatchedEngine

    inp = case["inp"]
    params = {k: torch.tensor(inp[f"braille.{k}"]) for k in ("w_in", "w_rec", "w_out",
                                                             "alpha")}
    reqs = [inp[f"req.{i}"] for i in range(int(inp["req.n"]))]
    eng = BatchedEngine(ranks.braille_cfg(), params, device="cpu", max_batch=8,
                        tick_granularity=32)
    want = ranks.sessions(eng, reqs)
    o = _rank0(case, world)
    np.testing.assert_array_equal(o["engine.sess.pred"], [x.pred for x in want])
    np.testing.assert_allclose(o["engine.sess.logits"], np.stack([x.logits for x in want]),
                               **FLOAT_TOL)


@pytest.mark.parametrize("world", [4, 8])
def test_shared_sharded_backend_accepts_equal_mesh(case, world):
    for r, o in enumerate(case["out"][world]):
        assert bool(o["share.equal"]), r
        assert bool(o["share.other_refused"]), r


def _grid_inputs(inp, sl=slice(None)):
    return [torch.tensor(inp[f"grid.{k}"][:, sl] if k != "y_star" else inp[f"grid.{k}"][sl])
            for k in ("raster", "y_star", "valid")]


def _grid_backend():
    return ExecutionBackend(ranks.quant_cfg(), device="cpu",
                            runtime=RuntimeConfig(commit_grid=DW_COMMIT_SPEC))


def _quant_weights(inp):
    return {k: torch.tensor(inp[f"quant.{k}"]) for k in ("w_in", "w_rec", "w_out")}


def test_commit_grid_batch_split_invariance(case):
    """Grid commits are exact integer sums: one 8-sample batch commits
    bitwise like the sum of its 5 + 3 split."""
    inp = case["inp"]
    be, w = _grid_backend(), _quant_weights(inp)
    assert be.runtime.commit_grid == DW_COMMIT_SPEC
    full, _ = be.train_tile(w, *_grid_inputs(inp))
    a, _ = be.train_tile(w, *_grid_inputs(inp, slice(0, 5)))
    b, _ = be.train_tile(w, *_grid_inputs(inp, slice(5, None)))
    for k in full:
        assert full[k].abs().max() > 0, k
        np.testing.assert_array_equal((a[k] + b[k]).numpy(), full[k].numpy(), err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
def test_grid_commit_bitwise_across_rank_counts(case, world):
    """The 1-, 4- and 8-rank grid commits of one batch are bitwise equal,
    and equal to the unsharded commit."""
    inp = case["inp"]
    full, m = _grid_backend().train_tile(_quant_weights(inp), *_grid_inputs(inp))
    o = _rank0(case, world)
    for k in full:
        np.testing.assert_array_equal(o[f"grid.dw.{k}"], full[k].numpy(), err_msg=k)
        np.testing.assert_array_equal(o[f"grid.dw.{k}"], _rank0(case, 1)[f"grid.dw.{k}"])
    np.testing.assert_array_equal(o["grid.spike_rate"], m["spike_rate"].numpy())


def test_grid_commit_matches_jax_commit_grid(case):
    """The port's grid commit against JAX's ``commit_grid=DW_COMMIT_SPEC``
    commit: within the float ``dw`` tolerance plus ``B * lsb``."""
    inp = case["inp"]
    got, _ = _grid_backend().train_tile(_quant_weights(inp), *_grid_inputs(inp))
    B = inp["grid.valid"].shape[1]
    for k, want in case["ref"]["grid"].items():
        err = float(np.abs(got[k].numpy() - want).max())
        assert err <= DW_TOL * float(np.abs(want).max()) + B * DW_COMMIT_SPEC.lsb, (k, err)


def test_backend_resize_identity_and_contract(case):
    be = ExecutionBackend(ranks.quant_cfg(), device="cpu")
    assert be.resize(None) is be
    with pytest.raises(ValueError, match="commit grid"):
        be.check_compatible(RuntimeConfig(commit_grid=DW_COMMIT_SPEC))
    for world in (4, 8):
        for o in case["out"][world]:
            assert int(o["resize.num_devices"]) == world and bool(o["resize.same"])


def test_survive_data_failure_resizes_backend(case):
    """Without a world: one survivor, no mesh, the backend itself; no
    survivor raises.  On a world: dropping the last rank resizes the others
    onto a mesh of the rest, whose grid commit is bitwise the full world's;
    the dropped rank gets no backend."""
    be = _grid_backend()
    resized, mesh = survive_data_failure(be, failed_ranks=[])
    assert mesh is None and resized is be
    with pytest.raises(ValueError, match="no surviving"):
        best_data_mesh_from([])
    assert best_data_mesh_from([3]) is None
    for world in (4, 8):
        outs = case["out"][world]
        for r, o in enumerate(outs):
            assert int(o["survive.mesh_size"]) == world - 1
            assert bool(o["survive.dropped"]) == (r == world - 1)
            if r < world - 1:
                assert int(o["survive.num_devices"]) == world - 1
                for k in ("w_in", "w_rec", "w_out"):
                    np.testing.assert_array_equal(o[f"survive.dw.{k}"], o[f"grid.dw.{k}"])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("mode", ["q", "f"])
def test_sharded_sessions_equal_unsharded(case, world, mode):
    """step_sessions over the mesh (carries gathered) against one device,
    two chained tiles with holes in ``live``: bitwise when quantized, to
    FLOAT_TOL in float mode."""
    o = _rank0(case, world)
    for k in ranks.STATE_KEYS:
        got, want = o[f"sess.{mode}.sharded.{k}"], o[f"sess.{mode}.single.{k}"]
        if mode == "q":
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            np.testing.assert_allclose(got, want, **FLOAT_TOL, err_msg=k)
    assert np.abs(o[f"sess.{mode}.single.acc_y"]).max() > 0


AGREE_CASES = [(name, arm, shape[1]) for name, _, shape, arms in ranks.AGREE_SCENARIOS
               for arm in arms]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name,arm,quantized", AGREE_CASES,
                         ids=[f"{n}-{a}" for n, a, _ in AGREE_CASES])
def test_rank_decisions_match_one_device(case, world, name, arm, quantized):
    """Over a mesh, rank 0's clock decides expiry, session deadlines and the
    idle offload, and a hook fault on any rank (the last alone, or every
    one) faults the launch on all ranks, which restart together: every
    rank's observations equal rank 0's bitwise, and rank 0's equal the JAX
    engine's on one device with rank 0's clock and the union of the hooks'
    faults (logits bitwise when quantized, else to FLOAT_TOL)."""
    want = case["ref"]["agree"][name, arm]
    outs = case["out"][world]
    prefix = f"agree.{name}.{arm}."
    got = {k: v for k, v in outs[0].items() if k.startswith(prefix)}
    assert set(got) == set(want) and want
    for k, w in want.items():
        if k.endswith(".logits") and not quantized:
            np.testing.assert_allclose(got[k], w, err_msg=k, **FLOAT_TOL)
        elif w.dtype.kind == "f":
            np.testing.assert_array_equal(got[k], w.astype(got[k].dtype), err_msg=k)
        else:
            assert got[k].tolist() == w.tolist(), k
    for r, o in enumerate(outs[1:], start=1):
        for k in got:
            np.testing.assert_array_equal(o[k], got[k], err_msg=f"rank {r}: {k}")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("kind", ["tile", "stream"])
def test_sticky_fault_on_one_rank_raises_on_every_rank(case, world, kind):
    """A sticky launcher error on the last rank: that rank raises its own
    error and every other rank a RankFaultError naming it, each well
    inside the group timeout (no rank waits for the all_gather the faulted
    rank never joins); every rank made the same control exchanges."""
    outs = case["out"][world]
    for r, o in enumerate(outs):
        if r == world - 1:
            assert str(o[f"sticky.{kind}.raised"]) == "KernelLaunchError", r
        else:
            assert str(o[f"sticky.{kind}.raised"]) == "RankFaultError", r
            assert int(o[f"sticky.{kind}.rank"]) == world - 1, r
        assert bool(o[f"sticky.{kind}.sticky"]), r
        assert float(o[f"sticky.{kind}.seconds"]) < GROUP_TIMEOUT_S / 4, r
        assert int(o["control.exchanges"]) == int(outs[0]["control.exchanges"]) > 0, r


def test_worlds_pick_their_backend_and_refuse_what_they_cannot_form():
    assert meshlib.dist_backend("cuda") == "nccl" and meshlib.dist_backend("cpu") == "gloo"
    with pytest.raises(ValueError):
        meshlib.dist_backend("meta")
    with pytest.raises(RuntimeError, match="join a world"):
        meshlib.make_data_mesh(device="cpu")


def test_max_batch_for_scales_with_ranks():
    cfg = ranks.braille_cfg()
    assert max_batch_for(cfg, num_devices=4) == 4 * max_batch_for(cfg)
    assert max_batch_for(cfg, num_devices=0) == max_batch_for(cfg)
