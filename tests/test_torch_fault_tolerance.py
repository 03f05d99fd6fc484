"""The port's durability slice against the JAX package: checkpoints,
kill-and-resume and the fault-tolerant trainer, on the CPU (the kernels'
plain versions).

* The checkpoint manager holds ``tests/test_fault_tolerance.py``'s manager
  tests, and its files are exchangeable with
  ``repro.distributed.checkpoint.CheckpointManager`` in both directions:
  the same ``leaves`` list, npz entries and manifest keys.
* Resuming is held *bitwise*: a learner interrupted in-process, and
  subprocess workers killed by SIGKILL at a commit, at a checkpoint's
  rename and by SIGTERM, each end with the weights of the uninterrupted
  run.  Every kill point is fixed or drawn from a seeded generator, and
  the kill waits for the first complete checkpoint.
* The slice against JAX: both packages' ``Trainer`` over
  ``make_eprop_commit_step`` from the same weights and optimizer state,
  round-nearest quantized commits, the same batches.  Tolerance, the one
  ``tests/test_torch_train.py`` holds END_B commits to: the weights' grid
  codes bitwise and the residuals to ``ACC_TOL`` (as
  ``test_eprop_sgd_update_matches_jax``), ``grad_norm`` (the norm of
  ``dw``) to ``DW_TOL`` of its value, ``loss`` (a function of the
  readout, bitwise when quantized) to ``LOSS_RTOL``.  The JAX step runs
  its Pallas kernel in interpret mode.
"""

import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.distributed.checkpoint import (
    CheckpointManager,
    CheckpointPolicy,
    ReplayCursor,
)
from repro_torch.train import chaos

DW_TOL = 1e-4
ACC_TOL = dict(atol=1e-6, rtol=0)
LOSS_RTOL = 1e-6
SEED = 5
SPB = 6      # samples a Trainer step commits

# ------------------------------------------------------------------ manager


def _tree():
    return {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": np.ones((4,), np.int32)}


def test_async_save_error_surfaces_at_next_save(tmp_path, monkeypatch):
    """A failed background write is raised at the *next* save entry,
    blocking or async, not held back until an explicit wait()."""
    from repro_torch.distributed import checkpoint as ckpt_mod

    mgr = CheckpointManager(tmp_path, keep=0)
    mgr.save(1, _tree())
    real = ckpt_mod.np.savez

    def boom(*a, **kw):
        raise OSError("disk gone")

    monkeypatch.setattr(ckpt_mod.np, "savez", boom)
    mgr.save_async(2, _tree())          # fails on the writer thread
    mgr._queue.join()
    monkeypatch.setattr(ckpt_mod.np, "savez", real)
    with pytest.raises(OSError, match="disk gone"):
        mgr.save_async(3, _tree())      # raised here, at the next save
    mgr.wait()
    mgr.save_async(4, _tree())          # the error was cleared once raised
    mgr.wait()

    monkeypatch.setattr(ckpt_mod.np, "savez", boom)
    mgr.save_async(5, _tree())
    mgr._queue.join()
    monkeypatch.setattr(ckpt_mod.np, "savez", real)
    with pytest.raises(OSError, match="disk gone"):
        mgr.save(6, _tree())            # the blocking entry raises it too
    assert mgr.latest_step() == 4


def test_prune_keep_zero_keeps_all(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=0)
    for s in range(1, 6):
        mgr.save(s, _tree())
    assert mgr.all_steps() == [1, 2, 3, 4, 5]
    mgr3 = CheckpointManager(tmp_path / "k3", keep=3)
    for s in range(1, 6):
        mgr3.save(s, _tree())
    assert mgr3.all_steps() == [3, 4, 5]


def test_restore_validates_every_leaf(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, _tree())
    with pytest.raises(ValueError, match=r"\['a'\]"):
        mgr.restore(1, {"a": torch.zeros(3, 2), "b": torch.ones(4, dtype=torch.int32)})
    with pytest.raises(ValueError, match=r"\['b'\].*int32"):
        mgr.restore(1, {"a": np.zeros((2, 3), np.float32), "b": np.ones((4,), np.float32)})
    with pytest.raises(KeyError, match="missing leaf"):
        mgr.restore(1, {"a": np.zeros((2, 3), np.float32), "c": np.zeros((1,), np.float32)})
    tree, manifest = mgr.restore(1, {"b": torch.zeros(4, dtype=torch.int32),
                                     "a": torch.zeros(2, 3)})
    assert manifest["step"] == 1 and list(tree) == ["b", "a"]   # the template's order
    np.testing.assert_array_equal(tree["a"], _tree()["a"])


def test_torn_tmp_and_corrupt_latest_fall_back(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=0)
    mgr.save(1, _tree())
    mgr.save(2, _tree())
    torn = tmp_path / "step_000000007.tmp"
    torn.mkdir()
    (torn / "arrays.npz").write_bytes(b"partial garbage")
    (tmp_path / "LATEST").write_text("step_not_a_number")
    mgr2 = CheckpointManager(tmp_path, keep=0)
    assert not torn.exists()                 # swept at construction
    assert mgr2.latest_step() == 2
    assert mgr2.all_steps() == [1, 2]
    (tmp_path / "LATEST").write_text("step_000000099")
    assert mgr2.latest_step() == 2


def test_quantized_residuals_roundtrip_bitwise(tmp_path):
    """The quantized EpropSGD state (grid weights, float residuals, int32
    sample count) and the generator's state survive a save and restore
    bit for bit, and the save copies: a later in-place change of the live
    tensors does not reach the checkpoint."""
    from repro_torch.core.quant import WEIGHT_SPEC
    from repro_torch.optim.eprop_opt import EpropSGD, EpropSGDConfig

    opt = EpropSGD(EpropSGDConfig(lr=0.01, quant=WEIGHT_SPEC, stochastic_round=True))
    rng = np.random.default_rng(0)
    w = opt.quantize_init({"w": torch.from_numpy(rng.normal(0, 0.3, (6, 5)).astype(np.float32))})
    state = opt.init(w)
    gen = torch.Generator().manual_seed(SEED)
    for i in range(5):
        dw = {"w": torch.from_numpy(np.random.default_rng(i).normal(0, 1e-2, (6, 5))
                                    .astype(np.float32))}
        w, state = opt.update(w, dw, state, gen)
    assert state["count"].dtype == torch.int32 and int(state["count"]) == 5
    live = {"w": w, "state": state, "generator": gen.get_state()}
    want = {k: v.clone() for k, v in w.items()}
    mgr = CheckpointManager(tmp_path)
    mgr.save_async(1, live)
    w["w"].add_(1.0)                         # after the enqueue, before the write
    mgr.wait()
    back, _ = mgr.restore(1, live)
    np.testing.assert_array_equal(back["w"]["w"], want["w"].numpy())
    np.testing.assert_array_equal(back["state"]["acc"]["w"], state["acc"]["w"].numpy())
    assert back["state"]["count"].dtype == np.int32 and int(back["state"]["count"]) == 5
    np.testing.assert_array_equal(back["generator"], gen.get_state().numpy())


def _mixed_tree(rng):
    """A learner-like tree in the port's insertion order (unsorted)."""
    return {"weights": {"w_rec": rng.normal(size=(4, 4)).astype(np.float32),
                        "w_in": rng.normal(size=(3, 4)).astype(np.float32)},
            "opt_state": {"count": np.int32(7),
                          "acc": {"w_rec": rng.normal(size=(4, 4)).astype(np.float32),
                                  "w_in": np.zeros((3, 4), np.float32)}},
            "key": np.array([3, 9], np.uint32),
            "list": [np.ones(2, np.float64), (np.zeros(1, np.int64),)]}


def _as_torch(tree):
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as_torch(v) for v in tree)
    return torch.from_numpy(np.array(tree))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_format_parity_with_jax(tmp_path, writer):
    """A tree written by one package's manager restores through the other's
    bitwise, and both managers write the same ``leaves`` list, npz entries
    and manifest keys for the same tree."""
    from repro.distributed.checkpoint import CheckpointManager as JaxManager

    tree = _mixed_tree(np.random.default_rng(SEED))
    extra = {"cursor": {"epoch": 1, "batch": 2}, "commits": 9}
    JaxManager(tmp_path / "jax", keep=0).save(9, tree, extra)
    CheckpointManager(tmp_path / "port", keep=0).save(9, _as_torch(tree), extra)
    man = {p: json.loads((tmp_path / p / "step_000000009" / "manifest.json").read_text())
           for p in ("jax", "port")}
    assert man["jax"]["leaves"] == man["port"]["leaves"]
    assert man["jax"]["leaves"][0] == "['key']"            # dict keys sorted
    assert "['weights']['w_in']" in man["port"]["leaves"]
    assert set(man["jax"]) == set(man["port"])
    entries = {p: sorted(np.load(tmp_path / p / "step_000000009" / "arrays.npz").files)
               for p in ("jax", "port")}
    assert entries["jax"] == entries["port"]

    if writer == "jax":
        back, manifest = CheckpointManager(tmp_path / "jax").restore(9, _as_torch(tree))
    else:
        back, manifest = JaxManager(tmp_path / "port").restore(9, tree)
    assert manifest["cursor"] == extra["cursor"]
    got = dict(zip(man["jax"]["leaves"], jax.tree.leaves(back)))
    want = dict(zip(man["jax"]["leaves"], jax.tree.leaves(tree)))
    for k in want:
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], want[k])


def test_opt_state_from_jax():
    from repro.core.quant import WEIGHT_SPEC as JW
    from repro.optim.eprop_opt import EpropSGD as JSGD
    from repro.optim.eprop_opt import EpropSGDConfig as JCfg
    from repro_torch.convert import opt_state_from_jax

    w = {"w_in": jnp.ones((2, 3)), "w_out": jnp.zeros((3, 1))}
    js = JSGD(JCfg(momentum=0.9, quant=JW)).init(w)
    js = dict(js, count=jnp.int32(12), acc={"w_in": jnp.full((2, 3), 0.25),
                                            "w_out": jnp.zeros((3, 1))})
    ts = opt_state_from_jax(jax.tree.map(np.asarray, js), device="cpu")
    assert ts["count"].dtype == torch.int32 and int(ts["count"]) == 12
    assert sorted(ts) == ["acc", "count", "mu"]
    np.testing.assert_array_equal(ts["acc"]["w_in"].numpy(), np.full((2, 3), 0.25))
    with pytest.raises(ValueError, match="unknown optimizer state"):
        opt_state_from_jax({"count": np.int32(0), "nu": {}}, device="cpu")


# ------------------------------------------------------------------- cursors


def _pipe(seed=3, spb=8):
    from repro_torch.data.braille import BrailleConfig, make_braille_dataset
    from repro_torch.data.pipeline import make_pipeline

    data = make_braille_dataset("AEU", BrailleConfig(samples_per_class=8, num_ticks=24))
    return make_pipeline("arm", data, samples_per_batch=spb, shuffle_train=True,
                         seed=seed, device="cpu")


def test_epoch_batches_cursor_manifest_roundtrip(tmp_path):
    from repro_torch.train.eprop_step import epoch_batches

    cur = ReplayCursor()
    it = epoch_batches(_pipe(), max_epochs=3, cursor=cur)
    assert len([next(it)["label"] for _ in range(5)]) == 5
    mgr = CheckpointManager(tmp_path)
    mgr.save(5, {"x": np.zeros(1, np.float32)}, extra={"cursor": cur.as_manifest()})
    _, manifest = mgr.restore(5, {"x": np.zeros(1, np.float32)})
    restored = ReplayCursor.from_manifest(manifest["cursor"])
    assert (restored.epoch, restored.batch) == (cur.epoch, cur.batch)
    it2 = epoch_batches(_pipe(), max_epochs=3, cursor=restored)
    rest, replayed = [b["label"] for b in it], [b["label"] for b in it2]
    assert len(rest) == len(replayed) > 0
    for a, b in zip(rest, replayed):
        assert torch.equal(a, b)


# --------------------------------------------------------------- learner

KW = dict(epochs=2, samples_per_class=8, num_ticks=24, spb=12, device="cpu")


def test_learner_checkpoint_resume_bitwise(tmp_path):
    """In-process: a run interrupted at a commit boundary and resumed from
    its checkpoint ends bitwise equal to the uninterrupted run: weights,
    residuals, the int32 sample count and the generator's state."""
    gold_learner, gold_pipe = chaos.build_learner(None, **KW)
    start = {k: w.clone() for k, w in gold_learner.weights.items()}
    gold_learner.fit(gold_pipe)
    for k, w in start.items():      # the commits moved every leaf
        assert not torch.equal(gold_learner.weights[k], w), k

    class Interrupt(Exception):
        pass

    def kill(lrn, commits):
        if commits >= 2:
            raise Interrupt

    a, pipe_a = chaos.build_learner(str(tmp_path), async_save=False, **KW)
    with pytest.raises(Interrupt):
        a.fit(pipe_a, on_commit=kill)
    b, pipe_b = chaos.build_learner(str(tmp_path), async_save=False, **KW)
    b.fit(pipe_b, resume=True)
    assert b.commits == gold_learner.commits == 4
    for k, w in gold_learner.weights.items():
        assert torch.equal(b.weights[k], w), k
    for k, acc in gold_learner.opt_state["acc"].items():
        assert torch.equal(b.opt_state["acc"][k], acc), k
    assert b.opt_state["count"].dtype == torch.int32
    assert int(b.opt_state["count"]) == int(gold_learner.opt_state["count"])
    assert torch.equal(b.generator.get_state(), gold_learner.generator.get_state())
    manifest = b.ckpt.manifest(b.ckpt.latest_step())
    assert manifest["generator_device"] == "cpu" and manifest["mesh_devices"] == 1
    assert "['generator']" in manifest["leaves"]


@pytest.fixture
def cut_checkpoint(tmp_path):
    """A directory holding one quantized END_B learner's checkpoints."""
    kw = dict(KW, epochs=1, samples_per_class=6, spb=9)
    a, pipe = chaos.build_learner(str(tmp_path), async_save=False, **kw)
    a.fit(pipe)
    return tmp_path, kw, a


def test_learner_restore_rejects_contract_mismatch(cut_checkpoint):
    from repro_torch.core.backend import ExecutionBackend
    from repro_torch.core.quant import QuantizedMode

    path, kw, _ = cut_checkpoint
    f, _ = chaos.build_learner(str(path), quantized=False, **kw)
    with pytest.raises(ValueError, match="register contract"):
        f.restore_checkpoint()
    q, _ = chaos.build_learner(str(path), **kw)
    q.backend = ExecutionBackend(q.cfg, device="cpu", quant=QuantizedMode(
        threshold=0x03F0, alpha_reg=0x0FE, kappa_reg=0x40))
    with pytest.raises(ValueError, match="register contract"):
        q.restore_checkpoint()


def test_learner_restore_rejects_commit_mode_mismatch(cut_checkpoint):
    import dataclasses

    path, kw, _ = cut_checkpoint
    s, _ = chaos.build_learner(str(path), **kw)
    s.ctrl = dataclasses.replace(s.ctrl, commit="sample")
    with pytest.raises(ValueError, match="commit='batch'"):
        s.restore_checkpoint()


def test_learner_restore_refuses_a_generator_of_another_device(cut_checkpoint):
    """A checkpoint cut on the card holds a 16-byte Philox state: a learner
    on the CPU refuses it, naming the leaf, and never reseeds; so does the
    per-leaf check when only the array gives it away."""
    path, kw, a = cut_checkpoint
    step = a.ckpt.latest_step()
    d = path / f"step_{step:09d}"
    with np.load(d / "arrays.npz") as z:
        arrays = {k: z[k] for k in z.files}
    arrays["['generator']"] = np.arange(16, dtype=np.uint8)    # a card's seed + offset
    np.savez(d / "arrays.npz", **arrays)
    manifest = json.loads((d / "manifest.json").read_text())
    (d / "manifest.json").write_text(json.dumps(dict(manifest, generator_device="cuda")))
    b, _ = chaos.build_learner(str(path), **kw)
    before = b.generator.get_state()
    card = r"cuda generator's state in its \['generator'\] leaf.*on cpu"
    with pytest.raises(ValueError, match=card):
        b.restore_checkpoint()
    assert torch.equal(b.generator.get_state(), before) and b.commits == 0
    (d / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match=r"\['generator'\]: checkpoint has \(16,\)"):
        b.restore_checkpoint()


def test_learner_checkpoints_do_not_cross_packages(tmp_path):
    """The JAX learner keeps a PRNG key where the port keeps a generator
    state: each package's learner refuses the other's checkpoint at the
    leaf."""
    from repro.train import chaos as jchaos

    kw = dict(epochs=1, samples_per_class=6, num_ticks=24, spb=9)
    j, jpipe = jchaos.build_learner(str(tmp_path / "jax"), async_save=False, **kw)
    j.fit(jpipe)
    t, _ = chaos.build_learner(str(tmp_path / "jax"), **kw, device="cpu")
    with pytest.raises(ValueError, match=r"no \['generator'\] leaf"):
        t.restore_checkpoint()
    a, pipe = chaos.build_learner(str(tmp_path / "port"), async_save=False, **kw,
                                  device="cpu")
    a.fit(pipe)
    j2, _ = jchaos.build_learner(str(tmp_path / "port"), **kw)
    with pytest.raises(KeyError, match=r"\['key'\]"):
        j2.restore_checkpoint()


def test_learner_restore_publishes_to_live_serve_lanes(cut_checkpoint):
    """A restored learner re-publishes its SRAM image into the registry,
    and an engine routed at that model serves the restored weights from
    its next tile."""
    from repro_torch.core.controller import make_infer_fn
    from repro_torch.data.braille import BrailleConfig, make_braille_dataset
    from repro_torch.data.pipeline import EventStream
    from repro_torch.serve import BatchedEngine, ModelRegistry
    from repro_torch.serve.batching import decode_events_host

    path, kw, a = cut_checkpoint
    final = {k: v.clone() for k, v in a.weights.items()}
    reg = ModelRegistry()
    b, _ = chaos.build_learner(str(path), registry=reg, seed=17, **kw)
    eng = BatchedEngine(registry=reg, model_id=b.model_id, device="cpu", max_batch=4,
                        tick_granularity=24)
    swaps = reg.get(b.model_id).swaps
    assert b.restore_checkpoint()
    assert reg.get(b.model_id).swaps == swaps + 1
    for k, v in final.items():
        assert torch.equal(b.weights[k], v), k
    data = make_braille_dataset("AEU", BrailleConfig(samples_per_class=6, num_ticks=24))
    reqs = list(EventStream(data, "test"))
    res, _ = eng.serve(iter(reqs))
    infer = make_infer_fn(b.cfg)
    for r, ev in zip(res, reqs):
        raster, valid, _ = decode_events_host([ev], b.cfg.n_in, r.bucket_ticks,
                                              b.cfg.label_delay)
        o = infer({k: final[k] for k in ("w_in", "w_rec", "w_out")},
                  torch.from_numpy(raster[:, 0]), torch.from_numpy(valid[:, 0]))
        assert r.pred == int(o["pred"])
        np.testing.assert_array_equal(r.logits, o["acc_y"].numpy())


def test_learner_without_policy_refuses_checkpoint_calls():
    learner, _ = chaos.build_learner(None, **KW)
    for call in (learner.save_checkpoint, learner.restore_checkpoint):
        with pytest.raises(ValueError, match="no checkpoint policy"):
            call()


# --------------------------------------------------------------- trainer


def _quadratic_step(term_at=None):
    def step(params, opt_state, batch):
        new = {k: w - 0.1 * (2 * w) for k, w in params.items()}
        if term_at is not None and batch["i"] == term_at:
            os.kill(os.getpid(), signal.SIGTERM)
        loss = sum(torch.sum(w ** 2) for w in params.values())
        return new, {"step": opt_state["step"] + 1}, {
            "loss": loss, "grad_norm": torch.tensor(1.0)}
    return step


def _counter_data():
    i = 0
    while True:
        yield {"i": i}
        i += 1


def test_trainer_sigterm_cuts_final_checkpoint(tmp_path):
    from repro_torch.train.trainer import Trainer, TrainerConfig

    tr = Trainer(_quadratic_step(term_at=3), {"w": torch.ones(4)},
                 {"step": torch.tensor(0, dtype=torch.int32)}, _counter_data(),
                 TrainerConfig(total_steps=100, ckpt_every=1000, ckpt_dir=str(tmp_path)))
    tr.install_signal_handlers()
    try:
        out = tr.run()
    finally:
        tr.restore_signal_handlers()
    assert out["stopped_by_signal"]
    assert 0 < out["step"] < 100
    assert tr.ckpt.latest_step() == out["step"]   # the final blocking save landed
    tr2 = Trainer(_quadratic_step(), {"w": torch.ones(4)},
                  {"step": torch.tensor(0, dtype=torch.int32)}, _counter_data(),
                  TrainerConfig(total_steps=100, ckpt_dir=str(tmp_path)))
    assert tr2.restore()
    assert tr2.step == out["step"]
    assert isinstance(tr2.params["w"], torch.Tensor)
    assert torch.equal(tr2.params["w"], tr.params["w"])
    assert tr2.opt_state["step"].dtype == torch.int32


def test_trainer_checkpoint_policy_and_cursor(tmp_path):
    from repro_torch.train.eprop_step import epoch_batches
    from repro_torch.train.trainer import Trainer, TrainerConfig

    policy = CheckpointPolicy(directory=tmp_path, every=2, keep=0, async_save=False)
    cur = ReplayCursor()
    data = epoch_batches(_pipe(), max_epochs=100, cursor=cur)

    def step(params, opt_state, batch):
        return params, {"step": opt_state["step"] + 1}, {
            "loss": torch.tensor(1.0), "grad_norm": torch.tensor(1.0)}

    zero = torch.tensor(0, dtype=torch.int32)
    tr = Trainer(step, {"w": torch.ones(2)}, {"step": zero}, data,
                 TrainerConfig(total_steps=5), checkpoint=policy, cursor=cur)
    tr.run()
    assert tr.ckpt.all_steps() == [2, 4, 5]      # the policy's cadence + the final save
    cur2 = ReplayCursor()
    tr2 = Trainer(step, {"w": torch.ones(2)}, {"step": zero}, iter([]),
                  TrainerConfig(total_steps=5), checkpoint=policy, cursor=cur2)
    assert tr2.restore()
    assert (cur2.epoch, cur2.batch) == (cur.epoch, cur.batch)


def test_trainer_rolls_back_non_finite_steps(tmp_path):
    from repro_torch.train.trainer import Trainer, TrainerConfig

    def step(params, opt_state, batch):
        bad = batch["i"] in (1, 2)
        return {"w": params["w"] + 1}, opt_state, {
            "loss": torch.tensor(float("nan") if bad else 1.0),
            "grad_norm": torch.tensor(float("inf") if batch["i"] == 4 else 1.0)}

    tr = Trainer(step, {"w": torch.zeros(1)}, {}, _counter_data(),
                 TrainerConfig(total_steps=3, ckpt_dir=str(tmp_path), max_bad_steps=2))
    out = tr.run()
    assert out["rejected_steps"] == 3 and float(tr.params["w"]) == 3.0
    tr = Trainer(step, {"w": torch.zeros(1)}, {}, _counter_data(),
                 TrainerConfig(total_steps=3, ckpt_dir=str(tmp_path / "b"),
                               max_bad_steps=1))
    with pytest.raises(RuntimeError, match="2 consecutive non-finite steps"):
        tr.run()


def test_eprop_commit_step_refuses_stochastic_commits():
    from repro_torch.core.quant import WEIGHT_SPEC
    from repro_torch.core.rsnn import Presets
    from repro_torch.optim.eprop_opt import EpropSGD, EpropSGDConfig
    from repro_torch.train.eprop_step import make_eprop_commit_step

    opt = EpropSGD(EpropSGDConfig(quant=WEIGHT_SPEC, stochastic_round=True))
    with pytest.raises(ValueError, match="stochastic"):
        make_eprop_commit_step(Presets.braille(num_ticks=8), opt, "cpu")


def _trainer_case(T=24, spc=8, spb=SPB, seed=SEED, w0=None):
    """Both packages' configs, optimizers, round-nearest quantized
    commits, one set of initial weights (``w0``, else drawn from
    ``seed``) and their pipelines shuffled by ``seed``."""
    from repro.core.quant import WEIGHT_SPEC as JW
    from repro.core.rsnn import Presets as JPresets
    from repro.data.braille import BrailleConfig as JBC
    from repro.data.braille import make_braille_dataset as jmake
    from repro.data.pipeline import make_pipeline as jpipe
    from repro.optim.eprop_opt import EpropSGD as JSGD
    from repro.optim.eprop_opt import EpropSGDConfig as JCfg
    from repro_torch.core.quant import WEIGHT_SPEC
    from repro_torch.core.rsnn import Presets
    from repro_torch.data.braille import BrailleConfig, make_braille_dataset
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.optim.eprop_opt import EpropSGD, EpropSGDConfig

    if w0 is None:
        rng = np.random.default_rng(seed)
        shapes = {"w_in": (12, 38), "w_rec": (38, 38), "w_out": (38, 3)}
        w0 = {k: (np.round(2.5 * rng.normal(size=s) / np.sqrt(s[0]) * 16) / 16)
              .astype(np.float32) for k, s in shapes.items()}
    kw = dict(lr=0.01, clip=10.0)
    jax_side = (JPresets.braille(n_classes=3, num_ticks=T, quantized=True),
                JSGD(JCfg(quant=JW, **kw)),
                jpipe("arm", jmake("AEU", JBC(num_ticks=T, samples_per_class=spc)),
                      samples_per_batch=spb, shuffle_train=True, seed=seed))
    port_side = (Presets.braille(n_classes=3, num_ticks=T, quantized=True),
                 EpropSGD(EpropSGDConfig(quant=WEIGHT_SPEC, **kw)),
                 make_pipeline("arm", make_braille_dataset(
                     "AEU", BrailleConfig(num_ticks=T, samples_per_class=spc)),
                     samples_per_batch=spb, shuffle_train=True, seed=seed, device="cpu"))
    return w0, jax_side, port_side


def _hold_trainer_to_jax(tmp_path, steps, spb, case):
    """The same weights (``params_from_jax``) and optimizer state
    (``opt_state_from_jax``) through both packages' ``Trainer`` over
    ``make_eprop_commit_step``, the same batches, held to the module's
    stated tolerance step by step and at the end.  Returns the port's
    trainer."""
    from repro.train.eprop_step import epoch_batches as jbatches
    from repro.train.eprop_step import make_eprop_commit_step as jstep
    from repro.train.trainer import Trainer as JTrainer
    from repro.train.trainer import TrainerConfig as JTrainerConfig
    from repro_torch.convert import opt_state_from_jax, params_from_jax
    from repro_torch.train.eprop_step import epoch_batches, make_eprop_commit_step
    from repro_torch.train.trainer import Trainer, TrainerConfig

    w0, (jcfg, jopt, jpipe), (tcfg, topt, tpipe) = case
    jw = {k: jnp.asarray(v) for k, v in w0.items()}
    js = jopt.init(jw)
    jtr = JTrainer(jstep(jcfg, jopt, "kernel"), jw, js, jbatches(jpipe),
                   JTrainerConfig(total_steps=steps, ckpt_dir=str(tmp_path / "jax"),
                                  log_every=1))
    tr = Trainer(make_eprop_commit_step(tcfg, topt, "cpu"),
                 params_from_jax(w0, device="cpu"),
                 opt_state_from_jax(jax.tree.map(np.asarray, js), device="cpu"),
                 epoch_batches(tpipe),
                 TrainerConfig(total_steps=steps, ckpt_dir=str(tmp_path / "port"),
                               log_every=1))
    jout, tout = jtr.run(), tr.run()
    assert jout["step"] == tout["step"] == steps
    assert tout["rejected_steps"] == jout["rejected_steps"] == 0
    # every step's log entry; the straggler watchdog's extra entries come
    # from the host's wall clock (a step slowed by other processes), not
    # from either package's arithmetic
    jlog, tlog = ([h for h in t.metrics.history if "straggler" not in h.metrics]
                  for t in (jtr, tr))
    assert len(tlog) == len(jlog) == steps
    for js_, ts_ in zip(jlog, tlog):
        j, t = js_.metrics, ts_.metrics
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=LOSS_RTOL)
        assert abs(t["grad_norm"] - j["grad_norm"]) <= DW_TOL * j["grad_norm"]
        assert round(t["accuracy"] * spb) == round(j["accuracy"] * spb)   # the count
    for k in w0:
        np.testing.assert_array_equal(tr.params[k].numpy() * 16,
                                      np.asarray(jtr.params[k]) * 16)   # grid codes
        np.testing.assert_allclose(tr.opt_state["acc"][k].numpy(),
                                   np.asarray(jtr.opt_state["acc"][k]), **ACC_TOL)
    assert int(tr.opt_state["count"]) == int(jtr.opt_state["count"])
    return tr


def test_trainer_eprop_commit_step_matches_jax(tmp_path):
    """The slice against JAX at a small shape (T=24, 6 samples a step)."""
    _hold_trainer_to_jax(tmp_path, 6, SPB, _trainer_case())


def test_trainer_eprop_commit_step_matches_jax_at_the_drill_shape(tmp_path):
    """The slice against JAX at the kill-and-resume drill's Trainer shape
    (T=128, the default AEU split, 70 samples a step, 12 steps, the
    weights ``init_params`` draws from seed 11, the pipeline shuffled by
    seed 3): the per-step loss that drill reports on the card, rise and
    all, is the reference's, and the commits move every leaf."""
    from repro_torch.core.quant import WEIGHT_SPEC
    from repro_torch.core.rsnn import Presets, init_params, trainable
    from repro_torch.optim.eprop_opt import EpropSGD, EpropSGDConfig

    opt = EpropSGD(EpropSGDConfig(lr=0.01, clip=10.0, quant=WEIGHT_SPEC))
    cfg = Presets.braille(n_classes=3, num_ticks=128, quantized=True)
    w0 = {k: v.numpy() for k, v in opt.quantize_init(trainable(init_params(
        torch.Generator().manual_seed(11), cfg, device="cpu"))).items()}
    tr = _hold_trainer_to_jax(tmp_path, 12, 70,
                              _trainer_case(T=128, spc=200, spb=70, seed=3, w0=w0))
    for k, w in w0.items():
        assert not np.array_equal(tr.params[k].numpy(), w), k


def test_trainer_eprop_commit_step_resumes_bitwise(tmp_path):
    """The Trainer over make_eprop_commit_step, stopped by SIGTERM and
    resumed from its checkpoint in-process, ends bitwise on the
    uninterrupted run."""
    from repro_torch.convert import params_from_jax
    from repro_torch.train.eprop_step import epoch_batches, make_eprop_commit_step
    from repro_torch.train.trainer import Trainer, TrainerConfig

    steps = 6

    def trainer(directory, stop_at=None):
        w0, _, (tcfg, topt, tpipe) = _trainer_case()
        w = params_from_jax(w0, device="cpu")
        fn = make_eprop_commit_step(tcfg, topt, "cpu")
        calls = [0]

        def step(params, opt_state, batch):
            out = fn(params, opt_state, batch)
            calls[0] += 1
            if calls[0] == stop_at:
                os.kill(os.getpid(), signal.SIGTERM)
            return out

        cur = ReplayCursor()
        policy = CheckpointPolicy(directory=directory, every=1, keep=0)
        return Trainer(step, w, topt.init(w), epoch_batches(tpipe, cursor=cur),
                       TrainerConfig(total_steps=steps), checkpoint=policy, cursor=cur)

    gold = trainer(tmp_path / "gold")
    start = {k: w.clone() for k, w in gold.params.items()}
    gold.run()
    # the commits moved the weights (w_out's round-nearest updates stay
    # under half a grid step at this size)
    assert any(not torch.equal(gold.params[k], w) for k, w in start.items())
    a = trainer(tmp_path / "run", stop_at=3)
    a.install_signal_handlers()
    try:
        out = a.run()
    finally:
        a.restore_signal_handlers()
    assert out["stopped_by_signal"] and out["step"] < steps
    b = trainer(tmp_path / "run")
    assert b.restore() and b.step == out["step"]
    assert b.run()["step"] == steps
    for k, w in gold.params.items():
        assert torch.equal(b.params[k], w), k
        assert torch.equal(b.opt_state["acc"][k], gold.opt_state["acc"][k]), k


# ------------------------------------------------------------ chaos (subproc)

WARGS = ["--epochs", "2", "--samples-per-class", "8", "--ticks", "32", "--spb", "12",
         "--device", "cpu"]
GOLD_KW = dict(epochs=2, samples_per_class=8, num_ticks=32, spb=12, device="cpu")


def _assert_bitwise(gold, out, res, **kw):
    start, _ = chaos.build_learner(None, **GOLD_KW, **kw)     # never fit
    for k, w in start.weights.items():      # golden moved every leaf
        assert not np.array_equal(gold[k], w.numpy()), k
    got = chaos.load_result_weights(out)
    assert sorted(got) == sorted(gold)
    for k in gold:
        np.testing.assert_array_equal(got[k], gold[k])
    assert res["device"] == "cpu" and res["rsnn_train"] == 0    # the plain versions
    assert all(s["status"]["device"] == "cpu" for s in res["spawns"] if s["status"])


def test_chaos_sigkill_at_commit_boundary(tmp_path):
    """SIGKILL at a seeded commit boundary, once a checkpoint is on disk;
    the restart resumes from it and ends bitwise on the golden run."""
    gold = chaos.golden_run(**GOLD_KW)
    kill_at = int(np.random.default_rng(SEED).integers(1, 4))
    out = str(tmp_path / "result")
    res = chaos.run_chaos(str(tmp_path / "ck"), out, ["--kill-at-commit", kill_at], WARGS)
    assert res["spawns"][0]["rc"] == -signal.SIGKILL
    assert res["restarts"] >= 1 and res["resumed_from"] is not None
    _assert_bitwise(gold, out, res)


def test_chaos_sigkill_mid_save_torn_tmp(tmp_path):
    """SIGKILL at step 2's rename: the restart sweeps the torn ``.tmp``,
    resumes from the newest complete step and lands bitwise on golden."""
    gold = chaos.golden_run(**GOLD_KW)
    out = str(tmp_path / "result")
    res = chaos.run_chaos(str(tmp_path / "ck"), out, ["--kill-mid-save-step", 2], WARGS)
    assert not list((tmp_path / "ck").glob("*.tmp"))
    assert res["resumed_from"] is not None and res["resumed_from"] < 2
    _assert_bitwise(gold, out, res)


def test_chaos_sigterm_graceful_drill(tmp_path):
    """SIGTERM: the worker finishes the batch, cuts a final blocking
    checkpoint and exits with STOPPED_RC; the restart ends bitwise on
    golden."""
    gold = chaos.golden_run(**GOLD_KW)
    out = str(tmp_path / "result")
    res = chaos.run_chaos(str(tmp_path / "ck"), out, ["--sigterm-at-commit", 2], WARGS)
    assert res["spawns"][0]["rc"] == chaos.STOPPED_RC
    assert res["resumed_from"] == 2
    _assert_bitwise(gold, out, res)


def test_chaos_float_sparse_sync_drill_resumes_bitwise(tmp_path):
    """The drill under the reference worker's other flags: float weights,
    seed 5, a blocking checkpoint every second commit.  SIGKILL at commit
    3 finds step 2 on disk; the restart resumes from it, cuts only even
    steps and ends bitwise on the golden run of the same learner."""
    kw = dict(quantized=False, seed=5)
    gold = chaos.golden_run(**GOLD_KW, **kw)
    out = str(tmp_path / "result")
    res = chaos.run_chaos(str(tmp_path / "ck"), out, ["--kill-at-commit", 3],
                          WARGS + ["--float", "--every", "2", "--sync", "--seed", "5"])
    assert res["spawns"][0]["rc"] == -signal.SIGKILL
    assert res["resumed_from"] == 2
    steps = [int(p.name.split("_")[1]) for p in (tmp_path / "ck").glob("step_*")]
    assert steps and all(s % 2 == 0 for s in steps)
    _assert_bitwise(gold, out, res, **kw)


def test_worker_takes_every_reference_flag_but_backend(tmp_path, monkeypatch):
    """Every flag of the reference worker (``python -m repro.train.chaos``)
    but ``--backend`` (the port dispatches by ``--device``) parses in the
    port's worker to the value the reference's parser gives the same
    command line."""
    from repro.train import chaos as jchaos

    seen = {}
    monkeypatch.setattr(jchaos, "run_worker", lambda a: seen.setdefault("args", a) and 0)
    argv = ["--ckpt-dir", str(tmp_path), "--out", str(tmp_path / "o"), "--float",
            "--epochs", "2", "--spb", "12", "--samples-per-class", "8", "--ticks", "32",
            "--seed", "5", "--mesh-devices", "2", "--deterministic", "--every", "3",
            "--sync", "--kill-at-commit", "4", "--kill-mid-save-step", "2",
            "--sigterm-at-commit", "6"]
    jchaos.main(argv)
    ref = vars(seen["args"])
    assert set(ref) - {"backend"} == {a.lstrip("-").replace("-", "_")
                                      for a in argv if a.startswith("--")}
    port = vars(chaos.parse_args(argv))
    for k, v in ref.items():
        if k != "backend":
            assert port[k] == v, k
    defaults = chaos.parse_args(["--ckpt-dir", str(tmp_path)])
    assert (defaults.float, defaults.seed, defaults.every, defaults.sync) == (
        False, 3, 1, False)


def test_kill_waits_for_a_checkpoint_and_fails_loudly(tmp_path):
    mgr = CheckpointManager(tmp_path)
    with pytest.raises(RuntimeError, match="no complete checkpoint"):
        chaos._wait_for_checkpoint(mgr, 0.05)
    mgr.save(3, _tree())
    assert chaos._wait_for_checkpoint(mgr, 0.05) == 3


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def test_chaos_elastic_shrink_8_to_4(tmp_path):
    """The elastic drill: SIGKILL one rank of an 8-rank gloo world at a
    seeded commit (once rank 0's checkpoint is on disk), restart on 4
    ranks.  With the integer commit grid armed the shrunk run's END_B
    commits do not depend on the rank count: the final weights are bitwise
    the 1-rank golden run's.  The launcher brought the whole killed world
    down, and no rank of either world is left."""
    gold = chaos.golden_run(deterministic=True, **GOLD_KW)
    kill_at = int(np.random.default_rng(SEED).integers(1, 4))
    out = str(tmp_path / "result")
    res = chaos.run_chaos(str(tmp_path / "ck"), out, ["--kill-at-commit", kill_at],
                          WARGS + ["--deterministic"], mesh_devices=8,
                          restart_mesh_devices=4, timeout=300)
    first, last = res["spawns"][0], res["spawns"][-1]
    assert first["rc"] == -signal.SIGKILL and first["status"]["ranks"] == 8
    assert res["resumed_from"] is not None and res["ranks"] == 4
    assert all(sp["status"]["commit_grid"] is True for sp in res["spawns"])
    _assert_bitwise(gold, out, res)
    assert len(first["pids"]) == 8 and len(last["pids"]) == 4
    assert not [pid for sp in res["spawns"] for pid in sp["pids"] if _alive(pid)]
    manifest = json.loads((tmp_path / "result.json").read_text())
    assert manifest["commits"] == res["commits"]


@pytest.mark.parametrize("flag", ["--mesh-devices", "--deterministic"])
def test_worker_parses_mesh_flags_and_refuses_worlds_it_cannot_form(tmp_path, flag, capsys,
                                                                   monkeypatch):
    """``--mesh-devices`` and ``--deterministic`` parse; the worker refuses
    a rank outside its world, and more ranks on the card than the machine
    has cards (NCCL runs one rank a card)."""
    argv = ["--ckpt-dir", str(tmp_path), flag] + (["8"] if flag == "--mesh-devices" else [])
    args = chaos.parse_args(argv)
    assert args.mesh_devices == 8 if flag == "--mesh-devices" else args.deterministic
    with pytest.raises(SystemExit) as e:
        chaos.main(argv + ["--rank", "8", "--rendezvous", str(tmp_path / "rdv")])
    assert e.value.code == 2 and "--rank" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="one rank a card"):
        chaos.main(["--ckpt-dir", str(tmp_path), "--device", "cuda:0", "--mesh-devices",
                    "8"] + argv[2:3] * (flag == "--deterministic"))
    assert not list(tmp_path.glob("step_*"))


def test_worker_and_trainer_step_need_the_card(tmp_path, monkeypatch):
    """The worker's default device is the card, and so is the step's: both
    raise without one instead of dropping to the plain versions."""
    from repro_torch.core.rsnn import Presets
    from repro_torch.optim.eprop_opt import EpropSGD, EpropSGDConfig
    from repro_torch.train.eprop_step import make_eprop_commit_step

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        chaos.main(["--ckpt-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_eprop_commit_step(Presets.braille(num_ticks=8), EpropSGD(EpropSGDConfig()))
    assert not list(tmp_path.glob("step_*"))
