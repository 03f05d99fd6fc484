"""The production-mesh dry run (``repro_torch.launch.dryrun``) against the
JAX package's (``repro.launch.dryrun``), whose own cells fail on this JAX
version ("can only refer to Auto axes", ROADMAP C): the port is held to
the reference's parts that run, and to real gloo worlds.

The port's fake worlds run in subprocesses (``tests/_torch_dryrun_ranks.py``:
a fake world of 512 for the production meshes, of 4 for a 2 x 2 mesh) and
its real gloo world of 4 in spawned ranks, all started together; the
reference runs here over ``jax.sharding.AbstractMesh`` (its module is
imported with its XLA flag undone, so no process sees 512 host devices).

* (a) ``cell_list``, ``skip_reason``, ``tune_cfg`` and ``make_rules``: the
  reference's, for every arch, shape and mesh, under ``kv_shard``
  auto/heads/seq/none and two ``--rules-override``;
* (b) for one arch of each family at full size, every parameter,
  optimizer-state, input and cache leaf's shard on rank 0 of the fake
  16 x 16 world is the reference's ``NamedSharding`` shard shape, where
  the reference can place the leaf at all (JAX refuses a split that does
  not divide; the port's rank 0 then holds the larger part,
  ``ceil(n / k)``, listed per leaf);
* (c) ``params_total``, ``params_active``, ``model_flops`` and ``tokens``:
  the reference's formulas on its own counts, exactly;
* (d) at reduced configs on a 2 x 2 mesh, rank 0 of a fake world and of a
  real gloo world count the same argument bytes, collectives by op and
  flops (exactly), and the real sharded prefill's and decode's logits
  equal the unsharded port's within ``rtol=1e-5`` (``SERVE_RTOL``, and
  that fraction of the largest logit as the floor of an element near
  zero; f32: sums split over ranks in another order), for qwen3 (GQA), deepseek
  (MLA + MoE) and mamba2 under ``kv_shard`` seq and heads;
* (e) ``_combine_cost`` of the k = 1 and k = 2 runs is the full-depth
  flop count, exactly, for a dense reduced arch (a period of one layer);
  for a period of several layers only with the checkpoint's early stop
  off;
* (f) ``--prune-causal`` and ``--attn-block`` raise.
"""

import argparse
import contextlib
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import _torch_dist_ranks as dist_ranks
import _torch_dryrun_ranks as ranks
from repro_torch.configs.base import ARCH_IDS, SHAPES, get_config
from repro_torch.launch import dryrun

HELPER = Path(__file__).with_name("_torch_dryrun_ranks.py")
SERVE_RTOL = 1e-5
GROUP_TIMEOUT_S = 120.0


@contextlib.contextmanager
def _xla_flags_kept():
    """The reference module sets XLA_FLAGS when imported; this process's
    JAX has started already, and its children must not inherit 512
    devices."""
    before = os.environ.get("XLA_FLAGS")
    try:
        yield
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before


def _reference():
    with _xla_flags_kept():
        return importlib.import_module("repro.launch.dryrun")


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The port's fake worlds (subprocesses) and its gloo world of 4, run
    together."""
    root = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = {m: subprocess.Popen([sys.executable, str(HELPER), m, str(root / f"{m}.json")],
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                 env=env)
             for m in ("rules", "fake4", "calib", "period")}
    try:
        dist_ranks.spawn_world(ranks.run_world, 4, (str(root),), str(root / "rdv"),
                               GROUP_TIMEOUT_S)
        for m, p in procs.items():
            out, err = p.communicate(timeout=600)
            assert "DRYRUN_RANKS_OK" in out, f"{m}:\n{out[-2000:]}\n{err[-4000:]}"
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    load = lambda name: json.loads((root / name).read_text())
    return (load("rules.json"),
            {**load("fake4.json"), **load("calib.json"), **load("period.json")},
            load("world_r0.json"))


def _ns(**kw):
    base = dict(arch=None, shape=None, multi_pod=False, both_meshes=False, kv_shard="auto",
                prune_causal=False, no_remat=False, n_micro=1, attn_block=0,
                compress_pods=False, no_calibrate=False, remat_policy="full", moe_groups=0,
                ssd_chunk=0, ssd_bf16=False, rules_override=[])
    base.update(kw)
    return argparse.Namespace(**base)


def _abstract(multi_pod):
    from jax.sharding import AbstractMesh

    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def _jax_table(rules):
    return {k: list(v) if isinstance(v, tuple) else v for k, v in rules.table.items()}


# --------------------------------------------------------------------------- (a)


@pytest.mark.parametrize("opts", [
    dict(), dict(arch="llama3-8b,mamba2-1.3b"), dict(shape="decode_32k"),
    dict(multi_pod=True), dict(both_meshes=True), dict(arch="yi-34b", shape="train_4k",
                                                       both_meshes=True)])
def test_cell_list_is_the_references(opts):
    ref = _reference()
    assert dryrun.cell_list(_ns(**opts)) == ref.cell_list(_ns(**opts))


def test_all_is_eighty_cells_and_the_skips_are_the_references():
    from repro.configs.base import SHAPES as JSHAPES
    from repro.configs.base import get_config as jget_config

    ref = _reference()
    cells = dryrun.cell_list(_ns(both_meshes=True))
    assert len(cells) == 80
    skipped = 0
    for arch, shape, _ in cells:
        got = dryrun.skip_reason(get_config(arch), SHAPES[shape])
        assert got == ref.skip_reason(jget_config(arch), JSHAPES[shape])
        skipped += got is not None
    assert skipped == 16     # long_500k of the eight full-attention archs, both meshes


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("knobs", [
    dict(), dict(no_remat=True), dict(remat_policy="dots"), dict(moe_groups=4),
    dict(ssd_chunk=128, ssd_bf16=True)])
def test_tune_cfg_is_the_references(shape, knobs):
    from repro.configs.base import SHAPES as JSHAPES
    from repro.configs.base import get_config as jget_config

    ref = _reference()
    for arch in ARCH_IDS:
        got = dryrun.tune_cfg(get_config(arch), SHAPES[shape], _ns(**knobs))
        want = ref.tune_cfg(jget_config(arch), JSHAPES[shape], _ns(**knobs))
        assert (got.remat, got.remat_policy) == (want.remat, want.remat_policy), arch
        if want.moe is not None:
            assert got.moe.dispatch_groups == want.moe.dispatch_groups, arch
        if want.ssm is not None:
            assert (got.ssm.chunk, got.ssm.compute_dtype) == \
                (want.ssm.chunk, want.ssm.compute_dtype), arch


@pytest.mark.parametrize("mesh_tag", ["16x16", "2x16x16"])
def test_make_rules_is_the_references(case, mesh_tag):
    """Every shape under kv_shard auto/heads/seq/none, without and with
    ``--rules-override act_seq=model --rules-override batch=data+model``,
    on the fake world's production mesh: the reference's table over the
    same mesh's axes."""
    from repro.configs.base import SHAPES as JSHAPES

    ref = _reference()
    tables = case[0]["rules"]
    mesh = _abstract(mesh_tag == "2x16x16")
    n = 0
    for name in SHAPES:
        for kv in ranks.KV_SHARDS:
            for ovs in ((), (ranks.OVERRIDE, "batch=data+model")):
                want = _jax_table(ref.make_rules(JSHAPES[name], mesh,
                                                 _ns(kv_shard=kv, rules_override=list(ovs))))
                assert tables[f"{mesh_tag}|{name}|{kv}|{'+'.join(ovs)}"] == want, (name, kv, ovs)
                n += 1
    assert n == len(SHAPES) * len(ranks.KV_SHARDS) * 2


# --------------------------------------------------------------------------- (b)


def _jax_leaves(arch, shape_name):
    """Every leaf of the reference's cell (params, AdamW moments, inputs,
    decode caches) → (global shape, logical axes), under the port's leaf
    names."""
    from repro.configs.base import SHAPES as JSHAPES
    from repro.configs.base import get_config as jget_config
    from repro.models.model import build as jbuild

    model = jbuild(jget_config(arch))
    shape = JSHAPES[shape_name]
    params, specs = model.abstract()
    out = {}

    def walk(tree, axes, path):
        if isinstance(tree, dict):
            for k in tree:
                walk(tree[k], axes[k], f"{path}/{k}")
        elif isinstance(tree, (list, tuple)) and not hasattr(tree, "shape"):
            for i, v in enumerate(tree):
                walk(v, axes[i], f"{path}/{i}")
        elif tree is not None:
            out[path] = (tuple(tree.shape), axes)

    walk(params, specs, "params")
    if shape.kind == "train":
        walk({"mu": params, "nu": params}, {"mu": specs, "nu": specs}, "opt")
    ref = _reference()
    for k, v in model.input_specs(shape).items():
        out[f"inputs/{k}"] = (tuple(v.shape), ref.BATCH_AXES[k])
    if shape.kind == "decode":
        cache, axes = model.cache_specs(shape.global_batch, shape.seq_len)
        walk(cache, axes, "cache")
    return out


@pytest.mark.parametrize("arch", ranks.FAMILY_ARCHS)
def test_local_shards_on_the_fake_world_are_the_references(case, arch):
    from jax.sharding import NamedSharding

    from repro.configs.base import SHAPES as JSHAPES
    from repro.distributed.sharding import logical_spec

    ref = _reference()
    mesh = _abstract(False)
    uneven = []
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        got = case[0]["shapes"][f"{arch}|{name}"]
        want = _jax_leaves(arch, name)
        assert set(got) == set(want), set(got) ^ set(want)
        rules = ref.make_rules(JSHAPES[name], mesh, _ns())
        for path, (shp, axes) in want.items():
            spec = logical_spec(axes, mesh, rules)
            try:
                w = list(NamedSharding(mesh, spec).shard_shape(shp))
            except ValueError:    # JAX cannot split it evenly: the port's rank 0
                k = [1] * len(shp)  # holds ceil(n / k) of each split dimension
                for d, entry in enumerate(spec):
                    for a in ((entry,) if isinstance(entry, str) else entry or ()):
                        k[d] *= dict(mesh.shape)[a]
                w = [-(-n // kk) for n, kk in zip(shp, k)]
                uneven.append((name, path))
            assert got[path] == w, (name, path, shp, axes)
    # the leaves the reference cannot place: seamless's 256,102-word
    # vocabulary over the 16-way model axis
    assert all("seamless" in arch and ("embed" in p or "lm_head" in p) for _, p in uneven), uneven


# --------------------------------------------------------------------------- (c)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_counts_are_the_references(arch):
    from repro.configs.base import get_config as jget_config
    from repro.models.transformer import count_params as jcount

    total, active = jcount(jget_config(arch)), jcount(jget_config(arch), active_only=True)
    for name, shape in SHAPES.items():
        got = dryrun.model_counts(get_config(arch), shape)
        tokens = shape.global_batch * (shape.seq_len if shape.kind in ("train", "prefill")
                                       else 1)
        assert got == {"params_total": total, "params_active": active,
                       "model_flops": (6 if shape.kind == "train" else 2) * active * tokens,
                       "tokens": tokens}, name


# --------------------------------------------------------------------------- (d)


@pytest.mark.parametrize("arch,kind,kv", ranks.CASES)
def test_fake_world_counts_what_the_real_world_does(case, arch, kind, kv):
    _, fake, world = case
    assert fake[f"{arch}|{kind}|{kv}"] == world[f"acct|{arch}|{kind}|{kv}"]
    assert fake[f"{arch}|{kind}|{kv}"]["flops"] > 0


@pytest.mark.parametrize("arch", ranks.SERVE_ARCHS)
@pytest.mark.parametrize("kv", ranks.SERVE_KV)
def test_sharded_prefill_and_decode_match_the_unsharded_port(case, arch, kv):
    got = np.asarray(case[2][f"logits|{arch}|{kv}"])
    want = ranks.serve_logits(arch, kv).numpy()
    assert got.shape == want.shape and want.shape[:2] == (ranks.B, 2)
    np.testing.assert_allclose(got, want, rtol=SERVE_RTOL,
                               atol=SERVE_RTOL * float(np.abs(want).max()))


# --------------------------------------------------------------------------- (e), (f)


def test_calibration_recovers_the_full_depth_count(case):
    c = case[1]["calib"]
    assert c["repeats"] > 2 and c["k2"] > c["k1"] > 0
    assert c["combined"] == c["full"]


def test_calibration_of_a_multi_layer_period_differs_by_the_recompute_early_stop(case):
    """The vlm's period is five layers: with torch.utils.checkpoint's
    early stop (the default) the unscanned variants recompute less than
    the scanned stack; with it off the combination is exact."""
    on, off = case[1]["calib_period_early_True"], case[1]["calib_period_early_False"]
    assert off["combined"] == off["full"]
    assert on["combined"] < on["full"] <= off["full"]


@pytest.mark.parametrize("knob", [dict(prune_causal=True), dict(attn_block=512)])
def test_knobs_without_a_counterpart_raise(knob):
    with pytest.raises(ValueError, match="no counterpart"):
        dryrun.tune_cfg(get_config("llama3-8b"), SHAPES["train_4k"], _ns(**knob))


def test_peak_top_lists_the_largest_storages_live_at_the_peak():
    """``StepTally(top=2)`` on real CPU tensors: the two largest storages
    live when the run peaked, with the ops that made them, and nothing
    freed before the peak among them."""
    import torch

    from repro_torch.launch.trace_analysis import StepTally

    def step():
        a = torch.ones(1000)              # 4,000 B, freed before the peak
        b = torch.full((3000,), 2.0)      # 12,000 B
        del a
        c = torch.empty(2000)             # 8,000 B
        d = torch.ones(500)               # 2,000 B: the peak, b + c + d
        return b, c, d

    tally = StepTally("cpu", top=2)
    with tally:
        out = step()
    assert [r["bytes"] for r in tally.peak_top] == [12000, 8000]
    assert [r["op"] for r in tally.peak_top] == ["aten.full", "aten.empty"]
    assert tally.peak_bytes == 12000 + 8000 + 2000 and len(out) == 3
