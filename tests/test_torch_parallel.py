"""The port's meshes, sharding rules, resharding, GPipe and trace accounting
against the JAX package.

Gloo worlds of 1, 4 and 8 ranks are spawned once for the module
(``tests/_torch_dist_ranks.py:spawn_world``), each rank running
``tests/_torch_parallel_ranks.py:run_parallel``; JAX's 4-stage GPipe runs
in a process of its own over 4 host devices
(``tests/_torch_parallel_jax.py``), while the worlds run.

* The rules (``BASE_RULES``, ``resolve``, ``override``, ``strip``,
  ``logical_spec``) on ``(data, model)`` and ``(pod, data, model)``
  meshes of the port's world equal JAX's on ``make_debug_mesh`` meshes of
  its one device, entry for entry; ``param_specs()`` equals JAX's
  ``Model.param_specs()`` for every arch's ``reduced()`` config.
* ``reshard`` of qwen3-1.7b ``reduced()`` onto a (2, 2) mesh of 4 ranks:
  every ``full_tensor()`` bitwise the host array, every local shard the
  shape its logical spec gives; ``survive_failure`` with rank 3 out of
  service (model_parallel 2) the same on the (1, 2) mesh of ranks 0-1.
* ``best_mesh_from`` on 8 ranks at model_parallel 2 gives (4, 2) and
  raises on 1 rank (``tests/test_runtime.py:81-86``).
* ``gpipe`` in worlds of 1 and 4 against JAX's ``gpipe`` and
  ``reference_pipeline`` at JAX's test shapes (``rtol = atol = 1e-5``;
  different matmul kernels), and bitwise against the port's own
  ``reference_pipeline``; its handoffs are sends and receives in the
  trace that ``trace_analysis`` reads.
* ``trace_analysis.collective_bytes`` applies JAX's ring cost models:
  equal to ``hlo_analysis.collective_bytes`` on a synthetic HLO text with
  the same ops, shapes and groups.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

import _torch_dist_ranks as dist_ranks
import _torch_parallel_ranks as ranks
from repro.configs import base as jbase
from repro.distributed import sharding as jsharding
from repro.launch import hlo_analysis
from repro.launch.mesh import make_debug_mesh as jmake_debug_mesh
from repro.models.model import build as jbuild
from repro_torch.configs.base import ARCH_IDS, get_reduced
from repro_torch.distributed import elastic, sharding
from repro_torch.launch import trace_analysis
from repro_torch.models.model import build

WORLDS = (1, 4, 8)
GROUP_TIMEOUT_S = 60.0
JAX_SCRIPT = Path(__file__).with_name("_torch_parallel_jax.py")
SEED = 43


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel")
    rng = np.random.default_rng(SEED)
    inp = {}
    for n, n_micro in ((1, 4), (4, 6)):      # tests/test_pipeline_parallel.py's shapes
        inp[f"gpipe{n}.w"] = (rng.standard_normal((n, 8, 8)) * 0.5).astype(np.float32)
        inp[f"gpipe{n}.x"] = rng.standard_normal((n_micro, 2, 8)).astype(np.float32)
    np.savez(root / "in.npz", **inp)
    proc = subprocess.Popen([sys.executable, str(JAX_SCRIPT), str(root / "in.npz"),
                             str(root / "jax_out.npz"), "parallel"],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        out = {}
        for world in WORLDS:
            dist_ranks.spawn_world(ranks.run_parallel, world, (str(root / "in.npz"), str(root)),
                                   str(root / f"rdv{world}"), GROUP_TIMEOUT_S)
            out[world] = [dict(np.load(root / f"parallel_w{world}_r{r}.npz"))
                          for r in range(world)]
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert "JAX_REFERENCE_OK" in stdout, stdout[-2000:] + stderr[-4000:]
    return inp, dict(np.load(root / "jax_out.npz")), out


# ---------------------------------------------------------------------------
# rules and specs
# ---------------------------------------------------------------------------


def test_base_rules_are_the_reference_table():
    assert sharding.BASE_RULES == jsharding.BASE_RULES
    assert list(sharding.BASE_RULES) == list(jsharding.BASE_RULES)


def _entry(e):
    """A JAX ``PartitionSpec`` entry in the JSON form the ranks write."""
    return list(e) if isinstance(e, tuple) else e


def _jax_report(mesh):
    base = jsharding.ShardingRules(jsharding.BASE_RULES)

    def table(rules):
        return {name: _entry(rules.resolve(name, mesh)) for name in jsharding.BASE_RULES}

    with pytest.raises(KeyError):
        jsharding.logical_spec(("nonsense",), mesh, base)
    return {"base": table(base),
            "override": table(base.override(kv_cache_seq="model", embed=None)),
            "strip_pod": table(base.strip("pod")), "strip_data": table(base.strip("data")),
            "spec": [_entry(e) for e in jsharding.logical_spec(
                ("batch", "act_seq", "vocab", "embed", None, "norm"), mesh, base)],
            "unknown_raises": True}


@pytest.mark.parametrize("mesh", ["data_model", "pod_data_model"])
def test_rules_resolve_like_the_reference(case, mesh):
    """Every logical name under the base, overridden and stripped rules."""
    jmesh = jmake_debug_mesh(1, 1) if mesh == "data_model" else jmake_debug_mesh(1, 1, n_pod=1)
    got = json.loads(str(case[2][1][0][f"rules.{mesh}"]))
    assert got == _jax_report(jmesh)


def test_rule_tables_strip_and_override_like_the_reference():
    ours, theirs = sharding.ShardingRules(sharding.BASE_RULES), jsharding.ShardingRules(
        jsharding.BASE_RULES)
    for axis in ("pod", "data", "model"):
        assert ours.strip(axis).table == theirs.strip(axis).table
    assert (ours.override(embed=None, batch=("data",)).table
            == theirs.override(embed=None, batch=("data",)).table)


def _flat(tree, path=""):
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _flat(tree[key], f"{path}/{key}").items()}
    if isinstance(tree, list):
        return {k: v for i, t in enumerate(tree) for k, v in _flat(t, f"{path}/{i}").items()}
    return {path: tree}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_are_the_references(arch):
    """The logical axes of every leaf, by key path; the meta shapes equal
    JAX's abstract shapes."""
    model = build(get_reduced(arch))
    shapes, specs = model.abstract()
    jshapes, jspecs = jbuild(jbase.get_reduced(arch)).abstract()
    assert _flat(specs) == _flat(jspecs)
    assert {k: tuple(v.shape) for k, v in _flat(shapes).items()} == {
        k: tuple(v.shape) for k, v in _flat(jshapes).items()}
    assert all(t.device.type == "meta" for t in _flat(shapes).values())
    assert model.param_specs() == specs


def test_param_shardings_place_named_dims():
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:      # the rules read only the axis names
        mesh_dim_names = ("pod", "data", "model")

    pl = sharding.param_shardings({"w": ("embed", "mlp"), "sub": [("norm",)],
                                   "b": ("batch", None)}, Mesh())
    assert pl["w"] == (Replicate(), Shard(0), Shard(1))
    assert pl["sub"][0] == (Replicate(), Replicate(), Replicate())
    assert pl["b"] == (Shard(0), Shard(0), Replicate())
    with pytest.raises(ValueError):       # one mesh axis for two dimensions
        sharding.placements(("data", "data"), Mesh())


def test_with_axes_refuses_a_rank_mismatch():
    import torch

    from repro_torch.models.layers import make_param

    with pytest.raises(ValueError, match="disagree on rank"):
        make_param(None, (4, 4), torch.float32, torch.device("meta"), axes=("embed",))


# ---------------------------------------------------------------------------
# meshes, resharding, elastic
# ---------------------------------------------------------------------------


def test_best_mesh_from_survivors(case):
    got = json.loads(str(case[2][8][0]["best.mesh"]))
    assert got == {"names": ["data", "model"], "ranks": [[0, 1], [2, 3], [4, 5], [6, 7]]}
    with pytest.raises(ValueError):
        elastic.best_mesh_from([0], model_parallel=2)


def test_production_mesh_refuses_a_small_world(case):
    assert all(bool(o["production.raises"]) for o in case[2][8])


def _placed(o, prefix):
    keys = [k for k in o if k.startswith(f"{prefix}.full_equal")]
    assert len(keys) == len(_flat(build(get_reduced(ranks.STEP_ARCH)).param_specs()))
    for k in keys:
        path = k[len(f"{prefix}.full_equal"):]
        assert bool(o[k]), f"{prefix} {path}: full tensor is not the host array"
        np.testing.assert_array_equal(o[f"{prefix}.local_shape{path}"],
                                      o[f"{prefix}.want_shape{path}"], err_msg=path)


def test_reshard_onto_a_2x2_mesh(case):
    """Every leaf bitwise whole again, each rank's shards the spec's shape
    (some leaves are split: ``embed`` over data, ``vocab`` over model)."""
    for o in case[2][4]:
        assert json.loads(str(o["reshard.mesh"])) == {"names": ["data", "model"],
                                                     "ranks": [[0, 1], [2, 3]]}
        _placed(o, "reshard")
    o = case[2][4][0]
    assert list(o["reshard.local_shape/embed"]) == [
        get_reduced(ranks.STEP_ARCH).vocab // 2, get_reduced(ranks.STEP_ARCH).d_model // 2]


def test_survive_failure_reshards_onto_the_survivors(case):
    outs = case[2][4]
    for r, o in enumerate(outs):
        assert json.loads(str(o["survive.mesh"])) == {"names": ["data", "model"],
                                                     "ranks": [[0, 1]]}
        assert bool(o["survive.none"]) == (r >= 2)     # rank 3 failed, rank 2 idle
        if r < 2:
            _placed(o, "survive")


# ---------------------------------------------------------------------------
# GPipe
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", [1, 4])
def test_gpipe_matches_the_reference(case, world):
    _, ref, out = case
    for o in out[world]:
        np.testing.assert_allclose(o["gpipe.out"], ref[f"gpipe{world}.out"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(o["gpipe.out"], ref[f"gpipe{world}.ref"], rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(o["gpipe.out"], o["gpipe.ref"])
        np.testing.assert_array_equal(o["gpipe.out"], out[world][0]["gpipe.out"])


def test_gpipe_handoffs_are_point_to_point_in_the_trace(case):
    """4 stages, 6 microbatches: 9 ticks, a send a tick from each stage but
    the last and a receive a tick into each but the first, (2, 8) f32 each;
    then one all-reduce of the (6, 2, 8) f32 outputs."""
    ticks, mb_bytes, out_bytes = 6 + 4 - 1, 2 * 8 * 4, 6 * 2 * 8 * 4
    for s, o in enumerate(case[2][4]):
        t = json.loads(str(o["gpipe.trace"]))
        want = {"all_reduce": 1}
        if s < 3:
            want["send"] = ticks
        if s > 0:
            want["recv"] = ticks
        assert t["count_by_op"] == want
        assert t["bytes_by_op"]["all_reduce"] == 2 * 3 / 4 * out_bytes
        assert t["bytes_by_op"].get("send", 0) == (ticks * mb_bytes if s < 3 else 0)
        assert t["bytes_by_op"].get("recv", 0) == 0


# ---------------------------------------------------------------------------
# trace accounting
# ---------------------------------------------------------------------------

_HLO = """
  %ag = s8[4,1024]{1,0} all-gather(s8[1,1024]{1,0} %q), replica_groups={{0,1,2,3}}, dimensions={0}
  %ag2 = f32[8]{0} all-gather(f32[1]{0} %s), replica_groups=[1,8]<=[8], dimensions={0}
  %ar = f32[256]{0} all-reduce(f32[256]{0} %x), replica_groups=[2,4]<=[8], to_apply=%add
  %ar2 = bf16[64,32]{1,0} all-reduce(bf16[64,32]{1,0} %y), replica_groups={{0,1},{2,3}}, to_apply=%add
  %rs = f32[64]{0} reduce-scatter(f32[256]{0} %z), replica_groups={{0,1,2,3}}, dimensions={0}
  %a2a = bf16[8,32]{1,0} all-to-all(bf16[8,32]{1,0} %w), replica_groups={{0,1}}
  %cp = f32[2,8]{1,0} collective-permute(f32[2,8]{1,0} %v), source_target_pairs={{0,1},{1,2}}
"""

# the same ops as the records NCCL writes (record_param_comms)
_TRACE = [("allgather_into_tensor_coalesced", "Char", 1024, 4096, 4),
          ("_allgather_base", "Float", 1, 8, 8),
          ("allreduce", "Float", 256, 256, 4),
          ("allreduce", "BFloat16", 2048, 2048, 2),
          ("_reduce_scatter_base", "Float", 256, 64, 4),
          ("all_to_all", "BFloat16", 256, 256, 2),
          ("send", "Float", 16, 16, 2),
          ("recv", "Float", 16, 16, 2)]
_NAMES = {"all-gather": "all_gather", "all-reduce": "all_reduce",
          "reduce-scatter": "reduce_scatter", "all-to-all": "all_to_all",
          "collective-permute": "send"}


def _comms_trace(rows):
    return {"traceEvents": [
        {"name": "record_param_comms", "cat": "cpu_op", "args": {
            "Collective name": c, "dtype": dt, "In msg nelems": i, "Out msg nelems": o,
            "Group size": n}} for c, dt, i, o, n in rows]
        + [{"name": "nccl:all_reduce", "cat": "user_annotation",
            "args": {"Input Dims": [[10]], "Input type": ["float"]}}]}


def test_cost_models_match_the_reference_hlo_accounting():
    want = hlo_analysis.collective_bytes(_HLO, 8)
    got = trace_analysis.collective_bytes(_comms_trace(_TRACE), 8)
    assert {_NAMES[k]: v for k, v in want.bytes_by_op.items()} == {
        k: v for k, v in got.bytes_by_op.items() if k != "recv"}
    assert got.bytes_by_op["recv"] == 0
    assert want.total_wire_bytes == got.total_wire_bytes
    assert {_NAMES[k]: v for k, v in want.count_by_op.items()} == {
        k: v for k, v in got.count_by_op.items() if k != "recv"}
    # the groups read from the records (the reference's permute has none)
    assert [n for _, _, n in want.ops][:6] == [o.group_size for o in got.ops][:6]
    assert got.payload_by_op["all_gather"] == 1024 + 4


def test_annotations_without_a_group_take_the_device_count():
    """A backend's own records (gloo's) carry no group: ``n_devices``."""
    trace = {"traceEvents": [
        {"name": "gloo:all_gather", "cat": "user_annotation",
         "args": {"Input Dims": [[3, 5]], "Input type": ["signed char"]}},
        {"name": "gloo:all_reduce", "cat": "user_annotation",
         "args": {"Input Dims": [[6]], "Input type": ["c10::BFloat16"]}},
        {"name": "c10d::allgather_", "cat": "cpu_op", "args": {}},
        {"name": "ncclDevKernel_AllGather_RING_LL", "cat": "kernel"},
        {"name": "ncclDevKernel_AllGather_RING_LL", "cat": "kernel"},
        {"name": "gemm", "cat": "kernel"}]}
    stats = trace_analysis.collective_bytes(trace, 4)
    assert stats.bytes_by_op == {"all_gather": 3 * 15, "all_reduce": 2 * 3 / 4 * 12}
    assert stats.count_by_op == {"all_gather": 1, "all_reduce": 1}
    assert trace_analysis.op_histogram(trace) == [("ncclDevKernel_AllGather_RING_LL", 2),
                                                  ("gemm", 1)]
    with pytest.raises(ValueError, match="element type"):
        trace_analysis.collective_bytes({"traceEvents": [
            {"name": "gloo:all_gather", "cat": "user_annotation",
             "args": {"Input Dims": [[3]], "Input type": ["mystery"]}}]}, 2)
