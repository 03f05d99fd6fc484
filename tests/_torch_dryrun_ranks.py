"""The port's side of ``tests/test_torch_dryrun.py`` that needs a world:
no JAX here.

* ``python tests/_torch_dryrun_ranks.py rules OUT``: one rank of a fake
  world of 512 (cuda ranks), the production meshes 2 x 16 x 16 (every
  rank) and 16 x 16 (ranks 0-255); for every arch, shape, mesh and
  kv_shard the dry run's rules table, and for one arch of each family
  every parameter, optimizer-state, input and cache leaf's local shard
  shape on rank 0, written as JSON;
* ``python tests/_torch_dryrun_ranks.py fake4|calib|period OUT``: rank
  0 of a fake world of 4 (cpu ranks, a 2 x 2 mesh): the dry run's
  accounting of each :data:`CASES` step; or the calibration runs (k = 1,
  2 and full depth) of a dense reduced arch, or of one whose period is
  several layers;
* :func:`run_world` is each rank of the real gloo world of 4 (spawned by
  ``tests/_torch_dist_ranks.py:spawn_world``): the same accounting on
  real tensors, and the sharded prefill's and decode's logits.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.base import SHAPES, get_config, get_reduced  # noqa: E402
from repro_torch.distributed.sharding import (  # noqa: E402
    batch_shardings,
    from_global,
    local_shape_and_offset,
    on_mesh,
    param_shardings,
    place_state,
)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as meshlib  # noqa: E402
from repro_torch.models.model import build  # noqa: E402
from repro_torch.models.transformer import _layer_plan  # noqa: E402
from repro_torch.train.train_step import opt_state_specs  # noqa: E402

KV_SHARDS = ("auto", "heads", "seq", "none")
OVERRIDE = "act_seq=model"
FAMILY_ARCHS = ("llama3-8b", "deepseek-v2-lite-16b", "mamba2-1.3b", "jamba-v0.1-52b",
                "llama-3.2-vision-90b", "seamless-m4t-large-v2")
# (d): the archs and kv_shard settings whose sharded serving the gloo world
# holds to the unsharded port, and the reduced shapes
SERVE_ARCHS = ("qwen3-1.7b", "deepseek-v2-lite-16b", "mamba2-1.3b")
SERVE_KV = ("seq", "heads")
B, S = 4, 16
SEED = 5
# (d): the steps whose fake and real accounting must agree: each serving
# arch's prefill and decode, the two kv_shard settings alternating, a
# train step, and a MoE train step with its dispatch in 4 groups
# (``--moe-groups 4``, kind ``train-g4``: two groups on each data rank)
CASES = tuple((arch, kind, SERVE_KV[(i + j) % 2]) for i, arch in enumerate(SERVE_ARCHS)
              for j, kind in enumerate(("prefill", "decode"))) + (
    ("qwen3-1.7b", "train", "auto"), ("deepseek-v2-lite-16b", "train-g4", "auto"))
CALIB_ARCH = "llama3-8b"
PERIOD_ARCH = "llama-3.2-vision-90b"
SHAPE_OF = {"train": "train_4k", "prefill": "prefill_32k", "decode": "decode_32k"}


def opts_for(kv="auto", overrides=(), **kw):
    argv = ["--kv-shard", kv, "--device", "cpu"]
    for ov in overrides:
        argv += ["--rules-override", ov]
    opts = dryrun.parser().parse_args(argv)
    for k, v in kw.items():
        setattr(opts, k, v)
    return opts


def reduced_cfg(arch):
    """The reduced config in f32 (the gloo world compares f32 logits)."""
    return get_reduced(arch).replace(dtype="float32")


def split_kind(kind):
    """``"train-g4"`` → ``("train", 4)``; a kind without ``-g`` has no
    groups."""
    base, _, g = kind.partition("-g")
    return base, int(g or 0)


def small_shape(kind):
    return dryrun.cell_shape(SHAPE_OF[split_kind(kind)[0]], opts_for(batch=B, seq=S))


def _local_shapes(metas, pls, mesh):
    out = {}

    def walk(m, pl, path):
        if isinstance(m, dict):
            for k in m:
                walk(m[k], pl[k], f"{path}/{k}")
        elif isinstance(m, list):
            for i, v in enumerate(m):
                walk(v, pl[i], f"{path}/{i}")
        elif m is not None:
            out[path] = list(local_shape_and_offset(m.shape, mesh, pl)[0])

    walk(metas, pls, "")
    return out


def rules_report(out_path):
    from torch.distributed.device_mesh import DeviceMesh

    meshlib.join_fake_world(512, device="cuda")
    meshes = {"2x16x16": meshlib.make_production_mesh(multi_pod=True),
              "16x16": DeviceMesh("cuda", torch.arange(256).reshape(16, 16),
                                  mesh_dim_names=("data", "model"))}
    out = {"rules": {}, "shapes": {}}
    for tag, mesh in meshes.items():
        for name, shape in SHAPES.items():
            for kv in KV_SHARDS:
                for ovs in ((), (OVERRIDE, "batch=data+model")):
                    rules = dryrun.make_rules(shape, mesh, opts_for(kv, ovs))
                    key = f"{tag}|{name}|{kv}|{'+'.join(ovs)}"
                    out["rules"][key] = {k: list(v) if isinstance(v, tuple) else v
                                         for k, v in rules.table.items()}
    mesh = meshes["16x16"]
    for arch in FAMILY_ARCHS:
        cfg = get_config(arch)
        model = build(cfg)
        metas, specs = model.abstract()
        for name in ("train_4k", "prefill_32k", "decode_32k"):
            shape = SHAPES[name]
            rules = dryrun.make_rules(shape, mesh, opts_for())
            leaves = {f"params{k}": v for k, v in _local_shapes(
                metas, param_shardings(specs, mesh, rules), mesh).items()}
            if shape.kind == "train":
                f32 = {"mu": metas, "nu": metas}
                o_pl = param_shardings(opt_state_specs(specs), mesh, rules)
                leaves.update({f"opt{k}": v for k, v in _local_shapes(
                    f32, {"mu": o_pl["mu"], "nu": o_pl["nu"]}, mesh).items()})
            ins = model.input_specs(shape)
            pls = batch_shardings(ins, mesh, rules)
            leaves.update({f"inputs/{k}": list(local_shape_and_offset(v.shape, mesh, pls[k])[0])
                           for k, v in ins.items()})
            if shape.kind == "decode":
                caches = model.cache_specs(shape.global_batch, shape.seq_len)
                leaves.update({f"cache{k}": v for k, v in _local_shapes(
                    caches, param_shardings(model.cache_axes(shape.global_batch,
                                                             shape.seq_len), mesh, rules),
                    mesh).items()})
            out["shapes"][f"{arch}|{name}"] = leaves
    meshlib.leave_world()
    Path(out_path).write_text(json.dumps(out))


def _inputs(cfg, shape, rng):
    toks = rng.integers(0, cfg.vocab, size=(shape.global_batch, shape.seq_len + 1))
    return {"tokens": torch.from_numpy(toks[:, :-1].astype(np.int32)),
            "targets": torch.from_numpy(toks[:, 1:].astype(np.int32)),
            "next": torch.from_numpy(toks[:, -1:].astype(np.int32))}


def _accounting(rec):
    return {"argument_bytes": rec["memory"]["argument_bytes"],
            "count_by_op": rec["collectives"]["count_by_op"],
            "flops": rec["cost"]["flops"]}


def fake4_report(out_path):
    """Rank 0 of a fake world of 4: each case's accounting."""
    meshlib.join_fake_world(4, device="cpu")
    mesh = meshlib.make_debug_mesh(2, 2)
    out = {}
    for arch, kind, kv in CASES:
        shape = small_shape(kind)
        opts = opts_for(kv, moe_groups=split_kind(kind)[1])
        cfg = dryrun.tune_cfg(reduced_cfg(arch), shape, opts)
        rec = dryrun.compile_cell(cfg, shape, mesh, dryrun.make_rules(shape, mesh, opts), opts)
        out[f"{arch}|{kind}|{kv}"] = _accounting(rec)
    meshlib.leave_world()
    Path(out_path).write_text(json.dumps(out))


def calib_report(out_path):
    """Rank 0 of a fake world of 4: (e)'s calibration runs."""
    meshlib.join_fake_world(4, device="cpu")
    mesh = meshlib.make_debug_mesh(2, 2)
    out = {}
    shape = small_shape("train")
    opts = opts_for()
    cfg = dryrun.tune_cfg(get_reduced(CALIB_ARCH), shape, opts)
    rules = dryrun.make_rules(shape, mesh, opts)
    full = dryrun.compile_cell(cfg, shape, mesh, rules, opts)
    f1, f2 = (dryrun.compile_cell(dryrun.calib_config(cfg, k), shape, mesh, rules, opts)
              for k in (1, 2))
    out["calib"] = {"full": full["cost"]["flops"], "repeats": _layer_plan(cfg).repeats,
                    "combined": dryrun._combine_cost(f1, f2, _layer_plan(cfg).repeats)["flops"],
                    "k1": f1["cost"]["flops"], "k2": f2["cost"]["flops"]}
    meshlib.leave_world()
    Path(out_path).write_text(json.dumps(out))


def period_report(out_path):
    """Rank 0 of a fake world of 4: (e)'s calibration runs of an arch whose
    period is several layers, with the checkpoint's early stop on and off:
    it recomputes less of a layer-sized region than of a period-sized
    one."""
    meshlib.join_fake_world(4, device="cpu")
    mesh = meshlib.make_debug_mesh(2, 2)
    out = {}
    shape = small_shape("train")
    opts = opts_for()
    rules = dryrun.make_rules(shape, mesh, opts)
    cfg = dryrun.tune_cfg(get_reduced(PERIOD_ARCH), shape, opts)
    for early in (True, False):
        with torch.utils.checkpoint.set_checkpoint_early_stop(early):
            full = dryrun.compile_cell(cfg, shape, mesh, rules, opts)
            f1, f2 = (dryrun.compile_cell(dryrun.calib_config(cfg, k), shape, mesh, rules, opts)
                      for k in (1, 2))
        out[f"calib_period_early_{early}"] = {
            "full": full["cost"]["flops"],
            "combined": dryrun._combine_cost(f1, f2, _layer_plan(cfg).repeats)["flops"]}
    meshlib.leave_world()
    Path(out_path).write_text(json.dumps(out))


def run_world(rank, world, out_dir):
    """Each rank of the gloo world of 4, on a 2 x 2 mesh: every case's
    accounting on real tensors (global values every rank draws alike),
    and the sharded prefill-then-decode logits of each serving case."""
    torch.set_num_threads(1)
    mesh = meshlib.make_debug_mesh(2, 2)
    out = {}
    for arch, kind, kv in CASES:
        shape = small_shape(kind)
        opts = opts_for(kv, moe_groups=split_kind(kind)[1])
        cfg = dryrun.tune_cfg(reduced_cfg(arch), shape, opts)
        rules = dryrun.make_rules(shape, mesh, opts)
        params = build(cfg).init(SEED, device="cpu")
        inp = _inputs(cfg, shape, np.random.default_rng(SEED))
        if kind == "decode":
            inp["tokens"] = inp["next"]
        ins = {k: v for k, v in inp.items() if k in build(cfg).input_specs(shape)}
        step, args, donated = dryrun.cell_step(cfg, shape, mesh, rules, opts,
                                               device=torch.device("cpu"), params=params,
                                               inputs=ins)
        rec = dryrun.account(step, args, donated, "cpu")
        rec.pop("outputs")
        out[f"acct|{arch}|{kind}|{kv}"] = _accounting(rec)
    for arch in SERVE_ARCHS:
        for kv in SERVE_KV:
            out[f"logits|{arch}|{kv}"] = serve_logits(arch, kv, mesh).tolist()
    if rank == 0:
        Path(out_dir, f"world_r{rank}.json").write_text(json.dumps(out))


def serve_logits(arch, kv, mesh=None):
    """The prefill's last logits and one decode step's, ``(B, 2, V)``:
    on ``mesh`` (parameters, inputs and caches placed by the dry run's
    rules under ``kv``) or, without one, unsharded."""
    shape = small_shape("decode")
    cfg = reduced_cfg(arch).replace(remat=False)
    model = build(cfg)
    params = model.init(SEED, device="cpu")
    inp = _inputs(cfg, shape, np.random.default_rng(SEED + 1))
    L = S + 1
    if mesh is None:
        caches = model.init_cache(B, L, device="cpu")
        lp, caches = model.prefill(params, {"tokens": inp["tokens"]}, caches)
        ld, _ = model.decode_step(params, caches, inp["next"], S)
        return torch.cat([lp, ld], dim=1)
    opts = opts_for(kv)
    rules = dryrun.make_rules(shape, mesh, opts)
    _, specs = model.abstract()
    with on_mesh(mesh, rules):
        p = place_state(params, param_shardings(specs, mesh, rules), mesh)
        pl = batch_shardings({"tokens": None}, mesh, rules)["tokens"]
        caches = model.init_cache(B, L, device="cpu")
        lp, caches = model.prefill(p, {"tokens": from_global(inp["tokens"], mesh, pl)}, caches)
        ld, _ = model.decode_step(p, caches, from_global(inp["next"], mesh, pl), S)
    return torch.cat([lp.full_tensor(), ld.full_tensor()], dim=1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["rules", "fake4", "calib", "period"])
    ap.add_argument("out")
    a = ap.parse_args()
    torch.set_num_threads(2)
    {"rules": rules_report, "fake4": fake4_report, "calib": calib_report,
     "period": period_report}[a.mode](a.out)
    print("DRYRUN_RANKS_OK")


if __name__ == "__main__":
    main()
