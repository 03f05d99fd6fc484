"""The production-mesh dry run (counterpart of :mod:`repro.launch.dryrun`).

For every (architecture × input shape × mesh) cell the reference lowers
and compiles the real step (train, prefill or serve decode) against 512
placeholder host devices and records XLA's memory and cost analyses and
the collectives of the partitioned program.  PyTorch has no compile of a
sharded program ahead of time, so the port *runs* the step instead, on
one rank of a fake world (:func:`repro_torch.launch.mesh.join_fake_world`:
PyTorch's fake process group, whose collectives move nothing) under
``FakeTensorMode`` (tensors with shapes, dtypes and devices and no
memory): the production mesh (16 × 16, or 2 × 16 × 16 with
``--multi-pod``) builds as on 256 or 512 real ranks, the parameters,
optimizer state, inputs and caches are DTensors placed by the sharding
rules, and the step runs op by op as on a card, its kernels through their
operators' fake implementations
(:mod:`repro_torch.kernels.flash_attention`).  What one rank does is then
counted as it dispatches (:class:`repro_torch.launch.trace_analysis.
StepTally`).  The numbers are counts on a fake world, not measurements.

A record has the reference's keys (file names ``<arch>__<shape>__<mesh>__
<tag>.json`` under ``experiments/dryrun_torch/``):

* ``memory`` (per rank): ``argument_bytes``, the local shards of the
  parameters, optimizer state, inputs and caches; ``output_bytes``, the
  local shards of what the step returns; ``alias_bytes``, what the
  reference donates (parameters and optimizer state to train, the cache
  to decode: the port writes the cache in place); ``temp_bytes``, the peak
  of the storages the step makes alive at once (its outputs among them),
  so ``argument_bytes + temp_bytes`` is the rank's peak.  On ``cuda``
  each storage is counted in the caching allocator's 512-byte blocks;
* ``cost`` (per rank): ``flops``, the operations of the rank's local
  ops by ``torch.utils.flop_counter``'s formulas (a DTensor-level count
  would be the global one), the flash kernels by their valid keys alone;
  ``bytes_accessed``, each op's input and output bytes summed (an upper
  bound: no fusion); ``transcendentals``, ``-1`` (not counted);
* ``collectives`` (per rank): ``total_wire_bytes``, ``bytes_by_op``,
  ``count_by_op`` by the reference's ring cost models
  (:func:`repro_torch.launch.trace_analysis.wire_bytes`);
* ``calibration`` and ``cost_corrected``: the reference's k = 1 and
  k = 2 unscanned variants combined as ``rest + R·body``.  XLA's cost
  analysis visits a loop body once, which is what they correct; a run
  visits every layer, so ``cost`` is already the full-depth count, and
  the combination equals it where a period is one layer
  (``tests/test_torch_dryrun.py`` holds it to that).  Where a period is
  several layers (jamba, the vlm) training recomputes a little less in
  the unscanned variants: ``torch.utils.checkpoint`` stops a region's
  recompute once the tensors its backward needs are back, and the
  unscanned variants checkpoint a layer at a time where the scanned
  stack checkpoints a period (with the early stop off they agree
  exactly, as the test shows);
* ``params_total``, ``params_active``, ``model_flops``, ``tokens``: the
  reference's formulas.

``lower_s`` is the time to place the arguments, ``compile_s`` the traced
run's.  ``--peak-top N`` adds ``memory.peak_top``: the N largest
storages live at the peak, each with the op that made it and the port's
code that called it.  ``--prune-causal`` and ``--attn-block`` have no counterpart (the
card's kernels always skip the masked tiles and size their own) and
raise ``ValueError``.

The decode step writes slot ``seq_len - 1`` of a full cache (the
reference attends over every slot under its mask, so that is the same
work).  Under ``kv_shard="seq"`` (the decode cells' ``"auto"``) each
rank holds its slots of every layer's cache and attends to them alone,
the ranks' partial outputs merged by their log-sum-exp
(``models/attention.py``).  ``--moe-groups G`` sets the MoE layers'
``dispatch_groups`` (a multiple of the batch ranks: 16 on 16 × 16, 32 on
2 × 16 × 16); each rank then dispatches its own groups, and without it
its own rows' hits of a global routing (``models/moe.py``); a record's
``opts`` and ``--summary`` show it.

Every entry point simulates ``cuda`` ranks unless the caller passes
``--device cpu``, where the kernels' plain versions run (as the tests
do).  A ``cuda`` cell needs a PyTorch built with CUDA (its indexing and
autograd look up the device), not a card.

Usage::

  python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k [--multi-pod]
  python -m repro_torch.launch.dryrun --all [--jobs 8]   # every cell, a process each
  python -m repro_torch.launch.dryrun --summary           # the records as a table
  python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k \\
      --mesh 1x1 --batch 4 --seq 2048                    # a small world
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ARCH_IDS, SHAPES, Shape, get_config, get_reduced
from repro_torch.distributed.sharding import (
    BASE_RULES,
    ShardingRules,
    axis_size,
    batch_shardings,
    from_global,
    on_mesh,
    param_shardings,
    place_state,
    placed_empty,
)
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.trace_analysis import StepTally
from repro_torch.models.model import build
from repro_torch.models.transformer import _layer_plan, count_params, tree_map
from repro_torch.optim.adamw import AdamW, AdamWConfig
from repro_torch.train.train_step import (
    _pod_mesh,
    make_train_step_compressed,
    make_train_step_sharded,
    opt_state_specs,
)

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"


def make_rules(shape, mesh, opts) -> ShardingRules:
    """The reference's rules of a cell: ``kv_shard`` (``"auto"``: ``"seq"``
    to decode, else ``"none"``), the batch left whole where the data axes
    do not divide it, then each ``--rules-override`` ``name=axis`` (``a+b``
    a tuple, ``None``/``none``/empty nothing)."""
    rules = ShardingRules(dict(BASE_RULES))
    kv = opts.kv_shard
    if kv == "auto":
        kv = "seq" if shape.kind == "decode" else "none"
    if kv == "heads":
        rules = rules.override(act_kv_heads="model")
    elif kv == "seq":
        rules = rules.override(kv_cache_seq="model", act_kv_heads=None)
    if shape.global_batch % axis_size(mesh, ("pod", "data")) != 0:
        rules = rules.override(batch=None)
    for ov in opts.rules_override:
        k, v = ov.split("=")
        rules = rules.override(**{k: None if v in ("None", "none", "") else
                                  tuple(v.split("+")) if "+" in v else v})
    return rules


def skip_reason(cfg, shape) -> Optional[str]:
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return (
            "pure full-attention arch: a 524k-token dense KV decode is the "
            "quadratic regime long_500k excludes (DESIGN.md §5)"
        )
    return None


def tune_cfg(cfg, shape, opts):
    """The reference's knobs on a config.  ``prune_causal`` and
    ``attn_block`` have no counterpart and raise."""
    if opts.prune_causal:
        raise ValueError("--prune-causal has no counterpart: the card's flash kernels "
                         "always skip the key tiles above the diagonal")
    if opts.attn_block:
        raise ValueError("--attn-block has no counterpart: the card's flash kernels size "
                         "their own tiles (kernels/flash_attention.py FWD_BLOCK, FWD_KT, BLOCK_Q, "
                         "BLOCK_K)")
    if opts.no_remat:
        cfg = cfg.replace(remat=False)
    if shape.kind != "train":
        cfg = cfg.replace(remat=False)
    if opts.remat_policy != "full":
        cfg = cfg.replace(remat_policy=opts.remat_policy)
    if opts.moe_groups and cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch_groups=opts.moe_groups))
    if cfg.ssm is not None and (opts.ssd_chunk or opts.ssd_bf16):
        kw = {}
        if opts.ssd_chunk:
            kw["chunk"] = opts.ssd_chunk
        if opts.ssd_bf16:
            kw["compute_dtype"] = "bfloat16"
        cfg = cfg.replace(ssm=dataclasses.replace(cfg.ssm, **kw))
    return cfg


def decode_pos(shape) -> int:
    """The slot a decode cell writes: the last of a full cache."""
    return shape.seq_len - 1


def _fake_leaf(meta, mesh, pl, device, fill=None):
    return placed_empty(meta.shape, meta.dtype, mesh, pl, device, fill=fill)


def cell_step(cfg, shape, mesh, rules, opts, *, device,
              params: Optional[Dict[str, Any]] = None,
              inputs: Optional[Dict[str, torch.Tensor]] = None
              ) -> Tuple[Callable, Tuple[Any, ...], Tuple[int, ...]]:
    """``(step, args, donated)``: the cell's step as a function of its
    arguments, those arguments placed on ``mesh`` by ``rules``, and the
    indices of the arguments the reference donates.

    ``params`` and ``inputs`` are global values every rank holds (each
    keeps its shard); left out, each leaf is ``torch.empty`` of its
    local shape, which under ``FakeTensorMode`` holds no memory.  The
    optimizer moments, the compressed step's residual and the caches are
    zeros.  Train: ``make_train_step_sharded`` (with ``--compress-pods``
    on a mesh with ``pod``, ``make_train_step_compressed``, whose state
    lies on each pod's ``(data, model)`` mesh and whose batch every rank
    holds whole); prefill: ``Model.prefill``; decode:
    ``Model.decode_step`` at :func:`decode_pos`, its cache placed by
    ``Model.cache_axes``."""
    model = build(cfg)
    metas, specs = model.abstract()
    compress = (shape.kind == "train" and opts.compress_pods
                and "pod" in mesh.mesh_dim_names)
    p_mesh, p_rules = (_pod_mesh(mesh), rules.strip("pod")) if compress else (mesh, rules)
    p_pl = param_shardings(specs, p_mesh, p_rules)
    if params is None:
        params = tree_map(lambda m, pl: _fake_leaf(m, p_mesh, pl, device), metas, p_pl)
    else:
        params = place_state(params, p_pl, p_mesh)
    in_specs = model.input_specs(shape)
    in_pl = batch_shardings(in_specs, mesh, rules)
    if compress:   # the compressed step takes each pod's slice of the global batch
        batch = ({k: torch.empty(v.shape, dtype=v.dtype, device=device)
                  for k, v in in_specs.items()} if inputs is None else dict(inputs))
    elif inputs is None:
        batch = {k: _fake_leaf(v, mesh, in_pl[k], device) for k, v in in_specs.items()
                 if k != "pos"}
    else:
        batch = {k: from_global(v, mesh, in_pl[k]) for k, v in inputs.items() if k != "pos"}

    if shape.kind == "train":
        opt = AdamW(AdamWConfig())
        zeros = lambda m, pl: _fake_leaf(m, p_mesh, pl, device, fill=0.0)
        f32 = tree_map(lambda m: torch.empty(m.shape, dtype=torch.float32, device="meta"),
                       metas)
        o_pl = param_shardings(opt_state_specs(specs), p_mesh, p_rules)
        opt_state = {"mu": tree_map(zeros, f32, o_pl["mu"]),
                     "nu": tree_map(zeros, f32, o_pl["nu"]),
                     "step": torch.zeros((), dtype=torch.int32, device=device)}
        if compress:
            step = make_train_step_compressed(model, opt, mesh, n_micro=opts.n_micro,
                                              rules=rules)
            residual = tree_map(zeros, f32, p_pl)
            return step, (params, opt_state, residual, batch), (0, 1, 2)
        step = make_train_step_sharded(model, opt, mesh, rules, n_micro=opts.n_micro)
        return step, (params, opt_state, batch), (0, 1)

    if shape.kind == "prefill":
        def prefill(params, batch):
            with on_mesh(mesh, rules):
                return model.prefill(params, batch)
        return prefill, (params, batch), ()

    pos = decode_pos(shape)
    with on_mesh(mesh, rules):
        caches = model.init_cache(shape.global_batch, shape.seq_len, device=device)

    def decode(params, caches, tokens):
        with on_mesh(mesh, rules):
            return model.decode_step(params, caches, tokens, pos)
    return decode, (params, caches, batch["tokens"]), (1,)


def account(step: Callable, args: Tuple[Any, ...], donated: Tuple[int, ...],
            device_type: str, top: int = 0) -> Dict[str, Any]:
    """Run ``step(*args)`` under a :class:`StepTally` and return the
    record's ``memory`` (with ``top`` > 0 its ``peak_top``: the ``top``
    largest storages live at the peak), ``cost`` and ``collectives``, and
    the step's outputs under ``"outputs"`` (for a caller that checks
    them)."""
    tally = StepTally(device_type, top=top)
    arg_bytes = tally.hold(args)
    t0 = time.time()
    with tally:
        outputs = step(*args)
    run_s = time.time() - t0
    stats = tally.collective_stats()
    memory = {
        "argument_bytes": int(arg_bytes),
        "output_bytes": int(tally.tensor_bytes(outputs)),
        "temp_bytes": int(tally.peak_bytes),
        "alias_bytes": int(tally.tensor_bytes([args[i] for i in donated])),
    }
    if top:
        memory["peak_top"] = tally.peak_top
    return {
        "compile_s": round(run_s, 2),
        "memory": memory,
        "cost": {"flops": float(tally.flops), "bytes_accessed": float(tally.bytes_accessed),
                 "transcendentals": -1.0},
        "collectives": {"total_wire_bytes": stats.total_wire_bytes,
                        "bytes_by_op": stats.bytes_by_op, "count_by_op": stats.count_by_op},
        "outputs": outputs,
    }


def compile_cell(cfg, shape, mesh, rules, opts) -> dict:
    """Run one step on this rank of a fake world under ``FakeTensorMode``
    (see the module's note) and return the record's fields, the
    collectives always among them."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    device = torch.device(mesh.device_type)
    if device.type == "cuda" and not torch.backends.cuda.is_built():
        raise RuntimeError("simulated cuda ranks need a PyTorch built with CUDA (indexing "
                           "and autograd look up the device; no card is used): run with "
                           "--device cpu, or where PyTorch has CUDA")
    t0 = time.time()
    with FakeTensorMode(allow_non_fake_inputs=False):
        step, args, donated = cell_step(cfg, shape, mesh, rules, opts, device=device)
        lower_s = time.time() - t0
        out = account(step, args, donated, device.type, top=getattr(opts, "peak_top", 0))
    out.pop("outputs")
    return {"lower_s": round(lower_s, 2), **out}


def calib_config(cfg, k: int):
    """A k-period unscanned config (the reference's calibration
    variant; the port has no loops to unroll)."""
    plan = _layer_plan(cfg)
    n = len(plan.prefix) + k * len(plan.period)
    kw = dict(n_layers=n, scan_layers=False)
    if cfg.family == "audio":
        kw["n_enc_layers"] = k
    return cfg.replace(**kw)


def _combine_cost(f1: dict, f2: dict, repeats: int) -> dict:
    """total = rest + R·body, with body = f2 - f1 and rest = f1 - body."""
    out = {}
    for key in ("flops", "bytes_accessed", "transcendentals"):
        a, b = f1["cost"].get(key, -1), f2["cost"].get(key, -1)
        if a is None or a < 0 or b < 0:
            out[key] = -1
            continue
        body = max(b - a, 0.0)
        out[key] = a + (repeats - 1) * body
    c1 = f1.get("collectives", {}).get("bytes_by_op", {})
    c2 = f2.get("collectives", {}).get("bytes_by_op", {})
    coll = {}
    for op in set(c1) | set(c2):
        a, b = c1.get(op, 0.0), c2.get(op, 0.0)
        coll[op] = a + (repeats - 1) * max(b - a, 0.0)
    out["collective_bytes_by_op"] = coll
    out["collective_wire_bytes"] = sum(coll.values())
    return out


def mesh_tag(opts) -> str:
    if opts.mesh:
        return opts.mesh
    return "2x16x16" if opts.multi_pod else "16x16"


def cell_shape(shape_name: str, opts) -> Shape:
    """``SHAPES[shape_name]``, its batch and length replaced by
    ``--batch`` and ``--seq`` where given."""
    shape = SHAPES[shape_name]
    kw = {}
    if getattr(opts, "batch", 0):
        kw["global_batch"] = opts.batch
    if getattr(opts, "seq", 0):
        kw["seq_len"] = opts.seq
    return dataclasses.replace(shape, **kw) if kw else shape


def cell_mesh(opts):
    """The cell's mesh over the fake world this process joins: the
    production mesh, or ``--mesh DxM`` (``PxDxM`` with a ``pod`` axis)."""
    if not opts.mesh:
        mesh_lib.join_fake_world(512 if opts.multi_pod else 256, device=opts.device)
        return mesh_lib.make_production_mesh(multi_pod=opts.multi_pod, device=opts.device)
    dims = [int(d) for d in opts.mesh.split("x")]
    n = 1
    for d in dims:
        n *= d
    mesh_lib.join_fake_world(n, device=opts.device)
    if len(dims) == 3:
        return mesh_lib.make_debug_mesh(dims[1], dims[2], n_pod=dims[0], device=opts.device)
    return mesh_lib.make_debug_mesh(*dims, device=opts.device)


def run_cell(arch: str, shape_name: str, multi_pod: bool, opts) -> dict:
    """One cell's record (see the module's note).  Joins the fake world:
    a process runs one cell."""
    shape = cell_shape(shape_name, opts)
    cfg = get_reduced(arch) if opts.reduced else get_config(arch)
    opts.multi_pod = multi_pod
    mesh = cell_mesh(opts)
    record = {
        "arch": arch,
        "shape": shape_name,
        "kind": shape.kind,
        "mesh": "x".join(str(s) for s in mesh.mesh.shape),
        "n_devices": mesh.size(),
        "device": mesh.device_type,
        "counts": "fake world: counted on one rank, not measured",
        "opts": {
            "kv_shard": opts.kv_shard,
            "prune_causal": opts.prune_causal,
            "n_micro": opts.n_micro,
            "compress_pods": opts.compress_pods,
            "no_remat": opts.no_remat,
            "attn_block": opts.attn_block,
            "rules_override": opts.rules_override,
            "moe_groups": opts.moe_groups,
        },
    }
    if opts.batch or opts.seq or opts.reduced:
        record["shape_override"] = {"global_batch": shape.global_batch,
                                    "seq_len": shape.seq_len, "reduced": opts.reduced}
    reason = skip_reason(cfg, shape)
    if reason:
        record["skip"] = reason
        return record

    cfg = tune_cfg(cfg, shape, opts)
    rules = make_rules(shape, mesh, opts)
    main = compile_cell(cfg, shape, mesh, rules, opts)
    record.update(main)
    print("memory:", record.get("memory"))
    print("cost:", record.get("cost"))

    if not opts.no_calibrate:
        repeats = _layer_plan(cfg).repeats
        copts = argparse.Namespace(**vars(opts))
        copts.n_micro = 1
        f1 = compile_cell(calib_config(cfg, 1), shape, mesh, rules, copts)
        f2 = compile_cell(calib_config(cfg, 2), shape, mesh, rules, copts)
        record["calibration"] = {"k1": f1, "k2": f2, "repeats": repeats}
        record["cost_corrected"] = _combine_cost(f1, f2, repeats)

    record.update(model_counts(cfg, shape))
    return record


def model_counts(cfg, shape) -> Dict[str, int]:
    """The reference's model-level counts of a cell: parameters (all, and
    those a token runs through), the tokens of the step and ``6·N·T``
    (train) or ``2·N·T`` flops."""
    active = count_params(cfg, active_only=True)
    tokens = shape.global_batch * (shape.seq_len if shape.kind in ("train", "prefill") else 1)
    mult = 6 if shape.kind == "train" else 2
    return {"params_total": count_params(cfg), "params_active": active,
            "model_flops": mult * active * tokens, "tokens": tokens}


def cell_list(opts):
    cells = []
    for arch in (opts.arch.split(",") if opts.arch else ARCH_IDS):
        for shape in (opts.shape.split(",") if opts.shape else list(SHAPES)):
            for mp in ([opts.multi_pod] if not opts.both_meshes else [False, True]):
                cells.append((arch, shape, mp))
    return cells


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out-dir", default=str(OUT_DIR))
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--subprocess", action="store_true",
                    help="run each cell in its own process (used by --all)")
    ap.add_argument("--kv-shard", default="auto", choices=["auto", "heads", "seq", "none"])
    ap.add_argument("--prune-causal", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--attn-block", type=int, default=0)
    ap.add_argument("--compress-pods", action="store_true")
    ap.add_argument("--no-calibrate", action="store_true")
    ap.add_argument("--remat-policy", default="full", choices=["full", "dots"])
    ap.add_argument("--moe-groups", type=int, default=0)
    ap.add_argument("--ssd-chunk", type=int, default=0)
    ap.add_argument("--ssd-bf16", action="store_true")
    ap.add_argument("--rules-override", action="append", default=[])
    # the port's own
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the device type the fake ranks simulate")
    ap.add_argument("--jobs", type=int, default=1, help="cells run at once (parent mode)")
    ap.add_argument("--mesh", default="",
                    help="DxM or PxDxM: a debug mesh over a fake world of that size "
                         "in place of the production mesh")
    ap.add_argument("--batch", type=int, default=0, help="the shape's global batch")
    ap.add_argument("--seq", type=int, default=0, help="the shape's sequence length")
    ap.add_argument("--reduced", action="store_true", help="the arch's reduced config")
    ap.add_argument("--peak-top", type=int, default=0,
                    help="record the N largest storages live at the peak (a diagnostic: "
                         "it walks the stack at every op)")
    ap.add_argument("--summary", action="store_true",
                    help="print the records of --out-dir with --tag as a table and exit")
    return ap


# An H100's device memory, the budget a rank's peak is set against.
H100_BYTES = 80e9


def summary(out_dir: Path, tag: str = "baseline") -> str:
    """The records of ``out_dir`` with ``tag`` (several comma-separated:
    a row each) as a markdown table, a row an (arch, shape) in
    :func:`cell_list`'s order with the 16 × 16 and 2 × 16 × 16 cells side
    by side: each cell's peak a rank (``argument_bytes + temp_bytes``, GB)
    and whether it fits an H100's 80 GB, with ``G=<n>`` where the cell ran
    with ``--moe-groups``, its traced flops a rank and its collectives'
    wire GB a rank (all-gather / all-reduce / reduce-scatter); then the
    skipped cells, and any cell with an error or no record."""
    def cell(arch, shape, mesh, tag):
        path = Path(out_dir) / f"{arch}__{shape}__{mesh}__{tag}.json"
        if not path.exists():
            return "missing"
        r = json.loads(path.read_text())
        if "skip" in r:
            return "skip"
        if "error" in r:
            return f"error: {r['error'][:80]}"
        m, b = r["memory"], r["collectives"]["bytes_by_op"]
        peak = m["argument_bytes"] + m["temp_bytes"]
        wire = "/".join(f"{b.get(op, 0) / 1e9:.3g}"
                        for op in ("all_gather", "all_reduce", "reduce_scatter"))
        groups = r.get("opts", {}).get("moe_groups", 0)
        return (f"{peak / 1e9:.2f} ({m['argument_bytes'] / 1e9:.2f} + "
                f"{m['temp_bytes'] / 1e9:.2f}) {'yes' if peak <= H100_BYTES else '**no**'}"
                f"{f', G={groups}' if groups else ''} | "
                f"{r['cost']['flops']:.4g} | {wire}")

    rows = ["| arch | shape | 16x16: peak GB a rank (arg + temp), fits 80 GB | flops a rank "
            "| wire GB a rank ag/ar/rs | 2x16x16: peak GB (arg + temp), fits | flops | wire GB |",
            "|---|---|---|---|---|---|---|---|"]
    skipped, bad = [], []
    for arch, shape, _ in cell_list(argparse.Namespace(arch=None, shape=None,
                                                       multi_pod=False, both_meshes=False)):
        for t in tag.split(","):
            one, two = cell(arch, shape, "16x16", t), cell(arch, shape, "2x16x16", t)
            if one == two == "missing" and "," in tag:
                continue
            if one == two == "skip":
                skipped.append(f"{arch} {shape}")
            elif "|" not in one or "|" not in two:
                bad.append(f"{arch} {shape}: {one}; {two}")
            else:
                rows.append(f"| {arch} | {shape} | {one} | {two} |")
    rows.append(f"\nSkipped on both meshes (the reference's skip_reason): "
                f"{', '.join(dict.fromkeys(skipped))}.")
    if bad:
        rows.append("Not ok: " + "; ".join(bad))
    return "\n".join(rows)


def _child_cmd(arch, shape, mp, opts, out_dir) -> list:
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", arch, "--shape", shape, "--tag", opts.tag,
           "--out-dir", str(out_dir), "--kv-shard", opts.kv_shard,
           "--n-micro", str(opts.n_micro), "--device", opts.device]
    if mp:
        # multi-pod proves the step runs; the calibrated cost is a
        # single-pod deliverable, as in the reference
        cmd += ["--multi-pod", "--no-calibrate"]
    for flag in ("prune_causal", "no_remat", "compress_pods", "no_calibrate", "reduced"):
        if getattr(opts, flag):
            cmd.append("--" + flag.replace("_", "-"))
    for flag in ("attn_block", "batch", "seq", "moe_groups", "peak_top"):
        if getattr(opts, flag):
            cmd += ["--" + flag.replace("_", "-"), str(getattr(opts, flag))]
    if opts.mesh:
        cmd += ["--mesh", opts.mesh]
    for ov in opts.rules_override:
        cmd += ["--rules-override", ov]
    return cmd


def main(argv=None) -> int:
    opts = parser().parse_args(argv)
    out_dir = Path(opts.out_dir).resolve()
    if opts.summary:
        print(summary(out_dir, opts.tag))
        return 0
    out_dir.mkdir(parents=True, exist_ok=True)

    if (opts.all or opts.subprocess or (opts.arch and "," in opts.arch) or not opts.arch
            or not opts.shape or (opts.shape and "," in opts.shape) or opts.both_meshes):
        # parent mode: a process a cell (a fake world a process)
        if opts.all:
            opts.arch = None
            opts.shape = None
            opts.both_meshes = True
        jobs = []
        for arch, shape, mp in cell_list(opts):
            tag = opts.mesh or ("2x16x16" if mp else "16x16")
            name = f"{arch}__{shape}__{tag}__{opts.tag}"
            if (out_dir / (name + ".json")).exists() and not os.environ.get("DRYRUN_FORCE"):
                print(f"[skip existing] {name}")
                continue
            jobs.append((name, _child_cmd(arch, shape, mp, opts, out_dir)))
        src = str(Path(__file__).resolve().parents[2])
        env = dict(os.environ)
        env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH")
                                   else "")

        def run(job):
            name, cmd = job
            t0 = time.time()
            r = subprocess.run(cmd, env=env, capture_output=True, text=True)
            return name, r, time.time() - t0

        failures = []
        with concurrent.futures.ThreadPoolExecutor(max(1, opts.jobs)) as pool:
            for name, r, secs in pool.map(run, jobs):
                print(f"=== {name} ({secs:.1f} s) ===", flush=True)
                sys.stdout.write(r.stdout[-2000:])
                if r.returncode != 0:
                    failures.append(name)
                    sys.stdout.write(r.stderr[-4000:])
                    print(f"[FAIL] {name}", flush=True)
        print(f"done; {len(failures)} failures: {failures}")
        return 1 if failures else 0

    # child mode: one cell
    name = f"{opts.arch}__{opts.shape}__{mesh_tag(opts)}__{opts.tag}"
    t0 = time.time()
    try:
        record = run_cell(opts.arch, opts.shape, opts.multi_pod, opts)
    except Exception as e:
        record = {
            "arch": opts.arch, "shape": opts.shape, "mesh": mesh_tag(opts),
            "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc(),
        }
        (out_dir / (name + ".json")).write_text(json.dumps(record, indent=2))
        print(record["traceback"], file=sys.stderr)
        return 1
    finally:
        mesh_lib.leave_world()
    record["wall_s"] = round(time.time() - t0, 2)
    (out_dir / (name + ".json")).write_text(json.dumps(record, indent=2))
    print(f"[ok] {name}" + (" (skipped: %s)" % record["skip"] if record.get("skip") else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
