"""End-to-end fault-tolerant training on the PyTorch/CUDA port (the
counterpart of ``fault_tolerant_train.py``): checkpoint, kill, resume.

Phase 1 trains an LM for N steps with async checkpoints, then simulates a
node failure by abandoning the process state.  Phase 2 builds everything
from scratch and resumes from the newest atomic checkpoint: the losses go
on where they left off.  A final phase reshards the checkpoint onto a
different (elastic) mesh: this process joins a world of one (gloo on the
CPU, NCCL on the card) and places the restored state on a 1x1 ``(data,
model)`` mesh with ``repro_torch.distributed.elastic.reshard``.

    PYTHONPATH=src python examples/fault_tolerant_train_torch.py [--device cuda]

``--device cpu`` runs the kernels' plain PyTorch versions.
"""

import argparse
import tempfile
from pathlib import Path

import torch

from repro_torch.configs.base import get_reduced
from repro_torch.data.tokens import TokenStream, TokenStreamConfig
from repro_torch.distributed.checkpoint import CheckpointManager, host_tree
from repro_torch.distributed.elastic import reshard
from repro_torch.distributed.sharding import BASE_RULES, ShardingRules, use_mesh
from repro_torch.launch.mesh import join_world, leave_world, make_debug_mesh
from repro_torch.models.model import build
from repro_torch.models.transformer import tree_leaves
from repro_torch.optim.adamw import AdamW, AdamWConfig
from repro_torch.train.train_step import make_train_step, opt_state_specs
from repro_torch.train.trainer import Trainer, TrainerConfig


def build_everything(ckpt_dir, steps, device, seed=0, ckpt_every=5, batch=4, seq=64):
    cfg = get_reduced("qwen3-1.7b")
    model = build(cfg)
    params = model.init(seed, device=device)
    opt = AdamW(AdamWConfig(lr=1e-3, warmup_steps=5, decay_steps=steps))
    opt_state = opt.init(params)
    step_fn = make_train_step(model, opt)
    stream = TokenStream(TokenStreamConfig(vocab=cfg.vocab, batch=batch, seq_len=seq),
                         device=device)
    trainer = Trainer(
        step_fn, params, opt_state, iter(stream),
        TrainerConfig(total_steps=steps, ckpt_every=ckpt_every, ckpt_dir=ckpt_dir,
                      log_every=1),
    )
    return cfg, model, trainer, stream


def run(device="cuda", ckpt_dir=None, steps=(12, 20), ckpt_every=5, batch=4, seq=64):
    """The three phases: train ``steps[0]`` steps and drop everything,
    resume to ``steps[1]``, reshard the last checkpoint onto a 1x1 mesh of
    a world of one.  Returns the resumed trainer's step."""
    device = torch.device(device)
    ckpt_dir = ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_ft_")
    print("checkpoints:", ckpt_dir)
    kw = dict(ckpt_every=ckpt_every, batch=batch, seq=seq)

    # Phase 1: train, checkpoints every ckpt_every steps, then "crash".
    _, _, trainer, _ = build_everything(ckpt_dir, steps[0], device, **kw)
    trainer.run()
    losses1 = [s.metrics["loss"] for s in trainer.metrics.history]
    print(f"phase 1 done at step {trainer.step}; loss {losses1[0]:.3f} -> {losses1[-1]:.3f}")
    del trainer  # simulated node failure: all device state lost

    # Phase 2: fresh process state; resume from the newest atomic checkpoint.
    _, _, trainer2, stream2 = build_everything(ckpt_dir, steps[1], device, seed=1, **kw)
    assert trainer2.restore(), "no checkpoint found!"
    stream2.position = trainer2.step
    print(f"restored at step {trainer2.step}")
    trainer2.run()
    losses2 = [s.metrics["loss"] for s in trainer2.metrics.history]
    print(f"phase 2 done at step {trainer2.step}; last loss {losses2[-1]:.3f}")
    assert trainer2.step == steps[1]

    # Phase 3: elastic re-mesh: reload the final checkpoint onto a 1x1 mesh
    # (on a cluster: the survivors' mesh after dropping failed hosts).
    _, model, trainer3, _ = build_everything(ckpt_dir, steps[1], device, **kw)
    mgr = CheckpointManager(ckpt_dir)
    template = host_tree({"params": trainer3.params, "opt_state": trainer3.opt_state})
    host_state, manifest = mgr.restore(mgr.latest_step(), template)
    with tempfile.TemporaryDirectory() as rdv:
        join_world(0, 1, f"file://{Path(rdv) / 'rendezvous'}", device=device.type)
        try:
            mesh = make_debug_mesh(1, 1, device=device.type)
            specs = model.param_specs()
            full_specs = {"params": specs, "opt_state": opt_state_specs(specs)}
            rules = ShardingRules(BASE_RULES)
            with use_mesh(mesh, rules):
                placed = reshard(host_state, full_specs, mesh, rules)
            print(f"elastic reshard onto mesh {tuple(mesh.shape)} ok "
                  f"(step {manifest['step']}, {len(tree_leaves(placed))} leaves)")
        finally:
            leave_world()
    print("fault-tolerance drill complete")
    return trainer2.step


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    opts = ap.parse_args()
    run(opts.device)


if __name__ == "__main__":
    main()
