"""What each rank of a gloo world runs for ``tests/test_torch_exact.py``'s
mesh case.  The spawned ranks import this module by name, so it imports
neither JAX nor the JAX package.

Every rank loads the same inputs, runs the exact-mode ``train_tile`` of a
backend over a ``("data",)`` mesh of the whole world (float and on the
integer commit grid) and of a backend without one, and writes both to
``<out>/exact_w<world>_r<rank>.npz`` for the parent to compare.
"""

import dataclasses

import numpy as np
import torch

from repro_torch.core.backend import ExecutionBackend, RuntimeConfig
from repro_torch.core.quant import DW_COMMIT_SPEC
from repro_torch.core.rsnn import Presets
from repro_torch.launch.mesh import make_data_mesh


def exact_cfg(T, quantized):
    cfg = Presets.braille(n_classes=3, n_hid=16, num_ticks=T, quantized=quantized)
    return dataclasses.replace(cfg, eprop=dataclasses.replace(cfg.eprop, mode="exact"))


def run_exact(rank, world, in_path, out_dir):
    inp = dict(np.load(in_path))
    out = {}
    mesh = make_data_mesh(device="cpu")
    for tag, quantized, grid in (("float", False, None), ("grid", True, DW_COMMIT_SPEC)):
        w = {k: torch.from_numpy(inp[f"{tag}.{k}"]) for k in ("w_in", "w_rec", "w_out", "alpha")}
        args = [torch.from_numpy(inp[f"{tag}.{k}"]) for k in ("raster", "y_star", "valid")]
        cfg = exact_cfg(args[0].shape[0], quantized)
        for name, rt in (("mesh", RuntimeConfig(device="cpu", mesh=mesh, commit_grid=grid)),
                         ("one", RuntimeConfig(device="cpu", commit_grid=grid))):
            dw, m = ExecutionBackend(cfg, device=None, runtime=rt).train_tile(w, *args)
            out.update({f"{tag}.{name}.dw.{k}": v.numpy() for k, v in dw.items()})
            out.update({f"{tag}.{name}.{k}": v.numpy() for k, v in m.items()})
    np.savez(f"{out_dir}/exact_w{world}_r{rank}.npz", **out)
