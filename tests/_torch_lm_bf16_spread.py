"""How far bf16 attention gradients lie apart when only their roundings
differ: the calibration behind ``BWD_BF16_ROW_TOL``
(``repro_torch/kernels/flash_attention.py``) and ``LM_GRAD_TOL``
(``chip_smoke.py``, ``tests/test_torch_cuda.py``).  Not a test (pytest
does not collect it); run it on a CPU:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_torch_lm_bf16_spread.py

It prints two JSON lines:

* ``row_gate``: for each shape, ``grad_row_error`` of the port's plain
  backward in bf16 against JAX's ``jax.vjp`` of ``blocked_attention`` in
  bf16, per gradient, and the worst over all;
* ``leaf_spread``: one bf16 step's gradients of the reduced qwen3-1.7b
  (2 layers) with the plain attention at two tile sizes (128 and 64
  rows), per leaf ``max |Δg| / max |g|``, and the worst.
"""

import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import torch

from repro.models.attention import blocked_attention
from repro_torch.configs.base import get_reduced
from repro_torch.kernels import flash_attention as FA
from repro_torch.launch.train import build_run
from repro_torch.models.transformer import tree_leaves
from repro_torch.train.train_step import grads_of

SHAPES = [(64, True), (130, True), (130, False), (300, True), (1000, True)]


def row_gate():
    out = {}
    for S, causal in SHAPES:
        rng = np.random.default_rng(S)
        q, k, v, do = [(rng.normal(size=s) * sc).astype(np.float32).astype(ml_dtypes.bfloat16)
                       for s, sc in [((2, S, 4, 32), .3), ((2, S, 2, 32), .3),
                                     ((2, S, 2, 32), .3), ((2, S, 4, 32), 1.0)]]
        f = lambda q, k, v: blocked_attention(q, k, v, causal=causal)
        _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
        want = vjp(jnp.asarray(do))
        t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
        tq, tk, tv, tdo = (t(a) for a in (q, k, v, do))
        _, lse, o32 = FA.flash_attention_plain(tq, tk, tv, causal=causal, return_lse=True)
        got = FA.flash_attention_bwd_plain(tq, tk, tv, o32, lse, tdo, causal=causal)
        out[f"S={S} causal={causal}"] = {
            name: FA.grad_row_error(g, t(w)) for name, g, w in zip("qkv", got, want)}
    worst = max(e for errs in out.values() for e in errs.values())
    return {"row_gate": out, "worst": worst}


def leaf_spread():
    cfg = get_reduced("qwen3-1.7b").replace(dtype="bfloat16", n_layers=2)
    run = build_run(cfg, steps=1, batch=2, seq=512, device="cpu")
    params, _ = run.init_state()
    batch = next(run.stream)
    grads = {}
    for block in (128, 64):
        FA.PLAIN_BLOCK = block
        grads[block] = tree_leaves(grads_of(run.model, params, batch)[0])
    errs = [float((a.float() - b.float()).abs().max() / b.float().abs().max())
            for a, b in zip(grads[128], grads[64])]
    return {"leaf_spread": errs, "worst": max(errs)}


if __name__ == "__main__":
    print(json.dumps(row_gate()))
    print(json.dumps(leaf_spread()))
