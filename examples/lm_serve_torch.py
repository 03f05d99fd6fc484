"""Serve a (reduced) LM with batched requests on the PyTorch/CUDA port (the
counterpart of ``lm_serve.py``): prefill + greedy decode.

Demonstrates the serving half of the LM scaffold (KV and SSM caches,
batched prefill through the ``flash_attention`` kernel, token-by-token
decode) on any of the ten assigned architectures:

    PYTHONPATH=src python examples/lm_serve_torch.py --arch mamba2-1.3b \
        --steps 16 [--device cuda]

``--device cpu`` runs the kernels' plain PyTorch versions.
"""

import argparse
import time

import torch

from repro_torch.configs.base import get_reduced
from repro_torch.models.model import build
from repro_torch.train.serve_step import generate


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    opts = ap.parse_args()
    dev = torch.device(opts.device)

    cfg = get_reduced(opts.arch)
    model = build(cfg)
    params = model.init(0, device=dev)

    gen = torch.Generator().manual_seed(42)
    batch = {
        "tokens": torch.randint(0, cfg.vocab, (opts.batch, opts.prompt_len),
                                generator=gen).to(dev)
    }
    if cfg.family == "vlm":
        batch["media"] = 0.1 * torch.ones(
            (opts.batch, cfg.n_media_tokens, cfg.d_model), dtype=cfg.torch_dtype,
            device=dev)
    if cfg.family == "audio":
        batch = {
            "tokens": batch["tokens"][:, :1],
            "src_embeds": 0.1 * torch.ones(
                (opts.batch, opts.prompt_len, cfg.d_model), dtype=cfg.torch_dtype,
                device=dev),
        }

    t0 = time.time()
    with torch.no_grad():
        out = generate(model, params, batch, steps=opts.steps,
                       cache_len=opts.prompt_len + opts.steps + 8)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    print(f"arch={opts.arch} generated {tuple(out.shape)} tokens in {dt:.2f}s "
          f"({opts.batch * opts.steps / dt:.1f} tok/s, first call included)")
    print("sample:", out[0, :12].tolist())


if __name__ == "__main__":
    main()
