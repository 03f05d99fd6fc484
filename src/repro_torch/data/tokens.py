"""Synthetic LM token stream (counterpart of :mod:`repro.data.tokens`).

A Zipfian unigram source with a deterministic per-step draw: enough to
drive real optimisation (the loss falls from ln(V) toward the source's
entropy) without external data.  Batch ``position`` comes from NumPy's
``default_rng((seed, position))``, the JAX package's draw kept as it is,
so the port yields the same tokens bit for bit.  The stream carries an
explicit ``position``, so a restored checkpoint resumes mid-stream (the
trainer stores ``data_step``).

Batches are ``{"tokens", "targets"}`` of int64 ``(batch, seq_len)`` on the
stream's device (the card unless the caller passes ``"cpu"``).  The
``vlm`` family's batches also hold ``media`` ``(batch, n_media_tokens,
d_model)`` and the ``audio`` family's ``src_embeds`` ``(batch, seq_len,
d_model)``: stand-ins for a frontend's embeddings, ``0.02 ·
standard_normal`` drawn after the tokens from the same generator and kept
in f32, bit for bit the JAX stream's (the model casts them to its
dtype).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass
class TokenStreamConfig:
    vocab: int
    batch: int
    seq_len: int
    zipf_a: float = 1.2
    seed: int = 0
    d_model: int = 0           # for media/src stubs
    family: str = "dense"
    n_media_tokens: int = 0


class TokenStream:
    def __init__(self, cfg: TokenStreamConfig, position: int = 0,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.position = position
        self.device = resolve_device(device)
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self._p = (p / p.sum()).astype(np.float64)

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, self.position))
        self.position += 1
        toks = rng.choice(cfg.vocab, size=(cfg.batch, cfg.seq_len + 1), p=self._p)
        toks = torch.from_numpy(toks.astype(np.int64)).to(self.device)
        batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        stub = {"vlm": ("media", cfg.n_media_tokens),
                "audio": ("src_embeds", cfg.seq_len)}.get(cfg.family)
        if stub is not None:
            key, n = stub
            x = rng.standard_normal((cfg.batch, n, cfg.d_model)) * 0.02
            batch[key] = torch.from_numpy(x.astype(np.float32)).to(self.device)
        return batch
