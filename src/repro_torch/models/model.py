"""Model facade of the LM families — dense, ``moe``, ``ssm``, ``hybrid``,
``vlm`` and ``audio`` (counterpart of :mod:`repro.models.model`):
``build(config)`` → ``init`` / ``train_loss`` / ``prefill`` /
``decode_step`` / ``init_cache``.

As in the JAX package the model holds no weights: ``init`` returns the
parameter tree, and the serving methods take it.  So a JAX tree converted
by :func:`repro_torch.convert.lm_params_from_jax` runs as it is.

Batch contents by family: ``tokens`` (and, to train, ``targets``) (B, S)
integers; the ``vlm`` family also ``media`` (B, M, d_model), precomputed
patch embeddings (the vision frontend is a stub), and the ``audio`` family
``src_embeds`` (B, S_src, d_model), precomputed frame embeddings (the
speech frontend is a stub) that the encoder runs over.  Either is cast to
the model's dtype first (the flash kernels take one dtype for q, k and v;
the JAX package declares them in the model's dtype too, in
``Model.input_specs``): that is the memory of the cross-attention layers,
the encoder's output after ``enc_ln_f`` for ``audio``.

Training: ``train_loss(params, batch)`` → (loss + aux, metrics with
``aux_loss``).  The
stack runs in train mode (no caches, ``cfg.remat``); on the card every
attention layer goes through the forward and backward flash kernels
(a Mamba layer's SSD is ``torch`` products: no kernel of the port's).
The aux loss is the MoE layers' load-balance and z-losses summed over the
stack (0 without MoE layers).  The logits and their per-token f32
loss are taken :data:`LOSS_CHUNK` tokens at a time under
``torch.utils.checkpoint``, and recomputed so in the backward: at
qwen3-1.7b's vocabulary (151,936 words) and 8,192 tokens one f32 copy of
all the logits is 5 GB, and the loss's backward would hold several.
Under a mesh each chunk holds rows of every data rank's own
(:func:`repro_torch.distributed.sharding.row_chunks`), so no rank
computes another's tokens.  The
token means are then taken over all tokens at once, as in
:func:`repro_torch.models.layers.cross_entropy`.

Serving:

* ``prefill(params, batch[, caches])`` → (last-token logits ``(B, 1, V)``,
  caches); on the card every attention layer (the encoder's, the
  self-attention and the cross-attention layers) launches the flash
  kernel once.  The attention caches (keys and values, or MLA's ``c_kv``
  and ``k_pe``) of the L prompt positions go to slots ``[0, L)`` of
  ``caches`` (from ``init_cache``, of any length >= L), each Mamba
  layer's conv tails and f32 state (no length axis) to its cache, and
  each cross-attention layer's memory keys and values to its cache,
  whose slots must number the memory's positions exactly (else
  ``ValueError``), in place; without ``caches`` it makes a cache of
  exactly L slots and the memory's length;
* ``decode_step(params, caches, tokens, pos)`` → (logits, caches) — one
  new token against the caches (attention at slot ``pos``; a Mamba layer
  steps its recurrence and ignores ``pos``; a cross-attention attends its
  cached memory, through the flash kernel on the card), written in place.

``init`` and ``init_cache`` run on ``device="cuda"`` unless the caller
passes ``"cpu"``, and raise without a card.

On a mesh (:func:`repro_torch.distributed.sharding.on_mesh`, parameters
placed by ``param_shardings``, inputs by ``batch_shardings``) both serving
methods run on DTensors, as the reference dry run's prefill and decode
branches jit them: ``init_cache`` under a mesh places each cache leaf by
its logical axes (:meth:`cache_axes`; the slots split over
``kv_cache_seq``, the kv heads over ``act_kv_heads``), every layer writes
its cache's local slots (:func:`repro_torch.distributed.sharding.
write_slots`), and a decode whose cache slots are split attends on each
rank to its own slots and merges the ranks' partial outputs by their
log-sum-exp (:func:`repro_torch.models.attention.merge_partials`; MLA in
its latent space): no rank gathers a layer's cache, as the reference
computes on the split keys.  The MoE layers run on each rank's own rows
and experts (:func:`repro_torch.models.moe._moe_on_mesh`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import (
    current_mesh,
    current_rules,
    gather_fsdp,
    logical_sharding,
    placed_empty,
    recompute_in_mesh,
    row_chunks,
    shard,
)
from repro_torch.models import transformer as tf
from repro_torch.models.layers import embed_lookup, rms_norm, token_mean, token_nll

# Tokens whose logits exist at once in the training loss: 1,024 of
# qwen3-1.7b's are 0.3 GB in bf16 and 0.6 GB in f32.
LOSS_CHUNK = 1024


class Model(torch.nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.plan = tf.layer_plan(cfg)
        self.enc_plan = tf.encoder_plan(cfg)

    def init(self, seed: int = 0, device: DeviceLike = None) -> Dict[str, Any]:
        """Random weights drawn on ``device`` from a generator seeded with
        ``seed``, at the JAX package's scales."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return tf.init_model(gen, self.cfg, dev)

    def abstract(self):
        """(the parameter tree as ``meta`` tensors, its logical-axes specs):
        :func:`repro_torch.models.transformer.abstract_model`."""
        return tf.abstract_model(self.cfg)

    def param_specs(self):
        """The logical axes of every parameter, a tree shaped like
        ``init``'s; :func:`repro_torch.distributed.sharding.param_shardings`
        maps it onto a mesh."""
        return self.abstract()[1]

    def memory_len(self, batch) -> int:
        """The memory's positions in ``batch``: its ``media`` (vlm) or
        ``src_embeds`` (audio) length; 0 for the other families."""
        key = {"vlm": "media", "audio": "src_embeds"}.get(self.cfg.family)
        return 0 if key is None else batch[key].shape[1]

    def _memory(self, params, batch) -> Optional[torch.Tensor]:
        """The cross-attention memory in the model's dtype: the vlm's
        ``media`` as it is, the audio's ``src_embeds`` through the encoder
        (no caches) and ``enc_ln_f``; None for the other families."""
        cfg = self.cfg
        if cfg.family == "vlm":
            return shard(batch["media"].to(cfg.torch_dtype), "batch", None, "act_embed")
        if cfg.family == "audio":
            m = shard(batch["src_embeds"].to(cfg.torch_dtype), "batch", "act_seq", "act_embed")
            m, _, _ = tf.stack_forward(params["encoder"], m, cfg, self.enc_plan)
            return rms_norm(m, params["enc_ln_f"], cfg.norm_eps)
        return None

    def _logits(self, params, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, params["ln_f"], self.cfg.norm_eps)
        if self.cfg.tie_embeddings:
            logits = x @ gather_fsdp(params["embed"]).t()
        else:
            logits = x @ gather_fsdp(params["lm_head"])
        return shard(logits, "batch", *("act_seq",) * (logits.dim() - 2), "act_vocab")

    def _embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        return shard(embed_lookup(params["embed"], tokens), "batch", "act_seq", "act_embed")

    def train_loss(self, params, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        x = self._embed(params, batch["tokens"])
        x, _, aux = tf.stack_forward(params["layers"], x, self.cfg, self.plan,
                                     memory=self._memory(params, batch))
        x, targets = x.reshape(-1, x.shape[-1]), batch["targets"].reshape(-1)
        chunk = lambda xc, tc: token_nll(self._logits(params, xc), tc)
        in_mesh = recompute_in_mesh()
        kw = {} if in_mesh is None else {"context_fn": in_mesh}
        parts = [checkpoint(chunk, xc, tc, use_reentrant=False, preserve_rng_state=False,
                            **kw)
                 for xc, tc in row_chunks(LOSS_CHUNK, x, targets)]
        loss, metrics = token_mean(torch.cat([p[0] for p in parts]),
                                   torch.cat([p[1] for p in parts]))
        metrics["aux_loss"] = aux
        return loss + aux, metrics

    @torch.no_grad()
    def prefill(self, params, batch, caches: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, Dict]:
        tokens = batch["tokens"]
        if caches is None:
            caches = self.init_cache(*tokens.shape, device=tokens.device,
                                     mem_len=self.memory_len(batch))
        memory = self._memory(params, batch)
        x = self._embed(params, tokens)
        x, caches, _ = tf.stack_forward(params["layers"], x, self.cfg, self.plan, caches,
                                        memory=memory)
        return self._logits(params, x[:, -1:, :]), caches

    @torch.no_grad()
    def decode_step(self, params, caches, tokens: torch.Tensor, pos: int
                    ) -> Tuple[torch.Tensor, Dict]:
        """tokens: (B, 1) integers; pos: the write slot in the cache."""
        x = self._embed(params, tokens)
        x, caches, _ = tf.stack_forward(params["layers"], x, self.cfg, self.plan, caches,
                                        pos=int(pos))
        return self._logits(params, x), caches

    def input_specs(self, shape) -> Dict[str, torch.Tensor]:
        """Shape-and-dtype stand-ins (``meta`` tensors) of every model input
        of a :class:`~repro_torch.configs.base.Shape`, the JAX package's
        shapes and dtypes (int32 tokens; the stubs' embeddings in the
        model's dtype).  ``train``: ``tokens`` and ``targets`` (B, S), the
        vlm's ``media`` (B, n_media_tokens, d), the audio's
        ``src_embeds`` (B, S, d); ``prefill``: ``tokens`` (B, S) and the
        vlm's ``media``, or for audio a one-token ``tokens`` (B, 1) and an
        S-frame ``src_embeds``; ``decode``: ``tokens`` (B, 1) and ``pos``
        ()."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        spec = lambda *shp, dtype=torch.int32: torch.empty(shp, dtype=dtype, device="meta")
        emb = lambda n: spec(B, n, cfg.d_model, dtype=cfg.torch_dtype)
        if shape.kind == "decode":
            return {"tokens": spec(B, 1), "pos": spec()}
        if shape.kind not in ("train", "prefill"):
            raise ValueError(shape.kind)
        if shape.kind == "prefill" and cfg.family == "audio":
            return {"tokens": spec(B, 1), "src_embeds": emb(S)}
        specs = {"tokens": spec(B, S)}
        if shape.kind == "train":
            specs["targets"] = spec(B, S)
        if cfg.family == "vlm":
            specs["media"] = emb(cfg.n_media_tokens)
        if cfg.family == "audio":
            specs["src_embeds"] = emb(S)
        return specs

    def cache_specs(self, batch: int, max_len: int, mem_len: Optional[int] = None):
        """The cache tree as ``meta`` tensors (shapes and dtypes); the
        cross-attention caches hold ``mem_len`` memory positions, by
        default the config's (``n_media_tokens`` for vlm, ``enc_seq`` for
        audio)."""
        cfg = self.cfg
        if mem_len is None:
            mem_len = {"vlm": cfg.n_media_tokens, "audio": cfg.enc_seq}.get(cfg.family, 0)
        return tf.stack_cache_specs(cfg, self.plan, batch, max_len, mem_len)

    def cache_axes(self, batch: int, max_len: int, mem_len: Optional[int] = None):
        """The logical axes of every cache leaf, a tree of tuples shaped
        like :meth:`cache_specs` (the reference's ``cache_specs`` second
        half); ``param_shardings`` maps it onto a mesh."""
        return tf.stack_cache_axes(self.cache_specs(batch, max_len, mem_len))

    def init_cache(self, batch: int, max_len: int, device: DeviceLike = None,
                   mem_len: Optional[int] = None):
        """A zero cache on ``device``: ``max_len`` slots in each
        self-attention layer's, ``mem_len`` (default the config's) in each
        cross-attention layer's, and each Mamba layer's tails and state.
        Under a mesh (``use_mesh``) each leaf is a DTensor placed by its
        logical axes and the active rules, each rank making its own
        shard."""
        dev = resolve_device(device)
        specs = self.cache_specs(batch, max_len, mem_len)
        mesh = current_mesh()
        if mesh is None:
            return tf.tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype, device=dev), specs)
        rules = current_rules()
        return tf.tree_map(
            lambda t: placed_empty(t.shape, t.dtype, mesh,
                                   logical_sharding(t.logical_axes, mesh, rules)[1], dev,
                                   fill=0.0), specs)


def build(cfg) -> Model:
    return Model(cfg)
