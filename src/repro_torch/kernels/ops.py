"""Kernel dispatch by tensor device, with a launch counter per kernel.

Each public op takes its tensors where they lie: on a CUDA device it
launches the hand-written kernel; on the CPU it runs the plain PyTorch
version.  Any other device raises — there is no silent fallback, and a
failed build or launch propagates.

``launches`` (re-exported from :mod:`repro_torch.kernels.launch`; the
wrappers in :mod:`repro_torch.kernels.rsnn_step`,
:mod:`repro_torch.kernels.eprop_update` and
:mod:`repro_torch.kernels.flash_attention` count each launch) holds plain
integers for all eight kernels (the six of the JAX package's Pallas
kernels, the attention backward, counted once a backward call, and
``rsnn_train_exact``, the exact-mode e-prop the JAX package runs as a
compiled scan): a run sets them to 0, drives the main path, and reads
them back to show the path went through the kernels.
``grid_launches[k]`` counts the share of train kernel ``k``'s launches
that reduced onto the integer commit grid.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quant import QuantizedMode, QuantSpec
from repro_torch.kernels import eprop_update as _train
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import rsnn_step as _rsnn
from repro_torch.kernels.launch import KERNELS, grid_launches, launches, reset_launch_counts

__all__ = ["KERNELS", "eprop_update", "flash_attention", "grid_launches", "launches",
           "reset_launch_counts", "rsnn_forward", "rsnn_infer",
           "rsnn_step_sessions", "rsnn_train", "rsnn_train_exact"]


def _on_card(t: torch.Tensor, op: str) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{op}: no kernel or plain version for device {t.device}")


def rsnn_infer(raster, valid, w_in, w_rec, w_out, *, alpha: float,
               kappa: float, v_th: float = 1.0, reset: str = "sub",
               quant: Optional[QuantizedMode] = None,
               infer_window: str = "valid"):
    """Inference over one ``(T, B)`` tile → ``(acc_y (B, O), n_spk (B, 1))``."""
    kw = dict(alpha=alpha, kappa=kappa, v_th=v_th, reset=reset, quant=quant,
              infer_window=infer_window)
    if not _on_card(raster, "rsnn_infer"):
        return _rsnn.rsnn_infer_plain(raster, valid, w_in, w_rec, w_out, **kw)
    return _rsnn.rsnn_infer_cuda(raster, valid, w_in, w_rec, w_out, **kw)


def rsnn_step_sessions(raster, live, valid, v0, z0, y0, acc0, nspk0, w_in,
                       w_rec, w_out, *, alpha: float, kappa: float,
                       v_th: float = 1.0, reset: str = "sub",
                       quant: Optional[QuantizedMode] = None,
                       infer_window: str = "valid"):
    """One session tick-tile, carries in and out → ``(v, z, y, acc_y, n_spk)``."""
    kw = dict(alpha=alpha, kappa=kappa, v_th=v_th, reset=reset, quant=quant,
              infer_window=infer_window)
    args = (raster, live, valid, v0, z0, y0, acc0, nspk0, w_in, w_rec, w_out)
    if not _on_card(raster, "rsnn_step_sessions"):
        return _rsnn.rsnn_step_sessions_plain(*args, **kw)
    return _rsnn.rsnn_step_sessions_cuda(*args, **kw)


def rsnn_forward(raster, w_in, w_rec, w_out, *, alpha: float, kappa: float,
                 v_th: float = 1.0, reset: str = "sub", boxcar_width: float = 0.5,
                 surrogate: str = "boxcar", gamma: float = 0.3,
                 quant: Optional[QuantizedMode] = None):
    """Trace-streaming forward over one ``(T, B)`` tile → ``{"z", "h",
    "xbar", "pbar", "zbar", "y", "v"}``, each ``(T, B, ·)``, ``h`` the
    ``surrogate``'s pseudo-derivative (``"boxcar"`` of half-width
    ``boxcar_width``, or ``"triangular"`` scaled by ``gamma``)."""
    kw = dict(alpha=alpha, kappa=kappa, v_th=v_th, reset=reset,
              boxcar_width=boxcar_width, surrogate=surrogate, gamma=gamma, quant=quant)
    if not _on_card(raster, "rsnn_forward"):
        return _rsnn.rsnn_forward_plain(raster, w_in, w_rec, w_out, **kw)
    return _rsnn.rsnn_forward_cuda(raster, w_in, w_rec, w_out, **kw)


def rsnn_train(raster, y_star, valid, w_in, w_rec, w_out, b_fb, *,
               alpha: float, kappa: float, v_th: float = 1.0,
               reset: str = "sub", boxcar_width: float = 0.5,
               surrogate: str = "boxcar", gamma: float = 0.3,
               quant: Optional[QuantizedMode] = None, error: str = "softmax",
               target_amplitude: float = 1.0, infer_window: str = "valid",
               commit_grid: Optional[QuantSpec] = None):
    """Fused forward + e-prop update over one ``(T, B)`` tile →
    ``(dw_in, dw_rec, dw_out, acc_y (B, O), n_spk (B, 1))``, ``dw`` summed
    over the batch, ``dw_rec`` not yet masked; the eligibility follows
    ``surrogate`` as :func:`rsnn_forward`'s ``h`` does.  With
    ``commit_grid`` the three ``dw`` are the rows' int32 codes on that
    grid, summed (the deterministic END_B path: equal for any split of the
    rows)."""
    kw = dict(alpha=alpha, kappa=kappa, v_th=v_th, reset=reset,
              boxcar_width=boxcar_width, surrogate=surrogate, gamma=gamma,
              quant=quant, error=error,
              target_amplitude=target_amplitude, infer_window=infer_window,
              commit_grid=commit_grid)
    args = (raster, y_star, valid, w_in, w_rec, w_out, b_fb)
    if not _on_card(raster, "rsnn_train"):
        return _train.rsnn_train_plain(*args, **kw)
    return _train.rsnn_train_cuda(*args, **kw)


def rsnn_train_exact(raster, y_star, valid, w_in, w_rec, w_out, b_fb, *,
                     alpha, kappa: float, v_th: float = 1.0, reset: str = "sub",
                     boxcar_width: float = 0.5, surrogate: str = "boxcar",
                     gamma: float = 0.3, quant: Optional[QuantizedMode] = None,
                     error: str = "softmax", target_amplitude: float = 1.0,
                     infer_window: str = "valid",
                     commit_grid: Optional[QuantSpec] = None):
    """Forward + exact-mode e-prop (per-synapse traces) over one ``(T, B)``
    tile → the outputs of :func:`rsnn_train`; ``alpha`` a scalar or one
    decay a neuron ``(H,)``."""
    kw = dict(alpha=alpha, kappa=kappa, v_th=v_th, reset=reset,
              boxcar_width=boxcar_width, surrogate=surrogate, gamma=gamma,
              quant=quant, error=error, target_amplitude=target_amplitude,
              infer_window=infer_window, commit_grid=commit_grid)
    args = (raster, y_star, valid, w_in, w_rec, w_out, b_fb)
    if not _on_card(raster, "rsnn_train_exact"):
        return _train.rsnn_train_exact_plain(*args, **kw)
    return _train.rsnn_train_exact_cuda(*args, **kw)


def eprop_update(h, xbar, pbar, zbar, err, b_fb, *, kappa: float):
    """The split reverse pass over ``(T, B, ·)`` traces → ``(dw_in, dw_rec,
    dw_out)``, ``dw_rec`` not yet masked."""
    args = (h, xbar, pbar, zbar, err, b_fb)
    if not _on_card(h, "eprop_update"):
        return _train.eprop_update_plain(*args, kappa=kappa)
    return _train.eprop_update_cuda(*args, kappa=kappa)


def flash_attention(q, k, v, *, causal: bool, kv_len: Optional[int] = None):
    """Causal GQA online-softmax attention over q ``(B, Sq, H, D)`` and k, v
    ``(B, Skv, Hkv, D)`` → ``(B, Sq, H, D)``; keys at positions
    ``>= kv_len`` (default ``Skv``) are masked.  With grad on and an input
    that requires it, the call goes through
    :class:`~repro_torch.kernels.flash_attention.FlashAttentionFn` (its
    backward a kernel too; no ``kv_len`` there).  On the card each launch
    goes through its operator (``torch.ops.repro_torch.*``,
    :mod:`repro_torch.kernels.flash_attention`), which a fake tensor
    reaches without a launch."""
    on_card = _on_card(q, "flash_attention")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if kv_len is not None and kv_len != k.shape[1]:
            raise ValueError("flash_attention: the differentiable path takes no kv_len")
        return _flash.FlashAttentionFn.apply(q, k, v, causal)
    if not on_card:
        return _flash.flash_attention_plain(q, k, v, causal=causal, kv_len=kv_len)
    return torch.ops.repro_torch.flash_attention(q, k, v, causal, kv_len)
