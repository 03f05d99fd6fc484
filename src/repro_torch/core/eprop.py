"""Inference-side pieces of the e-prop RSNN, as eager PyTorch tick loops
(counterpart of :mod:`repro.core.eprop`).

This slice keeps what serving needs: the configs, the datapath resolution
(weights snapped onto the membrane grid in quantized mode, self-recurrence
masked), the hoisted dense input projection, the valid-masked spike rate,
and the two plain inference loops — whole-sample
(:func:`run_sample_inference`) and carry-in / carry-out streaming
(:func:`run_stream_inference`).  These loops are the reference the port's
kernels and backend are tested against; the training entry points
(traces, factored update) arrive with the training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.core.neuron import NeuronConfig, li_step, lif_step


@dataclasses.dataclass(frozen=True)
class EpropConfig:
    mode: str = "factored"          # "exact" | "factored"
    feedback: str = "symmetric"     # "symmetric" (B = W_out) | "random"
    error: str = "softmax"          # "softmax" | "direct"
    target_amplitude: float = 1.0   # for error="direct"
    mask_self_recurrence: bool = True
    infer_window: str = "valid"     # accumulate readout over "valid" | "all" ticks


def _rec_mask(w_rec: torch.Tensor, cfg: EpropConfig) -> torch.Tensor:
    H = w_rec.shape[0]
    if cfg.mask_self_recurrence:
        return 1.0 - torch.eye(H, dtype=w_rec.dtype, device=w_rec.device)
    return torch.ones_like(w_rec)


def _datapath(params: Dict[str, torch.Tensor], ncfg: NeuronConfig,
              ecfg: EpropConfig):
    """``(w_in, w_rec_masked, w_out, rec_mask, y_scale)`` as the tick
    datapath consumes them: raw in float mode; SRAM codes scaled onto the
    membrane grid in quantized mode, with the error path reading
    ``y / threshold``."""
    rec_mask = _rec_mask(params["w_rec"], ecfg)
    q = ncfg.quant
    if q is None:
        return (params["w_in"], params["w_rec"] * rec_mask, params["w_out"],
                rec_mask, 1.0)
    return (
        q.to_membrane(params["w_in"]),
        q.to_membrane(params["w_rec"]) * rec_mask,
        q.to_membrane(params["w_out"]),
        rec_mask,
        1.0 / float(q.threshold),
    )


def _input_projection(raster: torch.Tensor, w_in_d: torch.Tensor) -> torch.Tensor:
    """The per-tick ``x_t @ w_in`` hoisted into one ``(T*B, N) @ (N, H)``
    product (exact in quantized mode: integer operands below 2**24)."""
    T, B, n_in = raster.shape
    return (raster.reshape(T * B, n_in) @ w_in_d).reshape(T, B, -1)


def _spike_rate(n_spk: torch.Tensor, valid: torch.Tensor, n_hid: int) -> torch.Tensor:
    """Valid-masked spike rate: spikes inside the TARGET_VALID window per
    valid tick-neuron (padding-invariant)."""
    return n_spk.sum() / (torch.clamp(valid.sum(), min=1.0) * n_hid)


def run_sample_inference(
    params: Dict[str, torch.Tensor],
    raster: torch.Tensor,       # (T, B, N_in)
    valid: torch.Tensor,        # (T, B)
    ncfg: NeuronConfig,
    ecfg: EpropConfig,
) -> Dict[str, torch.Tensor]:
    """Classify one ``(T, B)`` tile from zero state → ``{"acc_y", "pred",
    "spike_rate"}``."""
    T, B, _ = raster.shape
    H = params["w_rec"].shape[0]
    n_out = params["w_out"].shape[1]
    dt, dev = raster.dtype, raster.device
    alpha = torch.as_tensor(params["alpha"], dtype=dt, device=dev).expand(H)
    w_in_d, w_rec_d, w_out_d, _, _ = _datapath(params, ncfg, ecfg)
    in_cur = _input_projection(raster, w_in_d)

    v = torch.zeros((B, H), dtype=dt, device=dev)
    z = torch.zeros_like(v)
    y = torch.zeros((B, n_out), dtype=dt, device=dev)
    acc_y = torch.zeros_like(y)
    n_spk = torch.zeros((), dtype=dt, device=dev)
    for t in range(T):
        current = in_cur[t] + z @ w_rec_d
        v, z, _ = lif_step(v, current, alpha, ncfg)
        y = li_step(y, z @ w_out_d, ncfg.kappa, ncfg)
        w_inf = valid[t][:, None] if ecfg.infer_window == "valid" else 1.0
        acc_y = acc_y + y * w_inf
        n_spk = n_spk + (z * valid[t][:, None]).sum()
    return {
        "acc_y": acc_y,
        "pred": torch.argmax(acc_y, dim=-1),
        "spike_rate": _spike_rate(n_spk, valid, H),
    }


def run_stream_inference(
    params: Dict[str, torch.Tensor],
    raster: torch.Tensor,              # (T, B, N_in) one tick-tile of B sessions
    live: torch.Tensor,                # (T, B) dynamics mask
    valid: torch.Tensor,               # (T, B) readout-accumulation mask
    state: Dict[str, torch.Tensor],    # {"v","z","y","acc_y","n_spk"} carries
    ncfg: NeuronConfig,
    ecfg: EpropConfig,
) -> Dict[str, torch.Tensor]:
    """Carry-in / carry-out inference over one streaming tick-tile.

    ``live == 0`` freezes a session's state by select (no leak), so ragged
    chunks pack into one rectangular tile; ``valid`` (⊆ live) gates the
    readout accumulation only (``live`` does when ``infer_window=="all"``).
    """
    H = params["w_rec"].shape[0]
    dt, dev = raster.dtype, raster.device
    alpha = torch.as_tensor(params["alpha"], dtype=dt, device=dev).expand(H)
    w_in_d, w_rec_d, w_out_d, _, _ = _datapath(params, ncfg, ecfg)
    in_cur = _input_projection(raster, w_in_d)
    acc_all = ecfg.infer_window == "all"

    v, z, y, acc_y, n_spk = (state[k].to(dt) for k in ("v", "z", "y", "acc_y", "n_spk"))
    for t in range(raster.shape[0]):
        current = in_cur[t] + z @ w_rec_d
        v_new, z_new, _ = lif_step(v, current, alpha, ncfg)
        y_new = li_step(y, z_new @ w_out_d, ncfg.kappa, ncfg)
        keep = live[t][:, None] > 0
        v = torch.where(keep, v_new, v)
        z = torch.where(keep, z_new, z)
        y = torch.where(keep, y_new, y)
        w_acc = (live[t] if acc_all else valid[t])[:, None]
        acc_y = acc_y + y_new * w_acc
        n_spk = n_spk + (z_new * valid[t][:, None]).sum(dim=1, keepdim=True)
    return {"v": v, "z": z, "y": y, "acc_y": acc_y, "n_spk": n_spk}
