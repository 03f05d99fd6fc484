"""e-prop for the ReckOn RSNN as eager PyTorch tick loops (counterpart of
:mod:`repro.core.eprop`) — the scan oracle the port's kernels and backend
are tested against.

e-prop (Bellec et al. 2020) for a LIF layer with decay ``alpha`` and an LI
readout with decay ``kappa``::

  eps_i[t]   = alpha * eps_i[t-1] + s_i[t]        presynaptic trace
  ebar_ij[t] = kappa * ebar_ij[t-1] + h_j[t] eps_i[t]
  L_j[t]     = sum_k B_jk err_k[t]                (B = W_out or random)
  dW_ij      = sum_t L_j[t] ebar_ij[t]            (applied as w -= lr dW)

* :func:`run_sample_exact` keeps the per-synapse filtered eligibility, as
  the chip's trace SRAM does;
* :func:`forward_traces` + :func:`factored_update` swap the two sums:
  ``sum_t L ebar = sum_s eps[s] h[s] F[s]`` with the reverse filter
  ``F[s] = L[s] + kappa F[s+1]``, so only O(T·H) traces are kept.

Both follow ``cfg.surrogate`` through :func:`pseudo_derivative`, as the
kernels do (``kernels/rsnn_step.py:pseudo_h``, whose triangular form
multiplies by the threshold's reciprocal where this one divides: an ulp
of ``h`` apart at some quantized membranes).  The inference loops
(:func:`run_sample_inference`, :func:`run_stream_inference`) and
:func:`forward_dynamics` (the bit-true probe) share the datapath
resolution: weights snapped onto the membrane grid in quantized mode,
self-recurrence masked, the readout error taken on ``y / threshold``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.core.neuron import NeuronConfig, li_step, lif_step, pseudo_derivative


@dataclasses.dataclass(frozen=True)
class EpropConfig:
    mode: str = "factored"          # "exact" | "factored"
    feedback: str = "symmetric"     # "symmetric" (B = W_out) | "random"
    error: str = "softmax"          # "softmax" | "direct"
    target_amplitude: float = 1.0   # for error="direct"
    mask_self_recurrence: bool = True
    infer_window: str = "valid"     # accumulate readout over "valid" | "all" ticks


def readout_error(y: torch.Tensor, y_star: torch.Tensor,
                  cfg: EpropConfig) -> torch.Tensor:
    """Per-tick output error ``err_k[t]`` (before TARGET_VALID masking)."""
    if cfg.error == "softmax":
        return torch.softmax(y, dim=-1) - y_star
    if cfg.error == "direct":
        return y - cfg.target_amplitude * y_star
    raise ValueError(cfg.error)


def _feedback(params: Dict[str, torch.Tensor], cfg: EpropConfig) -> torch.Tensor:
    """The feedback matrix ``B (H, O)`` in normalised weight units: the raw
    ``w_out`` (symmetric) or the fixed random ``b_fb``."""
    return params["w_out"] if cfg.feedback == "symmetric" else params["b_fb"]


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


# ---------------------------------------------------------------------------
# training: exact (per-synapse traces) and factored (scans + three products)
# ---------------------------------------------------------------------------


def _metrics(acc_y: torch.Tensor, n_spk, valid, n_hid: int):
    return {"acc_y": acc_y, "pred": torch.argmax(acc_y, dim=-1),
            "spike_rate": _spike_rate(n_spk, valid, n_hid)}


def run_sample_exact(
    params: Dict[str, torch.Tensor],
    raster: torch.Tensor,       # (T, B, N_in) {0,1}
    y_star: torch.Tensor,       # (B, O) one-hot
    valid: torch.Tensor,        # (T, B) TARGET_VALID mask
    ncfg: NeuronConfig,
    ecfg: EpropConfig,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """One tile with the per-synapse filtered eligibility updated every
    tick → ``(dw, metrics)``; ``dw`` are positive-gradient sums over the
    batch (applied as ``w -= lr * dw``).  ``params["alpha"]`` is a scalar
    or one decay a neuron ``(H,)``."""
    H = params["w_rec"].shape[0]
    alpha = torch.as_tensor(params["alpha"], dtype=raster.dtype,
                            device=raster.device).expand(H)
    w_in_d, w_rec_d, w_out_d, rec_mask, y_scale = _datapath(params, ncfg, ecfg)
    dw_in, dw_rec, dw_out, acc_y, n_spk = exact_tile(
        w_in_d, w_rec_d, w_out_d, _feedback(params, ecfg), alpha, raster,
        y_star, valid, y_scale, ncfg, ecfg)
    dw = {"w_in": dw_in, "w_rec": dw_rec * rec_mask, "w_out": dw_out}
    return dw, _metrics(acc_y, n_spk.sum(), valid, H)


def exact_tile(w_in_d, w_rec_d, w_out_d, b_fb, alpha, raster, y_star, valid,
               y_scale: float, ncfg: NeuronConfig, ecfg: EpropConfig):
    """The exact-mode tick loop on the datapath weights (membrane-grid
    images in quantized mode, ``w_rec`` self-recurrence masked) → ``(dw_in,
    dw_rec, dw_out, acc_y (B, O), n_spk (B, 1))``, the ``dw`` summed over
    the batch, ``dw_rec`` not masked.  ``alpha (H,)`` filters the
    presynaptic traces, and leaks the membrane in float mode."""
    T, B, n_in = raster.shape
    H = w_rec_d.shape[0]
    n_out = w_out_d.shape[1]
    dt, dev = raster.dtype, raster.device
    in_cur = _input_projection(raster, w_in_d)

    v = torch.zeros((B, H), dtype=dt, device=dev)
    z = torch.zeros_like(v)
    y = torch.zeros((B, n_out), dtype=dt, device=dev)
    eps_in = torch.zeros((B, n_in, H), dtype=dt, device=dev)
    eps_rec = torch.zeros((B, H, H), dtype=dt, device=dev)
    ebar_in, ebar_rec = torch.zeros_like(eps_in), torch.zeros_like(eps_rec)
    zbar = torch.zeros_like(v)
    dw_in = torch.zeros((n_in, H), dtype=dt, device=dev)
    dw_rec = torch.zeros((H, H), dtype=dt, device=dev)
    dw_out = torch.zeros((H, n_out), dtype=dt, device=dev)
    acc_y = torch.zeros_like(y)
    n_spk = torch.zeros((B, 1), dtype=dt, device=dev)
    for t in range(T):
        v_new, z_new, v_pre = lif_step(v, in_cur[t] + z @ w_rec_d, alpha, ncfg)
        y = li_step(y, z_new @ w_out_d, ncfg.kappa, ncfg)
        h = pseudo_derivative(v_pre, ncfg)
        eps_in = alpha * eps_in + raster[t][:, :, None]
        eps_rec = alpha * eps_rec + z[:, :, None]
        ebar_in = ncfg.kappa * ebar_in + h[:, None, :] * eps_in
        ebar_rec = ncfg.kappa * ebar_rec + h[:, None, :] * eps_rec
        zbar = ncfg.kappa * zbar + z_new
        err = readout_error(y * y_scale, y_star, ecfg) * valid[t][:, None]
        L = err @ b_fb.T
        dw_in = dw_in + torch.einsum("bih,bh->ih", ebar_in, L)
        dw_rec = dw_rec + torch.einsum("bkh,bh->kh", ebar_rec, L)
        dw_out = dw_out + torch.einsum("bh,bo->ho", zbar, err)
        w_inf = valid[t][:, None] if ecfg.infer_window == "valid" else 1.0
        acc_y = acc_y + y * w_inf
        n_spk = n_spk + (z_new * valid[t][:, None]).sum(dim=1, keepdim=True)
        v, z = v_new, z_new
    return dw_in, dw_rec, dw_out, acc_y, n_spk


def forward_traces(
    params: Dict[str, torch.Tensor],
    raster: torch.Tensor,      # (T, B, N_in)
    y_star: torch.Tensor,      # (B, O)
    valid: torch.Tensor,       # (T, B)
    ncfg: NeuronConfig,
    ecfg: EpropConfig,
):
    """Forward pass storing what the factored update needs →
    ``(h, xbar, pbar, zbar, err, y_inf, n_spk)``, each ``(T, B, ·)`` but
    ``n_spk (T,)``."""
    T, B, n_in = raster.shape
    H = params["w_rec"].shape[0]
    n_out = params["w_out"].shape[1]
    dt, dev = raster.dtype, raster.device
    alpha = torch.as_tensor(params["alpha"], dtype=dt, device=dev)
    if alpha.ndim != 0:
        raise ValueError("factored e-prop requires scalar alpha")
    w_in_d, w_rec_d, w_out_d, _, y_scale = _datapath(params, ncfg, ecfg)
    in_cur = _input_projection(raster, w_in_d)

    v = torch.zeros((B, H), dtype=dt, device=dev)
    z, pbar, zbar = torch.zeros_like(v), torch.zeros_like(v), torch.zeros_like(v)
    y = torch.zeros((B, n_out), dtype=dt, device=dev)
    xbar = torch.zeros((B, n_in), dtype=dt, device=dev)
    outs = {k: [] for k in ("h", "xbar", "pbar", "zbar", "err", "y_inf", "n_spk")}
    for t in range(T):
        v, z_new, v_pre = lif_step(v, in_cur[t] + z @ w_rec_d, alpha, ncfg)
        y = li_step(y, z_new @ w_out_d, ncfg.kappa, ncfg)
        xbar = alpha * xbar + raster[t]       # alpha-filtered input trace
        pbar = alpha * pbar + z               # presyn spikes: z BEFORE this tick
        zbar = ncfg.kappa * zbar + z_new      # kappa-filtered spikes
        vt = valid[t][:, None]
        outs["h"].append(pseudo_derivative(v_pre, ncfg))
        outs["xbar"].append(xbar)
        outs["pbar"].append(pbar)
        outs["zbar"].append(zbar)
        outs["err"].append(readout_error(y * y_scale, y_star, ecfg) * vt)
        outs["y_inf"].append(y * (vt if ecfg.infer_window == "valid" else 1.0))
        outs["n_spk"].append((z_new * vt).sum())
        z = z_new
    return tuple(torch.stack(outs[k]) for k in
                 ("h", "xbar", "pbar", "zbar", "err", "y_inf", "n_spk"))


def factored_update(
    params: Dict[str, torch.Tensor],
    h: torch.Tensor, xbar: torch.Tensor, pbar: torch.Tensor,
    zbar: torch.Tensor, err: torch.Tensor,
    ncfg: NeuronConfig, ecfg: EpropConfig,
) -> Dict[str, torch.Tensor]:
    """End-of-sample update: the reverse kappa-filter of the learning
    signal, then three products summed over ticks and the batch."""
    L = torch.einsum("tbo,ho->tbh", err, _feedback(params, ecfg))
    F = torch.empty_like(L)
    f = torch.zeros_like(L[0])
    for t in range(L.shape[0] - 1, -1, -1):
        f = L[t] + ncfg.kappa * f
        F[t] = f
    G = h * F
    return {
        "w_in": torch.einsum("tbi,tbh->ih", xbar, G),
        "w_rec": torch.einsum("tbk,tbh->kh", pbar, G) * _rec_mask(params["w_rec"], ecfg),
        "w_out": torch.einsum("tbh,tbo->ho", zbar, err),
    }


def run_sample_factored(params, raster, y_star, valid, ncfg: NeuronConfig,
                        ecfg: EpropConfig):
    h, xbar, pbar, zbar, err, y_inf, n_spk = forward_traces(
        params, raster, y_star, valid, ncfg, ecfg)
    dw = factored_update(params, h, xbar, pbar, zbar, err, ncfg, ecfg)
    return dw, _metrics(y_inf.sum(dim=0), n_spk.sum(), valid,
                        params["w_rec"].shape[0])


def run_sample(params, raster, y_star, valid, ncfg: NeuronConfig,
               ecfg: EpropConfig):
    """Dispatch on ``ecfg.mode``."""
    fn = run_sample_exact if ecfg.mode == "exact" else run_sample_factored
    return fn(params, raster, y_star, valid, ncfg, ecfg)


def forward_dynamics(
    params: Dict[str, torch.Tensor],
    raster: torch.Tensor,      # (T, B, N_in)
    ncfg: NeuronConfig,
    ecfg: EpropConfig,
) -> Dict[str, torch.Tensor]:
    """Full state trajectories — the probe the bit-true golden-reference
    tests drive: ``{"v": post-reset membrane (T, B, H), "v_pre", "z",
    "y" (T, B, O)}``; integers on the membrane grid in quantized mode."""
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
    outs = {k: [] for k in ("v", "v_pre", "z", "y")}
    for t in range(T):
        v, z, v_pre = lif_step(v, in_cur[t] + z @ w_rec_d, alpha, ncfg)
        y = li_step(y, z @ w_out_d, ncfg.kappa, ncfg)
        for k, x in (("v", v), ("v_pre", v_pre), ("z", z), ("y", y)):
            outs[k].append(x)
    return {k: torch.stack(x) for k, x in outs.items()}
