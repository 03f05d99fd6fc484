"""Device-memory bytes each kernel launch moves (counterpart of the
serving and training formulas of :mod:`repro.kernels.traffic`), and the
operations of the event-driven RSNN kernels.

Counted as the kernels read and write them on the card: the raster and
masks once, the weights once per launch (each block re-reads them, but
from L2 after the first), carries once in and once out.  The serving
kernels write no per-tick tensor; ``rsnn_forward`` streams its seven;
``rsnn_train`` keeps its trace set in shared memory where it fits (its
device scratch otherwise is not counted: it is the kernel's own round
trip, not the function's input or output); ``rsnn_train_exact`` keeps a
ring of tick blocks in shared memory at every size.
``BatchedEngine`` sums
the serving formulas into ``hbm_bytes_streamed``; ``chip_smoke.py``
derives each kernel's bound from these.  The attention kernel's bytes and its exact-causal operation count
close the module.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.kernels.rsnn_step import F32_BYTES, weight_elems


def infer_fused_tiled_bytes(T: int, B: int, n_in: int, n_hid: int,
                            n_out: int) -> int:
    """``rsnn_infer``: raster + valid + weights in, ``(B, O)`` logits and
    ``(B, 1)`` spike counts out."""
    reads = T * B * n_in + T * B + weight_elems(n_in, n_hid, n_out)
    writes = B * n_out + B
    return F32_BYTES * (reads + writes)


def stream_step_tiled_bytes(T: int, B: int, n_in: int, n_hid: int,
                            n_out: int) -> int:
    """``rsnn_step_sessions``: the inference streams plus the ``live`` mask
    and the ``(2H + 2O + 1)`` carry elements per session, in and out."""
    state = B * (2 * n_hid + 2 * n_out + 1)
    reads = 2 * T * B + T * B * n_in + state + weight_elems(n_in, n_hid, n_out)
    return F32_BYTES * (reads + state)


def forward_traces_bytes(T: int, B: int, n_in: int, n_hid: int,
                         n_out: int) -> int:
    """``rsnn_forward``: raster + weights in, seven per-tick streams out
    (``z, h, pbar, zbar, v`` of width H, ``xbar`` N, ``y`` O)."""
    reads = T * B * n_in + weight_elems(n_in, n_hid, n_out)
    writes = T * B * (5 * n_hid + n_in + n_out)
    return F32_BYTES * (reads + writes)


def eprop_update_bytes(T: int, B: int, n_in: int, n_hid: int,
                       n_out: int) -> int:
    """``eprop_update``: the five trace streams and ``b_fb`` in, the three
    ``dw`` matrices out."""
    reads = T * B * (3 * n_hid + n_in + n_out) + n_hid * n_out
    writes = weight_elems(n_in, n_hid, n_out)
    return F32_BYTES * (reads + writes)


def train_fused_tiled_bytes(T: int, B: int, n_in: int, n_hid: int,
                            n_out: int) -> int:
    """``rsnn_train``: raster, valid, targets, weights and feedback in; the
    three ``dw`` matrices, ``(B, O)`` logits and ``(B, 1)`` spike counts
    out.  No row is padded on the card (a block masks its ragged edge)."""
    reads = (T * B * n_in + T * B + B * n_out
             + weight_elems(n_in, n_hid, n_out) + n_hid * n_out)
    writes = weight_elems(n_in, n_hid, n_out) + B * n_out + B
    return F32_BYTES * (reads + writes)


def forward_event_flops(T: int, B: int, n_in: int, n_hid: int, n_out: int,
                        input_events: int, spikes: int, fed_back: int) -> int:
    """Operations ``rsnn_forward`` needs on given data, as the event-driven
    kernel does them: a multiply and an add per hidden neuron for each
    nonzero input and for each spike fed back from the tick before
    (``fed_back``: the spikes of all ticks but the last), per output for
    each spike; then every row and tick, a multiply and an add per neuron
    for the membrane leak and the ``pbar`` and ``zbar`` filters, per input
    for the ``xbar`` filter and per output for the readout leak."""
    events = 2 * n_hid * (input_events + fed_back) + 2 * n_out * spikes
    return events + T * B * 2 * (3 * n_hid + n_in + n_out)


def train_event_flops(T: int, B: int, n_in: int, n_hid: int, n_out: int,
                      input_events: int, spikes: int, fed_back: int) -> int:
    """Operations ``rsnn_train`` needs on given data: its forward
    (:func:`forward_event_flops`), then the dense reverse pass, the
    learning signal (H·O) and the three ``dw`` products (E) a tick and
    row."""
    reverse = 2 * T * B * (weight_elems(n_in, n_hid, n_out) + n_hid * n_out)
    return forward_event_flops(T, B, n_in, n_hid, n_out, input_events, spikes,
                               fed_back) + reverse


def train_exact_bytes(T: int, B: int, n_in: int, n_hid: int, n_out: int) -> int:
    """``rsnn_train_exact``: :func:`train_fused_tiled_bytes` and the
    neurons' decays ``alpha (H)`` in."""
    return train_fused_tiled_bytes(T, B, n_in, n_hid, n_out) + F32_BYTES * n_hid


def train_exact_event_flops(T: int, B: int, n_in: int, n_hid: int, n_out: int,
                            input_events: int, spikes: int, fed_back: int) -> int:
    """Operations exact-mode e-prop needs on given data: the event-driven
    sums of :func:`forward_event_flops`, every row and tick the membrane
    leak and the ``zbar`` filter (a multiply and an add per neuron) and the
    readout leak (per output) — no ``xbar`` or ``pbar`` filter — then per
    row and tick 7 per synapse, ``(N + H)·H`` of them (``eps`` 2, ``ebar``
    3, ``dw`` 2), and the learning signal and ``dw_out`` (``2·H·O`` each)."""
    events = 2 * n_hid * (input_events + fed_back) + 2 * n_out * spikes
    per_tick = (2 * (2 * n_hid + n_out) + 7 * (n_in + n_hid) * n_hid
                + 4 * n_hid * n_out)
    return events + T * B * per_tick


def serve_event_flops(T: int, B: int, n_in: int, n_hid: int, n_out: int,
                      input_events: int, spikes: int, fed_back: int) -> int:
    """Operations ``rsnn_infer`` or ``rsnn_step_sessions`` needs on given
    data, as the event-driven kernels do them: a multiply and an add per
    hidden neuron for each nonzero input and for each spike fed back from
    the tick before (``fed_back``: the spikes of the carry that enters each
    tick), per output for each spike (``spikes``: every tick's, before the
    ``live`` select); then every row and tick, the membrane and readout
    leaks (a multiply and an add per neuron and per output) and the
    accumulator's multiply-add per output."""
    events = 2 * n_hid * (input_events + fed_back) + 2 * n_out * spikes
    return events + T * B * (2 * n_hid + 4 * n_out)


def flash_attention_bytes(B: int, Sq: int, Skv: int, H: int, Hkv: int, D: int,
                          itemsize: int, DV: Optional[int] = None) -> int:
    """``flash_attention`` at q/k width ``D`` and v width ``DV`` (default
    ``D``): q and the ``(B, Sq, H, DV)`` output once, k and v once each (the
    kernel re-reads a KV tile for every query tile and head of its group,
    from L2)."""
    DV = D if DV is None else DV
    return itemsize * (B * Sq * H * (D + DV) + B * Skv * Hkv * (D + DV))


def attention_valid_keys(Sq: int, kv_len: int, causal: bool) -> int:
    """Keys a query row attends, summed over the ``Sq`` rows: ``kv_len``
    each, or with the causal mask (query ``i`` at position ``i``)
    ``min(i + 1, kv_len)``."""
    if not causal:
        return Sq * kv_len
    n = min(Sq, kv_len)
    return n * (n + 1) // 2 + (Sq - n) * kv_len


def flash_attention_flops(B: int, Sq: int, H: int, D: int, kv_len: int,
                          causal: bool, DV: Optional[int] = None) -> int:
    """Exact-causal operations of ``flash_attention`` at q/k width ``D`` and
    v width ``DV`` (default ``D``): a multiply and an add for each of the
    ``q·k`` (``D`` wide) and ``p·V`` (``DV`` wide) products of every valid
    key, ``2·B·H·(D + DV)·Σ_q(valid keys)``; the softmax's few per score
    are not counted."""
    DV = D if DV is None else DV
    return 2 * B * H * (D + DV) * attention_valid_keys(Sq, kv_len, causal)


def flash_attention_bwd_flops(B: int, Sq: int, H: int, D: int, kv_len: int,
                              causal: bool, DV: Optional[int] = None) -> int:
    """Exact-causal operations of ``flash_attention_bwd`` at q/k width ``D``
    and v width ``DV`` (default ``D``): its five products, the scores
    recomputed, dQ and dK over ``D`` and dP and dV over ``DV``, a multiply
    and an add each for every valid key, ``2·B·H·(3·D + 2·DV)·Σ_q(valid
    keys)``; the elementwise work on P and dS and the δ pre-pass are not
    counted."""
    DV = D if DV is None else DV
    return 2 * B * H * (3 * D + 2 * DV) * attention_valid_keys(Sq, kv_len, causal)


def flash_attention_bwd_bytes(B: int, Sq: int, Skv: int, H: int, Hkv: int, D: int,
                              itemsize: int, DV: Optional[int] = None) -> int:
    """``flash_attention_bwd`` at q/k width ``D`` and v width ``DV``
    (default ``D``): q read and dq written once (``(B, Sq, H, D)``), o and
    dO read once (``DV`` wide), k read and dk written once (``(B, Skv,
    Hkv, D)``), v read and dv written once (``DV`` wide), and the f32
    ``lse`` ``(B, H, Sq)`` read once; the kernel's own δ scratch is not
    counted."""
    DV = D if DV is None else DV
    return (itemsize * (2 * B * Sq * H * (D + DV) + 2 * B * Skv * Hkv * (D + DV))
            + 4 * B * H * Sq)
