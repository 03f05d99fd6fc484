"""Training-side kernels for Hopper — the fused train kernel and the split
e-prop update — with their plain PyTorch versions (counterpart of
:mod:`repro.kernels.eprop_update`).

* :func:`rsnn_train_cuda` — ``rsnn_train_kernel``: the ``train_tile`` op.
  Each batch row runs on a thread-block cluster
  (:func:`~repro_torch.kernels.rsnn_step.train_plan`: eight blocks at
  END_S's one row, one at the END_B tile).  Its leader block sums every
  tick's input current, then one warp runs the row's LIF recurrence on the
  event-driven warp-per-row loop, writing ``h`` and the spike masks a tick
  block at a time, while other warps follow it through ``mbarrier`` barriers:
  the readout with the error evaluated in-kernel (``softmax(y·s) − y*``
  or ``y·s − amp·y*``, masked by ``valid``, ``s = 1/threshold`` in
  quantized mode), the ``pbar`` and ``zbar`` filters from the spike masks,
  and the ``xbar`` filter.  The row's trace set stays in shared memory
  where it fits, and the cluster's other blocks mirror it tick block by
  tick block; else it goes to a device scratch, one block a row.  Then
  every block runs the F walk and its share of the ``dw`` sums.  Returns
  ``(dw_in, dw_rec, dw_out, acc_y (B, O), n_spk (B, 1))``, and the trace
  set when asked.
* :func:`eprop_update_cuda` — the reverse pass alone over ``(T, B, ·)``
  traces in device memory (the ``eprop_update`` op of the split
  pipeline): one thread per (row, neuron) for F, then one per (row, dw
  element).
* :func:`rsnn_train_exact_cuda` — ``rsnn_train_exact_kernel``: the
  ``train_tile`` op in exact mode (``EpropConfig.mode="exact"``, the
  per-synapse filtered eligibility of ReckOn's trace SRAM), with a scalar
  or per-neuron ``alpha``.  Each batch row runs on a thread-block
  cluster (:func:`~repro_torch.kernels.rsnn_step.train_exact_plan`): its
  leader block runs the forward a tick block at a time through a ring in
  shared memory (the input currents ahead of the LIF chain, which leaks
  each neuron by its own ``alpha``; then the readout, its error and the
  learning signal ``L = err · B_fbᵀ``), while walker threads walk the
  synapses ``(i, j)`` of the blocks the forward has finished, each
  synapse's state in registers through all ticks::

    eps  = alpha_j·eps + s_i[t]          (s: the input, or the spike of
    ebar = kappa·ebar + h_j[t]·eps        presynaptic neuron i a tick
    dW_ij += ebar·L_j[t]                  before)

  and ``dW_out[j, o] += zbar_j[t]·err_o[t]``.  Nothing of the forward
  depends on the traces, so the walks may trail the forward and still give
  the tick-by-tick values in the reference's order
  (:func:`rsnn_train_exact_plain`; ``dw`` to a tolerance, as
  ``rsnn_train``'s: the error goes through ``expf`` and ``L`` sums its
  products in another order than ``torch.matmul``).

Both reverse passes compute, over ticks ``T-1..0``, each ``dw`` element
summed by one thread in that order (``csrc/rsnn_train.cu``)::

  F[t]   = err[t] @ B_fbᵀ + κ·F[t+1]
  dW_in  = Σ_t xbar[t]ᵀ (h[t]∘F[t])
  dW_rec = Σ_t pbar[t]ᵀ (h[t]∘F[t])
  dW_out = Σ_t zbar[t]ᵀ err[t]

Each row's partial ``dw`` goes to its own slice of a ``(B, E)`` buffer,
and a last small kernel adds the slices in row order — no atomics, so two
launches give identical bits.  The caller masks ``dw_rec``'s
self-recurrence.

With ``commit_grid`` (a :class:`~repro_torch.core.quant.QuantSpec`, the
deterministic END_B path: :data:`~repro_torch.core.quant.DW_COMMIT_SPEC`)
``rsnn_train`` ends in ``rsnn_dw_codes_reduce_kernel`` instead: each row's
partial is snapped to ``clamp(round(x / lsb), -2^(bits-1), 2^(bits-1)-1)``
and the int32 codes are summed (:func:`dw_codes`).  A row's partial is
that sample's ``B=1`` ``dw`` (whatever cluster the plan gives a row at
this ``B``: each element is summed by one thread in the same order), and
integer sums do not depend on their order, so the
codes of a batch equal the summed codes of any split of it: a commit is
bitwise the same on 1, 4 or 8 ranks.  The sums wrap at ``2^31`` as the
reference's int32 sums do: at 24 bits, 256 rows of full-scale codes (the
Braille END_B batch is 70).

The weights are the ``to_membrane`` images in quantized mode; ``b_fb`` is
in normalised weight units (the raw ``w_out`` or the random ``B``).
``err`` uses ``expf``, so ``dw`` matches the plain version to a
tolerance, not bitwise; ``acc_y``, ``n_spk`` and the traces ``h, xbar,
pbar, zbar`` are bitwise in quantized mode.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from repro_torch.core.eprop import EpropConfig, exact_tile
from repro_torch.core.neuron import NeuronConfig
from repro_torch.core.quant import QuantizedMode, QuantSpec
from repro_torch.kernels.launch import grid_launches, launches, raise_on, stream_arg
from repro_torch.kernels.rsnn_step import (
    EVENT_LOOP_MAX_WIDTH,
    _check_exact_matmul,
    _consts,
    check_arg,
    check_surrogate,
    datapath_scalars,
    surrogate_scalars,
    tick_transition,
    train_exact_plan,
    train_plan,
    weight_elems,
)

# Outputs one row's in-kernel readout error handles (RSNN_MAX_OUT in
# csrc/rsnn_tick.cuh): the chip's 16 LI neurons.
MAX_ERR_OUTPUTS = 16

DwTriple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
# The per-tick trace set of rsnn_train, in the kernel's argument order.
TRACE_KEYS = ("h", "xbar", "pbar", "zbar", "err")


def _readout_error(y_err, y_star, error: str, target_amplitude: float):
    if error == "softmax":
        return torch.softmax(y_err, dim=-1) - y_star
    if error == "direct":
        return y_err - target_amplitude * y_star
    raise ValueError(f"unknown error mode {error!r}")


def eprop_update_plain(h, xbar, pbar, zbar, err, b_fb, *, kappa: float
                       ) -> DwTriple:
    """Plain version of :func:`eprop_update_cuda` → ``(dw_in (N, H),
    dw_rec (H, H), dw_out (H, O))``, summed over ticks and rows."""
    T, B, H = h.shape
    N, O = xbar.shape[2], err.shape[2]
    f = h.new_zeros((B, H))
    dw_in, dw_rec, dw_out = h.new_zeros((N, H)), h.new_zeros((H, H)), h.new_zeros((H, O))
    for t in range(T - 1, -1, -1):
        f = err[t] @ b_fb.T + kappa * f
        g = h[t] * f
        dw_in = dw_in + xbar[t].T @ g
        dw_rec = dw_rec + pbar[t].T @ g
        dw_out = dw_out + zbar[t].T @ err[t]
    return dw_in, dw_rec, dw_out


def dw_codes(dw: torch.Tensor, grid: QuantSpec) -> torch.Tensor:
    """``dw`` snapped onto the commit grid as int32 codes:
    ``clamp(round(x / lsb), -2^(bits-1), 2^(bits-1) - 1)`` (round half to
    even; the clamp before the cast)."""
    top = 2.0 ** (grid.bits - 1)
    return torch.clamp(torch.round(dw / grid.lsb), -top, top - 1).to(torch.int32)


def dw_codes_reduce_plain(part: torch.Tensor, grid: QuantSpec) -> torch.Tensor:
    """Plain version of ``rsnn_dw_codes_reduce_kernel``: the rows of a
    ``(B, E)`` partial buffer snapped (:func:`dw_codes`) and summed in int32
    → ``(E,)``."""
    return dw_codes(part, grid).sum(dim=0, dtype=torch.int32)


def _check_grid(grid: QuantSpec) -> None:
    if not 2 <= grid.bits <= 24:
        raise ValueError(f"commit grid of {grid.bits} bits: the codes' bound must "
                         "be exact in f32 (2 <= bits <= 24)")
    if math.frexp(grid.lsb)[0] != 0.5:
        raise ValueError(f"commit grid step {grid.lsb} is not a power of two: "
                         "x / lsb must be exact")


def _train_codes_plain(one, raster, y_star, valid, w_in, w_rec, w_out, b_fb, grid,
                       kw):
    """The commit-grid path of :func:`rsnn_train_plain` and
    :func:`rsnn_train_exact_plain` (``one``): one ``B=1`` pass a row (each
    row's arithmetic is the same whatever batch it came in, as in the
    reference's ``lax.map``), its ``dw`` snapped to codes, the codes summed
    in int32."""
    _check_grid(grid)
    T, B, N = raster.shape
    H, O = w_rec.shape[0], w_out.shape[1]
    codes = [raster.new_zeros(s, dtype=torch.int32) for s in ((N, H), (H, H), (H, O))]
    acc, nspk = raster.new_zeros((B, O)), raster.new_zeros((B, 1))
    for b in range(B):
        out = one(raster[:, b: b + 1], y_star[b: b + 1], valid[:, b: b + 1],
                  w_in, w_rec, w_out, b_fb, **kw)
        codes = [c + dw_codes(d, grid) for c, d in zip(codes, out[:3])]
        acc[b], nspk[b] = out[3][0], out[4][0]
    return (*codes, acc, nspk)


def rsnn_train_plain(raster, y_star, valid, w_in, w_rec, w_out, b_fb, *,
                     alpha: float, kappa: float, v_th: float = 1.0,
                     reset: str = "sub", boxcar_width: float = 0.5,
                     surrogate: str = "boxcar", gamma: float = 0.3,
                     quant: Optional[QuantizedMode] = None,
                     error: str = "softmax", target_amplitude: float = 1.0,
                     infer_window: str = "valid", return_traces: bool = False,
                     commit_grid: Optional[QuantSpec] = None):
    """Plain version of :func:`rsnn_train_cuda` → ``(dw_in, dw_rec, dw_out,
    acc_y (B, O), n_spk (B, 1))``, and with ``return_traces`` the trace set
    ``{"h", "xbar", "pbar", "zbar", "err"}``, each ``(T, B, ·)``, ``h``
    the ``surrogate``'s pseudo-derivative.  With ``commit_grid`` the three
    ``dw`` are the rows' summed int32 codes."""
    check_surrogate(surrogate)
    if commit_grid is not None:
        if return_traces:
            raise ValueError("rsnn_train: the commit-grid path returns no traces")
        kw = dict(alpha=alpha, kappa=kappa, v_th=v_th, reset=reset,
                  boxcar_width=boxcar_width, surrogate=surrogate, gamma=gamma,
                  quant=quant, error=error, target_amplitude=target_amplitude,
                  infer_window=infer_window)
        return _train_codes_plain(rsnn_train_plain, raster, y_star, valid, w_in,
                                  w_rec, w_out, b_fb, commit_grid, kw)
    c = _consts(alpha, kappa, v_th, reset, quant)
    _check_exact_matmul(raster, quant)
    y_scale = 1.0 if quant is None else 1.0 / float(quant.threshold)
    T, B, N = raster.shape
    H, O = w_rec.shape[0], w_out.shape[1]
    v, z = raster.new_zeros((B, H)), raster.new_zeros((B, H))
    pbar, zbar = raster.new_zeros((B, H)), raster.new_zeros((B, H))
    y, xbar = raster.new_zeros((B, O)), raster.new_zeros((B, N))
    acc, nspk = raster.new_zeros((B, O)), raster.new_zeros((B, 1))
    tr = {k: [] for k in TRACE_KEYS}
    for t in range(T):
        v, z_new, y, h = tick_transition(raster[t], v, z, y, w_in, w_rec, w_out,
                                         boxcar_width=boxcar_width, surrogate=surrogate,
                                         gamma=gamma, **c)
        xbar = c["alpha"] * xbar + raster[t]
        pbar = c["alpha"] * pbar + z          # presyn trace: z BEFORE this tick
        zbar = c["kappa"] * zbar + z_new
        vt = valid[t][:, None]
        err = _readout_error(y * y_scale, y_star, error, target_amplitude) * vt
        for k, x in (("h", h), ("xbar", xbar), ("pbar", pbar), ("zbar", zbar),
                     ("err", err)):
            tr[k].append(x)
        acc = acc + y * (1.0 if infer_window == "all" else vt)
        nspk = nspk + (z_new * vt).sum(dim=1, keepdim=True)
        z = z_new
    traces = {k: torch.stack(x) for k, x in tr.items()}
    dw = eprop_update_plain(*traces.values(), b_fb, kappa=c["kappa"])
    return (*dw, acc, nspk, traces) if return_traces else (*dw, acc, nspk)


def _dw_outputs(N: int, H: int, O: int, nb: int, dev, dtype=torch.float32):
    """The ``(nb, E)`` partial buffer (one slice a row) and the three ``dw``
    views of one ``(E,)`` result the reduce kernel writes (int32 codes on
    the commit grid)."""
    E = weight_elems(N, H, O)
    part = torch.empty((nb, E), dtype=torch.float32, device=dev)
    dw = torch.empty((E,), dtype=dtype, device=dev)
    views = (dw[: N * H].view(N, H), dw[N * H: N * H + H * H].view(H, H),
             dw[N * H + H * H:].view(H, O))
    return part, dw, views


def _check_train_args(op, raster, y_star, valid, w_in, w_rec, w_out, b_fb, error,
                      commit_grid):
    """The train kernels' argument checks (device, dtype, shape,
    contiguity, the widths the event loop takes, the error mode and the
    commit grid) → ``(T, B, N, H, O)``."""
    if error not in ("softmax", "direct"):
        raise ValueError(f"unknown error mode {error!r}")
    if commit_grid is not None:
        _check_grid(commit_grid)
    T, B, N = raster.shape
    H, O = w_rec.shape[0], w_out.shape[1]
    if O > MAX_ERR_OUTPUTS:
        raise ValueError(f"{op}: {O} outputs > {MAX_ERR_OUTPUTS} "
                         "(the chip's readout; RSNN_MAX_OUT in csrc)")
    if max(N, H) > EVENT_LOOP_MAX_WIDTH:
        raise ValueError(f"{op}: {N} inputs / {H} neurons > {EVENT_LOOP_MAX_WIDTH} "
                         "(the chip's; RSNN_MAX_WORDS in csrc)")
    for name, t, shape in (
        ("raster", raster, (T, B, N)), ("y_star", y_star, (B, O)),
        ("valid", valid, (T, B)), ("w_in", w_in, (N, H)),
        ("w_rec", w_rec, (H, H)), ("w_out", w_out, (H, O)),
        ("b_fb", b_fb, (H, O)),
    ):
        check_arg(name, t, shape, raster.device)
    return T, B, N, H, O


# The roles ``rsnn_train_cuda(clocks=...)`` records, in the kernel's order
# (RSNN_TRAIN_CLOCK_ROLES in csrc/rsnn_train.cuh): each role's first start
# and last end for row 0 (the leader's setup (staging, the barriers and
# the input currents), chain, xbar filter, first filter warp and first readout warp; the F walk and dw sums of the first
# block that runs them, the leader or block 1; block 1's mirror).
TRAIN_CLOCK_ROLES = ("setup", "chain", "xbar", "filters", "readout", "F walk", "dw sums",
                     "mirror")


def rsnn_train_cuda(raster, y_star, valid, w_in, w_rec, w_out, b_fb, *,
                    alpha: float, kappa: float, v_th: float = 1.0,
                    reset: str = "sub", boxcar_width: float = 0.5,
                    surrogate: str = "boxcar", gamma: float = 0.3,
                    quant: Optional[QuantizedMode] = None,
                    error: str = "softmax", target_amplitude: float = 1.0,
                    infer_window: str = "valid", return_traces: bool = False,
                    commit_grid: Optional[QuantSpec] = None,
                    return_partials: bool = False,
                    clocks: Optional[torch.Tensor] = None):
    """Launch ``rsnn_train_kernel`` (``rsnn_train_tri_kernel`` under the
    triangular surrogate; then the row-order ``dw`` reduction, or with
    ``commit_grid`` ``rsnn_dw_codes_reduce_kernel``) on the current stream
    of the tensors' device → the outputs of :func:`rsnn_train_plain`;
    ``return_partials`` appends the ``(B, E)`` per-row ``dw`` buffer the
    reduction read.  The layout is :func:`~repro_torch.kernels.rsnn_step.
    train_plan`'s at ``(T, B)``; no output depends on it.  ``clocks``, a
    contiguous int64 tensor of shape ``(len(TRAIN_CLOCK_ROLES), 2)`` on
    the card, receives the ``clock64()`` readings of row 0's roles as each
    begins and ends its work (how the time splits by role; block 1's on
    its own SM's clock).  Checks device, dtype, shape, contiguity and the
    surrogate; raises on a refused launch."""
    from repro_torch.kernels import build

    check_surrogate(surrogate)
    if commit_grid is not None and return_traces:
        raise ValueError("rsnn_train: the commit-grid path returns no traces")
    T, B, N, H, O = _check_train_args("rsnn_train", raster, y_star, valid, w_in, w_rec,
                                      w_out, b_fb, error, commit_grid)
    dev = raster.device
    acc = torch.empty((B, O), dtype=torch.float32, device=dev)
    nspk = torch.empty((B, 1), dtype=torch.float32, device=dev)
    width = {"xbar": N, "err": O}

    def traces():
        return {k: torch.empty((T, B, width.get(k, H)), dtype=torch.float32,
                               device=dev) for k in TRACE_KEYS}

    out_dtype = torch.float32 if commit_grid is None else torch.int32
    if B == 0 or T == 0:
        zeros = tuple(torch.zeros(s, dtype=out_dtype, device=dev)
                      for s in ((N, H), (H, H), (H, O)))
        out = (*zeros, acc.zero_(), nspk.zero_())
        if return_partials:
            out = (*out, torch.zeros((B, weight_elems(N, H, O)), device=dev))
        return (*out, traces()) if return_traces else out
    lib = build.library()
    c = _consts(alpha, kappa, v_th, reset, quant)
    plan = train_plan(T, N, H, O, B)
    if clocks is not None:
        check_arg("clocks", clocks, (len(TRAIN_CLOCK_ROLES), 2), dev, torch.int64)
    # the device path's scratch: the traces and G; on chip, only a copy of
    # the traces when the caller asks for them
    tr = traces() if return_traces or not plan.traces_smem else None
    g = None if plan.traces_smem else torch.empty((T, B, H), dtype=torch.float32,
                                                  device=dev)
    part, dw, views = _dw_outputs(N, H, O, B, dev, out_dtype)
    y_scale = 1.0 if quant is None else 1.0 / float(quant.threshold)
    ptrs = [t.data_ptr() for t in (raster, y_star, valid, w_in, w_rec, w_out, b_fb)]
    ptrs += [tr[k].data_ptr() if tr else None for k in TRACE_KEYS]
    ptrs += [g.data_ptr() if g is not None else None, part.data_ptr()]
    ptrs += [dw.data_ptr(), None] if commit_grid is None else [None, dw.data_ptr()]
    ptrs += [acc.data_ptr(), nspk.data_ptr()]
    lsb, bits = (0.0, 0) if commit_grid is None else (commit_grid.lsb, commit_grid.bits)
    with torch.cuda.device(dev):
        rc = lib.rsnn_train_launch(
            *ptrs, T, B, N, H, O, plan.threads, plan.cluster, plan.ticks,
            int(plan.weights_smem), int(plan.traces_smem), int(infer_window == "all"),
            ctypes.c_longlong(plan.smem_bytes), *datapath_scalars(c),
            *surrogate_scalars(surrogate, boxcar_width, gamma, c["v_th"]),
            ctypes.c_float(y_scale), ctypes.c_float(target_amplitude),
            int(error == "softmax"), ctypes.c_float(lsb), int(bits),
            clocks.data_ptr() if clocks is not None else None, stream_arg(dev))
    raise_on(lib, rc, "rsnn_train")
    launches["rsnn_train"] += 1
    if commit_grid is not None:
        grid_launches["rsnn_train"] += 1
    out = (*views, acc, nspk)
    if return_partials:
        out = (*out, part)
    return (*out, tr) if return_traces else out


def exact_alpha(alpha, n_hid: int, like: torch.Tensor) -> torch.Tensor:
    """The decays of exact mode as a contiguous ``(H,)`` float32 tensor on
    ``like``'s device: a scalar (a float or a 0-d tensor) broadcast, or one
    decay a neuron.  Any other shape raises."""
    if not isinstance(alpha, torch.Tensor):
        # a fill on the device: no host-to-device copy, which would wait for
        # the stream
        return torch.full((n_hid,), float(alpha), dtype=torch.float32, device=like.device)
    a = alpha.to(device=like.device, dtype=torch.float32)
    if a.ndim > 1 or (a.ndim == 1 and a.shape[0] != n_hid):
        raise ValueError(f"alpha: a scalar or one decay a neuron ({n_hid},), "
                         f"got shape {tuple(a.shape)}")
    return a.expand(n_hid).contiguous()


def rsnn_train_exact_plain(raster, y_star, valid, w_in, w_rec, w_out, b_fb, *,
                           alpha, kappa: float, v_th: float = 1.0,
                           reset: str = "sub", boxcar_width: float = 0.5,
                           surrogate: str = "boxcar", gamma: float = 0.3,
                           quant: Optional[QuantizedMode] = None,
                           error: str = "softmax", target_amplitude: float = 1.0,
                           infer_window: str = "valid",
                           commit_grid: Optional[QuantSpec] = None):
    """Plain version of :func:`rsnn_train_exact_cuda` → ``(dw_in, dw_rec,
    dw_out, acc_y (B, O), n_spk (B, 1))``: the port's exact-mode oracle
    (:func:`repro_torch.core.eprop.exact_tile`) on the datapath weights,
    under ``surrogate`` (its ``pseudo_derivative``: the triangular form
    divides, where the kernel multiplies by the reciprocal, an ulp of ``h``
    apart at some quantized membranes), ``dw`` summed over the batch and
    ``dw_rec`` not masked.  ``alpha`` is a scalar or ``(H,)``: it filters the
    presynaptic traces, and leaks the membrane in float mode (quantized
    mode leaks by ``alpha_reg``).  With ``commit_grid`` the three ``dw``
    are the rows' summed int32 codes."""
    check_surrogate(surrogate)
    kw = dict(alpha=alpha, kappa=kappa, v_th=v_th, reset=reset,
              boxcar_width=boxcar_width, surrogate=surrogate, gamma=gamma, quant=quant,
              error=error, target_amplitude=target_amplitude, infer_window=infer_window)
    if commit_grid is not None:
        return _train_codes_plain(rsnn_train_exact_plain, raster, y_star, valid, w_in,
                                  w_rec, w_out, b_fb, commit_grid, kw)
    c = _consts(0.0, kappa, v_th, reset, quant)
    _check_exact_matmul(raster, quant)
    ncfg = NeuronConfig(kappa=c["kappa"], v_th=c["v_th"], reset=reset,
                        surrogate=surrogate, boxcar_width=boxcar_width, gamma=gamma,
                        quant=quant)
    ecfg = EpropConfig(mode="exact", error=error, target_amplitude=target_amplitude,
                       infer_window=infer_window)
    y_scale = 1.0 if quant is None else 1.0 / float(quant.threshold)
    return exact_tile(w_in, w_rec, w_out, b_fb, exact_alpha(alpha, w_rec.shape[0], raster),
                      raster, y_star, valid, y_scale, ncfg, ecfg)


# The roles ``rsnn_train_exact_cuda(clocks=...)`` records, in the kernel's
# order (RSNN_EXACT_CLOCK_ROLES in csrc/rsnn_train.cuh).
EXACT_CLOCK_ROLES = ("chain", "inputs", "readout", "leader walker", "block 1")


def exact_clock_shape(T: int, plan) -> Tuple[int, int, int]:
    """``(roles, tick blocks, 2)``: the clock buffer of a launch at ``T``
    under ``plan``."""
    return (len(EXACT_CLOCK_ROLES), -(-T // plan.ticks), 2)


def rsnn_train_exact_cuda(raster, y_star, valid, w_in, w_rec, w_out, b_fb, *,
                          alpha, kappa: float, v_th: float = 1.0,
                          reset: str = "sub", boxcar_width: float = 0.5,
                          surrogate: str = "boxcar", gamma: float = 0.3,
                          quant: Optional[QuantizedMode] = None,
                          error: str = "softmax", target_amplitude: float = 1.0,
                          infer_window: str = "valid",
                          commit_grid: Optional[QuantSpec] = None,
                          return_partials: bool = False,
                          clocks: Optional[torch.Tensor] = None):
    """Launch ``rsnn_train_exact_kernel`` (``rsnn_train_exact_tri_kernel``
    under the triangular surrogate) on the clusters of
    :func:`~repro_torch.kernels.rsnn_step.train_exact_plan`, then the
    row-order ``dw`` reduction, or with ``commit_grid``
    ``rsnn_dw_codes_reduce_kernel``, on the current stream of the tensors'
    device → the outputs of :func:`rsnn_train_exact_plain`;
    ``return_partials`` appends the ``(B, E)`` per-row ``dw`` buffer the
    reduction read.  ``clocks``, a contiguous int64 tensor of
    :func:`exact_clock_shape` on the card, receives the ``clock64()``
    readings of the first cluster's roles as each begins and ends its work
    on each tick block (how the time splits by role).  Checks as
    :func:`rsnn_train_cuda`; raises on a refused launch."""
    from repro_torch.kernels import build

    check_surrogate(surrogate)
    T, B, N, H, O = _check_train_args("rsnn_train_exact", raster, y_star, valid, w_in,
                                      w_rec, w_out, b_fb, error, commit_grid)
    dev = raster.device
    a = exact_alpha(alpha, H, raster)
    acc = torch.empty((B, O), dtype=torch.float32, device=dev)
    nspk = torch.empty((B, 1), dtype=torch.float32, device=dev)
    out_dtype = torch.float32 if commit_grid is None else torch.int32
    if B == 0 or T == 0:
        zeros = tuple(torch.zeros(s, dtype=out_dtype, device=dev)
                      for s in ((N, H), (H, H), (H, O)))
        out = (*zeros, acc.zero_(), nspk.zero_())
        return (*out, torch.zeros((B, weight_elems(N, H, O)), device=dev)) \
            if return_partials else out
    lib = build.library()
    # the kernel leaks and filters by the alpha vector; TickParams.alpha
    # is not read
    c = _consts(0.0, kappa, v_th, reset, quant)
    plan = train_exact_plan(T, N, H, O, B)
    if clocks is not None:
        check_arg("clocks", clocks, exact_clock_shape(T, plan), dev, torch.int64)
    part, dw, views = _dw_outputs(N, H, O, B, dev, out_dtype)
    y_scale = 1.0 if quant is None else 1.0 / float(quant.threshold)
    ptrs = [t.data_ptr() for t in (raster, y_star, valid, w_in, w_rec, w_out, b_fb, a, part)]
    ptrs += [dw.data_ptr(), None] if commit_grid is None else [None, dw.data_ptr()]
    ptrs += [acc.data_ptr(), nspk.data_ptr()]
    lsb, bits = (0.0, 0) if commit_grid is None else (commit_grid.lsb, commit_grid.bits)
    with torch.cuda.device(dev):
        rc = lib.rsnn_train_exact_launch(
            *ptrs, T, B, N, H, O, plan.threads, plan.cluster, plan.groups, plan.slots,
            plan.ticks, plan.inputs, plan.g_in, plan.g_rec, plan.g_out, plan.lines,
            int(plan.weights_smem),
            int(infer_window == "all"), ctypes.c_longlong(plan.smem_bytes),
            *datapath_scalars(c),
            *surrogate_scalars(surrogate, boxcar_width, gamma, c["v_th"]),
            ctypes.c_float(y_scale), ctypes.c_float(target_amplitude),
            int(error == "softmax"), ctypes.c_float(lsb), int(bits),
            clocks.data_ptr() if clocks is not None else None, stream_arg(dev))
    raise_on(lib, rc, "rsnn_train_exact")
    launches["rsnn_train_exact"] += 1
    if commit_grid is not None:
        grid_launches["rsnn_train_exact"] += 1
    out = (*views, acc, nspk)
    return (*out, part) if return_partials else out


def eprop_update_cuda(h, xbar, pbar, zbar, err, b_fb, *, kappa: float
                      ) -> DwTriple:
    """Launch the reverse kernels (F per (row, neuron), ``dw`` per (row,
    element), the row-order reduction) on the current stream of the
    tensors' device → the outputs of :func:`eprop_update_plain`."""
    from repro_torch.kernels import build

    T, B, H = h.shape
    N, O = xbar.shape[2], err.shape[2]
    dev = h.device
    for name, t, shape in (
        ("h", h, (T, B, H)), ("xbar", xbar, (T, B, N)), ("pbar", pbar, (T, B, H)),
        ("zbar", zbar, (T, B, H)), ("err", err, (T, B, O)), ("b_fb", b_fb, (H, O)),
    ):
        check_arg(name, t, shape, dev)
    if B == 0 or T == 0:
        return (torch.zeros((N, H), device=dev), torch.zeros((H, H), device=dev),
                torch.zeros((H, O), device=dev))
    if O > MAX_ERR_OUTPUTS:
        raise ValueError(f"eprop_update: {O} outputs > {MAX_ERR_OUTPUTS} "
                         "(the chip's readout; RSNN_MAX_OUT in csrc)")
    lib = build.library()
    g = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    part, dw, views = _dw_outputs(N, H, O, B, dev)
    ptrs = [t.data_ptr() for t in (h, xbar, pbar, zbar, err, b_fb, g, part, dw)]
    with torch.cuda.device(dev):
        rc = lib.eprop_update_launch(*ptrs, T, B, N, H, O, ctypes.c_float(kappa),
                                     stream_arg(dev))
    raise_on(lib, rc, "eprop_update")
    launches["eprop_update"] += 1
    return views
