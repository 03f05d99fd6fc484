"""Forward-side RSNN tick kernels for Hopper, their plain PyTorch
versions, and the sizing helpers every RSNN kernel shares (counterpart of
:mod:`repro.kernels.rsnn_step`).

Three kernels run the tick loop forward:

* :func:`rsnn_infer_cuda` — ``rsnn_infer_kernel``: a ``(T, B)`` tile from
  zero state, accumulating the valid-weighted readout ``acc_y (B, O)`` and
  the valid-masked spike count ``n_spk (B, 1)`` on chip;
* :func:`rsnn_step_sessions_cuda` — ``rsnn_step_sessions_kernel``: the
  same tick loop from carried ``(v, z, y, acc_y, n_spk)`` rows, with the
  ``live`` select, returning the final carries;
* :func:`rsnn_forward_cuda` — ``rsnn_forward_kernel``: the
  trace-streaming forward of the ``forward_traces`` and ``dynamics`` ops,
  writing seven ``(T, B, ·)`` tensors ``z, h, xbar, pbar, zbar, y, v``.

All three, and ``rsnn_train``, run the warp-per-row event loop of
``csrc/rsnn_tick.cuh``: one warp carries one batch row through all T
ticks inside one launch, and the input currents and the readout run
outside the chain.  The first two live in ``csrc/rsnn_serve.cu`` and walk
the ticks a chunk at a time, up to 16 rows a block (:func:`serve_plan`);
the third lives in ``csrc/rsnn_train.cu`` beside ``rsnn_train``, whose
forward phases it shares, a warp a row and one row a block until a batch
outgrows what the card holds at once (:func:`forward_plan`).  The
``*_plain`` functions compute the same functions with eager PyTorch
through :func:`tick_transition`; the CPU path runs them, and
``chip_smoke.py`` holds the kernels against them on the card.
:mod:`repro_torch.kernels.ops` picks one or the other by tensor device.

Sizing (one place, every caller derives from it), bounded by the 1,024
threads and the 227 KB of shared memory a block may use on an H100:

* :func:`serve_plan` — the serving kernels: rows a block (a warp each),
  threads, ticks a chunk, and whether the f32 weights stage in shared
  memory beside the chunk;
* :func:`train_plan` — ``rsnn_train``: the row's whole trace set stays in
  shared memory where it fits, and the row spans a thread-block cluster
  at small B; it goes to a device scratch, one block a row, where it does
  not fit;
* :func:`train_exact_plan` — ``rsnn_train_exact``: the blocks a row (a
  thread-block cluster, and groups of clusters at the widest nets), the
  ring of tick blocks in shared memory, the walker threads' lines;
* :func:`forward_plan` — ``rsnn_forward``: rows a block (a loop warp
  each), the readout's chunks, and what of the weights and the rows'
  raster and input currents fits in shared memory;
* :func:`max_batch_for_dims` — the serving admission, the rows the
  serving kernels run at once on the card.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.quant import QuantizedMode
from repro_torch.kernels.launch import (
    H100_SMS,
    SMEM_PER_BLOCK,
    THREADS_PER_BLOCK,
    THREADS_PER_SM,
    cdiv,
    launches,
    raise_on,
    stream_arg,
)

F32_BYTES = 4

# rsnn_train's layout (RSNN_TRAIN_* in csrc/rsnn_train.cuh): the threads
# of a block (512: the chain, two readout warps, the xbar warp and nine
# filter warps, a thread for each of the chip's 256 neurons; and the dw
# sums over all of them, at most 128 registers a thread), the ticks of a
# block of the chain, and the largest cluster of blocks a row (the
# portable size).
TRAIN_THREADS = THREADS_PER_BLOCK // 2
TRAIN_TICKS = 16
TRAIN_MAX_CLUSTER = 8
# Warps of an rsnn_forward block besides its loop warps (one a row): they
# run the xbar filters beside the loops, and share the input sums, the
# readout and the spike streams with them (a one-row block has 256 threads).
FORWARD_HELPER_WARPS = THREADS_PER_BLOCK // 4 // 32 - 1
# Widths the warp-per-row event loop handles: 8 words of 32 lanes, the
# chip's 256 inputs and 256 neurons (RSNN_MAX_WORDS in csrc/rsnn_tick.cuh),
# and its 16 outputs (RSNN_MAX_OUT).
EVENT_LOOP_MAX_WIDTH = 256
EVENT_LOOP_MAX_OUT = 16
# Rows a serving block carries, a warp each: at most the warps of the
# smaller serving block (serve_threads).
SERVE_MAX_ROWS = THREADS_PER_BLOCK // 2 // 32
# The serving weights stage in shared memory only when at least this many
# ticks of a chunk fit beside them, so that staging them never cuts the
# chunks (and multiplies the block barriers) below that length.
SERVE_MIN_CHUNK = 32


def weight_elems(n_in: int, n_hid: int, n_out: int) -> int:
    """Elements of the weight set (w_in + w_rec + w_out)."""
    return n_in * n_hid + n_hid * n_hid + n_hid * n_out


def weights_bytes(n_in: int, n_hid: int, n_out: int) -> int:
    return F32_BYTES * weight_elems(n_in, n_hid, n_out)


@dataclasses.dataclass(frozen=True)
class TrainPlan:
    """One ``rsnn_train`` launch: each batch row on a thread-block cluster
    of ``cluster`` blocks of ``threads``; the chain in blocks of ``ticks``
    ticks (two mbarriers each); the row's trace set in shared memory
    (``traces_smem``), where the other blocks of the cluster mirror it, or
    in a device scratch (then one block a row); the f32 weights in shared
    memory where they fit; ``smem_bytes`` of dynamic shared memory a block
    (the kernel refuses a launch whose plan disagrees with its own
    layout)."""

    threads: int
    cluster: int
    ticks: int
    traces_smem: bool
    weights_smem: bool
    smem_bytes: int


def train_trace_bytes(T: int, n_in: int, n_hid: int, n_out: int) -> int:
    """One row's trace set: ``h, pbar, zbar`` (H), ``xbar`` (N) and ``err``
    (O) at every tick — 66 KB at Braille T=128."""
    return F32_BYTES * T * (3 * n_hid + n_in + n_out)


def spike_mask_bytes(T: int, n_hid: int) -> int:
    """One row's spike masks: one word per 32 neurons a tick."""
    return F32_BYTES * T * cdiv(n_hid, 32)


def train_barrier_bytes(T: int, ticks: int) -> int:
    """A block's mbarriers: two a block of ``ticks`` ticks, 8 bytes each."""
    return 16 * cdiv(T, ticks)


def train_plan(T: int, n_in: int, n_hid: int, n_out: int, B: int = 1) -> TrainPlan:
    """``rsnn_train`` at ``(T, B)``.  Every block keeps its mbarriers, the
    row's valid mask (T floats) and its spike masks (one word per 32
    neurons a tick) in shared memory; the row's trace set goes there too,
    with the weights, when both fit; otherwise it goes to a device
    scratch, and the weights stay in shared memory if they fit beside the
    masks.  With the trace set on chip a row spans a cluster: while ``B``
    rows of a wider cluster still fit the card's SMs at once, the cluster
    doubles, up to :data:`TRAIN_MAX_CLUSTER` (the dw sums of a row spread
    over more SMs); one block a row on the device scratch.  The plan
    depends on (T, N, H, O, B) alone, and no result depends on it: every
    dw element is summed by one thread in the same order."""
    base = (train_barrier_bytes(T, TRAIN_TICKS) + F32_BYTES * T
            + spike_mask_bytes(T, n_hid))
    weights = weights_bytes(n_in, n_hid, n_out)
    traces = train_trace_bytes(T, n_in, n_hid, n_out)
    if base > SMEM_PER_BLOCK:
        raise ValueError(f"rsnn_train: T={T} ticks of masks exceed a block's "
                         f"{SMEM_PER_BLOCK} bytes of shared memory")
    traces_smem = base + weights + traces <= SMEM_PER_BLOCK
    weights_smem = base + weights <= SMEM_PER_BLOCK
    used = base + (weights if weights_smem else 0) + (traces if traces_smem else 0)
    cluster = 1
    while traces_smem and cluster < TRAIN_MAX_CLUSTER and B * 2 * cluster <= H100_SMS:
        cluster *= 2
    return TrainPlan(threads=TRAIN_THREADS, cluster=cluster, ticks=TRAIN_TICKS,
                     traces_smem=traces_smem, weights_smem=weights_smem, smem_bytes=used)


# rsnn_train_exact's layout (RSNN_EXACT_* in csrc/rsnn_train.cuh): lines a
# walker thread carries in registers, the threads of a block (512, so that
# the chain and the walkers may hold 128 registers a thread), the leader
# block's chain and readout warps, the ring's most slots and ticks a slot
# (16 where the weights stage in shared memory; 8, in 3 slots, where they do
# not, so that L1 keeps room for the chain's w_rec), the input warps (4 where
# w_in is read from L2, else 2), and the largest cluster (the portable size).
EXACT_MAX_LINES = 16
EXACT_THREADS = THREADS_PER_BLOCK // 2
EXACT_FIXED_WARPS = 3
EXACT_MAX_SLOTS = 4
EXACT_TICKS = 16
EXACT_L2_TICKS = 8
EXACT_L2_SLOTS = 3
EXACT_INPUTS = 2
EXACT_L2_INPUTS = 4
EXACT_MAX_CLUSTER = 8


@dataclasses.dataclass(frozen=True)
class ExactPlan:
    """One ``rsnn_train_exact`` launch: each batch row on ``groups``
    thread-block clusters of ``cluster`` blocks of ``threads``; the leader
    block of each cluster keeps a ring of ``slots`` tick blocks of
    ``ticks`` ticks (and w_in, w_rec when ``weights_smem``) and runs
    ``inputs`` input warps; ``g_in``, ``g_rec`` and ``g_out`` walker threads
    a neuron take the input, recurrent and readout lines, ``lines`` each at
    most; ``smem_bytes`` of dynamic shared memory a block (the kernel
    refuses a launch whose plan disagrees with its own layout)."""

    threads: int
    cluster: int
    groups: int
    slots: int
    ticks: int
    inputs: int
    g_in: int
    g_rec: int
    g_out: int
    lines: int
    weights_smem: bool
    smem_bytes: int

    @property
    def blocks(self) -> int:
        """Blocks a batch row."""
        return self.cluster * self.groups


def exact_slot_words(n_in: int, n_hid: int, n_out: int, ticks: int) -> int:
    """Words of one ring slot: ``ticks`` ticks of the input currents and
    then ``h`` (rows padded to 32 words a mask word), the learning signal,
    the inputs, the readout and its error, the valid mask, and one more
    tick of spike masks (the tick before the slot); rounded up to a
    multiple of 4 (16-byte aligned slots)."""
    words = cdiv(n_hid, 32)
    w = ticks * (32 * words + n_hid + n_in + n_out + 1) + (ticks + 1) * words
    return cdiv(w, 4) * 4


def exact_smem_bytes(n_in: int, n_hid: int, n_out: int, slots: int, ticks: int,
                     weights_smem: bool) -> int:
    """A block's shared memory: four mbarriers a slot, the decays (H), the
    readout's w_out and b_fb, w_in and w_rec when staged, then the ring
    from a 16-byte boundary."""
    w = n_in * n_hid + n_hid * n_hid if weights_smem else 0
    ring_at = cdiv(8 * slots + n_hid + 2 * n_hid * n_out + w, 4) * 4
    return F32_BYTES * (ring_at + slots * exact_slot_words(n_in, n_hid, n_out, ticks))


def exact_walkers(n_in: int, n_hid: int, n_out: int, walkers: int):
    """Walker threads a neuron for the input, recurrent and readout lines,
    and lines a thread, over ``walkers`` threads: the fewest lines a
    thread (a power of two up to :data:`EXACT_MAX_LINES`: the kernel walks
    that many at every thread, unrolled) whose threads fit → ``(g_in,
    g_rec, g_out, lines)``, or None."""
    per_neuron = walkers // n_hid
    for k in (1, 2, 4, 8, EXACT_MAX_LINES):
        g = (cdiv(n_in, k), cdiv(n_hid, k), cdiv(n_out, k))
        if sum(g) <= per_neuron:
            return (*g, k)
    return None


def cluster_walkers(cluster: int, inputs: int) -> int:
    """Walker threads of one cluster: every thread of the other blocks,
    and the leader's warps after its chain, readout and input warps but
    for those on the chain's scheduler (warp % 4 == 0), which stay idle."""
    warps = EXACT_THREADS // 32
    leader = sum(1 for w in range(EXACT_FIXED_WARPS + inputs, warps) if w % 4)
    return 32 * ((cluster - 1) * warps + leader)


def train_exact_plan(T: int, n_in: int, n_hid: int, n_out: int, B: int = 1) -> ExactPlan:
    """``rsnn_train_exact`` at ``(T, B)``: one route at every net size and
    tick count, since nothing in shared memory grows with T.  The span of a
    row is the fewest blocks whose walker threads carry every synapse in at
    most :data:`EXACT_MAX_LINES` lines a thread (one cluster of 1, 2, 4 or
    8 blocks, then groups of 8); while ``B`` rows of a wider cluster still
    fit the card's SMs at once, the cluster doubles, up to 8 (the walks of
    a row spread over more SMs).  The ring holds no more slots than the
    row has tick blocks; w_in and w_rec stage in shared memory where they
    fit beside it."""
    if T < 1 or B < 1:
        raise ValueError(f"rsnn_train_exact: T={T}, B={B}")
    full = dict(ticks=EXACT_TICKS, inputs=EXACT_INPUTS, weights_smem=True,
                slots=min(EXACT_MAX_SLOTS, cdiv(T, EXACT_TICKS)))
    l2 = dict(ticks=EXACT_L2_TICKS, inputs=EXACT_L2_INPUTS, weights_smem=False,
              slots=min(EXACT_L2_SLOTS, cdiv(T, EXACT_L2_TICKS)))
    ring = full if exact_smem_bytes(n_in, n_hid, n_out, full["slots"], full["ticks"],
                                    True) <= SMEM_PER_BLOCK else l2
    smem = exact_smem_bytes(n_in, n_hid, n_out, ring["slots"], ring["ticks"],
                            ring["weights_smem"])
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"rsnn_train_exact: the ring of {n_in}/{n_hid}/{n_out} exceeds "
                         f"a block's {SMEM_PER_BLOCK} bytes of shared memory")
    cluster, groups = 1, 1

    def split():
        return exact_walkers(n_in, n_hid, n_out,
                             groups * cluster_walkers(cluster, ring["inputs"]))

    while split() is None:
        if cluster < EXACT_MAX_CLUSTER:
            cluster *= 2
        else:
            groups += 1
    while cluster < EXACT_MAX_CLUSTER and B * groups * 2 * cluster <= H100_SMS:
        cluster *= 2
    g_in, g_rec, g_out, k = split()
    return ExactPlan(threads=EXACT_THREADS, cluster=cluster, groups=groups, g_in=g_in,
                     g_rec=g_rec, g_out=g_out, lines=k, smem_bytes=smem, **ring)


@dataclasses.dataclass(frozen=True)
class ForwardPlan:
    """One ``rsnn_forward`` launch: ``rows`` batch rows a block, each on
    its own loop warp, and ``threads`` (the loop warps and
    :data:`FORWARD_HELPER_WARPS` more); the readout in chunks of ``Tl``
    ticks; the f32 weights in shared memory when ``weights_smem``; the
    rows' raster and input currents in shared memory when ``rows_smem``,
    else read from and parked in the device streams; ``smem_bytes`` of
    dynamic shared memory (the kernel refuses a launch whose plan
    disagrees with its own layout)."""

    rows: int
    threads: int
    Tl: int
    weights_smem: bool
    rows_smem: bool
    smem_bytes: int


def forward_row_bytes(T: int, n_in: int, n_hid: int) -> int:
    """One row's raster (N) and input currents (H) at every tick — 25 KB
    at Braille T=128."""
    return F32_BYTES * T * (n_in + n_hid)


def forward_plan(T: int, B: int, n_in: int, n_hid: int, n_out: int,
                 sm_count: int = H100_SMS) -> ForwardPlan:
    """Rows a block: one (a 256-thread block) while the SMs hold every row
    at once that way, eight blocks an SM by threads (1,056 rows); past
    that, the fewest that keep every row on the card at once, so that a
    large batch runs in one wave of blocks with its fixed costs (the
    staged weights, the serial leak walks) shared; at most
    :data:`SERVE_MAX_ROWS` and what the block's threads
    (:func:`serve_threads`, less the helper warps) and its shared memory
    hold.  Each row keeps its spike masks and a chunk of its
    readout currents in shared memory (raises when one row's masks and one
    tick do not fit); then the weights where they fit beside them (the
    Braille and cue nets; 256/256/16 is read from L2); then the longest
    readout chunk, up to T; then, with the whole readout, the rows' raster
    and input currents where they fit.  Results do not depend on the plan:
    every sum runs in an order fixed by the row."""
    per_row = spike_mask_bytes(T, n_hid) + F32_BYTES * n_out
    if per_row > SMEM_PER_BLOCK:
        raise ValueError(f"rsnn_forward: T={T} ticks of spike masks exceed a "
                         f"block's {SMEM_PER_BLOCK} bytes of shared memory")
    cap = min(SERVE_MAX_ROWS, serve_threads(n_in, n_hid) // 32 - FORWARD_HELPER_WARPS)
    one_row_blocks = THREADS_PER_SM // (32 * (1 + FORWARD_HELPER_WARPS))
    rows = max(1, min(cap, cdiv(B, sm_count * one_row_blocks), SMEM_PER_BLOCK // per_row))
    used = rows * spike_mask_bytes(T, n_hid)
    weights = weights_bytes(n_in, n_hid, n_out)
    weights_smem = used + weights + rows * F32_BYTES * n_out <= SMEM_PER_BLOCK
    used += weights if weights_smem else 0
    Tl = min(T, (SMEM_PER_BLOCK - used) // (rows * F32_BYTES * n_out))
    used += rows * F32_BYTES * Tl * n_out
    bufs = rows * forward_row_bytes(T, n_in, n_hid)
    rows_smem = Tl == T and used + bufs <= SMEM_PER_BLOCK
    return ForwardPlan(rows=rows, threads=32 * (rows + FORWARD_HELPER_WARPS), Tl=Tl,
                       weights_smem=weights_smem, rows_smem=rows_smem,
                       smem_bytes=used + (bufs if rows_smem else 0))


@dataclasses.dataclass(frozen=True)
class ServePlan:
    """One ``rsnn_infer`` / ``rsnn_step_sessions`` launch: ``rows`` batch
    rows a block, each on its own warp of the block's ``threads``; the
    ticks in chunks of ``Tc``; the f32 weights in shared memory when
    ``weights_smem``; ``smem_bytes`` of dynamic shared memory (the kernel
    refuses a launch whose plan disagrees with its own layout)."""

    rows: int
    threads: int
    weights_smem: bool
    Tc: int
    smem_bytes: int


def serve_tick_words(n_in: int, n_hid: int, n_out: int) -> int:
    """Shared-memory words one row and tick of a serving chunk takes: the
    input row (later the readout currents, ``max(N, O)``), the input
    current (H), the spike masks (one word per 32 neurons), valid and
    live."""
    return max(n_in, n_out) + n_hid + cdiv(n_hid, 32) + 2


def serve_threads(n_in: int, n_hid: int) -> int:
    """Threads of a serving block, the kernels' launch bound
    (``RsnnServeThreads`` in ``csrc/rsnn_serve.cu``): 1,024 where the
    inputs and neurons fit two words of 32 lanes (Braille; those kernels
    fit 64 registers a thread), else 512."""
    return THREADS_PER_BLOCK if max(n_in, n_hid) <= 64 else THREADS_PER_BLOCK // 2


def serve_plan(T: int, B: int, n_in: int, n_hid: int, n_out: int,
               sm_count: int = H100_SMS) -> ServePlan:
    """Rows a block: few enough that the batch spreads over every SM (the
    tick chain, not the width, sets a row's time), a warp each, at most
    :data:`SERVE_MAX_ROWS`.  Then the longest chunk of ticks that fits
    the block's shared memory, beside the weights where those fit with at
    least :data:`SERVE_MIN_CHUNK` ticks (Braille and cue do, 256/256/16
    does not).  Results do not depend on the plan: every row's sums run
    in an order fixed by the row."""
    rows = max(1, min(SERVE_MAX_ROWS, cdiv(B, sm_count)))
    per_tick = F32_BYTES * rows * serve_tick_words(n_in, n_hid, n_out)
    weights = weights_bytes(n_in, n_hid, n_out)
    weights_smem = weights + per_tick * max(1, min(T, SERVE_MIN_CHUNK)) <= SMEM_PER_BLOCK
    room = SMEM_PER_BLOCK - (weights if weights_smem else 0)
    Tc = max(1, min(T, room // per_tick))
    return ServePlan(rows=rows, threads=serve_threads(n_in, n_hid),
                     weights_smem=weights_smem,
                     Tc=Tc, smem_bytes=(weights if weights_smem else 0) + Tc * per_tick)


def serve_rows_per_sm(n_hid: int) -> int:
    """Row warps an SM runs at once when serving: as many as keep its
    per-tick LIF updates within one block's worth of threads — a row's
    warp updates 32 lanes × ``ceil(H/32)`` neuron slots a tick — and at
    most :data:`SERVE_MAX_ROWS` (one block's row warps): 16 Braille, 8 cue,
    4 at 256/256/16."""
    return max(1, min(SERVE_MAX_ROWS, THREADS_PER_BLOCK // (32 * cdiv(n_hid, 32))))


def max_batch_for_dims(n_in: int, n_hid: int, n_out: int) -> int:
    """Serving admission per launch: the largest power of two of rows that
    the card runs at once, :func:`serve_rows_per_sm` on each SM — 2,048
    Braille, 1,024 cue, 512 at 256/256/16.  :func:`serve_plan` runs every
    admitted row in one wave of blocks (``tests/test_torch_kernels.py``
    holds it to that)."""
    rows = H100_SMS * serve_rows_per_sm(n_hid)
    return 1 << (rows.bit_length() - 1)


def session_state_bytes(n_hid: int, n_out: int) -> int:
    """Device bytes one resident session's carry occupies: f32 rows of
    ``v, z (H)``, ``y, acc_y (O)`` and ``n_spk (1)``."""
    return F32_BYTES * (2 * n_hid + 2 * n_out + 1)


# ---------------------------------------------------------------------------
# plain tick datapath
# ---------------------------------------------------------------------------


SURROGATES = ("boxcar", "triangular")


def check_surrogate(surrogate: str) -> None:
    """Raises on a pseudo-derivative the kernels do not compute, as the
    reference's ``pseudo_derivative`` does."""
    if surrogate not in SURROGATES:
        raise ValueError(f"unknown surrogate {surrogate!r}")


def inv_threshold(v_th: float) -> float:
    """``f32(1 / v_th)``, rounded once: the factor the triangular
    pseudo-derivative multiplies by, as the reference's compiled scan does
    (XLA turns its division by the constant threshold into this
    product)."""
    return float(np.float32(1.0) / np.float32(v_th))


def pseudo_h(v_pre, v_th: float, *, surrogate: str = "boxcar",
             boxcar_width: float = 0.5, gamma: float = 0.3):
    """The pseudo-derivative at the pre-reset membrane as the kernels and
    the reference's compiled scan compute it: the boxcar ``|v_pre - v_th| <
    boxcar_width * v_th``, or Bellec's triangular ``gamma * max(0, 1 - d *
    r)``, ``d = |v_pre - v_th|``, ``r`` = :func:`inv_threshold`, with
    ``1 - d * r`` rounded once (XLA contracts it into a fused multiply-add,
    the kernels take an ``fmaf``).  Here it runs in f64 and rounds to f32:
    ``d * r`` is exact there, and the difference rounds to the fused
    result in quantized mode (``d`` an integer, ``r`` a multiple of 2^-33:
    exact in f64) and at ``v_th = 1`` (``d * r = d``).
    :func:`repro_torch.core.neuron.pseudo_derivative` divides instead (the
    reference's eager form); in quantized mode the two differ by an ulp at
    some membranes."""
    check_surrogate(surrogate)
    d = torch.abs(v_pre - v_th)
    if surrogate == "boxcar":
        return (d < boxcar_width * v_th).to(v_pre.dtype)
    u = (1.0 - d.double() * inv_threshold(v_th)).to(v_pre.dtype)
    return gamma * torch.clamp(u, min=0.0)


def surrogate_scalars(surrogate: str, boxcar_width: float, gamma: float,
                      v_th: float) -> list:
    """The C launchers' pseudo-derivative arguments (:func:`pseudo_h`):
    the boxcar half-width times ``v_th``, 1 for the triangular surrogate,
    ``gamma`` and :func:`inv_threshold`.  Raises on an unknown surrogate."""
    check_surrogate(surrogate)
    return [ctypes.c_float(boxcar_width * v_th), int(surrogate == "triangular"),
            ctypes.c_float(gamma), ctypes.c_float(inv_threshold(v_th))]


def tick_transition(x_t, v, z, y, w_in, w_rec, w_out, *, alpha: float,
                    kappa: float, v_th: float, reset_sub: bool,
                    boxcar_width: float = 0.5, surrogate: str = "boxcar",
                    gamma: float = 0.3,
                    quant: Optional[QuantizedMode] = None):
    """One LIF + LI tick → ``(v_new, z_new, y_new, h)``, ``h`` the
    pseudo-derivative at the pre-reset membrane (:func:`pseudo_h`)."""
    return tick_from_input_current(
        x_t @ w_in, v, z, y, w_rec, w_out, alpha=alpha, kappa=kappa,
        v_th=v_th, reset_sub=reset_sub, boxcar_width=boxcar_width,
        surrogate=surrogate, gamma=gamma, quant=quant,
    )


def tick_from_input_current(in_cur, v, z, y, w_rec, w_out, *, alpha: float,
                            kappa: float, v_th: float, reset_sub: bool,
                            boxcar_width: float = 0.5, surrogate: str = "boxcar",
                            gamma: float = 0.3,
                            quant: Optional[QuantizedMode] = None):
    """:func:`tick_transition` with ``x_t @ w_in`` given; keeps the JAX
    operand order ``in_cur + z @ w_rec``."""
    current = in_cur + z @ w_rec
    if quant is None:
        v_pre = alpha * v + current
    else:
        v_pre = quant.sat(quant.leak(v, quant.alpha_reg) + current)
    z_new = (v_pre >= v_th).to(v_pre.dtype)
    if reset_sub:
        v_new = v_pre - z_new * v_th
    else:
        v_new = v_pre * (1.0 - z_new)
    h = pseudo_h(v_pre, v_th, surrogate=surrogate, boxcar_width=boxcar_width,
                 gamma=gamma)
    y_lin = z_new @ w_out
    if quant is None:
        y_new = kappa * y + y_lin
    else:
        y_new = quant.sat(quant.leak(y, quant.kappa_reg) + y_lin)
    return v_new, z_new, y_new, h


def _consts(alpha, kappa, v_th, reset, quant):
    if quant is not None:
        alpha, kappa, v_th = quant.alpha, quant.kappa, float(quant.threshold)
    if reset not in ("sub", "zero"):
        raise ValueError(f"unknown reset mode {reset!r}")
    return dict(alpha=float(alpha), kappa=float(kappa), v_th=float(v_th),
                reset_sub=reset == "sub", quant=quant)


def _check_exact_matmul(raster: torch.Tensor, quant) -> None:
    """The quantized plain version relies on full-f32 products on the card
    (TF32 would round the >11-bit weight integers)."""
    if (quant is not None and raster.is_cuda
            and torch.backends.cuda.matmul.allow_tf32):
        raise ValueError(
            "quantized plain version needs torch.backends.cuda.matmul."
            "allow_tf32 = False (TF32 rounds the membrane-grid weights)"
        )


def rsnn_infer_plain(raster, valid, w_in, w_rec, w_out, *, alpha: float,
                     kappa: float, v_th: float = 1.0, reset: str = "sub",
                     quant: Optional[QuantizedMode] = None,
                     infer_window: str = "valid",
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`rsnn_infer_cuda` → ``(acc_y (B, O),
    n_spk (B, 1))``."""
    c = _consts(alpha, kappa, v_th, reset, quant)
    _check_exact_matmul(raster, quant)
    T, B, _ = raster.shape
    H, O = w_rec.shape[0], w_out.shape[1]
    v = raster.new_zeros((B, H))
    z = raster.new_zeros((B, H))
    y = raster.new_zeros((B, O))
    acc = raster.new_zeros((B, O))
    nspk = raster.new_zeros((B, 1))
    infer_all = infer_window == "all"
    for t in range(T):
        v, z, y, _ = tick_transition(raster[t], v, z, y, w_in, w_rec, w_out, **c)
        vt = valid[t][:, None]
        acc = acc + y * (1.0 if infer_all else vt)
        nspk = nspk + (z * vt).sum(dim=1, keepdim=True)
    return acc, nspk


def rsnn_step_sessions_plain(raster, live, valid, v0, z0, y0, acc0, nspk0,
                             w_in, w_rec, w_out, *, alpha: float,
                             kappa: float, v_th: float = 1.0,
                             reset: str = "sub",
                             quant: Optional[QuantizedMode] = None,
                             infer_window: str = "valid"):
    """Plain version of :func:`rsnn_step_sessions_cuda` → final
    ``(v, z, y, acc_y, n_spk)``."""
    c = _consts(alpha, kappa, v_th, reset, quant)
    _check_exact_matmul(raster, quant)
    v, z, y, acc, nspk = v0, z0, y0, acc0, nspk0
    infer_all = infer_window == "all"
    for t in range(raster.shape[0]):
        v_new, z_new, y_new, _ = tick_transition(
            raster[t], v, z, y, w_in, w_rec, w_out, **c)
        lt = live[t][:, None]
        vt = valid[t][:, None]
        keep = lt > 0
        v = torch.where(keep, v_new, v)
        z = torch.where(keep, z_new, z)
        y = torch.where(keep, y_new, y)
        acc = acc + y_new * (lt if infer_all else vt)
        nspk = nspk + (z_new * vt).sum(dim=1, keepdim=True)
    return v, z, y, acc, nspk


# ---------------------------------------------------------------------------
# kernel launchers (CUDA tensors only; ops.py dispatches)
# ---------------------------------------------------------------------------


def check_arg(name: str, t: torch.Tensor, shape, device, dtype=torch.float32) -> None:
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def datapath_scalars(c) -> list:
    """The C launchers' datapath arguments from :func:`_consts`: alpha,
    kappa, v_th, the two quantized leak factors, the membrane grid, the
    reset mode and the quantized flag."""
    q = c["quant"]
    return [
        ctypes.c_float(c["alpha"]), ctypes.c_float(c["kappa"]),
        ctypes.c_float(c["v_th"]),
        ctypes.c_float((q.alpha_reg & 0xFF) / 256.0 if q else 0.0),
        ctypes.c_float((q.kappa_reg & 0xFF) / 256.0 if q else 0.0),
        ctypes.c_float(float(q.v_min) if q else 0.0),
        ctypes.c_float(float(q.v_max) if q else 0.0),
        int(c["reset_sub"]), int(q is not None),
    ]


def _check_event_widths(name: str, N: int, H: int, O: int) -> None:
    """Raises on widths the event loop does not take."""
    if max(N, H) > EVENT_LOOP_MAX_WIDTH or O > EVENT_LOOP_MAX_OUT:
        raise ValueError(
            f"{name}: {N}/{H}/{O} exceeds the chip's "
            f"{EVENT_LOOP_MAX_WIDTH}/{EVENT_LOOP_MAX_WIDTH}/{EVENT_LOOP_MAX_OUT} "
            "(RSNN_MAX_WORDS, RSNN_MAX_OUT in csrc)")


def _serve_args(raster, w_rec, w_out, *, alpha, kappa, v_th, reset, quant,
                infer_window):
    """The serving launchers' dims (with :func:`serve_plan`'s geometry)
    and datapath scalars; raises on widths the event loop does not take."""
    T, B, N = raster.shape
    H, O = w_rec.shape[0], w_out.shape[1]
    _check_event_widths("serving kernels", N, H, O)
    c = _consts(alpha, kappa, v_th, reset, quant)
    sm = torch.cuda.get_device_properties(raster.device).multi_processor_count
    plan = serve_plan(T, B, N, H, O, sm)
    dims = [T, B, N, H, O, plan.rows, plan.threads, plan.Tc,
            int(plan.weights_smem), int(infer_window == "all"),
            ctypes.c_longlong(plan.smem_bytes)]
    return dims, datapath_scalars(c) + [stream_arg(raster.device)]


def rsnn_infer_cuda(raster, valid, w_in, w_rec, w_out, *, alpha: float,
                    kappa: float, v_th: float = 1.0, reset: str = "sub",
                    quant: Optional[QuantizedMode] = None,
                    infer_window: str = "valid"):
    """Launch ``rsnn_infer_kernel`` on the current stream of the tensors'
    device → ``(acc_y (B, O), n_spk (B, 1))``.  Checks device, dtype, shape
    and contiguity; raises on a refused launch."""
    from repro_torch.kernels import build

    T, B, N = raster.shape
    H, O = w_rec.shape[0], w_out.shape[1]
    dev = raster.device
    for name, t, shape in (("raster", raster, (T, B, N)), ("valid", valid, (T, B)),
                           ("w_in", w_in, (N, H)), ("w_rec", w_rec, (H, H)),
                           ("w_out", w_out, (H, O))):
        check_arg(name, t, shape, dev)
    acc = torch.empty((B, O), dtype=torch.float32, device=dev)
    nspk = torch.empty((B, 1), dtype=torch.float32, device=dev)
    if B == 0:
        return acc, nspk
    lib = build.library()
    dims, scalars = _serve_args(raster, w_rec, w_out, alpha=alpha, kappa=kappa,
                                v_th=v_th, reset=reset, quant=quant,
                                infer_window=infer_window)
    ptrs = [t.data_ptr() for t in (raster, valid, w_in, w_rec, w_out, acc, nspk)]
    with torch.cuda.device(dev):
        rc = lib.rsnn_infer_launch(*ptrs, *dims, *scalars)
    raise_on(lib, rc, "rsnn_infer")
    launches["rsnn_infer"] += 1
    return acc, nspk


def rsnn_step_sessions_cuda(raster, live, valid, v0, z0, y0, acc0, nspk0,
                            w_in, w_rec, w_out, *, alpha: float, kappa: float,
                            v_th: float = 1.0, reset: str = "sub",
                            quant: Optional[QuantizedMode] = None,
                            infer_window: str = "valid"):
    """Launch ``rsnn_step_sessions_kernel`` on the current stream of the
    tensors' device → final ``(v, z, y, acc_y, n_spk)``.  Same checks as
    :func:`rsnn_infer_cuda`."""
    from repro_torch.kernels import build

    T, B, N = raster.shape
    H, O = w_rec.shape[0], w_out.shape[1]
    dev = raster.device
    for name, t, shape in (
        ("raster", raster, (T, B, N)), ("live", live, (T, B)),
        ("valid", valid, (T, B)), ("v0", v0, (B, H)), ("z0", z0, (B, H)),
        ("y0", y0, (B, O)), ("acc0", acc0, (B, O)), ("nspk0", nspk0, (B, 1)),
        ("w_in", w_in, (N, H)), ("w_rec", w_rec, (H, H)),
        ("w_out", w_out, (H, O)),
    ):
        check_arg(name, t, shape, dev)
    outs = [torch.empty(s, dtype=torch.float32, device=dev)
            for s in ((B, H), (B, H), (B, O), (B, O), (B, 1))]
    if B == 0:
        return tuple(outs)
    lib = build.library()
    dims, scalars = _serve_args(raster, w_rec, w_out, alpha=alpha, kappa=kappa,
                                v_th=v_th, reset=reset, quant=quant,
                                infer_window=infer_window)
    ptrs = [t.data_ptr() for t in (raster, live, valid, v0, z0, y0, acc0, nspk0,
                                   w_in, w_rec, w_out, *outs)]
    with torch.cuda.device(dev):
        rc = lib.rsnn_step_sessions_launch(*ptrs, *dims, *scalars)
    raise_on(lib, rc, "rsnn_step_sessions")
    launches["rsnn_step_sessions"] += 1
    return tuple(outs)


# ---------------------------------------------------------------------------
# trace-streaming forward (forward_traces / dynamics ops)
# ---------------------------------------------------------------------------

FORWARD_KEYS = ("z", "h", "xbar", "pbar", "zbar", "y", "v")


def rsnn_forward_plain(raster, w_in, w_rec, w_out, *, alpha: float,
                       kappa: float, v_th: float = 1.0, reset: str = "sub",
                       boxcar_width: float = 0.5, surrogate: str = "boxcar",
                       gamma: float = 0.3,
                       quant: Optional[QuantizedMode] = None,
                       ) -> Dict[str, torch.Tensor]:
    """Plain version of :func:`rsnn_forward_cuda` → ``{"z", "h", "xbar",
    "pbar", "zbar", "y", "v"}``, each ``(T, B, ·)``; ``v`` is the
    post-reset membrane, ``h`` the ``surrogate``'s pseudo-derivative."""
    check_surrogate(surrogate)
    c = _consts(alpha, kappa, v_th, reset, quant)
    _check_exact_matmul(raster, quant)
    T, B, N = raster.shape
    H, O = w_rec.shape[0], w_out.shape[1]
    v, z = raster.new_zeros((B, H)), raster.new_zeros((B, H))
    pbar, zbar = raster.new_zeros((B, H)), raster.new_zeros((B, H))
    y, xbar = raster.new_zeros((B, O)), raster.new_zeros((B, N))
    outs = {k: [] for k in FORWARD_KEYS}
    for t in range(T):
        v_new, z_new, y, h = tick_transition(
            raster[t], v, z, y, w_in, w_rec, w_out,
            boxcar_width=boxcar_width, surrogate=surrogate, gamma=gamma, **c)
        xbar = c["alpha"] * xbar + raster[t]
        pbar = c["alpha"] * pbar + z          # presyn trace: z BEFORE this tick
        zbar = c["kappa"] * zbar + z_new
        for k, x in zip(FORWARD_KEYS, (z_new, h, xbar, pbar, zbar, y, v_new)):
            outs[k].append(x)
        v, z = v_new, z_new
    return {k: torch.stack(x) for k, x in outs.items()}


def rsnn_forward_cuda(raster, w_in, w_rec, w_out, *, alpha: float,
                      kappa: float, v_th: float = 1.0, reset: str = "sub",
                      boxcar_width: float = 0.5, surrogate: str = "boxcar",
                      gamma: float = 0.3,
                      quant: Optional[QuantizedMode] = None,
                      ) -> Dict[str, torch.Tensor]:
    """Launch ``rsnn_forward_kernel`` (``rsnn_forward_tri_kernel`` under
    the triangular surrogate) on the current stream of the tensors'
    device → the seven ``(T, B, ·)`` tensors of
    :func:`rsnn_forward_plain`.  Checks device, dtype, shape, contiguity
    and the surrogate; raises on a refused launch."""
    from repro_torch.kernels import build

    check_surrogate(surrogate)
    T, B, N = raster.shape
    H, O = w_rec.shape[0], w_out.shape[1]
    dev = raster.device
    for name, t, shape in (("raster", raster, (T, B, N)), ("w_in", w_in, (N, H)),
                           ("w_rec", w_rec, (H, H)), ("w_out", w_out, (H, O))):
        check_arg(name, t, shape, dev)
    width = {"xbar": N, "y": O}
    outs = {k: torch.empty((T, B, width.get(k, H)), dtype=torch.float32,
                           device=dev) for k in FORWARD_KEYS}
    if B == 0 or T == 0:
        return outs
    _check_event_widths("rsnn_forward", N, H, O)
    lib = build.library()
    c = _consts(alpha, kappa, v_th, reset, quant)
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = forward_plan(T, B, N, H, O, sm)
    ptrs = [t.data_ptr() for t in (raster, w_in, w_rec, w_out)]
    ptrs += [outs[k].data_ptr() for k in FORWARD_KEYS]
    with torch.cuda.device(dev):
        rc = lib.rsnn_forward_launch(
            *ptrs, T, B, N, H, O, plan.rows, plan.threads, plan.Tl,
            int(plan.weights_smem), int(plan.rows_smem),
            ctypes.c_longlong(plan.smem_bytes), *datapath_scalars(c),
            *surrogate_scalars(surrogate, boxcar_width, gamma, c["v_th"]),
            stream_arg(dev))
    raise_on(lib, rc, "rsnn_forward")
    launches["rsnn_forward"] += 1
    return outs
