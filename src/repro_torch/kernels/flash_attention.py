"""Causal GQA online-softmax (flash) attention for Hopper, and its plain
PyTorch version (counterpart of :mod:`repro.kernels.flash_attention`).

Both compute, for q ``(B, Sq, H, DK)``, k ``(B, Skv, Hkv, DK)`` and v
``(B, Skv, Hkv, DV)`` with ``H = Hkv·G`` (query head ``h`` reads KV head
``h // G``), the function of ``repro.models.attention.blocked_attention``
(and of the Pallas kernel, whose q, k and v share one width):

* scores ``q·k · DK**-0.5`` with the products summed in f32; keys at
  positions ``>= kv_len`` and, when ``causal``, keys after the query's own
  position masked at ``-1e30``;
* running max ``m``, running sum ``l`` and the output accumulator in f32,
  tile by tile over the keys; ``p`` rounded to the value dtype before the
  ``p·V`` product, as the JAX kernel does;
* output ``(B, Sq, H, DV)`` in q's dtype, divided by ``max(l, 1e-30)``.

The q/k width and the v width differ in MLA (deepseek-v2: 192 = 128 +
64 rope, and 128); the kernels are instantiated for the pairs of
:data:`KERNEL_HEAD_DIMS`.

Whole key tiles above the diagonal or past ``kv_len`` are skipped (their
terms are exact zeros once a row has seen key 0, which every row has).
Ragged lengths need no padding: the kernel masks its own edges.  On
request both forwards also return what the backward takes: each row's
log-sum-exp ``lse = m + log(l)`` in f32, ``(B, H, Sq)``, and the output
before its rounding to q's dtype (f32, ``(B, Sq, H, DV)``; in f32 the
output itself), from which the backward takes ``δ``.

The backward (``FlashAttentionFn``, the gradient JAX takes of
``repro.models.attention.blocked_attention`` with ``jax.grad``; the Pallas
kernel has none) recomputes the probabilities tile by tile from the saved
``lse``: ``P = exp(S - lse)``, ``dV = Pᵀ·dO``, ``dP = dO·Vᵀ``, ``dS = P ∘
(dP - δ)`` with ``δ = rowsum(dO ∘ O)``, ``dQ = scale·dS·K``, ``dK =
scale·dSᵀ·Q``; dK and dV summed over the G query heads of each KV head.
Like the forward it rounds ``P`` (and ``dS``) to the input dtype before
their products.  ``O`` in ``δ`` is the forward's f32 output before its
rounding: ``dQ_i = scale·Σ_j P_ij (dP_ij - δ_i) k_j`` cancels when the keys
share a large part (a cross-attention's memory does), and the bf16
output's rounding in ``δ`` then led it (0.85 of max|dq| from f32 where JAX's
bf16 gradient is 0.034, ``tests/test_torch_xattn.py``).

* :func:`flash_attention_cuda` launches the kernel of
  ``csrc/flash_attention.cu`` on the tensors' card: in bf16 (every model
  path) ``flash_fwd_kernel``, a producer warpgroup that keeps TMA loads of
  k and v tiles in flight through an ``mbarrier`` ring and two consumer
  warpgroups of 64 queries each that run both products on ``wgmma``; in
  f32 the CUDA-core ``flash_attention_f32_kernel``.  It reads q, k and v
  through their strides (only the last dimension must be contiguous), so
  the model's ``(B, S, H, D)`` projections go in without a transpose copy;
  in bf16 through tensor maps, which take only addresses and strides that
  are multiples of 16 bytes (:func:`tma_strides` raises on others).
* :func:`flash_attention_plain` is the same tiled loop in eager PyTorch;
  the CPU path runs it, and ``chip_smoke.py`` holds the kernel against it.
  It needs full-f32 matmuls (``torch.backends.cuda.matmul.allow_tf32``
  off, PyTorch's default) to be the kernel's reference on the card.
* :func:`flash_attention_bwd_cuda` launches the backward of
  ``csrc/flash_attention_bwd.cu`` (a ``δ`` pre-pass, then dK/dV blocks, a
  block a KV tile and KV head, and dQ blocks, a block a q block and one or
  two heads; in bf16 one launch of a warp-specialised ``wgmma`` kernel fed
  by TMA through an ``mbarrier`` ring: no atomics, so two launches give
  the same bits), :func:`flash_attention_bwd_plain` is its eager
  version.
* :func:`flash_plan` and :func:`flash_bwd_plan` are the launches'
  geometry (grid, the order in which blocks take their q tiles, threads,
  shared memory), pure Python so that the CPU tests reach them; the C
  launchers refuse a plan that is not their kernel's layout.

:mod:`repro_torch.kernels.ops` picks one or the other by tensor device.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Optional, Tuple

import torch

from repro_torch.kernels.launch import H100_SMS, cdiv, launches, raise_on, stream_arg

NEG_INF = -1e30
# Key and query rows per tile of the plain version; the tile sizes change
# only the order of the f32 sums.
PLAIN_BLOCK = 128
# (q/k width, v width) pairs the kernels are instantiated for
# (csrc/flash_attention.cu, csrc/flash_attention_bwd.cu): the dense
# models' equal widths and MLA's (192, 128), the latter in bf16 only.
KERNEL_HEAD_DIMS = ((16, 16), (32, 32), (64, 64), (128, 128), (192, 128))
DTYPES = (torch.float32, torch.bfloat16)
# A grid's second axis (the f32 forward's batch·heads, the backward's
# tiles).
MAX_GRID_Y = 65535
# The f32 kernels' tiles (FA_BQ, FA_BK in csrc/flash_common.cuh): 64 query
# rows a block of 128 threads, 64 keys a tile, staged rows padded by 4
# bytes.
BLOCK_Q = 64
BLOCK_K = 64
# The bf16 forward's geometry (FWD_* in csrc/flash_attention.cu): one
# persistent block an SM, a producer warpgroup and two consumer warpgroups
# of 64 queries each, so tiles of 128 queries, each walking k/v tiles of
# 128 keys through a TMA ring of 2 stages (a stage's k and v tiles, each
# with a full and an empty barrier: a k tile is released once its S is in,
# a v tile once its P·V is, and the next tiles' loads overlap this one's
# products, across the block's q tiles too).
FWD_THREADS = 384
FWD_BLOCK = 128
FWD_KT = 128
FWD_STAGES = 2
# Barriers of a forward block: q full and q empty, and each stage's k
# full, v full, k empty and v empty, 8 bytes each.
FWD_BARRIERS = 2 + 4 * FWD_STAGES
# The bf16 kernels align their shared memory to the 128-byte swizzle's
# 1,024-byte period themselves, and ask for that much more.
SWIZZLE_PERIOD = 1024
# TMA reads 16-byte aligned rows through strides in multiples of 16 bytes,
# each below 2^40 bytes; the backward's loads of o and dO move 16 bytes.
TMA_ALIGN = 16
TMA_MAX_STRIDE = 2 ** 40
COPY_BYTES = 16
# How far two bf16 attention results may lie apart, per query row (the D
# outputs of one batch, position and head): ``row_error <= BF16_ROW_TOL``.
# The kernel and its plain version both round p to bf16 (2^-9 relative),
# relative to running maxima that depend on their tile sizes, and each
# rounds its output to bf16 once; that last rounding alone may land one
# ulp apart on the row's largest element, 2^-7 of max |o_row|.  The limit
# is 8 · 2^-8 = 2^-5 of max |o_row|: room above those roundings, and far
# below a wrong scale (output x 0.9 is 0.1 of it) or one key tile lost
# from a row (at inputs of scale 0.3 the scores are near-uniform and each
# key moves the row by its own share, so 64 of n keys move it by about
# 8/sqrt(n) of its largest output).  chip_smoke.py logs both readings.
BF16_ROW_TOL = 8 * 2 ** -8
# Rows whose largest output is below this are held to it instead (an
# absolute floor, far below any output at the scales the checks use).
ROW_FLOOR = 2 ** -16
# How far two bf16 gradients (dq, dk or dv) may lie apart, per row:
# ``grad_row_error <= BWD_BF16_ROW_TOL``.  Each output is rounded to bf16
# once (one ulp at the row's largest element, 2^-7 of it), and P and dS
# are rounded to bf16 as product operands (2^-9 each, summed over many
# keys or queries).  A row whose gradient cancels (a query that sees a
# few keys, a key seen by a few queries) keeps absolute errors of the
# typical row's size: dS = P (dP - delta) takes delta = rowsum(dO o O),
# from a bf16 output O an error of 2^-9 of |dO||O| whatever the size of
# dS (the training path gives the f32 O instead; these gates take the
# rounded one, the larger error).  So a row is measured against the larger of its own largest
# element and the median over rows of that, and the limit is 2^-5 as in
# the forward: room above those roundings (the plain version against
# JAX's jax.vjp of blocked_attention in bf16: worst row 0.0176 at S <=
# 1000, tests/_torch_lm_bf16_spread.py on a CPU), far below dk x 0.9 (0.1
# of every large row) or a q tile dropped from dk and dv (0.56 and more
# in chip_smoke.py (p)).
BWD_BF16_ROW_TOL = 8 * 2 ** -8


@dataclasses.dataclass(frozen=True)
class FlashPlan:
    """One launch's geometry, as the launcher takes it: ``grid``,
    ``threads`` and ``smem_bytes`` of dynamic shared memory a block; tiles
    of ``q_block`` queries of one of the ``heads`` = B·H (batch, head)
    pairs, ``q_tiles`` of them a head, each walking key tiles of
    ``key_tile`` keys (in bf16 through a ring of ``stages`` k/v stages).

    * bf16 (``persistent``): ``grid = (min(tiles, SMs), 1)``, one block an
      SM that takes a tile of the schedule (:meth:`tiles`) a round, where
      tile ``i`` is q tile ``q_tiles - 1 - i // heads`` of batch·head ``i %
      heads``: every head's last q tile (under the causal mask the one
      with the most keys) comes before any head's second to last.  The
      rounds run over the blocks forwards and backwards in turn
      (:meth:`block_tiles`), so that the blocks' sums of key tiles come out
      even;
    * f32: ``grid = (q tiles, B·H)``, block ``x`` of a row taking q tile
      ``grid[0] - 1 - x``: each batch·head's last tile first."""

    grid: Tuple[int, int]
    threads: int
    smem_bytes: int
    q_block: int
    key_tile: int
    stages: int
    q_tiles: int
    heads: int
    persistent: bool

    def tiles(self) -> List[Tuple[int, int]]:
        """``(q tile, batch·head)`` of every tile: in bf16 in the
        schedule's order, in f32 in launch order (x fastest)."""
        if self.persistent:
            return [(self.q_tiles - 1 - i // self.heads, i % self.heads)
                    for i in range(self.q_tiles * self.heads)]
        nx, ny = self.grid
        return [(nx - 1 - x, y) for y in range(ny) for x in range(nx)]

    def block_tiles(self, x: int) -> List[Tuple[int, int]]:
        """bf16: the tiles persistent block ``x`` takes, in order: in round
        ``r`` tile ``r·G + x``, or ``r·G + G - 1 - x`` when ``r`` is odd
        (``G = grid[0]``; ``fwd_tile_index`` in the kernel)."""
        tiles, G = self.tiles(), self.grid[0]
        out = []
        for r in range(cdiv(len(tiles), G)):
            i = r * G + (G - 1 - x if r % 2 else x)
            if i >= len(tiles):
                break
            out.append(tiles[i])
        return out

    def key_walk(self, y: int, Sq: int, kv_len: int, causal: bool) -> List[Tuple[int, int]]:
        """``(first key, rows read)`` of every key tile that q tile ``y``
        visits, in order: up to the tile holding ``kv_len - 1`` and, when
        causal, the q tile's last query.  Rows past ``kv_len`` are not
        read: in bf16 the k and v tensor maps end at ``kv_len`` and the TMA
        writes zeros there, in f32 the loads are guarded."""
        q0 = y * self.q_block
        n = cdiv(kv_len, self.key_tile)
        if causal:
            n = min(n, (min(q0 + self.q_block, Sq) - 1) // self.key_tile + 1)
        return [(k0, min(self.key_tile, kv_len - k0))
                for k0 in range(0, n * self.key_tile, self.key_tile)]


def flash_smem_bytes(D: int, dtype: torch.dtype, DV: Optional[int] = None) -> int:
    """Dynamic shared memory of one block at q/k width ``D`` and v width
    ``DV`` (default ``D``): bf16 (``FwdSmem``) the q tile of ``FWD_BLOCK``
    rows, ``FWD_STAGES`` k and v tiles of ``FWD_KT`` rows and the
    ``FWD_BARRIERS`` barriers, with the swizzle's period more; f32 (``DV ==
    D`` only) the q, k and v tiles (rows of ``D + 1``), the 64 x 65 score
    tile and three row vectors."""
    DV = D if DV is None else DV
    if dtype == torch.bfloat16:
        return (SWIZZLE_PERIOD + (FWD_BLOCK * D + FWD_STAGES * FWD_KT * (D + DV)) * 2
                + 8 * FWD_BARRIERS)
    return ((BLOCK_Q + 2 * BLOCK_K) * (D + 1) + BLOCK_Q * (BLOCK_K + 1)
            + 3 * BLOCK_Q) * 4


def flash_plan(B: int, Sq: int, H: int, D: int, dtype: torch.dtype,
               DV: Optional[int] = None, sm_count: int = H100_SMS) -> FlashPlan:
    """The launch at these shapes on a card of ``sm_count`` SMs."""
    smem = flash_smem_bytes(D, dtype, DV)
    if dtype == torch.bfloat16:
        nq = cdiv(Sq, FWD_BLOCK)
        return FlashPlan(grid=(min(B * H * nq, sm_count), 1), threads=FWD_THREADS,
                         smem_bytes=smem, q_block=FWD_BLOCK, key_tile=FWD_KT,
                         stages=FWD_STAGES, q_tiles=nq, heads=B * H, persistent=True)
    nq = cdiv(Sq, BLOCK_Q)
    return FlashPlan(grid=(nq, B * H), threads=128, smem_bytes=smem, q_block=BLOCK_Q,
                     key_tile=BLOCK_K, stages=0, q_tiles=nq, heads=B * H, persistent=False)


def _check_copy_alignment(name: str, t: torch.Tensor) -> None:
    """The bf16 kernels read 16-byte pieces (TMA boxes, the backward's
    vector loads of o and dO): an address, and each stride that moves it
    (of a dimension longer than 1), must be multiples of 16 bytes."""
    step = COPY_BYTES // t.element_size()
    moving = [s for s, n in zip(t.stride()[:3], t.shape[:3]) if n > 1]
    if t.data_ptr() % COPY_BYTES or any(s % step for s in moving):
        raise ValueError(
            f"{name}: the bf16 kernel needs a {COPY_BYTES}-byte-aligned address and "
            f"batch, sequence and head strides in multiples of {step} elements, "
            f"got strides {tuple(t.stride())} at address {t.data_ptr():#x}")


def _check_shapes(q, k, v, kv_len):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or v.shape[:3] != k.shape[:3]:
        raise ValueError(
            f"flash_attention: expected q (B, Sq, H, DK), k (B, Skv, Hkv, DK) and v "
            f"(B, Skv, Hkv, DV), got {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}")
    B, Sq, H, D = q.shape
    _, Skv, Hkv, Dk = k.shape
    if k.shape[0] != B or Dk != D or Hkv == 0 or H % Hkv:
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)} and k {tuple(k.shape)} disagree "
            f"(batch, head width, or H not a multiple of Hkv)")
    kv_len = Skv if kv_len is None else int(kv_len)
    if not 1 <= kv_len <= Skv:
        raise ValueError(f"flash_attention: kv_len {kv_len} outside [1, {Skv}]")
    return kv_len


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, kv_len: Optional[int] = None,
                          return_lse: bool = False):
    """The kernel's function in eager PyTorch → ``(B, Sq, H, DV)`` in q's
    dtype, and with ``return_lse`` ``(o, lse, o32)``: also ``lse`` (f32,
    ``(B, H, Sq)``) and the output before its rounding (f32, the output
    itself in f32); ``kv_len`` defaults to ``Skv``."""
    kv_len = _check_shapes(q, k, v, kv_len)
    B, Sq, H, D = q.shape
    Hkv, DV = k.shape[2], v.shape[3]
    G = H // Hkv
    scale = D ** -0.5
    k, v = k[:, :kv_len], v[:, :kv_len]          # keys past kv_len never count
    out = torch.empty((B, Sq, H, DV), dtype=q.dtype, device=q.device)
    out32 = (torch.empty((B, Sq, H, DV), dtype=torch.float32, device=q.device)
             if return_lse and q.dtype != torch.float32 else None)
    lse = torch.empty((B, Sq, H), dtype=torch.float32, device=q.device)
    bq = bk = PLAIN_BLOCK
    for q0 in range(0, Sq, bq):
        n = min(bq, Sq - q0)
        qt = q[:, q0:q0 + n].float().reshape(B, n, Hkv, G, D)
        qpos = torch.arange(q0, q0 + n, device=q.device)
        m = torch.full((B, n, Hkv, G), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, n, Hkv, G, DV), dtype=torch.float32, device=q.device)
        n_kv = cdiv(kv_len, bk)
        if causal:
            n_kv = min(n_kv, (q0 + n - 1) // bk + 1)
        for j in range(n_kv):
            kt = k[:, j * bk:(j + 1) * bk]
            vt = v[:, j * bk:(j + 1) * bk]
            s = torch.einsum("bqhgd,bkhd->bqhgk", qt, kt.float()) * scale
            if causal:
                kpos = torch.arange(j * bk, j * bk + kt.shape[1], device=q.device)
                valid = kpos[None, :] <= qpos[:, None]
                s = torch.where(valid[None, :, None, None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bqhgk,bkhd->bqhgd", p.to(v.dtype).float(), vt.float())
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        out[:, q0:q0 + n] = o.reshape(B, n, H, DV).to(q.dtype)
        if out32 is not None:
            out32[:, q0:q0 + n] = o.reshape(B, n, H, DV)
        lse[:, q0:q0 + n] = (m + torch.log(l)).reshape(B, n, H)
    if return_lse:
        return out, lse.permute(0, 2, 1).contiguous(), out if out32 is None else out32
    return out


def row_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest over query rows of ``max |got - want| / max |want|`` within
    the row (its last dimension), ``inf`` when ``got`` is not finite."""
    if not torch.isfinite(got).all():
        return float("inf")
    d = (got.float() - want.float()).abs().amax(dim=-1)
    return float((d / want.float().abs().amax(dim=-1).clamp_min(ROW_FLOOR)).max())


def grad_row_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest over rows (the last dimension) of ``max |got - want|`` over
    the larger of the row's ``max |want|``, the median over rows of that,
    and ``ROW_FLOOR``; ``inf`` when ``got`` is not finite."""
    if not torch.isfinite(got).all():
        return float("inf")
    d = (got.float() - want.float()).abs().amax(dim=-1)
    m = want.float().abs().amax(dim=-1)
    return float((d / m.clamp_min(max(float(m.median()), ROW_FLOOR))).max())


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    """The SMs of the card ``dev``: the bf16 forward's persistent blocks."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _check_card_inputs(op: str, q, k, v, *, data: bool = True) -> List[int]:
    """What a launch refuses: tensors off ``q``'s card, dtypes, a head
    dimension that is not contiguous, head widths without an instance, and
    (bf16, ``data`` on) addresses and strides the tensor maps cannot take
    (:func:`tma_strides`).  ``data`` off (a fake or ``meta`` tensor: no
    memory) checks everything but the card and the addresses.  Returns the
    batch, sequence and head strides of q, k and v to launch with: in bf16
    the tensor maps' (``data`` on), else the tensors' own."""
    pair = (q.shape[3], v.shape[3])
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (data and not t.is_cuda) or t.device != dev:
            raise ValueError(f"{name}: expected a tensor on {dev}, got {t.device}")
        if t.dtype != q.dtype or t.dtype not in DTYPES:
            raise ValueError(f"{name}: expected one dtype of {DTYPES} for q, k and v, "
                             f"got {t.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the head dimension must be contiguous")
    if pair not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{op}: (q/k, v) head widths {pair} not in {KERNEL_HEAD_DIMS}")
    if q.dtype == torch.float32 and pair[0] != pair[1]:
        raise ValueError(f"{op}: the f32 kernels take one head width for q, k and v; "
                         f"(q/k, v) widths {pair} run in bf16 only")
    if data and q.dtype == torch.bfloat16:
        return [s for name, t in (("q", q), ("k", k), ("v", v))
                for s in tma_strides(name, t)]
    return [s for t in (q, k, v) for s in t.stride()[:3]]


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, kv_len: Optional[int] = None,
                         return_lse: bool = False):
    """Launch the bf16 Hopper kernel or the f32 kernel on the current
    stream of the tensors' card → a contiguous ``(B, Sq, H, DV)`` tensor in
    q's dtype, and with ``return_lse`` ``(o, lse, o32)``: also ``lse``
    (f32, ``(B, H, Sq)``) and the output before its rounding (f32; the
    output itself in f32), written by the same launch; without it the
    kernel writes neither, and its output has the same bits.  Checks
    device, dtype, shape, strides and (bf16: :func:`tma_strides`)
    alignment; raises on a refused launch.  In bf16 the launcher encodes
    q's, k's and v's tensor maps on the host (k's and v's end at
    ``kv_len``)."""
    from repro_torch.kernels import build

    kv_len = _check_shapes(q, k, v, kv_len)
    B, Sq, H, D = q.shape
    Skv, Hkv, DV = k.shape[1], k.shape[2], v.shape[3]
    dev = q.device
    strides = _check_card_inputs("flash_attention", q, k, v)
    plan = flash_plan(B, Sq, H, D, q.dtype, DV, _sm_count(dev))
    if plan.grid[1] > MAX_GRID_Y:
        raise ValueError(f"flash_attention: grid {plan.grid} has more than {MAX_GRID_Y} "
                         f"blocks on its second axis")
    o = torch.empty((B, Sq, H, DV), dtype=q.dtype, device=dev)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
           if return_lse else None)
    o32 = (torch.empty((B, Sq, H, DV), dtype=torch.float32, device=dev)
           if return_lse and q.dtype == torch.bfloat16 else None)
    done = (o, lse, o if o32 is None else o32) if return_lse else o
    if B == 0 or Sq == 0:
        return done
    lib = build.library()
    with torch.cuda.device(dev):
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr() if return_lse else None,
            None if o32 is None else o32.data_ptr(),
            int(q.dtype == torch.bfloat16), B, Sq, Skv, H, Hkv, D, DV,
            *[ctypes.c_longlong(s) for s in strides], kv_len, int(causal),
            ctypes.c_float(D ** -0.5), *plan.grid, plan.threads,
            ctypes.c_longlong(plan.smem_bytes), stream_arg(dev))
    raise_on(lib, rc, "flash_attention")
    launches["flash_attention"] += 1
    return done


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------


# The bf16 backward's geometry (csrc/flash_attention_bwd.cu): blocks of a
# producer warpgroup and two consumer warpgroups of 64 rows each, so 128
# keys a dK/dV block (walking q tiles of 64 queries) and 128 queries a dQ
# block (walking KV tiles of 64 keys, for two heads of a KV head's group
# at once when G is even: the k and v tiles are read once for both); TMA
# rings of 3 stages.  The f32 kernels take 64-row tiles and 128 threads.
# The pre-pass writes lse·log2(e) and δ for positions padded to a multiple
# of BWD_BLOCK.
BWD_THREADS = 384
BWD_BLOCK = 128
BWD_QT = 64
BWD_KT = 64
BWD_DKDV_STAGES = 3
BWD_DQ_STAGES = 3
# MLA's pair (192, 128): a dK/dV consumer keeps 64 keys' dK (96 f32
# registers a thread) and dV (64) across its walk; q tiles of 32 queries
# halve its S^T and dP^T tiles (16 registers each), so that it stays within
# the consumers' 240 registers.  Its dQ blocks take one head: two heads'
# q, dO and dQ tiles would need 286,720 bytes of shared memory.
BWD_QT_WIDE = 32
# Heads of the δ pre-pass a 128-thread block: in f32 a warp each, in bf16
# D / 8 threads each (16 bytes of o and of dO a thread).
BWD_DELTA_ROWS = 4


@dataclasses.dataclass(frozen=True)
class FlashBwdPlan:
    """The backward's launches, as the launcher takes them.

    * the ``δ`` pre-pass: ``delta_grid = (B·Sq, heads / delta_rows)``
      blocks of ``delta_rows`` heads of one ``(b, position)`` row of o and
      dO, writing the ``(B, H, sq_pad)`` layout (``lse·log2(e)`` and
      ``δ``; +inf and 0 past ``Sq``);
    * dK/dV: ``dkdv_grid = (B·Hkv, KV tiles)`` of ``key_tile`` keys, the
      tile index on the slow axis so that every block of KV tile 0 (under
      the causal mask the tiles with the most queries) starts first; each
      walks the q tiles of ``q_tile`` queries of its KV head's G heads
      (:meth:`dkdv_walk`);
    * dQ: ``dq_grid = (B·H / dq_heads, q blocks)`` of ``q_block`` queries
      of ``dq_heads`` heads of one KV head, the last block (the most keys)
      first, each walking KV tiles of ``kv_tile`` keys (:meth:`dq_walk`);
    * ``threads`` a dK/dV or dQ block and their dynamic shared memory.

    In bf16 the dK/dV blocks and then the dQ blocks are one launch of
    ``dkdv_grid`` then ``dq_grid`` blocks, each the larger of the two
    shared-memory sizes.  A block fills an SM (384 threads at 168
    registers, 163-225 KB of shared memory at D=128): at qwen3-1.7b's
    training shape (B=4, S=2,048, H=16, Hkv=8) dK/dV is 32 x 16 = 512
    blocks and dQ (two heads a block) 32 x 16 = 512 blocks, 7.8 waves of
    the 132 SMs together."""

    delta_grid: Tuple[int, int]
    delta_rows: int
    dkdv_grid: Tuple[int, int]
    dq_grid: Tuple[int, int]
    threads: int
    dkdv_smem_bytes: int
    dq_smem_bytes: int
    sq_pad: int
    dq_heads: int
    key_tile: int
    q_tile: int
    q_block: int
    kv_tile: int

    def dkdv_walk(self, x: int, Sq: int, causal: bool) -> List[int]:
        """First query of every q tile that KV tile ``x`` visits for one
        query head, in order: from the tile holding query ``x·key_tile``
        on when causal (earlier queries see none of its keys)."""
        first = x * self.key_tile // self.q_tile if causal else 0
        return [t * self.q_tile for t in range(first, cdiv(Sq, self.q_tile))]

    def dq_walk(self, y: int, Sq: int, Skv: int, causal: bool) -> List[int]:
        """First key of every KV tile that q block ``y`` visits, in
        order: up to the tile holding its last query's key when causal."""
        q0 = y * self.q_block
        n = cdiv(Skv, self.kv_tile)
        if causal:
            n = min(n, (min(q0 + self.q_block, Sq) - 1) // self.kv_tile + 1)
        return [t * self.kv_tile for t in range(n)]


def bwd_q_tile(D: int) -> int:
    """Queries of a bf16 dK/dV block's q tile at q/k width ``D``:
    ``BWD_QT``, or ``BWD_QT_WIDE`` above 128."""
    return BWD_QT if D <= 128 else BWD_QT_WIDE


def flash_bwd_smem_bytes(D: int, dtype: torch.dtype, dq_heads: int = 1,
                         DV: Optional[int] = None) -> Tuple[int, int]:
    """(dK/dV, dQ) dynamic shared memory of one block at q/k width ``D`` and
    v width ``DV`` (default ``D``).  bf16 (``DkdvSmem``, ``DqSmem``): dK/dV
    its 128-key k and v tiles and ``BWD_DKDV_STAGES`` q and dO tiles of
    :func:`bwd_q_tile` rows with their ``lse·log2(e)`` and ``δ``; dQ the
    128-query q and dO tiles of its ``dq_heads`` heads and
    ``BWD_DQ_STAGES`` k and v tiles of ``BWD_KT`` rows; each the swizzle's
    period more and 8 bytes a barrier.  f32 (``DV == D`` only): four tiles
    of rows ``D + 1``, the 64 x 65 tiles of ``P`` and ``dS`` (dK/dV) or
    ``dS`` (dQ), and the 64 ``lse`` and ``δ``."""
    DV = D if DV is None else DV
    if dtype == torch.bfloat16:
        row = (D + DV) * 2    # a q or k row and a dO or v row
        qt = bwd_q_tile(D)
        dkdv = (BWD_BLOCK * row + BWD_DKDV_STAGES * (qt * row + 2 * qt * 4)
                + 8 * (1 + 2 * BWD_DKDV_STAGES))
        dq = ((dq_heads * BWD_BLOCK + BWD_DQ_STAGES * BWD_KT) * row
              + 8 * (1 + 2 * BWD_DQ_STAGES))
        return SWIZZLE_PERIOD + dkdv, SWIZZLE_PERIOD + dq
    four = 4 * BLOCK_K * (D + 1)
    score = BLOCK_Q * (BLOCK_K + 1)
    return ((four + 2 * score + 2 * BLOCK_Q) * 4,
            (four + score + 2 * BLOCK_Q) * 4)


def flash_bwd_plan(B: int, Sq: int, Skv: int, H: int, Hkv: int, D: int,
                   dtype: torch.dtype, DV: Optional[int] = None) -> FlashBwdPlan:
    DV = D if DV is None else DV
    dq_heads = (2 if dtype == torch.bfloat16 and (H // Hkv) % 2 == 0 and D <= 128
                else 1)
    dkdv, dq = flash_bwd_smem_bytes(D, dtype, dq_heads, DV)
    sq_pad = cdiv(Sq, BWD_BLOCK) * BWD_BLOCK
    if dtype == torch.bfloat16:
        threads, key_tile, q_tile, q_block, kv_tile = (BWD_THREADS, BWD_BLOCK,
                                                       bwd_q_tile(D), BWD_BLOCK, BWD_KT)
        delta_rows = 128 // (DV // 8)
    else:
        threads, key_tile, q_tile, q_block, kv_tile = 128, BLOCK_K, BLOCK_Q, BLOCK_Q, BLOCK_K
        delta_rows = BWD_DELTA_ROWS
    return FlashBwdPlan(delta_grid=(B * Sq, cdiv(H, delta_rows)), delta_rows=delta_rows,
                        dkdv_grid=(B * Hkv, cdiv(Skv, key_tile)),
                        dq_grid=(B * H // dq_heads, cdiv(Sq, q_block)), threads=threads,
                        dkdv_smem_bytes=dkdv, dq_smem_bytes=dq, sq_pad=sq_pad,
                        dq_heads=dq_heads,
                        key_tile=key_tile, q_tile=q_tile, q_block=q_block,
                        kv_tile=kv_tile)


def tma_strides(name: str, t: torch.Tensor) -> Tuple[int, int, int]:
    """The batch, sequence and head strides (elements) through which the
    bf16 kernels' tensor maps read a ``(B, S, heads, D)`` tensor; a
    dimension of length 1 is never stepped, and gets its contiguous
    stride.  Raises unless the address and every stride that moves are
    multiples of 16 bytes and below 2^40 bytes."""
    es = t.element_size()
    shape, stride = t.shape, t.stride()
    out = [stride[i] if shape[i] > 1 else shape[i + 1] * shape[i + 2:].numel()
           for i in range(3)]
    bad = [s for s, n in zip(out, shape[:3])
           if n > 1 and (s * es % TMA_ALIGN or s * es >= TMA_MAX_STRIDE or s <= 0)]
    if t.data_ptr() % TMA_ALIGN or bad:
        raise ValueError(
            f"{name}: the bf16 kernels' tensor maps need a {TMA_ALIGN}-byte-aligned "
            f"address and batch, sequence and head strides in multiples of "
            f"{TMA_ALIGN} bytes below 2^40, got strides {tuple(t.stride())} of "
            f"{es}-byte elements at address {t.data_ptr():#x}")
    return out[0], out[1], out[2]


def _check_bwd_shapes(q, k, v, o, lse, do):
    _check_shapes(q, k, v, None)
    B, Sq, H, _ = q.shape
    want = (B, Sq, H, v.shape[3])
    if o.shape != want or do.shape != want:
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} and dO "
                         f"{tuple(do.shape)} must be {want}")
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: lse must be f32 {(B, H, Sq)}, got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if o.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: o must be the forward's f32 output before "
                         f"its rounding (return_lse's third), got {o.dtype}")


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True):
    """The backward in eager PyTorch, tile by tile as the kernel recomputes
    it → ``(dq, dk, dv)`` in q's dtype and the shapes of q, k and v (dq
    and dk at the q/k width, dv at the v width).  ``o`` is the forward's
    f32 output before its rounding (``return_lse``'s third); ``P``
    and ``dS`` are rounded to the input dtype before their products (as the
    bf16 kernel's tensor-core operands are); sums in f32."""
    _check_bwd_shapes(q, k, v, o, lse, do)
    B, Sq, H, D = q.shape
    Skv, Hkv, DV = k.shape[1], k.shape[2], v.shape[3]
    G = H // Hkv
    scale = D ** -0.5
    dt = q.dtype
    dev = q.device
    rnd = (lambda t: t.to(dt).float()) if dt != torch.float32 else (lambda t: t)
    delta = (do.float() * o.float()).sum(dim=-1).reshape(B, Sq, Hkv, G)
    lse_r = lse.permute(0, 2, 1).reshape(B, Sq, Hkv, G)
    dq = torch.zeros((B, Sq, Hkv, G, D), dtype=torch.float32, device=dev)
    dk = torch.zeros((B, Skv, Hkv, D), dtype=torch.float32, device=dev)
    dv = torch.zeros((B, Skv, Hkv, DV), dtype=torch.float32, device=dev)
    bq = bk = PLAIN_BLOCK
    for q0 in range(0, Sq, bq):
        n = min(bq, Sq - q0)
        qt = q[:, q0:q0 + n].float().reshape(B, n, Hkv, G, D)
        dot = do[:, q0:q0 + n].float().reshape(B, n, Hkv, G, DV)
        lt, dl = lse_r[:, q0:q0 + n, ..., None], delta[:, q0:q0 + n, ..., None]
        qpos = torch.arange(q0, q0 + n, device=dev)
        n_kv = cdiv(Skv, bk)
        if causal:
            n_kv = min(n_kv, (q0 + n - 1) // bk + 1)
        for j in range(n_kv):
            ks = slice(j * bk, min((j + 1) * bk, Skv))
            kt, vt = k[:, ks].float(), v[:, ks].float()
            s = torch.einsum("bqhgd,bkhd->bqhgk", qt, kt) * scale
            p = torch.exp(s - lt)
            if causal:
                kpos = torch.arange(ks.start, ks.stop, device=dev)
                valid = kpos[None, :] <= qpos[:, None]
                p = torch.where(valid[None, :, None, None, :], p, 0.0)
            dv[:, ks] += torch.einsum("bqhgk,bqhgd->bkhd", rnd(p), dot)
            dp = torch.einsum("bqhgd,bkhd->bqhgk", dot, vt)
            ds = rnd(p * (dp - dl))
            dq[:, q0:q0 + n] += torch.einsum("bqhgk,bkhd->bqhgd", ds, kt)
            dk[:, ks] += torch.einsum("bqhgk,bqhgd->bkhd", ds, qt)
    return ((dq * scale).reshape(B, Sq, H, D).to(dt), (dk * scale).to(dt),
            dv.to(dt))


def flash_attention_bwd_cuda(q, k, v, o, lse, do, *, causal: bool = True):
    """Launch the backward on the current stream of the tensors' card →
    contiguous ``(dq, dk, dv)`` in q's dtype: the ``δ`` pre-pass, then the
    dK/dV and the dQ walks (one launch in bf16).  ``o`` and ``lse`` are the
    forward's (contiguous; ``o`` its f32 output before its rounding,
    ``return_lse``'s third); a ``dO`` that is not contiguous or not 16-byte
    aligned is copied first.  In bf16, q, k and v are read through their strides by
    TMA, which raises (:func:`tma_strides`) unless they are 16-byte
    multiples.  Raises on a refused launch."""
    from repro_torch.kernels import build

    _check_bwd_shapes(q, k, v, o, lse, do)
    B, Sq, H, D = q.shape
    Skv, Hkv, DV = k.shape[1], k.shape[2], v.shape[3]
    dev = q.device
    strides = _check_card_inputs("flash_attention_bwd", q, k, v)
    if not do.is_contiguous() or do.data_ptr() % COPY_BYTES:
        do = do.clone(memory_format=torch.contiguous_format)
    for name, t in (("o", o), ("dO", do), ("lse", lse)):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"flash_attention_bwd: {name} must be contiguous on {dev}")
        if name == "dO" and t.dtype != q.dtype:
            raise ValueError(f"flash_attention_bwd: dO must be {q.dtype}, got {t.dtype}")
    if q.dtype == torch.bfloat16:
        for name, t in (("o", o), ("dO", do)):
            _check_copy_alignment(name, t)
    plan = flash_bwd_plan(B, Sq, Skv, H, Hkv, D, q.dtype, DV)
    if max(plan.dkdv_grid[1], plan.dq_grid[1], plan.delta_grid[1]) > MAX_GRID_Y:
        raise ValueError(f"flash_attention_bwd: {max(Sq, Skv)} positions or {H} heads "
                         f"need more than {MAX_GRID_Y} tiles")
    dq = torch.empty((B, Sq, H, D), dtype=q.dtype, device=dev)
    dk = torch.empty((B, Skv, Hkv, D), dtype=q.dtype, device=dev)
    dv = torch.empty((B, Skv, Hkv, DV), dtype=q.dtype, device=dev)
    if B == 0 or Sq == 0:
        return dq, dk.zero_(), dv.zero_()
    lse2 = torch.empty((B, H, plan.sq_pad), dtype=torch.float32, device=dev)
    delta = torch.empty_like(lse2)
    lib = build.library()
    with torch.cuda.device(dev):
        rc = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), lse2.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), int(q.dtype == torch.bfloat16), B, Sq, Skv,
            H, Hkv, D, DV, *[ctypes.c_longlong(s) for s in strides], int(causal),
            ctypes.c_float(D ** -0.5), plan.sq_pad, plan.delta_grid[1],
            plan.dkdv_grid[1], plan.dq_grid[1], plan.dq_heads, plan.threads,
            ctypes.c_longlong(plan.dkdv_smem_bytes),
            ctypes.c_longlong(plan.dq_smem_bytes), stream_arg(dev))
    raise_on(lib, rc, "flash_attention_bwd")
    launches["flash_attention_bwd"] += 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable causal GQA attention over q ``(B, Sq, H, DK)``, k
    ``(B, Skv, Hkv, DK)`` and v ``(B, Skv, Hkv, DV)`` (dq and dk come back
    DK wide, dv DV wide): on the card the forward kernel (with ``lse`` and
    the unrounded output) and the backward kernel, on the CPU their plain
    versions (:func:`repro_torch.kernels.ops.flash_attention` has checked
    the device).  It saves q, k, v, the output before its rounding (f32:
    the backward's ``δ`` takes it) and ``lse``; under
    ``torch.utils.checkpoint`` the forward runs again before the backward,
    and only that run's tensors are kept."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        if q.is_cuda:
            o, lse, o32 = flash_attention_lse(q, k, v, causal=causal)
        else:
            o, lse, o32 = flash_attention_plain(q, k, v, causal=causal, return_lse=True)
        ctx.save_for_backward(q, k, v, o32, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if q.is_cuda:
            dq, dk, dv = torch.ops.repro_torch.flash_attention_bwd(q, k, v, o, lse, do,
                                                                   ctx.causal)
        else:
            dq, dk, dv = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=ctx.causal)
        return dq, dk, dv, None


# ---------------------------------------------------------------------------
# the launches as operators of the dispatcher
# ---------------------------------------------------------------------------
#
# The three launches the model paths make are registered as custom
# operators: the forward (ops.flash_attention's, with ``kv_len``), the
# forward with ``lse`` and the f32 output (FlashAttentionFn's), and the
# backward.  On a real CUDA tensor each calls its launcher above, looked up
# when called (so a test that swaps the launcher for the plain version
# still reaches the swap), which counts its launch; there is no CPU
# implementation (the CPU path calls the plain versions itself) and no
# fallback.  On a fake or ``meta`` tensor (``FakeTensorMode``, the dry run
# of :mod:`repro_torch.launch.dryrun`) each gives the launch's outputs'
# shapes and dtypes after the launch's own shape checks, runs nothing and
# counts nothing.  ``torch.utils.flop_counter`` counts each by the
# kernel's operations, the valid keys alone (:mod:`repro_torch.kernels.
# traffic`), where it would not see a launch through ``ctypes`` at all.


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(), device_types="cuda")
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                       kv_len: Optional[int]) -> torch.Tensor:
    return flash_attention_cuda(q, k, v, causal=causal, kv_len=kv_len)


@flash_attention_op.register_fake
def _flash_attention_fake(q, k, v, causal, kv_len):
    _check_shapes(q, k, v, kv_len)
    _check_card_inputs("flash_attention", q, k, v, data=False)
    return q.new_empty((*q.shape[:3], v.shape[3]))


@torch.library.custom_op("repro_torch::flash_attention_lse", mutates_args=(),
                         device_types="cuda")
def flash_attention_lse_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           causal: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(o, lse, o32)``; an operator's outputs may not alias each other,
    so in f32 (where ``o32`` is ``o``) ``o32`` comes back empty and
    :func:`flash_attention_lse` gives ``o`` in its place."""
    o, lse, o32 = flash_attention_cuda(q, k, v, causal=causal, return_lse=True)
    return o, lse, o32.new_empty((0,)) if o32 is o else o32


@flash_attention_lse_op.register_fake
def _flash_attention_lse_fake(q, k, v, causal):
    _check_shapes(q, k, v, None)
    _check_card_inputs("flash_attention", q, k, v, data=False)
    B, Sq, H, _ = q.shape
    o = q.new_empty((B, Sq, H, v.shape[3]))
    o32 = (q.new_empty((B, Sq, H, v.shape[3]), dtype=torch.float32)
           if q.dtype == torch.bfloat16 else q.new_empty((0,)))
    return o, q.new_empty((B, H, Sq), dtype=torch.float32), o32


def flash_attention_lse(q, k, v, *, causal: bool = True):
    """The forward with ``lse`` and the f32 output on the tensors' card
    (the launch through its operator) → ``(o, lse, o32)`` as
    :func:`flash_attention_cuda` returns them."""
    o, lse, o32 = torch.ops.repro_torch.flash_attention_lse(q, k, v, causal)
    return o, lse, o if q.dtype == torch.float32 else o32


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=(),
                         device_types="cuda")
def flash_attention_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                           causal: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=causal)


@flash_attention_bwd_op.register_fake
def _flash_attention_bwd_fake(q, k, v, o, lse, do, causal):
    _check_bwd_shapes(q, k, v, o, lse, do)
    _check_card_inputs("flash_attention_bwd", q, k, v, data=False)
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


def _register_flop_formulas() -> None:
    from torch.utils.flop_counter import register_flop_formula

    from repro_torch.kernels.traffic import flash_attention_bwd_flops, flash_attention_flops

    def fwd(q, k, v, causal, kv_len=None, *args, out_shape=None, **kw):
        B, Sq, H, D = q
        return flash_attention_flops(B, Sq, H, D, k[1] if kv_len is None else kv_len,
                                     causal, v[3])

    def fwd_lse(q, k, v, causal, *args, out_shape=None, **kw):
        return fwd(q, k, v, causal)

    def bwd(q, k, v, o, lse, do, causal, *args, out_shape=None, **kw):
        B, Sq, H, D = q
        return flash_attention_bwd_flops(B, Sq, H, D, k[1], causal, v[3])

    register_flop_formula(torch.ops.repro_torch.flash_attention)(fwd)
    register_flop_formula(torch.ops.repro_torch.flash_attention_lse)(fwd_lse)
    register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)(bwd)


_register_flop_formulas()
