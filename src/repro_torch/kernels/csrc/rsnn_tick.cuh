// ReckOn's LIF + LI tick datapath, shared by every kernel of the library:
// the warp-per-row event loop of rsnn_forward and rsnn_train (rsnn_train.cu)
// and of the two serving kernels (rsnn_serve.cu).
//
// Replaces the TPU tick pipeline of src/repro/kernels/rsnn_step.py
// (tick_transition / tick_from_input_current, run once per grid step of
// _infer_kernel, _session_kernel, _kernel and eprop_update.py's
// _train_kernel).  On the TPU the grid (tile, tick) walks ticks in order
// and carries state in VMEM scratch; here the whole T-tick loop runs
// inside one launch, and one warp carries one row's recurrence in
// registers (the event loop below).
//
// Arithmetic contract (per tick, per row b, neuron h):
//   cur   = sum_k x[b,k] w_in[k,h]  +  sum_k z[b,k] w_rec[k,h]
//           (two sequential sums over k = 0..; input current first, then
//            the recurrent one added to it: the JAX operand order)
//   v_pre = alpha*v + cur                           (float; alpha one
//                                                    decay, or one a neuron)
//         | sat(floor(v * alpha_reg/256) + cur)     (quantized)
//   z     = v_pre >= v_th;  v = v_pre - z*v_th | v_pre*(1-z)
//   y     = kappa*y + sum_h z[b,h] w_out[h,o]       (float)
//         | sat(floor(y * kappa_reg/256) + ...)     (quantized)
// and, in the two trace modes, the e-prop quantities of the same tick:
//   h     = |v_pre - v_th| < boxcar_width*v_th      (boxcar surrogate)
//         | gamma * max(0, fma(-|v_pre - v_th|, r, 1))  (triangular; r =
//           f32(1/v_th), 1 - d*r rounded once as the reference's compiled
//           scan rounds it: an explicit fmaf, which -fmad=false keeps)
//   xbar  = alpha*xbar + x;  pbar = alpha*pbar + z_prev;  zbar = kappa*zbar + z
//   err   = softmax(y*s) - y* | y*s - amp*y*, times valid   (rsnn_train
//           only; s = 1/threshold in quantized mode)
// Each output row's sums run in a fixed order that depends on nothing but
// the row, so the result is the same for any block layout or batch: float
// chunk invariance (whole sample vs word-by-word feeds) is bitwise.
//
// The library is compiled with -fmad=false: every product is rounded
// before it is added, as the plain PyTorch version's separate multiply and
// add are (the triangular h's fmaf is the one fused operation, and the
// plain version rounds that expression once too).  In quantized mode every
// datapath operand is an integer below 2^24 carried in f32, so v, z, y,
// acc_y and n_spk are exact, and h and the traces follow from them by the
// plain version's float operations.
// No tensor core and no TF32 path is used.
#pragma once
#include <cuda_runtime.h>

struct TickParams {
  float alpha, kappa, v_th;      // float-mode decays and threshold
  float alpha_c, kappa_c;        // quantized leaks: reg / 256
  float v_lo, v_hi;              // quantized membrane grid
  int reset_sub;                 // 1: subtract threshold, 0: reset to zero
  int quant;                     // 1: fixed-point datapath
  // trace modes only
  float bw_vth;                  // boxcar half-width times v_th
  float y_scale;                 // readout scale the error sees
  float target_amp;              // error == "direct": target amplitude
  int err_softmax;               // 1: softmax error, 0: direct
  float gamma;                   // triangular surrogate: its scale
  float inv_vth;                 //   and f32(1 / v_th)
};

// The readout error of one row handles at most the chip's 16 outputs.
#define RSNN_MAX_OUT 16

__device__ __forceinline__ float rsnn_leak_in(float v, float cur,
                                              const TickParams& p) {
  if (p.quant) {
    return fminf(fmaxf(floorf(v * p.alpha_c) + cur, p.v_lo), p.v_hi);
  }
  return p.alpha * v + cur;
}

// rsnn_leak_in at the neuron's own decay alpha (float mode; quantized mode
// leaks by alpha_reg / 256 whatever alpha is).
__device__ __forceinline__ float rsnn_leak_in_at(float v, float cur,
                                                 const TickParams& p,
                                                 float alpha) {
  if (p.quant) {
    return fminf(fmaxf(floorf(v * p.alpha_c) + cur, p.v_lo), p.v_hi);
  }
  return alpha * v + cur;
}

__device__ __forceinline__ float rsnn_leak_out(float y, float cur,
                                               const TickParams& p) {
  if (p.quant) {
    return fminf(fmaxf(floorf(y * p.kappa_c) + cur, p.v_lo), p.v_hi);
  }
  return p.kappa * y + cur;
}

// Bellec's triangular pseudo-derivative gamma * max(0, 1 - |v_pre - v_th| /
// v_th), in the reference's compiled form: the division a product with
// r = f32(1/v_th) and 1 - d*r one fused operation.
__device__ __forceinline__ float rsnn_triangular(float v_pre,
                                                 const TickParams& p) {
  return p.gamma * fmaxf(0.f, fmaf(-fabsf(v_pre - p.v_th), p.inv_vth, 1.f));
}

// ---------------------------------------------------------------------------
// The warp-per-row event loop (rsnn_forward, rsnn_train, rsnn_infer,
// rsnn_step_sessions).
// One warp carries one row's LIF recurrence through the ticks with
// warp-level synchronisation only: lane l owns the hidden neurons
// h = l + 32j (j < J = ceil(H/32)), whose membranes stay in registers with
// last tick's spike masks.  The currents are event-driven: a __ballot_sync
// of the row's nonzero inputs or of last tick's spikes, then each lane adds
// x[k]*w[k,h] for the set bits only, in ascending k.  A skipped term is an
// exact +-0 product, and a sum that starts at +0 never changes when +-0 is
// added, so the loop gives the bits of the dense sums of the contract in
// both modes.  Only the recurrent sum and the leak are serial: the input
// sums of every tick (rsnn_input_currents), the xbar filter and the readout
// do not feed back into the recurrence and run before, beside or after the
// loop over many ticks at once; the loop adds the recurrent sum to the
// tick's input sum, as the contract says.
// ---------------------------------------------------------------------------

// Words of a spike or input mask: the chip's 256 neurons over 32 lanes.
#define RSNN_MAX_WORDS 8

// One row's per-tick trace set, element (t, i) at base + t * stride + i;
// a null h means "no such set".
struct RowTraces {
  float* h;              // (T, H) input current, then h, then G = h*F
  float* xbar;           // (T, N)
  float* pbar;           // (T, H)
  float* zbar;           // (T, H)
  float* err;            // (T, O)
  size_t sH, sN, sO;     // tick strides
  float* v;              // (T, H) post-reset membrane (rsnn_forward only)
};

// What rsnn_row_lif writes each tick besides the spike masks, a template
// argument, so that each kernel compiles only its own stores.
enum RowOut {
  ROW_COUNT = 0,     // the valid-masked spike count (the serving kernels)
  ROW_TRACES = 1,    // and h over tr.h alone, guarded by h < H (rsnn_train,
                     // whose helper warps filter pbar and zbar from the
                     // spike masks off the chain)
  ROW_STREAMS = 2,   // h, pbar, zbar and v to copy only; no count, no
                     // valid read; tr.h holds the input currents (rsnn_forward)
  ROW_EXACT = 3,     // h over tr.h only, every lane's (rows padded to 32*J
                     // words), and the count; no pbar or zbar filter
                     // (rsnn_train_exact)
};

// What the event loop carries from one tick to the next for one row, in
// the registers of its warp: lane l's membranes v[j] (h = l + 32j), last
// tick's spike masks (word j: neurons 32j..32j+31, the same on every
// lane), and the valid-masked spike count.
template <int W>
struct RowCarry {
  float v[W];
  unsigned z[W];
  float nspk;
};

template <int W>
__device__ __forceinline__ void rsnn_carry_zero(RowCarry<W>& c) {
#pragma unroll
  for (int j = 0; j < W; ++j) { c.v[j] = 0.f; c.z[j] = 0u; }
  c.nspk = 0.f;
}

// acc[j] += s_k * W[(kbase + k) * H + lane + 32j] for j < J over the set
// bits k of m, ascending; s_k is lane k's xv when SCALED, else 1 (a spike,
// whose product with w is w).  m is the same on every lane.
template <int W, bool SCALED>
__device__ __forceinline__ void rsnn_add_rows(float (&acc)[W], unsigned m,
                                              int kbase, float xv,
                                              const float* w_, int H, int J,
                                              int lane) {
  const float* base = w_ + (size_t)kbase * H + lane;
  while (m) {
    const int k = __ffs(m) - 1;
    m &= m - 1;
    const float s = SCALED ? __shfl_sync(0xffffffffu, xv, k) : 1.f;
    const float* r = base + (size_t)k * H;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const float a = (j < J && lane + 32 * j < H) ? r[32 * j] : 0.f;
      acc[j] += SCALED ? s * a : a;
    }
  }
}

__device__ __forceinline__ void rsnn_put(float* base, size_t stride, int t,
                                         int i, float x) {
  base[(size_t)t * stride + i] = x;
}

// The input currents sum_k x[k] w_in[k, h] of U (row, tick) items, in
// ascending k, into cur[u][h]; run by one whole warp.  Item u reads its
// inputs at xr[u] and is skipped when on[u] is false.  The items' event
// sums run side by side, a set bit of each a step, so that their loads and
// adds overlap; each item's own adds stay in order.
template <int W, int U>
__device__ __forceinline__ void rsnn_input_current_items(const float* const (&xr)[U],
                                                         const bool (&on)[U],
                                                         const float* w_in,
                                                         float* const (&cur)[U],
                                                         int N, int H) {
  const int lane = threadIdx.x & 31;
  const int NW = (N + 31) / 32, J = (H + 31) / 32;
  float acc[U][W];
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int j = 0; j < W; ++j) acc[u][j] = 0.f;
  }
#pragma unroll
  for (int w = 0; w < W; ++w) {
    if (w < NW) {
      const int k = lane + 32 * w;
      float xv[U];
      unsigned m[U];
      unsigned any = 0u;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        xv[u] = (on[u] && k < N) ? xr[u][k] : 0.f;
        m[u] = __ballot_sync(0xffffffffu, xv[u] != 0.f);
        any |= m[u];
      }
      const float* base = w_in + (size_t)(32 * w) * H + lane;
      while (any) {
        any = 0u;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (m[u]) {
            const int kk = __ffs(m[u]) - 1;
            m[u] &= m[u] - 1;
            const float s = __shfl_sync(0xffffffffu, xv[u], kk);
            const float* r = base + (size_t)kk * H;
#pragma unroll
            for (int j = 0; j < W; ++j) {
              const float a = (j < J && lane + 32 * j < H) ? r[32 * j] : 0.f;
              acc[u][j] += s * a;
            }
          }
          any |= m[u];
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const int h = lane + 32 * j;
      if (on[u] && j < J && h < H) cur[u][h] = acc[u][j];
    }
  }
}

// Items a warp interleaves: four at the narrow widths, two at the wide
// ones (whose sums hold more registers).
template <int W>
struct RsnnItems { static constexpr int U = W <= 2 ? 4 : 2; };

// The input currents of every tick of one row, x(t, k) at x[t * sx + k]
// into cur(t, h) at cur[t * sc + h]: the block's warps share the ticks.
template <int W>
__device__ void rsnn_input_currents(const float* x, size_t sx,
                                    const float* w_in, float* cur, size_t sc,
                                    int T, int N, int H) {
  constexpr int U = RsnnItems<W>::U;
  const int nw = blockDim.x >> 5;
  for (int t0 = (threadIdx.x >> 5) * U; t0 < T; t0 += nw * U) {
    const float* xr[U];
    float* cr[U];
    bool on[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = min(t0 + u, T - 1);
      on[u] = t0 + u < T;
      xr[u] = x + (size_t)t * sx;
      cr[u] = cur + (size_t)t * sc;
    }
    rsnn_input_current_items<W, U>(xr, on, w_in, cr, N, H);
  }
}

// The readout current of one tick and output o: w_out[h, o] summed over the
// set bits h of the tick's J spike-mask words, in ascending h.
__device__ __forceinline__ float rsnn_readout_sum(const unsigned* m, int J,
                                                  const float* w_out, int O,
                                                  int o) {
  float y_lin = 0.f;
  for (int j = 0; j < J; ++j) {
    unsigned bits = m[j];
    while (bits) {
      const int k = __ffs(bits) - 1;
      bits &= bits - 1;
      y_lin += w_out[(32 * j + k) * O + o];
    }
  }
  return y_lin;
}

// The LIF recurrence of one row through T ticks, run by one whole warp
// from the carries c, which it leaves at the last tick's state.  Reads
// each tick's input current from tr.h (stride tr.sH); writes each tick's
// spike masks (T, J) to `spikes` (the spikes before the live select).
// OUT (a RowOut): ROW_COUNT and ROW_TRACES add popc(spikes) * valid[t] to
// c.nspk; ROW_TRACES (rsnn_train) also writes the pseudo-derivative h over
// tr.h; ROW_STREAMS (rsnn_forward) writes h, pbar, zbar and the post-reset
// v to `copy` only; ROW_EXACT (rsnn_train_exact) counts as ROW_TRACES and
// writes h over tr.h unguarded: the caller pads each tick's row to 32*J
// words, so that no lane branches around its store.
// LIVE (rsnn_step_sessions): a tick with
// live[t] == 0 keeps v and z by select.  AVEC (rsnn_train_exact): neuron h
// leaks, and filters pbar, by its own decay alpha_h[h] instead of p.alpha.
// TRI: h is the triangular surrogate (rsnn_triangular), else the boxcar.
// W >= ceil(H/32).
template <int W, int OUT, bool LIVE, bool AVEC = false, bool TRI = false>
__device__ __forceinline__ void rsnn_row_lif(RowCarry<W>& c,
                                             const RowTraces tr,
                                             const RowTraces copy,
                                             const float* w_rec,
                                             const float* valid,
                                             const float* live,
                                             unsigned* spikes, int T, int H,
                                             const TickParams p,
                                             const float* alpha_h = nullptr) {
  const unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int J = (H + 31) / 32;
  float pbar[W], zbar[W], cn[W];
  float al[AVEC ? W : 1];   // AVEC: the lane's neurons' decays
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const int h = lane + 32 * j;
    pbar[j] = 0.f; zbar[j] = 0.f;
    cn[j] = (j < J && h < H) ? tr.h[h] : 0.f;   // input current, a tick ahead
  }
  if (AVEC) {
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const int h = lane + 32 * j;
      al[AVEC ? j : 0] = (j < J && h < H) ? alpha_h[h] : 0.f;
    }
  }
  for (int t = 0; t < T; ++t) {
    float in_cur[W], rec[W];
#pragma unroll
    for (int j = 0; j < W; ++j) { in_cur[j] = cn[j]; rec[j] = 0.f; }
    if (t + 1 < T) {
#pragma unroll
      for (int j = 0; j < W; ++j) {
        const int h = lane + 32 * j;
        cn[j] = (j < J && h < H) ? tr.h[(size_t)(t + 1) * tr.sH + h] : 0.f;
      }
    }
    // the recurrent current over last tick's spikes
#pragma unroll
    for (int j = 0; j < W; ++j) {
      if (j < J) rsnn_add_rows<W, false>(rec, c.z[j], 32 * j, 0.f, w_rec, H, J, lane);
    }
    // LIF, traces, the new spike masks
    const bool keep = !LIVE || live[t] > 0.f;
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      if (j < J) {
        const int h = lane + 32 * j;
        const float v_pre =
            AVEC ? rsnn_leak_in_at(c.v[j], in_cur[j] + rec[j], p, al[AVEC ? j : 0])
                 : rsnn_leak_in(c.v[j], in_cur[j] + rec[j], p);
        const float zz = v_pre >= p.v_th ? 1.f : 0.f;
        const float v_new = p.reset_sub ? v_pre - zz * p.v_th : v_pre * (1.f - zz);
        const unsigned m = __ballot_sync(FULL, h < H && zz > 0.f);
        if (OUT == ROW_EXACT) {
          const float hb = TRI ? rsnn_triangular(v_pre, p)
                               : (fabsf(v_pre - p.v_th) < p.bw_vth ? 1.f : 0.f);
          rsnn_put(tr.h, tr.sH, t, h, hb);
        }
        if (OUT == ROW_TRACES) {
          const float hb = TRI ? rsnn_triangular(v_pre, p)
                               : (fabsf(v_pre - p.v_th) < p.bw_vth ? 1.f : 0.f);
          if (h < H) rsnn_put(tr.h, tr.sH, t, h, hb);
        }
        if (OUT == ROW_STREAMS) {
          const float hb = TRI ? rsnn_triangular(v_pre, p)
                               : (fabsf(v_pre - p.v_th) < p.bw_vth ? 1.f : 0.f);
          const float z_prev = (c.z[j] >> lane) & 1u ? 1.f : 0.f;
          pbar[j] = (AVEC ? al[AVEC ? j : 0] : p.alpha) * pbar[j] + z_prev;
          zbar[j] = p.kappa * zbar[j] + zz;
          if (h < H) {
            rsnn_put(copy.h, copy.sH, t, h, hb);
            rsnn_put(copy.pbar, copy.sH, t, h, pbar[j]);
            rsnn_put(copy.zbar, copy.sH, t, h, zbar[j]);
            rsnn_put(copy.v, copy.sH, t, h, v_new);
          }
        }
        if (keep) { c.v[j] = v_new; c.z[j] = m; }
        cnt += __popc(m);
        spikes[t * J + j] = m;   // every lane writes the same word
      }
    }
    if (OUT != ROW_STREAMS) c.nspk += (float)cnt * valid[t];
  }
}

// Launch helper shared by every entry point: raises the dynamic
// shared-memory limit when the block needs more than the 48 KB default,
// and lowers *threads to what the kernel's registers allow a block (every
// launcher refuses a lowered count, since its plan names the threads).
// The serving kernels carry launch bounds for their 1,024-thread blocks
// (RsnnServeThreads), rsnn_train and rsnn_train_exact for their 512; a
// bound of 1,024 cut rsnn_forward's registers and slowed its chain.
template <typename Kernel>
inline int rsnn_prepare_launch(Kernel kernel, size_t smem_bytes,
                               int* threads) {
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return (int)e;
  if (*threads > a.maxThreadsPerBlock) {
    *threads = a.maxThreadsPerBlock / 32 * 32;
  }
  return 0;
}
