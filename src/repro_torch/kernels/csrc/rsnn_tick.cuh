// ReckOn's LIF + LI tick datapath, shared by every kernel of the library:
// the tile loop of the two serving kernels (rsnn_serve.cu) and of
// rsnn_forward, and the warp-per-row event loop of rsnn_train
// (rsnn_train.cu), further down.
//
// Replaces the TPU tick pipeline of src/repro/kernels/rsnn_step.py
// (tick_transition / tick_from_input_current, run once per grid step of
// _infer_kernel, _session_kernel, _kernel and eprop_update.py's
// _train_kernel).  On the TPU the grid (tile, tick) walks ticks in order
// and carries state in VMEM scratch; here the whole T-tick loop runs
// inside one launch: one block per tile of `bt` batch rows, one thread per
// (row, hidden neuron), carries in shared memory.
//
// Arithmetic contract (per tick, per row b, neuron h):
//   cur   = sum_k x[b,k] w_in[k,h]  +  sum_k z[b,k] w_rec[k,h]
//           (two sequential sums over k = 0..; input current first, then
//            the recurrent one added to it: the JAX operand order)
//   v_pre = alpha*v + cur                           (float)
//         | sat(floor(v * alpha_reg/256) + cur)     (quantized)
//   z     = v_pre >= v_th;  v = v_pre - z*v_th | v_pre*(1-z)
//   y     = kappa*y + sum_h z[b,h] w_out[h,o]       (float)
//         | sat(floor(y * kappa_reg/256) + ...)     (quantized)
// and, in the two trace modes, the e-prop quantities of the same tick:
//   h     = |v_pre - v_th| < boxcar_width*v_th      (boxcar surrogate)
//   xbar  = alpha*xbar + x;  pbar = alpha*pbar + z_prev;  zbar = kappa*zbar + z
//   err   = softmax(y*s) - y* | y*s - amp*y*, times valid   (rsnn_train
//           only; s = 1/threshold in quantized mode)
// Each output row's sums run in a fixed order that depends on nothing but
// the row, so the result is the same for any tile width or batch: float
// chunk invariance (whole sample vs word-by-word feeds) is bitwise.
//
// The library is compiled with -fmad=false: every product is rounded
// before it is added, as the plain PyTorch version's separate multiply and
// add are.  In quantized mode every datapath operand is an integer below
// 2^24 carried in f32, so v, z, y, acc_y and n_spk are exact, and h and
// the traces follow from them by the plain version's float operations.
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
};

// What a tile loop reads and writes.  SESSIONS reads carries and writes
// them back; FORWARD writes seven (T, B, .) per-tick tensors and no
// accumulator.
enum RsnnMode { RSNN_INFER = 0, RSNN_SESSIONS = 1, RSNN_FORWARD = 2 };

struct TileIO {
  const float* raster;   // (T, B, N)
  const float* live;     // (T, B)  SESSIONS
  const float* valid;    // (T, B)  all but FORWARD
  const float* v0;       // (B, H)  SESSIONS carries in ...
  const float* z0;
  const float* y0;       // (B, O)
  const float* acc0;
  const float* nspk0;    // (B, 1)
  const float* w_in;     // (N, H)
  const float* w_rec;    // (H, H), self-recurrence masked
  const float* w_out;    // (H, O)
  float* v_out;          // SESSIONS carries out
  float* z_out;
  float* y_out;
  float* acc_out;        // (B, O)  all but FORWARD
  float* nspk_out;       // (B, 1)
  float* tr_z;           // (T, B, H) FORWARD
  float* tr_h;           // (T, B, H) FORWARD
  float* tr_xbar;        // (T, B, N) FORWARD
  float* tr_pbar;        // (T, B, H) FORWARD
  float* tr_zbar;        // (T, B, H) FORWARD
  float* tr_y;           // (T, B, O) FORWARD
  float* tr_v;           // (T, B, H) FORWARD (post-reset membrane)
};

struct TileDims {
  int T, B, N, H, O;
  int bt;                // batch rows per block
  int weights_smem;      // 1: stage the weights in shared memory
  int infer_all;         // 1: acc_y over every (live) tick, 0: valid ticks
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

__device__ __forceinline__ float rsnn_leak_out(float y, float cur,
                                               const TickParams& p) {
  if (p.quant) {
    return fminf(fmaxf(floorf(y * p.kappa_c) + cur, p.v_lo), p.v_hi);
  }
  return p.kappa * y + cur;
}

// The input plus recurrent current of neuron h of one row, and the readout
// current of output o: sequential sums in the contract's order.  The tile
// loop calls each once with the weights in shared memory and once with
// them in device memory, so that each copy's loads have a known address
// space: shared loads, not generic ones, when the weights are staged.
__device__ __forceinline__ float rsnn_current(const float* xr, const float* zr,
                                              const float* w_in,
                                              const float* w_rec, int N, int H,
                                              int h) {
  float in_cur = 0.f;
  for (int k = 0; k < N; ++k) in_cur += xr[k] * w_in[k * H + h];
  float rec = 0.f;
  for (int k = 0; k < H; ++k) rec += zr[k] * w_rec[k * H + h];
  return in_cur + rec;
}

__device__ __forceinline__ float rsnn_readout_current(const float* zr,
                                                      const float* w_out,
                                                      int H, int O, int o) {
  float y_lin = 0.f;
  for (int k = 0; k < H; ++k) y_lin += zr[k] * w_out[k * O + o];
  return y_lin;
}

// Dynamic shared memory a tile needs, in floats; the trace modes add the
// xbar (N) and pbar, zbar (H each) carries of every row.
__host__ __device__ inline size_t rsnn_tile_smem_floats(int bt, int N, int H,
                                                        int O,
                                                        int weights_smem,
                                                        int traces = 0) {
  size_t w = weights_smem ? (size_t)N * H + (size_t)H * H + (size_t)H * O : 0;
  size_t tr = traces ? (size_t)bt * ((size_t)N + 2 * (size_t)H) : 0;
  return w + 3 * (size_t)bt * H + (size_t)bt * N + 2 * (size_t)bt * O +
         3 * (size_t)bt + tr;
}

// The T-tick loop of one tile.  INFER and FORWARD start from zero state with
// every tick live; SESSIONS starts from the carries and applies `live`.
template <int MODE>
__device__ void rsnn_tile_loop(const TileIO& io, const TileDims& d,
                               const TickParams p) {
  constexpr bool SESSIONS = MODE == RSNN_SESSIONS;
  constexpr bool TRACES = MODE == RSNN_FORWARD;
  constexpr bool ACCUM = MODE != RSNN_FORWARD;
  extern __shared__ float smem[];
  const int T = d.T, B = d.B, N = d.N, H = d.H, O = d.O, bt = d.bt;
  const int infer_all = d.infer_all;
  const int b0 = blockIdx.x * bt;
  const int rows = min(bt, B - b0);
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  // No two buffers of a launch alias: restrict-qualified locals let the
  // compiler use read-only loads and keep values across the stores.
  const float* __restrict__ raster = io.raster;
  const float* __restrict__ live_g = io.live;
  const float* __restrict__ valid_g = io.valid;
  const float* __restrict__ w_in_g = io.w_in;
  const float* __restrict__ w_rec_g = io.w_rec;
  const float* __restrict__ w_out_g = io.w_out;
  float* __restrict__ acc_out = io.acc_out;
  float* __restrict__ nspk_out = io.nspk_out;
  float* __restrict__ tr_z = io.tr_z;
  float* __restrict__ tr_h = io.tr_h;
  float* __restrict__ tr_xbar = io.tr_xbar;
  float* __restrict__ tr_pbar = io.tr_pbar;
  float* __restrict__ tr_zbar = io.tr_zbar;
  float* __restrict__ tr_y = io.tr_y;
  float* __restrict__ tr_v = io.tr_v;

  const bool wsmem = d.weights_smem;   // the weights fit in shared memory
  float* s = smem;
  float* wi = s;   s += wsmem ? N * H : 0;
  float* wr = s;   s += wsmem ? H * H : 0;
  float* wo = s;   s += wsmem ? H * O : 0;
  if (wsmem) {
    for (int i = tid; i < N * H; i += nth) wi[i] = w_in_g[i];
    for (int i = tid; i < H * H; i += nth) wr[i] = w_rec_g[i];
    for (int i = tid; i < H * O; i += nth) wo[i] = w_out_g[i];
  }
  float* v = s;    s += bt * H;
  float* z = s;    s += bt * H;
  float* zn = s;   s += bt * H;   // this tick's spikes before the live select
  float* x = s;    s += bt * N;
  float* y = s;    s += bt * O;
  float* acc = s;  s += bt * O;
  float* nspk = s; s += bt;
  float* lv = s;   s += bt;
  float* vd = s;   s += bt;
  float* xbar = s; s += TRACES ? bt * N : 0;
  float* pbar = s; s += TRACES ? bt * H : 0;
  float* zbar = s;

  for (int i = tid; i < bt * H; i += nth) {
    const bool in = i / H < rows;
    const size_t g = (size_t)b0 * H + i;
    v[i] = (SESSIONS && in) ? io.v0[g] : 0.f;
    z[i] = (SESSIONS && in) ? io.z0[g] : 0.f;
    if (TRACES) { pbar[i] = 0.f; zbar[i] = 0.f; }
  }
  for (int i = tid; i < bt * O; i += nth) {
    const bool in = i / O < rows;
    const size_t g = (size_t)b0 * O + i;
    y[i] = (SESSIONS && in) ? io.y0[g] : 0.f;
    acc[i] = (SESSIONS && in) ? io.acc0[g] : 0.f;
  }
  for (int b = tid; b < bt; b += nth) {
    nspk[b] = (SESSIONS && b < rows) ? io.nspk0[b0 + b] : 0.f;
  }
  if (TRACES) {
    for (int i = tid; i < bt * N; i += nth) xbar[i] = 0.f;
  }

  for (int t = 0; t < T; ++t) {
    const size_t row0 = (size_t)t * B + b0;   // (t, b0) in a (T, B) layout
    const float* xt = raster + row0 * N;
    for (int i = tid; i < bt * N; i += nth) {
      x[i] = i < rows * N ? xt[i] : 0.f;
      if (TRACES) {
        const float xb = p.alpha * xbar[i] + x[i];
        xbar[i] = xb;
        if (i < rows * N) tr_xbar[row0 * N + i] = xb;
      }
    }
    for (int b = tid; b < bt; b += nth) {
      const size_t g = row0 + b;
      vd[b] = (ACCUM && b < rows) ? valid_g[g] : 0.f;
      lv[b] = SESSIONS ? (b < rows ? live_g[g] : 0.f) : 1.f;
    }
    __syncthreads();

    // LIF: one thread per (row, hidden neuron)
    for (int i = tid; i < bt * H; i += nth) {
      const int b = i / H;
      const int h = i - b * H;
      const float* xr = x + b * N;
      const float* zr = z + b * H;
      const float cur = wsmem ? rsnn_current(xr, zr, wi, wr, N, H, h)
                              : rsnn_current(xr, zr, w_in_g, w_rec_g, N, H, h);
      const float v_pre = rsnn_leak_in(v[i], cur, p);
      const float zz = v_pre >= p.v_th ? 1.f : 0.f;
      const float v_new = p.reset_sub ? v_pre - zz * p.v_th : v_pre * (1.f - zz);
      zn[i] = zz;
      if (lv[b] > 0.f) v[i] = v_new;   // live == 0 freezes by select
      if (TRACES) {
        const float hb = fabsf(v_pre - p.v_th) < p.bw_vth ? 1.f : 0.f;
        const float pb = p.alpha * pbar[i] + z[i];   // z before this tick
        const float zb = p.kappa * zbar[i] + zz;
        pbar[i] = pb;
        zbar[i] = zb;
        if (b < rows) {
          const size_t r = row0 * H + i;
          tr_h[r] = hb;
          tr_pbar[r] = pb;
          tr_zbar[r] = zb;
          if (MODE == RSNN_FORWARD) { tr_z[r] = zz; tr_v[r] = v_new; }
        }
      }
    }
    __syncthreads();

    // LI readout and accumulators: one thread per (row, output)
    for (int i = tid; i < bt * O; i += nth) {
      const int b = i / O;
      const int o = i - b * O;
      const float* zr = zn + b * H;
      const float y_lin = wsmem ? rsnn_readout_current(zr, wo, H, O, o)
                                : rsnn_readout_current(zr, w_out_g, H, O, o);
      const float y_new = rsnn_leak_out(y[i], y_lin, p);
      if (ACCUM) {
        const float w = infer_all ? lv[b] : vd[b];
        acc[i] += y_new * w;
      }
      if (lv[b] > 0.f) y[i] = y_new;
      if (MODE == RSNN_FORWARD && b < rows) tr_y[row0 * O + i] = y_new;
    }
    if (ACCUM) {
      for (int b = tid; b < bt; b += nth) {
        float cnt = 0.f;
        for (int k = 0; k < H; ++k) cnt += zn[b * H + k] * vd[b];
        nspk[b] += cnt;
      }
    }
    for (int i = tid; i < bt * H; i += nth) {
      if (lv[i / H] > 0.f) z[i] = zn[i];
    }
    __syncthreads();
  }

  if (ACCUM) {
    for (int i = tid; i < rows * O; i += nth) acc_out[(size_t)b0 * O + i] = acc[i];
    for (int b = tid; b < rows; b += nth) nspk_out[b0 + b] = nspk[b];
  }
  if (SESSIONS) {
    for (int i = tid; i < rows * H; i += nth) {
      io.v_out[(size_t)b0 * H + i] = v[i];
      io.z_out[(size_t)b0 * H + i] = z[i];
    }
    for (int i = tid; i < rows * O; i += nth) io.y_out[(size_t)b0 * O + i] = y[i];
  }
}

// ---------------------------------------------------------------------------
// The warp-per-row event loop (rsnn_train).  One warp carries one row's
// LIF recurrence through all T ticks with warp-level synchronisation only:
// lane l owns the hidden neurons h = l + 32j (j < J = ceil(H/32)).  The
// currents are event-driven: a __ballot_sync of the row's nonzero inputs
// or of last tick's spikes, then each lane adds x[k]*w[k,h] for the set
// bits only, in ascending k.  A skipped term is an exact +-0 product, and a
// sum that starts at +0 never changes when +-0 is added, so the loop gives
// the bits of rsnn_tile_loop in both modes.  Only the recurrent sum and
// the leak are serial: the input sums of every tick (rsnn_input_currents),
// the xbar filter and the readout do not feed back into the recurrence and
// run beside or after the loop over all ticks at once (rsnn_train.cu); the
// loop adds the recurrent sum to the tick's input sum, as the contract
// says.  rsnn_tile_loop stays the loop of the other kernels until they
// move here.
// ---------------------------------------------------------------------------

// Words of a spike or input mask: the chip's 256 neurons over 32 lanes.
#define RSNN_MAX_WORDS 8

// One row's per-tick trace set, element (t, i) at base + t * stride + i;
// a null h means "no such set".
struct RowTraces {
  float* h;              // (T, H) input current, then boxcar h, then G = h*F
  float* xbar;           // (T, N)
  float* pbar;           // (T, H)
  float* zbar;           // (T, H)
  float* err;            // (T, O)
  size_t sH, sN, sO;     // tick strides
};

// acc[j] += s_k * W[(kbase + k) * H + lane + 32j] for j < J over the set
// bits k of m, ascending; s_k is lane k's xv when SCALED, else 1 (a spike,
// whose product with w is w).  Two bits at a time: their loads issue
// together, their adds stay in order.
template <int W, bool SCALED>
__device__ __forceinline__ void rsnn_add_rows(float (&acc)[W], unsigned m,
                                              int kbase, float xv,
                                              const float* w_, int H, int J,
                                              int lane) {
  while (m) {
    const int k0 = __ffs(m) - 1;
    m &= m - 1;
    const int k1 = m ? __ffs(m) - 1 : -1;
    m &= m - 1;
    const float s0 = SCALED ? __shfl_sync(0xffffffffu, xv, k0) : 1.f;
    const float s1 = SCALED ? __shfl_sync(0xffffffffu, xv, k1 & 31) : 1.f;
    const float* r0 = w_ + (size_t)(kbase + k0) * H + lane;
    const float* r1 = w_ + (size_t)(kbase + (k1 < 0 ? k0 : k1)) * H + lane;
    float a[W], b[W];
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const bool in = j < J && lane + 32 * j < H;
      a[j] = in ? r0[32 * j] : 0.f;
      b[j] = in ? r1[32 * j] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < W; ++j) acc[j] += SCALED ? s0 * a[j] : a[j];
    if (k1 >= 0) {
#pragma unroll
      for (int j = 0; j < W; ++j) acc[j] += SCALED ? s1 * b[j] : b[j];
    }
  }
}

__device__ __forceinline__ void rsnn_put(float* base, size_t stride, int t,
                                         int i, float x) {
  base[(size_t)t * stride + i] = x;
}

// The input current sum_k x(t, k) w_in[k, h] of every tick of one row, in
// ascending k, into cur(t, h): one warp per tick at a time.
template <int W>
__device__ void rsnn_input_currents(const float* x, size_t sx,
                                    const float* w_in, float* cur, size_t sc,
                                    int T, int N, int H) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int NW = (N + 31) / 32, J = (H + 31) / 32;
  for (int t = warp; t < T; t += blockDim.x >> 5) {
    const float* xr = x + (size_t)t * sx;
    float acc[W];
#pragma unroll
    for (int j = 0; j < W; ++j) acc[j] = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      if (w < NW) {
        const int k = lane + 32 * w;
        const float xv = k < N ? xr[k] : 0.f;
        const unsigned m = __ballot_sync(0xffffffffu, xv != 0.f);
        rsnn_add_rows<W, true>(acc, m, 32 * w, xv, w_in, H, J, lane);
      }
    }
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const int h = lane + 32 * j;
      if (j < J && h < H) rsnn_put(cur, sc, t, h, acc[j]);
    }
  }
}

// The LIF recurrence of one row, run by one whole warp: the row's T ticks
// from zero state.  Reads each tick's input current from tr.h and writes
// the boxcar h over it, and the pbar, zbar traces (also to `copy` when
// copy.h is not null); writes the spike masks (T, J) to `spikes` and the
// valid-masked spike count to *nspk_out.  W >= ceil(H/32).
template <int W>
__device__ void rsnn_row_lif(const RowTraces tr, const RowTraces copy,
                             const float* w_rec, const float* valid,
                             unsigned* spikes, float* nspk_out, int T, int H,
                             const TickParams p) {
  const unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int J = (H + 31) / 32;
  const bool cp = copy.h != nullptr;
  float v[W], pbar[W], zbar[W], cn[W];
  unsigned zmask[W];
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const int h = lane + 32 * j;
    v[j] = 0.f; pbar[j] = 0.f; zbar[j] = 0.f; zmask[j] = 0u;
    cn[j] = (j < J && h < H) ? tr.h[h] : 0.f;   // input current, a tick ahead
  }
  float nspk = 0.f;
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
      if (j < J) rsnn_add_rows<W, false>(rec, zmask[j], 32 * j, 0.f, w_rec, H, J, lane);
    }
    // LIF, traces, the new spike masks
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      if (j < J) {
        const int h = lane + 32 * j;
        const float v_pre = rsnn_leak_in(v[j], in_cur[j] + rec[j], p);
        const float zz = v_pre >= p.v_th ? 1.f : 0.f;
        v[j] = p.reset_sub ? v_pre - zz * p.v_th : v_pre * (1.f - zz);
        const float hb = fabsf(v_pre - p.v_th) < p.bw_vth ? 1.f : 0.f;
        const float z_prev = (zmask[j] >> lane) & 1u ? 1.f : 0.f;
        pbar[j] = p.alpha * pbar[j] + z_prev;
        zbar[j] = p.kappa * zbar[j] + zz;
        zmask[j] = __ballot_sync(FULL, h < H && zz > 0.f);
        cnt += __popc(zmask[j]);
        spikes[t * J + j] = zmask[j];   // every lane writes the same word
        if (h < H) {
          rsnn_put(tr.h, tr.sH, t, h, hb);
          rsnn_put(tr.pbar, tr.sH, t, h, pbar[j]);
          rsnn_put(tr.zbar, tr.sH, t, h, zbar[j]);
          if (cp) {
            rsnn_put(copy.h, copy.sH, t, h, hb);
            rsnn_put(copy.pbar, copy.sH, t, h, pbar[j]);
            rsnn_put(copy.zbar, copy.sH, t, h, zbar[j]);
          }
        }
      }
    }
    nspk += (float)cnt * valid[t];
  }
  if (lane == 0) *nspk_out = nspk;
}

// Launch helper shared by every entry point: raises the dynamic
// shared-memory limit when the tile needs more than the 48 KB default, and
// lowers *threads to what the kernel's registers allow a block (the tile
// loops stride over any thread count).  The kernels carry no launch bounds:
// capping their registers to fit 1,024 threads made the tick sums slower.
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
