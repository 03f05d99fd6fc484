// The device side of the training kernels (rsnn_train.cu): the forward
// phases rsnn_forward, rsnn_train and rsnn_train_exact share, each kernel's
// body as a template over the surrogate (TRI), the reverse device functions,
// and the launch dispatch over W.  Included by rsnn_train.cu (the boxcar
// kernels, the reverse kernels and the launchers) and rsnn_train_tri.cu
// (the triangular surrogate's kernels): the kernels of each surrogate
// compile in a translation unit of their own.  The design notes are in
// rsnn_train.cu.
#pragma once
#include "rsnn_tick.cuh"

// Functions that are not templates or inline are static here: each
// translation unit that includes this header keeps its own copy.

// F over the ticks for neuron h of one row: l = sum_o err(t, o) b_fb[h, o]
// in o order, F = l + kappa*F, G(t) = h(t) * F, walking t = T-1..0.  In
// rsnn_train's shared-memory path g aliases h.
static __device__ void rsnn_f_walk(const float* h, size_t sh, float* g, size_t sg,
                            const float* err, size_t se, const float* b_fb_h,
                            int O, int T, float kappa) {
  float bf[RSNN_MAX_OUT];
#pragma unroll
  for (int o = 0; o < RSNN_MAX_OUT; ++o) bf[o] = o < O ? b_fb_h[o] : 0.f;
  float f = 0.f;
  for (int t = T - 1; t >= 0; --t) {
    const float* e = err + (size_t)t * se;
    float l = 0.f;
#pragma unroll
    for (int o = 0; o < RSNN_MAX_OUT; ++o) {
      if (o < O) l += e[o] * bf[o];
    }
    f = l + kappa * f;
    g[(size_t)t * sg] = h[(size_t)t * sh] * f;
  }
}

// One row's traces as the dw sums read them; element (t, i) at
// base + t * stride + i.
struct RowGrad {
  const float* xbar; size_t sN;
  const float* pbar; const float* zbar; size_t sH;
  const float* g; size_t sG;
  const float* err; size_t sO;
};

// dw element e of one row (e over w_in, then w_rec, then w_out, row-major),
// summed over t = T-1..0.
static __device__ float rsnn_dw_elem(const RowGrad& r, int e, int N, int H, int O,
                              int T) {
  const int e_in = N * H, e_rec = H * H;
  const float* a;
  const float* b;
  size_t sa, sb;
  if (e < e_in) {
    a = r.xbar + e / H; sa = r.sN; b = r.g + e % H; sb = r.sG;
  } else if (e < e_in + e_rec) {
    e -= e_in;
    a = r.pbar + e / H; sa = r.sH; b = r.g + e % H; sb = r.sG;
  } else {
    e -= e_in + e_rec;
    a = r.zbar + e / O; sa = r.sH; b = r.err + e % O; sb = r.sO;
  }
  float acc = 0.f;
#pragma unroll 8
  for (int t = T - 1; t >= 0; --t) acc += a[(size_t)t * sa] * b[(size_t)t * sb];
  return acc;
}

// Row b's view of (T, B, .) device traces.
__device__ __forceinline__ RowGrad device_row(const float* xbar,
                                              const float* pbar,
                                              const float* zbar,
                                              const float* g, const float* err,
                                              int b, int B, int N, int H,
                                              int O) {
  return RowGrad{xbar + (size_t)b * N, (size_t)B * N,
                 pbar + (size_t)b * H, zbar + (size_t)b * H, (size_t)B * H,
                 g + (size_t)b * H, (size_t)B * H,
                 err + (size_t)b * O, (size_t)B * O};
}

struct TrainArgs {
  const float* raster;   // (T, B, N)
  const float* y_star;   // (B, O)
  const float* valid;    // (T, B)
  const float* w_in;
  const float* w_rec;
  const float* w_out;
  const float* b_fb;     // (H, O)
  // (T, B, .) device traces h, xbar, pbar, zbar, err and G: the scratch of
  // the device path; in the shared-memory path h is null unless the caller
  // asked for the traces (then the forward writes a copy), and g unused
  float* tr_h;
  float* tr_xbar;
  float* tr_pbar;
  float* tr_zbar;
  float* tr_err;
  float* g;
  float* dw_part;        // (B, E)
  float* acc_y;          // (B, O)
  float* n_spk;          // (B, 1)
  int T, B, N, H, O;
  int weights_smem, infer_all;
};

// Dynamic shared memory of one rsnn_train block, in 4-byte words: the
// row's valid mask (T) and spike masks (T * ceil(H/32)),
// the weights when they fit, the row's trace set when it fits beside them
// (kernels/rsnn_step.py:train_plan makes the same choice; the trace set
// stays on chip only with the weights).
__host__ __device__ inline size_t rsnn_train_smem_floats(int T, int N, int H,
                                                         int O,
                                                         int weights_smem,
                                                         int traces_smem) {
  size_t w = weights_smem ? (size_t)N * H + (size_t)H * H + (size_t)H * O : 0;
  size_t tr = traces_smem ? (size_t)T * (3 * (size_t)H + N + O) : 0;
  return (size_t)T * (1 + (H + 31) / 32) + w + tr;
}

// The forward phases that rsnn_forward and rsnn_train share, besides
// rsnn_tick.cuh's input sums (rsnn_input_currents), LIF loop (rsnn_row_lif)
// and leaks (rsnn_leak_out).

// The xbar filter of input k of one row, xbar = alpha*xbar + x over the
// ticks: x(t, k) at x[t * sx + k], xbar(t, k) to out[t * so + k] (out may
// be x: in place) and, when cp, to copy[t * sc + k].
__device__ __forceinline__ void rsnn_xbar_walk(const float* x, size_t sx,
                                               float* out, size_t so,
                                               float* copy, size_t sc, bool cp,
                                               int k, int T, float alpha) {
  float xb = 0.f;
  for (int t = 0; t < T; ++t) {
    xb = alpha * xb + x[(size_t)t * sx + k];
    rsnn_put(out, so, t, k, xb);
    if (cp) rsnn_put(copy, sc, t, k, xb);
  }
}

// The readout currents of one row over T ticks, after the LIF loop: every
// (tick, output) sums w_out over the tick's spikes in ascending h
// (rsnn_readout_sum) into y(t, o) at y[t * sy + o]; the block's threads
// share the items.
__device__ __forceinline__ void rsnn_readout_currents(const unsigned* spikes,
                                                      int J, const float* w_out,
                                                      int T, int O, float* y,
                                                      size_t sy) {
  for (int i = threadIdx.x; i < T * O; i += blockDim.x) {
    const int t = i / O, o = i - (i / O) * O;
    rsnn_put(y, sy, t, o, rsnn_readout_sum(spikes + t * J, J, w_out, O, o));
  }
}

// rsnn_train's readout of one row over all its ticks, after the LIF loop:
// the readout currents of every (tick, output) into the err slots
// (rsnn_readout_currents), one thread per output runs the LI leak through the
// ticks and adds acc_y, then every tick turns its y into the readout
// error in place — the contract's operations in its order, the ticks side
// by side wherever they do not depend on each other.
static __device__ void rsnn_row_readout(const TrainArgs& a, const TickParams& p,
                                 const RowTraces& tr, const RowTraces& copy,
                                 const unsigned* spikes, const float* vs,
                                 const float* w_out, int b) {
  const int T = a.T, O = a.O, J = (a.H + 31) / 32;
  const int tid = threadIdx.x, nth = blockDim.x;
  rsnn_readout_currents(spikes, J, w_out, T, O, tr.err, tr.sO);
  __syncthreads();
  if (tid < O) {
    float y = 0.f, acc = 0.f;
    for (int t = 0; t < T; ++t) {
      float* e = tr.err + (size_t)t * tr.sO + tid;
      y = rsnn_leak_out(y, *e, p);
      acc += y * (a.infer_all ? 1.f : vs[t]);
      *e = y;
    }
    a.acc_y[(size_t)b * O + tid] = acc;
  }
  __syncthreads();
  float ys[RSNN_MAX_OUT];
#pragma unroll
  for (int o = 0; o < RSNN_MAX_OUT; ++o) {
    ys[o] = o < O ? a.y_star[(size_t)b * O + o] : 0.f;
  }
  for (int t = tid; t < T; t += nth) {
    float* e = tr.err + (size_t)t * tr.sO;
    const float vd = vs[t];
    float u[RSNN_MAX_OUT];
#pragma unroll
    for (int o = 0; o < RSNN_MAX_OUT; ++o) u[o] = o < O ? e[o] * p.y_scale : 0.f;
    float m = u[0];
#pragma unroll
    for (int o = 1; o < RSNN_MAX_OUT; ++o) {
      if (o < O) m = fmaxf(m, u[o]);
    }
    if (p.err_softmax) {
      float sum = 0.f;
#pragma unroll
      for (int o = 0; o < RSNN_MAX_OUT; ++o) {
        if (o < O) {
          u[o] = expf(u[o] - m);
          sum += u[o];
        }
      }
#pragma unroll
      for (int o = 0; o < RSNN_MAX_OUT; ++o) {
        if (o < O) u[o] = (u[o] / sum - ys[o]) * vd;
      }
    } else {
#pragma unroll
      for (int o = 0; o < RSNN_MAX_OUT; ++o) {
        if (o < O) u[o] = (u[o] - p.target_amp * ys[o]) * vd;
      }
    }
#pragma unroll
    for (int o = 0; o < RSNN_MAX_OUT; ++o) {
      if (o < O) {
        e[o] = u[o];
        if (copy.h) rsnn_put(copy.err, copy.sO, t, o, u[o]);
      }
    }
  }
}

// One rsnn_train block's work (row blockIdx.x), TRI the surrogate.
template <int W, bool SMEM_TRACES, bool TRI>
__device__ __forceinline__ void rsnn_train_row(const TrainArgs& a, const TickParams& p) {
  extern __shared__ float smem[];
  const int T = a.T, B = a.B, N = a.N, H = a.H, O = a.O;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, nth = blockDim.x;
  float* s = smem;
  float* vs = s;  s += T;
  unsigned* spikes = reinterpret_cast<unsigned*>(s);  s += (size_t)T * ((H + 31) / 32);
  const float* w_in = a.w_in;
  const float* w_rec = a.w_rec;
  const float* w_out = a.w_out;
  if (SMEM_TRACES || a.weights_smem) {
    float* wi = s;  s += N * H;
    float* wr = s;  s += H * H;
    float* wo = s;  s += H * O;
    for (int i = tid; i < N * H; i += nth) wi[i] = a.w_in[i];
    for (int i = tid; i < H * H; i += nth) wr[i] = a.w_rec[i];
    for (int i = tid; i < H * O; i += nth) wo[i] = a.w_out[i];
    w_in = wi; w_rec = wr; w_out = wo;
  }
  for (int t = tid; t < T; t += nth) vs[t] = a.valid[(size_t)t * B + b];
  RowTraces dev{};   // row b of the device traces, where there are any
  if (a.tr_h) {
    dev = RowTraces{a.tr_h + (size_t)b * H, a.tr_xbar + (size_t)b * N,
                    a.tr_pbar + (size_t)b * H, a.tr_zbar + (size_t)b * H,
                    a.tr_err + (size_t)b * O, (size_t)B * H, (size_t)B * N,
                    (size_t)B * O};
  }
  RowTraces tr, copy{};
  const float* x;   // x(t, k) at x[t * sx + k]
  size_t sx;
  if (SMEM_TRACES) {
    tr = RowTraces{s, s + 3 * (size_t)T * H, s + (size_t)T * H,
                   s + 2 * (size_t)T * H, s + (size_t)T * (3 * H + N),
                   (size_t)H, (size_t)N, (size_t)O};
    // the row's raster, which the xbar walk below turns into xbar in place
    for (int i = tid; i < T * N; i += nth) {
      tr.xbar[i] = a.raster[((size_t)(i / N) * B + b) * N + i % N];
    }
    copy = dev;
    x = tr.xbar; sx = N;
  } else {
    tr = dev;
    x = a.raster + (size_t)b * N; sx = (size_t)B * N;
  }
  __syncthreads();
  rsnn_input_currents<W>(x, sx, w_in, tr.h, tr.sH, T, N, H);
  __syncthreads();
  if (tid < 32) {
    RowCarry<W> c;
    rsnn_carry_zero(c);
    rsnn_row_lif<W, ROW_TRACES, false, false, TRI>(c, tr, copy, w_rec, vs, nullptr, spikes,
                                                   T, H, p);
    if (tid == 0) a.n_spk[b] = c.nspk;
  } else {
    // xbar = alpha * xbar + x over the ticks, one thread per input
    for (int k = tid - 32; k < N; k += nth - 32) {
      rsnn_xbar_walk(x, sx, tr.xbar, tr.sN, copy.xbar, copy.sN, copy.h != nullptr,
                     k, T, p.alpha);
    }
  }
  __syncthreads();
  rsnn_row_readout(a, p, tr, copy, spikes, vs, w_out, b);
  __syncthreads();

  float* g = SMEM_TRACES ? tr.h : a.g + (size_t)b * H;
  const size_t sg = SMEM_TRACES ? (size_t)H : (size_t)B * H;
  for (int h = tid; h < H; h += nth) {
    rsnn_f_walk(tr.h + h, tr.sH, g + h, sg, tr.err, tr.sO, a.b_fb + (size_t)h * O,
                O, T, p.kappa);
  }
  if (SMEM_TRACES) {
    __syncthreads();
    const RowGrad r{tr.xbar, tr.sN, tr.pbar, tr.zbar, tr.sH, g, sg, tr.err, tr.sO};
    const int e_all = N * H + H * H + H * O;
    float* part = a.dw_part + (size_t)b * e_all;
    for (int e = tid; e < e_all; e += nth) part[e] = rsnn_dw_elem(r, e, N, H, O, T);
  }
}

// ---------------------------------------------------------------------------
// rsnn_train_exact: exact-mode e-prop (per-synapse traces)
// ---------------------------------------------------------------------------

// One row's view of what the exact walks read, element (t, i) at
// base + t * stride + i: the presynaptic inputs x, the spike masks (word w
// of tick t at spikes + t * sz + w), the pseudo-derivative h, the learning signal l,
// zbar, the readout error err, and the neurons' decays alpha (H).
struct RowExact {
  const float* x; size_t sx;
  const unsigned* spikes; size_t sz;
  const float* h; const float* l; const float* zbar; size_t sH;
  const float* err; size_t sO;
  const float* alpha;
};

// dw element e of one row in exact mode (e over w_in, then w_rec, then
// w_out, row-major), its state in registers, the ticks walked forward in
// the reference's order (repro/core/eprop.py:run_sample_exact):
//   synapse (i, j), presynaptic line i < N + H, s_i(t) = x(t, i) for an
//   input, z_k(t - 1) for recurrent neuron k = i - N (0 at t = 0):
//     eps = alpha_j*eps + s_i(t);  ebar = kappa*ebar + h_j(t)*eps;
//     dw += ebar*l_j(t)
//   readout (j, o): dw += zbar_j(t)*err_o(t).
static __device__ float rsnn_exact_dw_elem(const RowExact& r, int e, int N, int H,
                                    int O, int T, float kappa) {
  const int e_syn = (N + H) * H;
  float acc = 0.f;
  if (e < e_syn) {
    const int i = e / H, j = e - (e / H) * H;
    const float a = r.alpha[j];
    const float* hj = r.h + j;
    const float* lj = r.l + j;
    float eps = 0.f, ebar = 0.f;
    if (i < N) {
      const float* xi = r.x + i;
      for (int t = 0; t < T; ++t) {
        eps = a * eps + xi[(size_t)t * r.sx];
        ebar = kappa * ebar + hj[(size_t)t * r.sH] * eps;
        acc += ebar * lj[(size_t)t * r.sH];
      }
    } else {
      const int k = i - N;
      const unsigned* m = r.spikes + (k >> 5);
      const int bit = k & 31;
      for (int t = 0; t < T; ++t) {
        const float zk = t > 0 && ((m[(size_t)(t - 1) * r.sz] >> bit) & 1u) ? 1.f : 0.f;
        eps = a * eps + zk;
        ebar = kappa * ebar + hj[(size_t)t * r.sH] * eps;
        acc += ebar * lj[(size_t)t * r.sH];
      }
    }
  } else {
    e -= e_syn;
    const int j = e / O, o = e - (e / O) * O;
    for (int t = 0; t < T; ++t) {
      acc += r.zbar[(size_t)t * r.sH + j] * r.err[(size_t)t * r.sO + o];
    }
  }
  return acc;
}

// Dynamic shared memory of one rsnn_train_exact block, in 4-byte words:
// rsnn_train's layout (kernels/rsnn_step.py:train_exact_plan) and the
// row's decays alpha (H).
__host__ __device__ inline size_t rsnn_train_exact_smem_floats(int T, int N,
                                                               int H, int O,
                                                               int weights_smem,
                                                               int traces_smem) {
  return rsnn_train_smem_floats(T, N, H, O, weights_smem, traces_smem) + H;
}

// rsnn_train_exact_kernel — exact-mode e-prop behind
// ExecutionBackend.train_tile with EpropConfig(mode="exact"): the
// counterpart of the reference's scan backend, which compiles
// src/repro/core/eprop.py:run_sample_exact into one device program a tile
// (no Pallas kernel).  One block per batch row, in phases separated by
// block barriers:
//   1. the input currents of every tick (rsnn_input_currents);
//   2. one warp runs the LIF recurrence (rsnn_row_lif, each neuron leaking
//      by its own alpha), writing h, zbar and the spike masks;
//   3. the readout and its error (rsnn_row_readout), acc_y;
//   4. the learning signal l(t, j) = sum_o err(t, o) b_fb[j, o] in o order,
//      over the pbar slots rsnn_row_lif wrote (not read here);
//   5. (shared-memory path) the block's threads share the dw elements,
//      each walking its synapse through the ticks (rsnn_exact_dw_elem).
// Nothing of phases 1-4 depends on eps or ebar, so phase 5 walks each
// synapse through all ticks after the forward: every value is the one the
// tick-by-tick update gives, the synapse's state never leaves registers,
// and no block barrier sits inside a tick loop.  The trace set (the input
// currents then h, the raster, l, zbar, err) is rsnn_train's size; where it
// does not fit beside the weights (Braille past T=424, the cue net, the
// 256/256/16 net) it goes to a device scratch with the spike masks, and
// rsnn_exact_dw_rows_kernel walks the synapses, one thread per (element,
// row).  Then rsnn_dw_reduce_kernel, or on the commit grid
// rsnn_dw_codes_reduce_kernel, sums the rows' partials.
//
// Bound on the H100: 7 operations a synapse and tick (eps 2, ebar 3, dw 2)
// over (N + H) * H synapses, plus 4 * H * O a tick for l and dw_out: at
// Braille (12/38/3) 13,940 a tick, 3.6 M at T=256 (0.053 us at f32 67
// TFLOP/s); the bytes (raster, weights in, dw out) are fewer still.  The
// row's LIF chain (some hundreds of cycles a tick, as in rsnn_train) and one
// row's walks on one SM set the pace at small B.
template <int W, bool SMEM_TRACES, bool TRI>
__device__ __forceinline__ void rsnn_train_exact_row(const TrainArgs& a, const float* alpha,
                                                     unsigned* spk_dev, const TickParams& p) {
  extern __shared__ float smem[];
  const int T = a.T, B = a.B, N = a.N, H = a.H, O = a.O, J = (H + 31) / 32;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, nth = blockDim.x;
  float* s = smem;
  float* vs = s;  s += T;
  unsigned* spikes = reinterpret_cast<unsigned*>(s);  s += (size_t)T * J;
  float* al = s;  s += H;
  const float* w_in = a.w_in;
  const float* w_rec = a.w_rec;
  const float* w_out = a.w_out;
  if (SMEM_TRACES || a.weights_smem) {
    float* wi = s;  s += N * H;
    float* wr = s;  s += H * H;
    float* wo = s;  s += H * O;
    for (int i = tid; i < N * H; i += nth) wi[i] = a.w_in[i];
    for (int i = tid; i < H * H; i += nth) wr[i] = a.w_rec[i];
    for (int i = tid; i < H * O; i += nth) wo[i] = a.w_out[i];
    w_in = wi; w_rec = wr; w_out = wo;
  }
  for (int t = tid; t < T; t += nth) vs[t] = a.valid[(size_t)t * B + b];
  for (int h = tid; h < H; h += nth) al[h] = alpha[h];
  // tr.h: the input currents, then h; tr.xbar: the raster (shared-memory
  // path); tr.pbar: rsnn_row_lif's pbar, then l
  RowTraces tr;
  const float* x;   // x(t, k) at x[t * sx + k]
  size_t sx;
  if (SMEM_TRACES) {
    tr = RowTraces{s, s + 3 * (size_t)T * H, s + (size_t)T * H,
                   s + 2 * (size_t)T * H, s + (size_t)T * (3 * H + N),
                   (size_t)H, (size_t)N, (size_t)O};
    for (int i = tid; i < T * N; i += nth) {
      tr.xbar[i] = a.raster[((size_t)(i / N) * B + b) * N + i % N];
    }
    x = tr.xbar; sx = N;
  } else {
    tr = RowTraces{a.tr_h + (size_t)b * H, nullptr, a.tr_pbar + (size_t)b * H,
                   a.tr_zbar + (size_t)b * H, a.tr_err + (size_t)b * O,
                   (size_t)B * H, (size_t)B * N, (size_t)B * O};
    x = a.raster + (size_t)b * N; sx = (size_t)B * N;
  }
  __syncthreads();
  rsnn_input_currents<W>(x, sx, w_in, tr.h, tr.sH, T, N, H);
  __syncthreads();
  const RowTraces none{};
  if (tid < 32) {
    RowCarry<W> c;
    rsnn_carry_zero(c);
    rsnn_row_lif<W, ROW_TRACES, false, true, TRI>(c, tr, none, w_rec, vs, nullptr, spikes,
                                                  T, H, p, al);
    if (tid == 0) a.n_spk[b] = c.nspk;
  }
  __syncthreads();
  rsnn_row_readout(a, p, tr, none, spikes, vs, w_out, b);
  __syncthreads();
  for (int i = tid; i < T * H; i += nth) {
    const int t = i / H, j = i - (i / H) * H;
    const float* e = tr.err + (size_t)t * tr.sO;
    const float* bf = a.b_fb + (size_t)j * O;
    float l = 0.f;
    for (int o = 0; o < O; ++o) l += e[o] * bf[o];
    tr.pbar[(size_t)t * tr.sH + j] = l;
  }
  if (!SMEM_TRACES) {
    unsigned* out = spk_dev + (size_t)b * T * J;
    for (int i = tid; i < T * J; i += nth) out[i] = spikes[i];
    return;
  }
  __syncthreads();
  const RowExact r{x, sx, spikes, (size_t)J, tr.h, tr.pbar, tr.zbar, tr.sH, tr.err,
                   tr.sO, al};
  const int e_all = N * H + H * H + H * O;
  float* part = a.dw_part + (size_t)b * e_all;
  for (int e = tid; e < e_all; e += nth) part[e] = rsnn_exact_dw_elem(r, e, N, H, O, T, p.kappa);
}

struct ForwardArgs {
  const float* raster;   // (T, B, N)
  const float* w_in;     // (N, H)
  const float* w_rec;    // (H, H), self-recurrence masked
  const float* w_out;    // (H, O)
  float* z;              // (T, B, H)
  float* h;              // (T, B, H)
  float* xbar;           // (T, B, N)
  float* pbar;           // (T, B, H)
  float* zbar;           // (T, B, H)
  float* y;              // (T, B, O)
  float* v;              // (T, B, H) post-reset membrane
  int T, B, N, H, O;
  int rows;              // batch rows a block, one loop warp each
  int Tl;                // ticks a chunk of the readout
  int weights_smem;      // 1: stage the weights in shared memory
  int rows_smem;         // 1: the rows' raster and input currents in shared
                         //    memory (only when Tl == T)
};

// Dynamic shared memory of one rsnn_forward block, in 4-byte words
// (kernels/rsnn_step.py:forward_plan): the weights when staged; every row's
// spike masks (T * ceil(H/32)) and a chunk of Tl ticks of its readout
// currents (Tl * O); then every row's raster (T*N) and input currents (T*H)
// when they fit.
__host__ __device__ inline size_t rsnn_forward_smem_words(int rows, int T,
                                                          int Tl, int N, int H,
                                                          int O,
                                                          int weights_smem,
                                                          int rows_smem) {
  size_t w = weights_smem ? (size_t)N * H + (size_t)H * H + (size_t)H * O : 0;
  size_t r = (size_t)T * ((H + 31) / 32) + (size_t)Tl * O +
             (rows_smem ? (size_t)T * ((size_t)N + H) : 0);
  return w + (size_t)rows * r;
}

template <int W, bool TRI>
__device__ __forceinline__ void rsnn_forward_rows(const ForwardArgs& a, const TickParams& p) {
  extern __shared__ float smem[];
  const int T = a.T, B = a.B, N = a.N, H = a.H, O = a.O, J = (H + 31) / 32;
  const int R = a.rows, Tl = a.Tl;
  const int b0 = blockIdx.x * R;
  const int nr = min(R, B - b0);
  const int tid = threadIdx.x, nth = blockDim.x, warp = tid >> 5;
  float* s = smem;
  const float* w_in = a.w_in;
  const float* w_rec = a.w_rec;
  const float* w_out = a.w_out;
  if (a.weights_smem) {
    float* wi = s;  s += N * H;
    float* wr = s;  s += H * H;
    float* wo = s;  s += H * O;
    for (int i = tid; i < N * H; i += nth) wi[i] = a.w_in[i];
    for (int i = tid; i < H * H; i += nth) wr[i] = a.w_rec[i];
    for (int i = tid; i < H * O; i += nth) wo[i] = a.w_out[i];
    w_in = wi; w_rec = wr; w_out = wo;
  }
  unsigned* spikes = reinterpret_cast<unsigned*>(s);  s += (size_t)R * T * J;
  float* lin = s;  s += (size_t)R * Tl * O;   // readout currents (r, t, o)
  // row r's inputs x(t, k) at x + r * xr + t * sx + k, its input currents
  // c(t, h) at cur + r * cr + t * sc + h: in shared memory, or the raster
  // and the h stream (which the loop then overwrites with h)
  const size_t sH = (size_t)B * H, sN = (size_t)B * N, sO = (size_t)B * O;
  const float* x;
  float* cur;
  size_t xr, cr, sx, sc;
  if (a.rows_smem) {
    float* xs = s;  s += (size_t)R * T * N;
    // row r's raster at xs + r * T * N: each tick's rows are one run
    for (int i = tid; i < T * nr * N; i += nth) {
      const int t = i / (nr * N), rk = i - t * nr * N;
      const int r = rk / N;
      xs[((size_t)r * T + t) * N + rk - r * N] = a.raster[((size_t)t * B + b0) * N + rk];
    }
    x = xs; xr = (size_t)T * N; sx = N;
    cur = s; cr = (size_t)T * H; sc = H;
  } else {
    x = a.raster + (size_t)b0 * N; xr = N; sx = sN;
    cur = a.h + (size_t)b0 * H; cr = H; sc = sH;
  }
  __syncthreads();
  for (int r = 0; r < nr; ++r) {
    rsnn_input_currents<W>(x + r * xr, sx, w_in, cur + r * cr, sc, T, N, H);
  }
  __syncthreads();
  if (warp < nr) {
    // warp r carries row b0 + r, writing its h, pbar, zbar and v streams
    const int b = b0 + warp;
    const RowTraces in{cur + warp * cr, nullptr, nullptr, nullptr, nullptr, sc, 0, 0};
    const RowTraces dev{a.h + (size_t)b * H, nullptr, a.pbar + (size_t)b * H,
                        a.zbar + (size_t)b * H, nullptr, sH, sN, sO,
                        a.v + (size_t)b * H};
    RowCarry<W> c;
    rsnn_carry_zero(c);
    rsnn_row_lif<W, ROW_STREAMS, false, false, TRI>(c, in, dev, w_rec, nullptr, nullptr,
                                                    spikes + (size_t)warp * T * J, T, H, p);
  } else if (warp >= R) {
    // the other warps: the xbar filter, one thread per (row, input)
    for (int i = tid - 32 * R; i < nr * N; i += nth - 32 * R) {
      const int r = i / N, k = i - r * N;
      rsnn_xbar_walk(x + r * xr, sx, a.xbar + (size_t)(b0 + r) * N, sN, nullptr, 0,
                     false, k, T, p.alpha);
    }
  }
  __syncthreads();
  // z(t, h) from the spike masks
  const int TH = T * H;
  for (int i = tid; i < nr * TH; i += nth) {
    const int r = i / TH, th = i - r * TH;
    const int t = th / H, hh = th - t * H;
    a.z[(size_t)t * sH + (size_t)(b0 + r) * H + hh] =
        (spikes[((size_t)r * T + t) * J + (hh >> 5)] >> (hh & 31)) & 1u ? 1.f : 0.f;
  }
  // the readout a chunk of Tl ticks at a time: the readout currents of the
  // chunk's (row, tick, output), then the LI leak, one thread per (row,
  // output) carrying y across the chunks
  const bool ro = tid < nr * O;
  const int rr = ro ? tid / O : 0, oo = tid - rr * O;
  float* y = a.y + (size_t)(b0 + rr) * O + oo;
  float yv = 0.f;
  for (int t0 = 0; t0 < T; t0 += Tl) {
    const int tl = min(Tl, T - t0);
    for (int r = 0; r < nr; ++r) {
      rsnn_readout_currents(spikes + ((size_t)r * T + t0) * J, J, w_out, tl, O,
                            lin + (size_t)r * Tl * O, O);
    }
    __syncthreads();
    if (ro) {
      for (int t = 0; t < tl; ++t) {
        yv = rsnn_leak_out(yv, lin[((size_t)rr * Tl + t) * O + oo], p);
        y[(size_t)(t0 + t) * sO] = yv;
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Launch dispatch by width W (and trace placement) over the kernels of one
// surrogate, which RsnnTraceKernels<TRI> names: rsnn_train.cu defines the
// boxcar's (TRI false) and the launchers, rsnn_train_tri.cu the triangular
// surrogate's (TRI true) and its dispatch, so that nvcc compiles the two
// sets side by side.
// ---------------------------------------------------------------------------

template <bool TRI> struct RsnnTraceKernels;

template <bool TRI, int W>
static int rsnn_forward_launch_w(const ForwardArgs& a, const TickParams& p, int threads,
                                 size_t smem, cudaStream_t stream) {
  const auto kernel = RsnnTraceKernels<TRI>::template forward<W>();
  int fit = threads;
  int rc = rsnn_prepare_launch(kernel, smem, &fit);
  if (rc) return rc;
  if (fit != threads) return (int)cudaErrorInvalidConfiguration;
  const int blocks = (a.B + a.rows - 1) / a.rows;
  kernel<<<blocks, threads, smem, stream>>>(a, p);
  return (int)cudaGetLastError();
}

template <bool TRI>
int rsnn_forward_dispatch(const ForwardArgs& a, const TickParams& p, int threads,
                          size_t smem, cudaStream_t st) {
  switch ((max(a.N, a.H) + 31) / 32) {
    case 1: return rsnn_forward_launch_w<TRI, 1>(a, p, threads, smem, st);
    case 2: return rsnn_forward_launch_w<TRI, 2>(a, p, threads, smem, st);
    case 3: return rsnn_forward_launch_w<TRI, 3>(a, p, threads, smem, st);
    case 4: return rsnn_forward_launch_w<TRI, 4>(a, p, threads, smem, st);
    case 5: return rsnn_forward_launch_w<TRI, 5>(a, p, threads, smem, st);
    case 6: return rsnn_forward_launch_w<TRI, 6>(a, p, threads, smem, st);
    case 7: return rsnn_forward_launch_w<TRI, 7>(a, p, threads, smem, st);
    case 8: return rsnn_forward_launch_w<TRI, 8>(a, p, threads, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool TRI, int W, bool SMEM_TRACES>
static int rsnn_train_launch_w(const TrainArgs& a, const TickParams& p, int threads,
                               size_t smem, cudaStream_t stream) {
  const auto kernel = RsnnTraceKernels<TRI>::template train<W, SMEM_TRACES>();
  int rc = rsnn_prepare_launch(kernel, smem, &threads);
  if (rc) return rc;
  kernel<<<a.B, threads, smem, stream>>>(a, p);
  return (int)cudaGetLastError();
}

template <bool TRI, bool SMEM_TRACES>
static int rsnn_train_launch_s(const TrainArgs& a, const TickParams& p, int threads,
                               size_t smem, cudaStream_t stream) {
  switch ((max(a.N, a.H) + 31) / 32) {
    case 1: return rsnn_train_launch_w<TRI, 1, SMEM_TRACES>(a, p, threads, smem, stream);
    case 2: return rsnn_train_launch_w<TRI, 2, SMEM_TRACES>(a, p, threads, smem, stream);
    case 3: return rsnn_train_launch_w<TRI, 3, SMEM_TRACES>(a, p, threads, smem, stream);
    case 4: return rsnn_train_launch_w<TRI, 4, SMEM_TRACES>(a, p, threads, smem, stream);
    case 5: return rsnn_train_launch_w<TRI, 5, SMEM_TRACES>(a, p, threads, smem, stream);
    case 6: return rsnn_train_launch_w<TRI, 6, SMEM_TRACES>(a, p, threads, smem, stream);
    case 7: return rsnn_train_launch_w<TRI, 7, SMEM_TRACES>(a, p, threads, smem, stream);
    case 8: return rsnn_train_launch_w<TRI, 8, SMEM_TRACES>(a, p, threads, smem, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool TRI>
int rsnn_train_dispatch(const TrainArgs& a, const TickParams& p, int traces_smem,
                        int threads, size_t smem, cudaStream_t st) {
  return traces_smem ? rsnn_train_launch_s<TRI, true>(a, p, threads, smem, st)
                     : rsnn_train_launch_s<TRI, false>(a, p, threads, smem, st);
}

template <bool TRI, int W, bool SMEM_TRACES>
static int rsnn_train_exact_launch_w(const TrainArgs& a, const float* alpha,
                                     unsigned* spk, const TickParams& p, int threads,
                                     size_t smem, cudaStream_t stream) {
  const auto kernel = RsnnTraceKernels<TRI>::template exact<W, SMEM_TRACES>();
  int rc = rsnn_prepare_launch(kernel, smem, &threads);
  if (rc) return rc;
  kernel<<<a.B, threads, smem, stream>>>(a, alpha, spk, p);
  return (int)cudaGetLastError();
}

template <bool TRI, bool SMEM_TRACES>
static int rsnn_train_exact_launch_s(const TrainArgs& a, const float* alpha,
                                     unsigned* spk, const TickParams& p, int threads,
                                     size_t smem, cudaStream_t stream) {
  switch ((max(a.N, a.H) + 31) / 32) {
    case 1: return rsnn_train_exact_launch_w<TRI, 1, SMEM_TRACES>(a, alpha, spk, p, threads, smem, stream);
    case 2: return rsnn_train_exact_launch_w<TRI, 2, SMEM_TRACES>(a, alpha, spk, p, threads, smem, stream);
    case 3: return rsnn_train_exact_launch_w<TRI, 3, SMEM_TRACES>(a, alpha, spk, p, threads, smem, stream);
    case 4: return rsnn_train_exact_launch_w<TRI, 4, SMEM_TRACES>(a, alpha, spk, p, threads, smem, stream);
    case 5: return rsnn_train_exact_launch_w<TRI, 5, SMEM_TRACES>(a, alpha, spk, p, threads, smem, stream);
    case 6: return rsnn_train_exact_launch_w<TRI, 6, SMEM_TRACES>(a, alpha, spk, p, threads, smem, stream);
    case 7: return rsnn_train_exact_launch_w<TRI, 7, SMEM_TRACES>(a, alpha, spk, p, threads, smem, stream);
    case 8: return rsnn_train_exact_launch_w<TRI, 8, SMEM_TRACES>(a, alpha, spk, p, threads, smem, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool TRI>
int rsnn_train_exact_dispatch(const TrainArgs& a, const float* alpha, unsigned* spk,
                              const TickParams& p, int traces_smem, int threads,
                              size_t smem, cudaStream_t st) {
  return traces_smem
             ? rsnn_train_exact_launch_s<TRI, true>(a, alpha, spk, p, threads, smem, st)
             : rsnn_train_exact_launch_s<TRI, false>(a, alpha, spk, p, threads, smem, st);
}
