// The training kernels, built into one library with the serving kernels of
// rsnn_serve.cu.  rsnn_forward, rsnn_train and rsnn_train_exact (exact-mode
// e-prop, below rsnn_train) run the
// warp-per-row event loop of rsnn_tick.cuh (the serving kernels run the
// same loop) and share their forward phases (phases 1-3 of rsnn_train
// below: rsnn_input_currents, rsnn_row_lif, rsnn_xbar_walk,
// rsnn_readout_currents, rsnn_leak_out); rsnn_train and eprop_update share
// the reverse device functions (rsnn_f_walk, rsnn_dw_elem).
//
// rsnn_forward_kernel — the trace-streaming forward behind the backend's
// forward_traces and dynamics ops.  Replaces src/repro/kernels/rsnn_step.py:
// _kernel and :_forward_dma_kernel (wrapper rsnn_forward).  Writes seven
// (T, B, .) tensors: z, h, xbar, pbar, zbar, y and the post-reset v.  It is
// rsnn_train's phases 1-3 without the readout error, for up to 16 rows a
// block (kernels/rsnn_step.py:forward_plan: one row a block until a batch
// outgrows the 1,056 one-row blocks the SMs hold at once, then packed as
// the serving kernels pack theirs): the input currents of every row; then one
// loop warp a row writes h, pbar, zbar and v straight to the device streams
// (ROW_STREAMS) while the other warps run the xbar filters; then z is
// expanded from the spike masks and the readout runs a chunk of ticks at a
// time, the readout currents of every (row, tick, output), then the LI
// leak, one thread per (row, output).  The rows' raster and input currents
// stay in shared memory where they fit; where they do not, the filters
// read the raster in place and the input currents are parked in the h
// stream, which the loop then overwrites.
//
// rsnn_train_kernel — the fused train op behind ExecutionBackend.train_tile,
// every END_S and END_B commit.  Replaces src/repro/kernels/eprop_update.py:
// _train_kernel and :_train_dma_kernel (wrapper rsnn_train).  One block per
// batch row, in phases separated by block barriers (none inside a tick
// loop):
//   1. the warps share the ticks and sum each tick's input current over
//      its input events (rsnn_input_currents);
//   2. one warp runs the LIF recurrence through the T ticks on the
//      warp-per-row event loop of rsnn_tick.cuh (rsnn_row_lif), writing the
//      h, pbar, zbar traces and the spike masks, while the other warps run
//      the xbar filter, one thread per input;
//   3. the readout over all ticks at once (rsnn_row_readout): y_lin per
//      (tick, output), the LI leak one thread per output (acc_y), the
//      readout error per tick;
//   4. the reverse pass: one thread per neuron walks the ticks backwards
//      through F = err.B_fb^T + kappa*F and stores G = h*F over h; then the
//      block's threads share the dw elements, each summing its products
//      over t = T-1..0.
// Also writes acc_y (B, O) and the valid-masked n_spk (B, 1).  Every sum
// runs in the order of the contract in rsnn_tick.cuh: in quantized mode
// acc_y, n_spk and the traces equal the plain version's bit for bit.
//
// eprop_update — the split reverse pass behind the backend's eprop_update
// op, over (T, B, .) traces in device memory.  Replaces
// src/repro/kernels/eprop_update.py:_kernel (wrapper eprop_update): the
// reverse device functions below, spread over one thread per (row,
// neuron) and then one per (row, dw element).
//
// rsnn_dw_reduce_kernel — the cross-row dw sum of the last two.
//
// rsnn_dw_codes_reduce_kernel — rsnn_train's cross-row sum on the integer
// commit grid (the deterministic END_B path): each row's partial dw is
// snapped to an int32 code and the codes are summed.  Replaces the
// lax.map of B=1 tiles and the int32 code sum of
// src/repro/core/backend.py:_train_det_codes / :_train_det_impl.  Each row's
// partial is that sample's B=1 dw (one block a row; train_plan does not
// depend on B), and integer addition is associative, so the codes of any
// split of the rows sum to the codes of the whole batch: a commit does not
// depend on how many ranks share its batch.
//
// Design.  On the TPU the trace set of a batch tile stays in VMEM.  One
// row's set takes T*(3H+N+O)*4 bytes: 66 KB at Braille T=128, so it fits
// the 227 KB a block may hold beside the weights, the valid mask and the
// spike masks, and every phase works in shared memory (the row's raster is
// copied in first; the xbar filter turns it into xbar in place, and the
// input currents are parked in the h slots that the LIF loop overwrites).
// Where the set does not fit (the 256/256/16 chip-maximum net at T=128
// takes 532 KB, Braille past T=424), the same phases run on a (T, B, .)
// scratch in device memory, and the dw sums run as a second kernel over
// one thread per (dw element, row).  Each row writes its partial dw to its
// own slice of a (B, E) buffer, and rsnn_dw_reduce_kernel adds the slices
// in row order: no atomics, two launches give identical bits.
//
// Bound on the H100: the LIF loop is a serial chain, some hundreds of
// cycles a tick; its event-driven sums do 2*H multiply-adds per input
// event and per spike of the last tick, and the readout 2*O per spike
// (kernels/traffic.py:forward_event_flops); the reverse pass does
// 2*T*B*(E + H*O) multiply-adds (E = N*H + H*H + H*O) out of shared memory.
// rsnn_forward's seven streams make it bytes-bound on paper
// (traffic.forward_traces_bytes), but the chain sets its pace too.  The
// feedback b_fb is in normalised weight units (the raw w_out or the random
// B), the error is taken on y * y_scale (1/threshold in quantized mode), and
// the boxcar h is used whatever the config's surrogate, as on the TPU.
#include "rsnn_tick.cuh"

// F over the ticks for neuron h of one row: l = sum_o err(t, o) b_fb[h, o]
// in o order, F = l + kappa*F, G(t) = h(t) * F, walking t = T-1..0.  In
// rsnn_train's shared-memory path g aliases h.
__device__ void rsnn_f_walk(const float* h, size_t sh, float* g, size_t sg,
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
__device__ float rsnn_dw_elem(const RowGrad& r, int e, int N, int H, int O,
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
__device__ void rsnn_row_readout(const TrainArgs& a, const TickParams& p,
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

template <int W, bool SMEM_TRACES>
__global__ void rsnn_train_kernel(TrainArgs a, TickParams p) {
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
    rsnn_row_lif<W, ROW_TRACES, false>(c, tr, copy, w_rec, vs, nullptr, spikes, T, H, p);
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
// of tick t at spikes + t * sz + w), the boxcar h, the learning signal l,
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
__device__ float rsnn_exact_dw_elem(const RowExact& r, int e, int N, int H,
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
template <int W, bool SMEM_TRACES>
__global__ void rsnn_train_exact_kernel(TrainArgs a, const float* alpha,
                                        unsigned* spk_dev, TickParams p) {
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
    rsnn_row_lif<W, ROW_TRACES, false, true>(c, tr, none, w_rec, vs, nullptr, spikes, T,
                                             H, p, al);
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

// The exact walks over the device scratch: one thread per (dw element,
// row), row b's partial to dw_part[b].
__global__ void rsnn_exact_dw_rows_kernel(TrainArgs a, const float* alpha,
                                          const unsigned* spk_dev, float kappa) {
  const int T = a.T, B = a.B, N = a.N, H = a.H, O = a.O, J = (H + 31) / 32;
  const int e_all = N * H + H * H + H * O;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (e >= e_all) return;
  const RowExact r{a.raster + (size_t)b * N, (size_t)B * N, spk_dev + (size_t)b * T * J,
                   (size_t)J, a.tr_h + (size_t)b * H, a.tr_pbar + (size_t)b * H,
                   a.tr_zbar + (size_t)b * H, (size_t)B * H, a.tr_err + (size_t)b * O,
                   (size_t)B * O, alpha};
  a.dw_part[(size_t)b * e_all + e] = rsnn_exact_dw_elem(r, e, N, H, O, T, kappa);
}

// F over device traces: one thread per (row, neuron).
__global__ void rsnn_f_walk_kernel(const float* h, float* g, const float* err,
                                   const float* b_fb, int T, int B, int H,
                                   int O, float kappa) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * H) return;
  const int b = i / H, hh = i % H;
  const size_t off = (size_t)b * H + hh;
  rsnn_f_walk(h + off, (size_t)B * H, g + off, (size_t)B * H,
              err + (size_t)b * O, (size_t)B * O, b_fb + (size_t)hh * O, O, T,
              kappa);
}

// dw over device traces: one thread per (dw element, row), row b's partial
// to dw_part[b].
__global__ void rsnn_dw_rows_kernel(const float* xbar, const float* pbar,
                                    const float* zbar, const float* g,
                                    const float* err, float* dw_part, int T,
                                    int B, int N, int H, int O) {
  const int e_all = N * H + H * H + H * O;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (e >= e_all) return;
  const RowGrad r = device_row(xbar, pbar, zbar, g, err, b, B, N, H, O);
  dw_part[(size_t)b * e_all + e] = rsnn_dw_elem(r, e, N, H, O, T);
}

// Threads of a block of the flat reverse kernels.
#define RSNN_FLAT_THREADS 256

static int rsnn_dw_rows(const float* xbar, const float* pbar,
                        const float* zbar, const float* g, const float* err,
                        float* dw_part, int T, int B, int N, int H, int O,
                        cudaStream_t stream) {
  const int e_all = N * H + H * H + H * O;
  const dim3 grid((e_all + RSNN_FLAT_THREADS - 1) / RSNN_FLAT_THREADS, B);
  rsnn_dw_rows_kernel<<<grid, RSNN_FLAT_THREADS, 0, stream>>>(
      xbar, pbar, zbar, g, err, dw_part, T, B, N, H, O);
  return (int)cudaGetLastError();
}

// dw[e] = sum over rows k = 0, 1, ... of part[k, e], in row order.
__global__ void rsnn_dw_reduce_kernel(const float* __restrict__ part, int nb,
                                      int e_all, float* __restrict__ dw) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= e_all) return;
  float s = 0.f;
  for (int k = 0; k < nb; ++k) s += part[(size_t)k * e_all + e];
  dw[e] = s;
}

static int rsnn_reduce_dw(const float* part, int nb, int e_all, float* dw,
                          cudaStream_t stream) {
  const int threads = RSNN_FLAT_THREADS;
  rsnn_dw_reduce_kernel<<<(e_all + threads - 1) / threads, threads, 0,
                          stream>>>(part, nb, e_all, dw);
  return (int)cudaGetLastError();
}

// codes[e] = sum over rows k = 0, 1, ... of
// clamp(rint(part[k, e] / lsb), -2^(bits-1), 2^(bits-1) - 1), in int32.
// rintf rounds half to even, as jnp.round and torch.round do; lsb is a power
// of two, so part / lsb is exact and equals part * (1 / lsb), the product
// the kernel takes (an IEEE division is a subroutine call that kept the
// loop from running its loads ahead: 0.0244 ms against the float reduce's
// 0.0031 at B=70 on an H100, PERF.md); the clamp runs in float, before the
// cast.  The sum wraps at 2^31 as the reference's int32 sum does (at 24
// bits, 256 rows of full-scale codes).  Bound: B*E floats read, E ints
// written, one thread per element: bytes-bound, like the float reduce.
__global__ void rsnn_dw_codes_reduce_kernel(const float* __restrict__ part,
                                            int nb, int e_all, float inv_lsb,
                                            float lo, float hi,
                                            int* __restrict__ codes) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= e_all) return;
  unsigned s = 0u;
  for (int k = 0; k < nb; ++k) {
    const float q = rintf(part[(size_t)k * e_all + e] * inv_lsb);
    s += (unsigned)(int)fminf(fmaxf(q, lo), hi);
  }
  codes[e] = (int)s;
}

// lsb must be a power of two (the wrapper checks): 1 / lsb is then exact.
static int rsnn_reduce_codes(const float* part, int nb, int e_all, float lsb,
                             int bits, int* codes, cudaStream_t stream) {
  const int threads = RSNN_FLAT_THREADS;
  const float top = (float)(1 << (bits - 1));   // bits <= 24: exact
  rsnn_dw_codes_reduce_kernel<<<(e_all + threads - 1) / threads, threads, 0,
                                stream>>>(part, nb, e_all, 1.f / lsb, -top,
                                          top - 1.f, codes);
  return (int)cudaGetLastError();
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

template <int W>
__global__ void rsnn_forward_kernel(ForwardArgs a, TickParams p) {
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
  // and the h stream (which the loop then overwrites with the boxcar h)
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
    rsnn_row_lif<W, ROW_STREAMS, false>(c, in, dev, w_rec, nullptr, nullptr,
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

template <int W>
static int rsnn_forward_launch_w(const ForwardArgs& a, const TickParams& p,
                                 int threads, size_t smem, cudaStream_t stream) {
  int fit = threads;
  int rc = rsnn_prepare_launch(rsnn_forward_kernel<W>, smem, &fit);
  if (rc) return rc;
  if (fit != threads) return (int)cudaErrorInvalidConfiguration;
  const int blocks = (a.B + a.rows - 1) / a.rows;
  rsnn_forward_kernel<W><<<blocks, threads, smem, stream>>>(a, p);
  return (int)cudaGetLastError();
}

// The plan (rows, threads, Tl, weights_smem, rows_smem, smem_bytes) is the
// wrapper's (kernels/rsnn_step.py:forward_plan); the launch is refused
// unless it is a layout of this kernel: a loop warp per row and at least
// one more warp, a readout chunk of 1..T ticks, the rows' buffers on chip
// only with the whole readout, the shared-memory bytes of those choices.
extern "C" int rsnn_forward_launch(
    const float* raster, const float* w_in, const float* w_rec,
    const float* w_out, float* z, float* h, float* xbar, float* pbar,
    float* zbar, float* y, float* v, int T, int B, int N, int H, int O,
    int rows, int threads, int Tl, int weights_smem, int rows_smem,
    long long smem_bytes, float alpha, float kappa, float v_th, float alpha_c,
    float kappa_c, float v_lo, float v_hi, int reset_sub, int quant,
    float bw_vth, void* stream) {
  if (T < 1 || B < 1 || O > RSNN_MAX_OUT || N > 32 * RSNN_MAX_WORDS ||
      H > 32 * RSNN_MAX_WORDS || rows < 1 || threads % 32 ||
      threads < 32 * (rows + 1) || Tl < 1 || Tl > T || (rows_smem && Tl != T) ||
      (size_t)smem_bytes != rsnn_forward_smem_words(rows, T, Tl, N, H, O,
                                                    weights_smem, rows_smem) *
                                sizeof(float)) {
    return (int)cudaErrorInvalidValue;
  }
  TickParams p{alpha, kappa, v_th, alpha_c, kappa_c, v_lo, v_hi, reset_sub,
               quant, bw_vth, 1.f, 0.f, 0};
  const ForwardArgs a{raster, w_in, w_rec, w_out, z, h, xbar, pbar, zbar, y, v,
                      T, B, N, H, O, rows, Tl, weights_smem, rows_smem};
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = (size_t)smem_bytes;
  switch ((max(N, H) + 31) / 32) {
    case 1: return rsnn_forward_launch_w<1>(a, p, threads, smem, st);
    case 2: return rsnn_forward_launch_w<2>(a, p, threads, smem, st);
    case 3: return rsnn_forward_launch_w<3>(a, p, threads, smem, st);
    case 4: return rsnn_forward_launch_w<4>(a, p, threads, smem, st);
    case 5: return rsnn_forward_launch_w<5>(a, p, threads, smem, st);
    case 6: return rsnn_forward_launch_w<6>(a, p, threads, smem, st);
    case 7: return rsnn_forward_launch_w<7>(a, p, threads, smem, st);
    case 8: return rsnn_forward_launch_w<8>(a, p, threads, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int W, bool SMEM_TRACES>
static int rsnn_train_launch_w(const TrainArgs& a, const TickParams& p,
                               int threads, size_t smem, cudaStream_t stream) {
  int rc = rsnn_prepare_launch(rsnn_train_kernel<W, SMEM_TRACES>, smem, &threads);
  if (rc) return rc;
  rsnn_train_kernel<W, SMEM_TRACES><<<a.B, threads, smem, stream>>>(a, p);
  return (int)cudaGetLastError();
}

template <bool SMEM_TRACES>
static int rsnn_train_launch_s(const TrainArgs& a, const TickParams& p,
                               int threads, size_t smem, cudaStream_t stream) {
  switch ((max(a.N, a.H) + 31) / 32) {
    case 1: return rsnn_train_launch_w<1, SMEM_TRACES>(a, p, threads, smem, stream);
    case 2: return rsnn_train_launch_w<2, SMEM_TRACES>(a, p, threads, smem, stream);
    case 3: return rsnn_train_launch_w<3, SMEM_TRACES>(a, p, threads, smem, stream);
    case 4: return rsnn_train_launch_w<4, SMEM_TRACES>(a, p, threads, smem, stream);
    case 5: return rsnn_train_launch_w<5, SMEM_TRACES>(a, p, threads, smem, stream);
    case 6: return rsnn_train_launch_w<6, SMEM_TRACES>(a, p, threads, smem, stream);
    case 7: return rsnn_train_launch_w<7, SMEM_TRACES>(a, p, threads, smem, stream);
    case 8: return rsnn_train_launch_w<8, SMEM_TRACES>(a, p, threads, smem, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// smem_bytes: the dynamic shared memory of the wrapper's plan
// (kernels/rsnn_step.py:train_plan); the launch is refused unless it is
// this kernel's layout for the same choices.  commit_lsb 0 sums the rows'
// dw in float into dw; commit_lsb > 0 sums their codes on the grid of
// commit_bits bits and step commit_lsb into dw_codes instead.
extern "C" int rsnn_train_launch(
    const float* raster, const float* y_star, const float* valid,
    const float* w_in, const float* w_rec, const float* w_out,
    const float* b_fb, float* tr_h, float* tr_xbar, float* tr_pbar,
    float* tr_zbar, float* tr_err, float* g, float* dw_part, float* dw,
    int* dw_codes, float* acc_y, float* n_spk, int T, int B, int N, int H,
    int O, int threads, int weights_smem, int traces_smem, int infer_all,
    long long smem_bytes, float alpha, float kappa, float v_th,
    float alpha_c, float kappa_c, float v_lo, float v_hi, int reset_sub,
    int quant, float bw_vth, float y_scale, float target_amp, int err_softmax,
    float commit_lsb, int commit_bits, void* stream) {
  const bool grid = commit_lsb > 0.f;
  if (O > RSNN_MAX_OUT || N > 32 * RSNN_MAX_WORDS || H > 32 * RSNN_MAX_WORDS ||
      (!traces_smem && !tr_h) || (traces_smem && !weights_smem) || threads < 64 ||
      (size_t)smem_bytes != rsnn_train_smem_floats(T, N, H, O, weights_smem,
                                                   traces_smem) * sizeof(float) ||
      (grid ? (!dw_codes || commit_bits < 2 || commit_bits > 24) : !dw)) {
    return (int)cudaErrorInvalidValue;
  }
  TickParams p{alpha, kappa, v_th, alpha_c, kappa_c, v_lo, v_hi, reset_sub,
               quant, bw_vth, y_scale, target_amp, err_softmax};
  TrainArgs a{raster, y_star, valid, w_in, w_rec, w_out, b_fb, tr_h, tr_xbar,
              tr_pbar, tr_zbar, tr_err, g, dw_part, acc_y, n_spk,
              T, B, N, H, O, weights_smem, infer_all};
  cudaStream_t st = (cudaStream_t)stream;
  int rc = traces_smem ? rsnn_train_launch_s<true>(a, p, threads, smem_bytes, st)
                       : rsnn_train_launch_s<false>(a, p, threads, smem_bytes, st);
  if (rc) return rc;
  if (!traces_smem) {
    rc = rsnn_dw_rows(tr_xbar, tr_pbar, tr_zbar, g, tr_err, dw_part, T, B, N, H,
                      O, st);
    if (rc) return rc;
  }
  const int e_all = N * H + H * H + H * O;
  return grid ? rsnn_reduce_codes(dw_part, B, e_all, commit_lsb, commit_bits,
                                  dw_codes, st)
              : rsnn_reduce_dw(dw_part, B, e_all, dw, st);
}

extern "C" int eprop_update_launch(
    const float* h, const float* xbar, const float* pbar, const float* zbar,
    const float* err, const float* b_fb, float* g, float* dw_part, float* dw,
    int T, int B, int N, int H, int O, float kappa, void* stream) {
  if (O > RSNN_MAX_OUT) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int n = B * H;
  rsnn_f_walk_kernel<<<(n + RSNN_FLAT_THREADS - 1) / RSNN_FLAT_THREADS,
                       RSNN_FLAT_THREADS, 0, st>>>(h, g, err, b_fb, T, B, H, O,
                                                   kappa);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  rc = rsnn_dw_rows(xbar, pbar, zbar, g, err, dw_part, T, B, N, H, O, st);
  if (rc) return rc;
  return rsnn_reduce_dw(dw_part, B, N * H + H * H + H * O, dw, st);
}

template <int W, bool SMEM_TRACES>
static int rsnn_train_exact_launch_w(const TrainArgs& a, const float* alpha,
                                     unsigned* spk, const TickParams& p, int threads,
                                     size_t smem, cudaStream_t stream) {
  int rc = rsnn_prepare_launch(rsnn_train_exact_kernel<W, SMEM_TRACES>, smem, &threads);
  if (rc) return rc;
  rsnn_train_exact_kernel<W, SMEM_TRACES><<<a.B, threads, smem, stream>>>(a, alpha, spk, p);
  return (int)cudaGetLastError();
}

template <bool SMEM_TRACES>
static int rsnn_train_exact_launch_s(const TrainArgs& a, const float* alpha,
                                     unsigned* spk, const TickParams& p, int threads,
                                     size_t smem, cudaStream_t stream) {
  switch ((max(a.N, a.H) + 31) / 32) {
    case 1: return rsnn_train_exact_launch_w<1, SMEM_TRACES>(a, alpha, spk, p, threads, smem, stream);
    case 2: return rsnn_train_exact_launch_w<2, SMEM_TRACES>(a, alpha, spk, p, threads, smem, stream);
    case 3: return rsnn_train_exact_launch_w<3, SMEM_TRACES>(a, alpha, spk, p, threads, smem, stream);
    case 4: return rsnn_train_exact_launch_w<4, SMEM_TRACES>(a, alpha, spk, p, threads, smem, stream);
    case 5: return rsnn_train_exact_launch_w<5, SMEM_TRACES>(a, alpha, spk, p, threads, smem, stream);
    case 6: return rsnn_train_exact_launch_w<6, SMEM_TRACES>(a, alpha, spk, p, threads, smem, stream);
    case 7: return rsnn_train_exact_launch_w<7, SMEM_TRACES>(a, alpha, spk, p, threads, smem, stream);
    case 8: return rsnn_train_exact_launch_w<8, SMEM_TRACES>(a, alpha, spk, p, threads, smem, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// As rsnn_train_launch, with alpha (H) the neurons' decays and, for the
// device-scratch path (traces_smem 0), tr_h, tr_l, tr_zbar (T, B, H), tr_err
// (T, B, O) and spk (B, T, ceil(H/32)); smem_bytes must be this kernel's
// layout for the plan's choices (kernels/rsnn_step.py:train_exact_plan).
extern "C" int rsnn_train_exact_launch(
    const float* raster, const float* y_star, const float* valid,
    const float* w_in, const float* w_rec, const float* w_out,
    const float* b_fb, const float* alpha, float* tr_h, float* tr_l,
    float* tr_zbar, float* tr_err, unsigned* spk, float* dw_part, float* dw,
    int* dw_codes, float* acc_y, float* n_spk, int T, int B, int N, int H,
    int O, int threads, int weights_smem, int traces_smem, int infer_all,
    long long smem_bytes, float alpha_f, float kappa, float v_th,
    float alpha_c, float kappa_c, float v_lo, float v_hi, int reset_sub,
    int quant, float bw_vth, float y_scale, float target_amp, int err_softmax,
    float commit_lsb, int commit_bits, void* stream) {
  const bool grid = commit_lsb > 0.f;
  if (T < 1 || B < 1 || O > RSNN_MAX_OUT || N > 32 * RSNN_MAX_WORDS ||
      H > 32 * RSNN_MAX_WORDS || !alpha ||
      (!traces_smem && (!tr_h || !tr_l || !tr_zbar || !tr_err || !spk)) ||
      (traces_smem && !weights_smem) || threads < 64 ||
      (size_t)smem_bytes != rsnn_train_exact_smem_floats(T, N, H, O, weights_smem,
                                                         traces_smem) * sizeof(float) ||
      (grid ? (!dw_codes || commit_bits < 2 || commit_bits > 24) : !dw)) {
    return (int)cudaErrorInvalidValue;
  }
  TickParams p{alpha_f, kappa, v_th, alpha_c, kappa_c, v_lo, v_hi, reset_sub,
               quant, bw_vth, y_scale, target_amp, err_softmax};
  TrainArgs a{raster, y_star, valid, w_in, w_rec, w_out, b_fb, tr_h, nullptr,
              tr_l, tr_zbar, tr_err, nullptr, dw_part, acc_y, n_spk,
              T, B, N, H, O, weights_smem, infer_all};
  cudaStream_t st = (cudaStream_t)stream;
  int rc = traces_smem
               ? rsnn_train_exact_launch_s<true>(a, alpha, spk, p, threads, smem_bytes, st)
               : rsnn_train_exact_launch_s<false>(a, alpha, spk, p, threads, smem_bytes, st);
  if (rc) return rc;
  const int e_all = N * H + H * H + H * O;
  if (!traces_smem) {
    const dim3 grid_rows((e_all + RSNN_FLAT_THREADS - 1) / RSNN_FLAT_THREADS, B);
    rsnn_exact_dw_rows_kernel<<<grid_rows, RSNN_FLAT_THREADS, 0, st>>>(a, alpha, spk,
                                                                      kappa);
    rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  return grid ? rsnn_reduce_codes(dw_part, B, e_all, commit_lsb, commit_bits,
                                  dw_codes, st)
              : rsnn_reduce_dw(dw_part, B, e_all, dw, st);
}
