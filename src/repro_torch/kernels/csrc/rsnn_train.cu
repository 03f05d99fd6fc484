// The three training kernels, built into one library with the serving
// kernels of rsnn_serve.cu.  rsnn_forward runs the tile loop of
// rsnn_tick.cuh, rsnn_train the warp-per-row event loop there (with its
// e-prop traces; the serving kernels run the same loop without them);
// rsnn_train and eprop_update share the reverse device functions below
// (rsnn_f_walk, rsnn_dw_elem).
//
// rsnn_forward_kernel — the trace-streaming forward behind the backend's
// forward_traces and dynamics ops.  Replaces src/repro/kernels/rsnn_step.py:
// _kernel and :_forward_dma_kernel (wrapper rsnn_forward).  Writes seven
// (T, B, .) tensors: z, h, xbar, pbar, zbar, y and the post-reset v.
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
// event and per spike of the last tick, and the readout 2*O per spike; the
// reverse pass does 2*T*B*(E + H*O) multiply-adds (E = N*H + H*H + H*O)
// out of shared memory.  The feedback b_fb is in normalised weight units
// (the raw w_out or the random B), the error is taken on y * y_scale
// (1/threshold in quantized mode), and the boxcar h is used whatever the
// config's surrogate, as on the TPU.
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

// The readout of one row over all its ticks, after the LIF loop: every
// (tick, output) sums w_out over the tick's spikes in ascending h (into
// the err slots), one thread per output runs the LI leak through the
// ticks and adds acc_y, then every tick turns its y into the readout
// error in place — the contract's operations in its order, the ticks side
// by side wherever they do not depend on each other.
__device__ void rsnn_row_readout(const TrainArgs& a, const TickParams& p,
                                 const RowTraces& tr, const RowTraces& copy,
                                 const unsigned* spikes, const float* vs,
                                 const float* w_out, int b) {
  const int T = a.T, O = a.O, J = (a.H + 31) / 32;
  const int tid = threadIdx.x, nth = blockDim.x;
  for (int i = tid; i < T * O; i += nth) {
    const int t = i / O, o = i - (i / O) * O;
    rsnn_put(tr.err, tr.sO, t, o, rsnn_readout_sum(spikes + t * J, J, w_out, O, o));
  }
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
    rsnn_row_lif<W, true, false>(c, tr, copy, w_rec, vs, nullptr, spikes, T, H, p);
    if (tid == 0) a.n_spk[b] = c.nspk;
  } else {
    // xbar = alpha * xbar + x over the ticks, one thread per input
    for (int k = tid - 32; k < N; k += nth - 32) {
      float xb = 0.f;
      for (int t = 0; t < T; ++t) {
        xb = p.alpha * xb + x[(size_t)t * sx + k];
        rsnn_put(tr.xbar, tr.sN, t, k, xb);
        if (copy.h) rsnn_put(copy.xbar, copy.sN, t, k, xb);
      }
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

__global__ void rsnn_forward_kernel(TileIO io, TileDims d, TickParams p) {
  rsnn_tile_loop<RSNN_FORWARD>(io, d, p);
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

extern "C" int rsnn_forward_launch(
    const float* raster, const float* w_in, const float* w_rec,
    const float* w_out, float* z, float* h, float* xbar, float* pbar,
    float* zbar, float* y, float* v, int T, int B, int N, int H, int O,
    int bt, int threads, int weights_smem, float alpha, float kappa,
    float v_th, float alpha_c, float kappa_c, float v_lo, float v_hi,
    int reset_sub, int quant, float bw_vth, void* stream) {
  TickParams p{alpha, kappa, v_th, alpha_c, kappa_c, v_lo, v_hi, reset_sub,
               quant, bw_vth, 1.f, 0.f, 0};
  TileIO io{};
  io.raster = raster;
  io.w_in = w_in; io.w_rec = w_rec; io.w_out = w_out;
  io.tr_z = z; io.tr_h = h; io.tr_xbar = xbar; io.tr_pbar = pbar;
  io.tr_zbar = zbar; io.tr_y = y; io.tr_v = v;
  TileDims d{T, B, N, H, O, bt, weights_smem};
  const size_t smem =
      rsnn_tile_smem_floats(bt, N, H, O, weights_smem) * sizeof(float);
  int rc = rsnn_prepare_launch(rsnn_forward_kernel, smem, &threads);
  if (rc) return rc;
  const int blocks = (B + bt - 1) / bt;
  rsnn_forward_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(io, d, p);
  return (int)cudaGetLastError();
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
// this kernel's layout for the same choices.
extern "C" int rsnn_train_launch(
    const float* raster, const float* y_star, const float* valid,
    const float* w_in, const float* w_rec, const float* w_out,
    const float* b_fb, float* tr_h, float* tr_xbar, float* tr_pbar,
    float* tr_zbar, float* tr_err, float* g, float* dw_part, float* dw,
    float* acc_y, float* n_spk, int T, int B, int N, int H, int O,
    int threads, int weights_smem, int traces_smem, int infer_all,
    long long smem_bytes, float alpha, float kappa, float v_th,
    float alpha_c, float kappa_c, float v_lo, float v_hi, int reset_sub,
    int quant, float bw_vth, float y_scale, float target_amp, int err_softmax,
    void* stream) {
  if (O > RSNN_MAX_OUT || N > 32 * RSNN_MAX_WORDS || H > 32 * RSNN_MAX_WORDS ||
      (!traces_smem && !tr_h) || (traces_smem && !weights_smem) || threads < 64 ||
      (size_t)smem_bytes != rsnn_train_smem_floats(T, N, H, O, weights_smem,
                                                   traces_smem) * sizeof(float)) {
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
  return rsnn_reduce_dw(dw_part, B, N * H + H * H + H * O, dw, st);
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
