// The two serving kernels, on the warp-per-row event loop of rsnn_tick.cuh
// (rsnn_row_lif, the loop rsnn_train and rsnn_forward run, without the
// e-prop traces).
// They build into one library with the training kernels of rsnn_train.cu.
//
// rsnn_infer_kernel — whole-sample inference over one (T, B) tile, behind
// ExecutionBackend.inference.  Replaces src/repro/kernels/rsnn_step.py:
// _infer_kernel and :_infer_dma_kernel (wrapper rsnn_infer).  It writes only
// acc_y (B, O) and the valid-masked spike count n_spk (B, 1), never a
// per-tick tensor.
//
// rsnn_step_sessions_kernel — one streaming tick-tile of B resident
// sessions, carries in and out, behind ExecutionBackend.step_sessions, which
// BatchedEngine.serve() and the open_session/feed/pump path run.  Replaces
// src/repro/kernels/rsnn_step.py:_session_kernel and :_session_dma_kernel
// (wrapper rsnn_step_sessions).  The tile starts from the gathered
// (v, z, y, acc_y, n_spk) rows; a tick with live == 0 leaves a session's
// v, z and y untouched by select (no leak), so ragged chunks pack into one
// rectangular tile; acc_y is weighted by valid, or by live when
// infer_window == "all".  rsnn_infer is the same kernel from zero carries
// with every tick live.
//
// Each pair of TPU variants computes one function; the two-slot DMA of the
// second is a VMEM device, so there is one kernel for each pair.
//
// Bound on the H100: the bytes (raster, masks, carries and weights once,
// outputs) over 3.35 TB/s and the event-driven f32 operations (2H per input
// event and per spike fed back, 2O per spike) over 67 TFLOP/s are both far
// below what the serial tick chain costs: each tick of a row depends on the
// one before through the recurrent sum and the leak.  The design keeps that
// chain as short as it can be:
//   * one warp per batch row for the whole T-tick recurrence, membranes
//     and spike masks in registers, warp-level sync only inside a tick
//     (rsnn_row_lif); the recurrent current sums w_rec rows over last
//     tick's spikes only;
//   * nothing that does not feed back runs in the chain.  The block walks
//     the ticks in chunks of Tc (kernels/rsnn_step.py:serve_plan), with
//     block barriers between the phases of a chunk and none inside a tick:
//       (a) every warp copies the chunk's raster rows, valid and live into
//           shared memory, then sums the input currents of every (row,
//           tick) over the tick's input events, a few items a warp side by
//           side (rsnn_input_current_items);
//       (b) each row's warp runs the chunk's ticks and writes each tick's
//           spike masks;
//       (c) every thread sums the readout currents of the chunk's (row,
//           tick, output) over the masks (rsnn_readout_sum); then one
//           thread per (row, output) runs the LI leak and the accumulator
//           through the chunk's ticks, y and acc_y in its registers.
// The f32 weights stay in shared memory where they fit beside a chunk
// (the Braille net: 8 KB; the cue net: 57 KB); the chip maximum 256/256/16
// (528 KiB) is read from global memory, where L2 keeps it, and the event
// sums touch only the rows of active inputs and spiking neurons.
#include "rsnn_tick.cuh"

// Threads of a serving block (kernels/rsnn_step.py:serve_threads), the
// kernels' launch bound: at most 16 of its warps carry rows, and all of
// them share phases (a) and (c).  1,024 at the narrow widths (W <= 2:
// Braille), whose kernels fit the 64 registers a thread that allows; 512,
// at most 128 registers a thread, at the wider ones.
template <int W>
struct RsnnServeThreads {
  static constexpr int n = W <= 2 ? 1024 : 512;
};

struct ServeArgs {
  const float* raster;   // (T, B, N)
  const float* live;     // (T, B)  sessions
  const float* valid;    // (T, B)
  const float* v0;       // (B, H)  sessions carries in ...
  const float* z0;
  const float* y0;       // (B, O)
  const float* acc0;
  const float* nspk0;    // (B, 1)
  const float* w_in;     // (N, H)
  const float* w_rec;    // (H, H), self-recurrence masked
  const float* w_out;    // (H, O)
  float* v_out;          // sessions carries out
  float* z_out;
  float* y_out;
  float* acc_out;        // (B, O)
  float* nspk_out;       // (B, 1)
  int T, B, N, H, O;
  int rows;              // batch rows a block, one warp each
  int Tc;                // ticks a chunk
  int weights_smem;      // 1: stage the weights in shared memory
  int infer_all;         // 1: acc_y over every live tick, 0: valid ticks
};

// Dynamic shared memory of one serving block, in 4-byte words
// (kernels/rsnn_step.py:serve_plan): the weights when staged, then for
// every row and tick of a chunk max(N, O) words of input (later of readout
// current), H of input current, ceil(H/32) spike-mask words, valid and live.
__host__ __device__ inline size_t rsnn_serve_smem_words(int rows, int Tc,
                                                        int N, int H, int O,
                                                        int weights_smem) {
  size_t w = weights_smem ? (size_t)N * H + (size_t)H * H + (size_t)H * O : 0;
  const int xs = N > O ? N : O;
  return w + (size_t)rows * Tc * ((size_t)xs + H + (H + 31) / 32 + 2);
}

// WSMEM (the plan's weights_smem) is a template flag, so that the tick
// chain's w_rec loads are shared-memory loads with 32-bit addresses.
template <int W, bool SESSIONS, bool WSMEM>
__device__ __forceinline__ void rsnn_serve_rows(const ServeArgs& a,
                                                const TickParams& p) {
  extern __shared__ float smem[];
  const unsigned FULL = 0xffffffffu;
  const int T = a.T, B = a.B, N = a.N, H = a.H, O = a.O;
  const int R = a.rows, Tc = a.Tc;
  const int J = (H + 31) / 32, XS = N > O ? N : O;
  const int b0 = blockIdx.x * R;
  const int nr = min(R, B - b0);
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nth >> 5;
  const float* __restrict__ raster = a.raster;

  float* s = smem;
  const float* w_in = a.w_in;
  const float* w_rec = a.w_rec;
  const float* w_out = a.w_out;
  if (WSMEM) {
    float* wi = s;  s += N * H;
    float* wr = s;  s += H * H;
    float* wo = s;  s += H * O;
    for (int i = tid; i < N * H; i += nth) wi[i] = a.w_in[i];
    for (int i = tid; i < H * H; i += nth) wr[i] = a.w_rec[i];
    for (int i = tid; i < H * O; i += nth) wo[i] = a.w_out[i];
    w_in = wi; w_rec = wr; w_out = wo;
  }
  float* xs = s;  s += (size_t)Tc * R * XS;   // x(t, r, k), then y_lin(t, r, o), at (t*R + r)*XS
  float* cur = s;  s += (size_t)R * Tc * H;   // input current (r, t, h)
  unsigned* zs = reinterpret_cast<unsigned*>(s);  s += (size_t)R * Tc * J;   // masks (r, t, j)
  float* vd = s;  s += (size_t)R * Tc;        // valid (r, t)
  float* lv = s;                              // live (r, t)

  // warp r < nr carries row b0 + r
  const bool row_warp = warp < nr;
  RowCarry<W> c;
  rsnn_carry_zero(c);
  if (SESSIONS && row_warp) {
    const size_t g = (size_t)(b0 + warp) * H;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const int h = lane + 32 * j;
      const bool in = j < J && h < H;
      c.v[j] = in ? a.v0[g + h] : 0.f;
      c.z[j] = __ballot_sync(FULL, in && a.z0[g + h] != 0.f);
    }
    c.nspk = a.nspk0[b0 + warp];
  }
  // thread r*O + o carries y and acc_y of row b0 + r, output o
  const bool ro = tid < nr * O;
  const int rr = ro ? tid / O : 0;
  const int oo = tid - rr * O;
  float y = 0.f, acc = 0.f;
  if (SESSIONS && ro) {
    y = a.y0[(size_t)(b0 + rr) * O + oo];
    acc = a.acc0[(size_t)(b0 + rr) * O + oo];
  }

  for (int t0 = 0; t0 < T; t0 += Tc) {
    const int tc = min(Tc, T - t0);
    // (a) the chunk's raster rows (tick t's rows are one contiguous run),
    // CU loads in flight a thread, then valid and live
    constexpr int CU = 4;
    const int RN = R * N, total = tc * RN;
    for (int i0 = tid; i0 < total; i0 += CU * nth) {
      float xv[CU];
      int dst[CU];
#pragma unroll
      for (int u = 0; u < CU; ++u) {
        const int i = i0 + u * nth;
        const int t = i / RN, rn = i - t * RN;
        const int r = rn / N;
        dst[u] = i < total ? (t * R + r) * XS + rn - r * N : -1;
        xv[u] = (i < total && r < nr)
                    ? raster[((size_t)(t0 + t) * B + b0) * N + rn] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < CU; ++u) {
        if (dst[u] >= 0) xs[dst[u]] = xv[u];
      }
    }
    for (int i = tid; i < tc * R; i += nth) {
      const int t = i / R, r = i - t * R;
      const size_t g = (size_t)(t0 + t) * B + b0 + r;
      vd[r * Tc + t] = r < nr ? a.valid[g] : 0.f;
      if (SESSIONS) lv[r * Tc + t] = r < nr ? a.live[g] : 0.f;
    }
    __syncthreads();
    // the input currents of every (row, tick): a warp takes U items at a
    // time, side by side
    constexpr int U = RsnnItems<W>::U;
    for (int i0 = warp * U; i0 < nr * tc; i0 += nw * U) {
      const float* xr[U];
      float* cr[U];
      bool on[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = min(i0 + u, nr * tc - 1);
        const int r = i / tc, t = i - r * tc;
        on[u] = i0 + u < nr * tc;
        xr[u] = xs + (t * R + r) * XS;
        cr[u] = cur + ((size_t)r * Tc + t) * H;
      }
      rsnn_input_current_items<W, U>(xr, on, w_in, cr, N, H);
    }
    __syncthreads();
    // (b) the recurrence: each row on its own warp
    if (row_warp) {
      const RowTraces tr{cur + (size_t)warp * Tc * H, nullptr, nullptr, nullptr,
                         nullptr, (size_t)H, 0, 0};
      rsnn_row_lif<W, ROW_COUNT, SESSIONS>(c, tr, RowTraces{}, w_rec,
                                           vd + warp * Tc, lv + warp * Tc,
                                           zs + (size_t)warp * Tc * J, tc, H, p);
    }
    __syncthreads();
    // (c) the readout currents of every (row, tick, output), then the LI
    // leak through the ticks
    const int TO = tc * O;
    for (int i = tid; i < nr * TO; i += nth) {
      const int r = i / TO, to = i - r * TO;
      const int t = to / O, o = to - t * O;
      xs[(t * R + r) * XS + o] =
          rsnn_readout_sum(zs + ((size_t)r * Tc + t) * J, J, w_out, O, o);
    }
    __syncthreads();
    if (ro) {
      for (int t = 0; t < tc; ++t) {
        const float y_new = rsnn_leak_out(y, xs[(t * R + rr) * XS + oo], p);
        const float l = SESSIONS ? lv[rr * Tc + t] : 1.f;
        acc += y_new * (a.infer_all ? l : vd[rr * Tc + t]);
        y = l > 0.f ? y_new : y;
      }
    }
    __syncthreads();
  }

  if (row_warp) {
    const int b = b0 + warp;
    if (SESSIONS) {
#pragma unroll
      for (int j = 0; j < W; ++j) {
        const int h = lane + 32 * j;
        if (j < J && h < H) {
          a.v_out[(size_t)b * H + h] = c.v[j];
          a.z_out[(size_t)b * H + h] = (c.z[j] >> lane) & 1u ? 1.f : 0.f;
        }
      }
    }
    if (lane == 0) a.nspk_out[b] = c.nspk;
  }
  if (ro) {
    const size_t g = (size_t)(b0 + rr) * O + oo;
    a.acc_out[g] = acc;
    if (SESSIONS) a.y_out[g] = y;
  }
}

template <int W, bool WSMEM>
__global__ void __launch_bounds__(RsnnServeThreads<W>::n)
rsnn_infer_kernel(ServeArgs a, TickParams p) {
  rsnn_serve_rows<W, false, WSMEM>(a, p);
}

template <int W, bool WSMEM>
__global__ void __launch_bounds__(RsnnServeThreads<W>::n)
rsnn_step_sessions_kernel(ServeArgs a, TickParams p) {
  rsnn_serve_rows<W, true, WSMEM>(a, p);
}

template <int W>
static int rsnn_serve_launch_w(const ServeArgs& a, const TickParams& p,
                               bool sessions, int threads, size_t smem,
                               cudaStream_t stream) {
  void (*kernel)(ServeArgs, TickParams) =
      a.weights_smem
          ? (sessions ? &rsnn_step_sessions_kernel<W, true> : &rsnn_infer_kernel<W, true>)
          : (sessions ? &rsnn_step_sessions_kernel<W, false> : &rsnn_infer_kernel<W, false>);
  if (threads != RsnnServeThreads<W>::n) return (int)cudaErrorInvalidValue;
  int fit = threads;
  int rc = rsnn_prepare_launch(kernel, smem, &fit);
  if (rc) return rc;
  if (fit != threads) return (int)cudaErrorInvalidConfiguration;
  const int blocks = (a.B + a.rows - 1) / a.rows;
  kernel<<<blocks, threads, smem, stream>>>(a, p);
  return (int)cudaGetLastError();
}

// The plan (rows, threads, Tc, weights_smem, smem_bytes) is the wrapper's
// (kernels/rsnn_step.py:serve_plan); the launch is refused unless it is a
// layout of this kernel.
static int rsnn_serve_launch(const ServeArgs& a, const TickParams& p,
                             bool sessions, int threads, long long smem_bytes,
                             void* stream) {
  if (a.B < 1 || a.O > RSNN_MAX_OUT || a.N > 32 * RSNN_MAX_WORDS ||
      a.H > 32 * RSNN_MAX_WORDS || a.rows < 1 || a.Tc < 1 ||
      a.rows * 32 > threads || a.rows * a.O > threads ||
      (size_t)smem_bytes != rsnn_serve_smem_words(a.rows, a.Tc, a.N, a.H, a.O,
                                                  a.weights_smem) * sizeof(float)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = (size_t)smem_bytes;
  switch ((max(a.N, a.H) + 31) / 32) {
    case 1: return rsnn_serve_launch_w<1>(a, p, sessions, threads, smem, st);
    case 2: return rsnn_serve_launch_w<2>(a, p, sessions, threads, smem, st);
    case 3: return rsnn_serve_launch_w<3>(a, p, sessions, threads, smem, st);
    case 4: return rsnn_serve_launch_w<4>(a, p, sessions, threads, smem, st);
    case 5: return rsnn_serve_launch_w<5>(a, p, sessions, threads, smem, st);
    case 6: return rsnn_serve_launch_w<6>(a, p, sessions, threads, smem, st);
    case 7: return rsnn_serve_launch_w<7>(a, p, sessions, threads, smem, st);
    case 8: return rsnn_serve_launch_w<8>(a, p, sessions, threads, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int rsnn_infer_launch(
    const float* raster, const float* valid, const float* w_in,
    const float* w_rec, const float* w_out, float* acc_y, float* n_spk, int T,
    int B, int N, int H, int O, int rows, int threads, int Tc,
    int weights_smem, int infer_all, long long smem_bytes, float alpha,
    float kappa, float v_th, float alpha_c, float kappa_c, float v_lo,
    float v_hi, int reset_sub, int quant, void* stream) {
  TickParams p{alpha, kappa, v_th, alpha_c, kappa_c, v_lo, v_hi, reset_sub,
               quant};
  ServeArgs a{};
  a.raster = raster; a.valid = valid;
  a.w_in = w_in; a.w_rec = w_rec; a.w_out = w_out;
  a.acc_out = acc_y; a.nspk_out = n_spk;
  a.T = T; a.B = B; a.N = N; a.H = H; a.O = O;
  a.rows = rows; a.Tc = Tc; a.weights_smem = weights_smem; a.infer_all = infer_all;
  return rsnn_serve_launch(a, p, false, threads, smem_bytes, stream);
}

extern "C" int rsnn_step_sessions_launch(
    const float* raster, const float* live, const float* valid,
    const float* v0, const float* z0, const float* y0, const float* acc0,
    const float* nspk0, const float* w_in, const float* w_rec,
    const float* w_out, float* v, float* z, float* y, float* acc_y,
    float* n_spk, int T, int B, int N, int H, int O, int rows, int threads,
    int Tc, int weights_smem, int infer_all, long long smem_bytes,
    float alpha, float kappa, float v_th, float alpha_c, float kappa_c,
    float v_lo, float v_hi, int reset_sub, int quant, void* stream) {
  TickParams p{alpha, kappa, v_th, alpha_c, kappa_c, v_lo, v_hi, reset_sub,
               quant};
  ServeArgs a{raster, live, valid, v0, z0, y0, acc0, nspk0, w_in, w_rec, w_out,
              v, z, y, acc_y, n_spk, T, B, N, H, O, rows, Tc, weights_smem,
              infer_all};
  return rsnn_serve_launch(a, p, true, threads, smem_bytes, stream);
}

extern "C" const char* rsnn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
