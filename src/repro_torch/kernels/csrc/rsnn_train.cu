// The three training kernels, built into one library with the serving
// kernels of rsnn_serve.cu.  Their forward is the tick datapath of
// rsnn_tick.cuh in a trace mode; their reverse pass is one device
// function, rsnn_eprop_reverse, below.
//
// rsnn_forward_kernel — the trace-streaming forward behind the backend's
// forward_traces and dynamics ops.  Replaces src/repro/kernels/rsnn_step.py:
// _kernel and :_forward_dma_kernel (wrapper rsnn_forward).  Writes seven
// (T, B, .) tensors: z, h, xbar, pbar, zbar, y and the post-reset v.
//
// rsnn_train_kernel — the fused train op behind ExecutionBackend.train_tile,
// every END_S and END_B commit.  Replaces src/repro/kernels/eprop_update.py:
// _train_kernel and :_train_dma_kernel (wrapper rsnn_train).  Per block of
// rows: the forward ticks with the readout error evaluated in-kernel, then,
// in the same launch, the reverse kappa-filter and the three dw sums of the
// block's rows.  Also writes acc_y (B, O) and the valid-masked n_spk (B, 1).
//
// eprop_update_kernel — the split reverse pass behind the backend's
// eprop_update op, over traces in device memory.  Replaces
// src/repro/kernels/eprop_update.py:_kernel (wrapper eprop_update).
//
// rsnn_dw_reduce_kernel — the cross-block dw sum of the last two.
//
// Design.  On the TPU the trace set of a batch tile stays in VMEM.  On the
// H100 one row's traces take T*(3H+N+O)*4 bytes (66 KB at Braille T=128,
// 532 KB at 256/256/16), so at most a few rows would fit the 227 KB a
// block may hold.  The trace set therefore lives in a (T, B, .) scratch
// in device memory that the wrapper allocates: the forward phase writes
// it and the reverse phase of the same block reads it back (4.6 MB at the
// END_B tile T=128, B=70: it stays in the 50 MB L2).  The reverse pass
// runs in two steps: one thread per (row, neuron) walks the ticks
// backwards through F = err.B_fb^T + kappa*F and stores G = h*F; then one
// thread per dw element sums its products over (t = T-1..0, row) in that
// fixed order.  TPU blocks add their dw into the output in tile order;
// CUDA blocks finish in no order, so each block writes its partial dw to
// its own slice of an (nb, E) buffer, and rsnn_dw_reduce_kernel adds the
// slices in block order.  No atomics: two launches give identical bits.
//
// Bound on the H100: the forward is the serial tick chain of the serving
// kernels (see rsnn_serve.cu); the reverse pass does 2*T*B*E multiply-adds
// (E = N*H + H*H + H*O) out of L1/L2, small beside the chain at Braille
// width.  The feedback b_fb is in normalised weight units (the raw w_out or
// the random B), the error is taken on y * y_scale (1/threshold in
// quantized mode), and the boxcar h is used whatever the config's
// surrogate, as on the TPU.
#include "rsnn_tick.cuh"

struct ReverseIO {
  const float* h;        // (T, B, H)   may alias g (rsnn_train)
  float* g;              // (T, B, H)   G = h * F, written here
  const float* xbar;     // (T, B, N)
  const float* pbar;     // (T, B, H)
  const float* zbar;     // (T, B, H)
  const float* err;      // (T, B, O)
  const float* b_fb;     // (H, O)
  float* dw_part;        // (nb, E): this block writes row blockIdx.x
};

// The reverse pass over rows [b0, b0 + rows).  Not __restrict__: in
// rsnn_train the traces were written by other threads of this block.
__device__ void rsnn_eprop_reverse(const ReverseIO& io, int T, int B, int N,
                                   int H, int O, int b0, int rows,
                                   float kappa) {
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  for (int i = tid; i < rows * H; i += nth) {
    const int b = i / H;
    const int h = i - b * H;
    float f = 0.f;
    for (int t = T - 1; t >= 0; --t) {
      const size_t r = (size_t)t * B + b0 + b;
      const float* e = io.err + r * O;
      float l = 0.f;
      for (int o = 0; o < O; ++o) l += e[o] * io.b_fb[h * O + o];
      f = l + kappa * f;
      io.g[r * H + h] = io.h[r * H + h] * f;
    }
  }
  __syncthreads();
  const int e_in = N * H, e_rec = H * H, e_all = N * H + H * H + H * O;
  float* part = io.dw_part + (size_t)blockIdx.x * e_all;
  for (int e = tid; e < e_all; e += nth) {
    float acc = 0.f;
    if (e < e_in) {
      const int n = e / H, h = e - (e / H) * H;
      for (int t = T - 1; t >= 0; --t) {
        const size_t r0 = (size_t)t * B + b0;
        for (int b = 0; b < rows; ++b) {
          acc += io.xbar[(r0 + b) * N + n] * io.g[(r0 + b) * H + h];
        }
      }
    } else if (e < e_in + e_rec) {
      const int k = (e - e_in) / H, h = (e - e_in) - k * H;
      for (int t = T - 1; t >= 0; --t) {
        const size_t r0 = (size_t)t * B + b0;
        for (int b = 0; b < rows; ++b) {
          acc += io.pbar[(r0 + b) * H + k] * io.g[(r0 + b) * H + h];
        }
      }
    } else {
      const int h = (e - e_in - e_rec) / O, o = (e - e_in - e_rec) - h * O;
      for (int t = T - 1; t >= 0; --t) {
        const size_t r0 = (size_t)t * B + b0;
        for (int b = 0; b < rows; ++b) {
          acc += io.zbar[(r0 + b) * H + h] * io.err[(r0 + b) * O + o];
        }
      }
    }
    part[e] = acc;
  }
}

__global__ void rsnn_forward_kernel(TileIO io, TileDims d, TickParams p) {
  rsnn_tile_loop<RSNN_FORWARD>(io, d, p);
}

__global__ void rsnn_train_kernel(TileIO io, TileDims d, TickParams p,
                                  ReverseIO rio) {
  rsnn_tile_loop<RSNN_TRAIN>(io, d, p);   // ends on a block barrier
  const int b0 = blockIdx.x * d.bt;
  rsnn_eprop_reverse(rio, d.T, d.B, d.N, d.H, d.O, b0, min(d.bt, d.B - b0),
                     p.kappa);
}

__global__ void eprop_update_kernel(ReverseIO rio, int T, int B, int N, int H,
                                    int O, int bt, float kappa) {
  const int b0 = blockIdx.x * bt;
  rsnn_eprop_reverse(rio, T, B, N, H, O, b0, min(bt, B - b0), kappa);
}

// dw[e] = sum over blocks k = 0, 1, ... of part[k, e], in block order.
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
  const int threads = 256;
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
  TileDims d{T, B, N, H, O, bt, weights_smem, 0};
  const size_t smem =
      rsnn_tile_smem_floats(bt, N, H, O, weights_smem, 1) * sizeof(float);
  int rc = rsnn_prepare_launch(rsnn_forward_kernel, smem, &threads);
  if (rc) return rc;
  const int blocks = (B + bt - 1) / bt;
  rsnn_forward_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(io, d, p);
  return (int)cudaGetLastError();
}

extern "C" int rsnn_train_launch(
    const float* raster, const float* y_star, const float* valid,
    const float* w_in, const float* w_rec, const float* w_out,
    const float* b_fb, float* tr_h, float* tr_xbar, float* tr_pbar,
    float* tr_zbar, float* tr_err, float* dw_part, float* dw, float* acc_y,
    float* n_spk, int T, int B, int N, int H, int O, int bt, int threads,
    int weights_smem, int infer_all, float alpha, float kappa, float v_th,
    float alpha_c, float kappa_c, float v_lo, float v_hi, int reset_sub,
    int quant, float bw_vth, float y_scale, float target_amp, int err_softmax,
    void* stream) {
  if (O > RSNN_MAX_OUT) return (int)cudaErrorInvalidValue;
  TickParams p{alpha, kappa, v_th, alpha_c, kappa_c, v_lo, v_hi, reset_sub,
               quant, bw_vth, y_scale, target_amp, err_softmax};
  TileIO io{};
  io.raster = raster; io.valid = valid; io.y_star = y_star;
  io.w_in = w_in; io.w_rec = w_rec; io.w_out = w_out;
  io.acc_out = acc_y; io.nspk_out = n_spk;
  io.tr_h = tr_h; io.tr_xbar = tr_xbar; io.tr_pbar = tr_pbar;
  io.tr_zbar = tr_zbar; io.tr_err = tr_err;
  ReverseIO rio{tr_h, tr_h, tr_xbar, tr_pbar, tr_zbar, tr_err, b_fb, dw_part};
  TileDims d{T, B, N, H, O, bt, weights_smem, infer_all};
  const size_t smem =
      rsnn_tile_smem_floats(bt, N, H, O, weights_smem, 1) * sizeof(float);
  int rc = rsnn_prepare_launch(rsnn_train_kernel, smem, &threads);
  if (rc) return rc;
  const int blocks = (B + bt - 1) / bt;
  rsnn_train_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(io, d, p,
                                                                     rio);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  return rsnn_reduce_dw(dw_part, blocks, N * H + H * H + H * O, dw,
                        (cudaStream_t)stream);
}

extern "C" int eprop_update_launch(
    const float* h, const float* xbar, const float* pbar, const float* zbar,
    const float* err, const float* b_fb, float* g, float* dw_part, float* dw,
    int T, int B, int N, int H, int O, int bt, int threads, float kappa,
    void* stream) {
  ReverseIO rio{h, g, xbar, pbar, zbar, err, b_fb, dw_part};
  const int blocks = (B + bt - 1) / bt;
  eprop_update_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      rio, T, B, N, H, O, bt, kappa);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  return rsnn_reduce_dw(dw_part, blocks, N * H + H * H + H * O, dw,
                        (cudaStream_t)stream);
}
