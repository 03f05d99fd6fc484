// One tick-tile of ReckOn's LIF + LI datapath, shared by the two serving
// kernels (rsnn_serve.cu).
//
// Replaces the TPU tick pipeline of src/repro/kernels/rsnn_step.py
// (tick_transition / tick_from_input_current, run once per grid step of
// _infer_kernel and _session_kernel).  On the TPU the grid (tile, tick)
// walks ticks in order and carries state in VMEM scratch; here the whole
// T-tick loop runs inside one launch: one block per tile of `bt` batch
// rows, one thread per (row, hidden neuron), carries in shared memory.
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
// Each output row's sums run in a fixed order that depends on nothing but
// the row, so the result is the same for any tile width or batch: float
// chunk invariance (whole sample vs word-by-word feeds) is bitwise.
//
// The library is compiled with -fmad=false: every product is rounded
// before it is added, as the plain PyTorch version's separate multiply and
// add are.  In quantized mode every operand is an integer below 2^24
// carried in f32, so every step is exact either way.  No tensor core and
// no TF32 path is used.
#pragma once
#include <cuda_runtime.h>

struct TickParams {
  float alpha, kappa, v_th;      // float-mode decays and threshold
  float alpha_c, kappa_c;        // quantized leaks: reg / 256
  float v_lo, v_hi;              // quantized membrane grid
  int reset_sub;                 // 1: subtract threshold, 0: reset to zero
  int quant;                     // 1: fixed-point datapath
};

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

// Dynamic shared memory a tile needs, in floats.
__host__ __device__ inline size_t rsnn_tile_smem_floats(int bt, int N, int H,
                                                        int O,
                                                        int weights_smem) {
  size_t w = weights_smem ? (size_t)N * H + (size_t)H * H + (size_t)H * O : 0;
  return w + 3 * (size_t)bt * H + (size_t)bt * N + 2 * (size_t)bt * O +
         3 * (size_t)bt;
}

// The T-tick loop of one tile.  SESSIONS selects carries-in/out and the
// `live` select; otherwise the tile starts from zero state, every tick is
// live, and only acc_y / n_spk are written.
template <bool SESSIONS>
__device__ void rsnn_tile_loop(
    const float* __restrict__ raster,   // (T, B, N)
    const float* __restrict__ live_g,   // (T, B)  sessions only
    const float* __restrict__ valid_g,  // (T, B)
    const float* __restrict__ v0, const float* __restrict__ z0,
    const float* __restrict__ y0, const float* __restrict__ acc0,
    const float* __restrict__ nspk0,
    const float* __restrict__ w_in_g,   // (N, H)
    const float* __restrict__ w_rec_g,  // (H, H), self-recurrence masked
    const float* __restrict__ w_out_g,  // (H, O)
    float* __restrict__ v_out, float* __restrict__ z_out,
    float* __restrict__ y_out, float* __restrict__ acc_out,
    float* __restrict__ nspk_out, int T, int B, int N, int H, int O, int bt,
    int weights_smem, int infer_all, TickParams p) {
  extern __shared__ float smem[];
  const int b0 = blockIdx.x * bt;
  const int rows = min(bt, B - b0);
  const int tid = threadIdx.x;
  const int nth = blockDim.x;

  float* s = smem;
  const float* w_in = w_in_g;
  const float* w_rec = w_rec_g;
  const float* w_out = w_out_g;
  if (weights_smem) {
    float* wi = s; s += N * H;
    float* wr = s; s += H * H;
    float* wo = s; s += H * O;
    for (int i = tid; i < N * H; i += nth) wi[i] = w_in_g[i];
    for (int i = tid; i < H * H; i += nth) wr[i] = w_rec_g[i];
    for (int i = tid; i < H * O; i += nth) wo[i] = w_out_g[i];
    w_in = wi; w_rec = wr; w_out = wo;
  }
  float* v = s;    s += bt * H;
  float* z = s;    s += bt * H;
  float* zn = s;   s += bt * H;   // this tick's spikes before the live select
  float* x = s;    s += bt * N;
  float* y = s;    s += bt * O;
  float* acc = s;  s += bt * O;
  float* nspk = s; s += bt;
  float* lv = s;   s += bt;
  float* vd = s;

  for (int i = tid; i < bt * H; i += nth) {
    const bool in = i / H < rows;
    const size_t g = (size_t)b0 * H + i;
    v[i] = (SESSIONS && in) ? v0[g] : 0.f;
    z[i] = (SESSIONS && in) ? z0[g] : 0.f;
  }
  for (int i = tid; i < bt * O; i += nth) {
    const bool in = i / O < rows;
    const size_t g = (size_t)b0 * O + i;
    y[i] = (SESSIONS && in) ? y0[g] : 0.f;
    acc[i] = (SESSIONS && in) ? acc0[g] : 0.f;
  }
  for (int b = tid; b < bt; b += nth) {
    nspk[b] = (SESSIONS && b < rows) ? nspk0[b0 + b] : 0.f;
  }

  for (int t = 0; t < T; ++t) {
    const float* xt = raster + ((size_t)t * B + b0) * N;
    for (int i = tid; i < bt * N; i += nth) x[i] = i < rows * N ? xt[i] : 0.f;
    for (int b = tid; b < bt; b += nth) {
      const size_t g = (size_t)t * B + b0 + b;
      vd[b] = b < rows ? valid_g[g] : 0.f;
      lv[b] = SESSIONS ? (b < rows ? live_g[g] : 0.f) : 1.f;
    }
    __syncthreads();

    // LIF: one thread per (row, hidden neuron)
    for (int i = tid; i < bt * H; i += nth) {
      const int b = i / H;
      const int h = i - b * H;
      const float* xr = x + b * N;
      const float* zr = z + b * H;
      float in_cur = 0.f;
      for (int k = 0; k < N; ++k) in_cur += xr[k] * w_in[k * H + h];
      float rec = 0.f;
      for (int k = 0; k < H; ++k) rec += zr[k] * w_rec[k * H + h];
      const float v_pre = rsnn_leak_in(v[i], in_cur + rec, p);
      const float zz = v_pre >= p.v_th ? 1.f : 0.f;
      const float v_new = p.reset_sub ? v_pre - zz * p.v_th : v_pre * (1.f - zz);
      zn[i] = zz;
      if (lv[b] > 0.f) v[i] = v_new;   // live == 0 freezes by select
    }
    __syncthreads();

    // LI readout and accumulators: one thread per (row, output)
    for (int i = tid; i < bt * O; i += nth) {
      const int b = i / O;
      const int o = i - b * O;
      const float* zr = zn + b * H;
      float y_lin = 0.f;
      for (int k = 0; k < H; ++k) y_lin += zr[k] * w_out[k * O + o];
      const float y_new = rsnn_leak_out(y[i], y_lin, p);
      const float w = infer_all ? lv[b] : vd[b];
      acc[i] += y_new * w;
      if (lv[b] > 0.f) y[i] = y_new;
    }
    for (int b = tid; b < bt; b += nth) {
      float cnt = 0.f;
      for (int k = 0; k < H; ++k) cnt += zn[b * H + k] * vd[b];
      nspk[b] += cnt;
    }
    for (int i = tid; i < bt * H; i += nth) {
      if (lv[i / H] > 0.f) z[i] = zn[i];
    }
    __syncthreads();
  }

  for (int i = tid; i < rows * O; i += nth) acc_out[(size_t)b0 * O + i] = acc[i];
  for (int b = tid; b < rows; b += nth) nspk_out[b0 + b] = nspk[b];
  if (SESSIONS) {
    for (int i = tid; i < rows * H; i += nth) {
      v_out[(size_t)b0 * H + i] = v[i];
      z_out[(size_t)b0 * H + i] = z[i];
    }
    for (int i = tid; i < rows * O; i += nth) y_out[(size_t)b0 * O + i] = y[i];
  }
}

// Launch helper shared by both entry points: raises the dynamic
// shared-memory limit when the tile needs more than the 48 KB default.
template <typename Kernel>
inline int rsnn_prepare_launch(Kernel kernel, size_t smem_bytes) {
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}
