// The two serving kernels: both run the tick datapath of rsnn_tick.cuh
// over the whole T-tick loop inside one launch.  They build into one
// library with the training kernels of rsnn_train.cu.
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
// carries untouched by select (no leak), so ragged chunks pack into one
// rectangular tile; acc_y is weighted by valid, or by live when
// infer_window == "all".
//
// Each pair of TPU variants computes one function; the two-slot DMA of the
// second is a VMEM device, so there is one kernel for each pair.
//
// Bound on the H100: the bytes (raster, masks, carries and weights once,
// outputs) over 3.35 TB/s and the f32 operations T*B*2(N*H + H*H + H*O) over
// 67 TFLOP/s are both far below what the serial tick chain costs at Braille
// width (12/38/3): each tick is a dependent chain of N + H multiply-adds per
// thread plus three block barriers, T times over.  The design therefore
// keeps everything a tick touches on chip — carries in shared memory, the
// weights too where they fit (the Braille net: 8 KB in f32) — and spreads
// the batch over as many blocks as there are SMs (the wrapper picks the rows
// per block).  At the chip maximum 256/256/16 the f32 weights (528 KiB)
// exceed the 227 KB a block may hold, so they are read from global memory,
// where L2 keeps them after the first tick.
#include "rsnn_tick.cuh"

__global__ void rsnn_infer_kernel(TileIO io, TileDims d, TickParams p) {
  rsnn_tile_loop<RSNN_INFER>(io, d, p);
}

__global__ void rsnn_step_sessions_kernel(TileIO io, TileDims d, TickParams p) {
  rsnn_tile_loop<RSNN_SESSIONS>(io, d, p);
}

extern "C" int rsnn_infer_launch(
    const float* raster, const float* valid, const float* w_in,
    const float* w_rec, const float* w_out, float* acc_y, float* n_spk, int T,
    int B, int N, int H, int O, int bt, int threads, int weights_smem,
    int infer_all, float alpha, float kappa, float v_th, float alpha_c,
    float kappa_c, float v_lo, float v_hi, int reset_sub, int quant,
    void* stream) {
  TickParams p{alpha, kappa, v_th, alpha_c, kappa_c, v_lo, v_hi, reset_sub,
               quant};
  TileIO io{};
  io.raster = raster; io.valid = valid;
  io.w_in = w_in; io.w_rec = w_rec; io.w_out = w_out;
  io.acc_out = acc_y; io.nspk_out = n_spk;
  TileDims d{T, B, N, H, O, bt, weights_smem, infer_all};
  const size_t smem =
      rsnn_tile_smem_floats(bt, N, H, O, weights_smem) * sizeof(float);
  int rc = rsnn_prepare_launch(rsnn_infer_kernel, smem, &threads);
  if (rc) return rc;
  const int blocks = (B + bt - 1) / bt;
  rsnn_infer_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(io, d, p);
  return (int)cudaGetLastError();
}

extern "C" int rsnn_step_sessions_launch(
    const float* raster, const float* live, const float* valid,
    const float* v0, const float* z0, const float* y0, const float* acc0,
    const float* nspk0, const float* w_in, const float* w_rec,
    const float* w_out, float* v, float* z, float* y, float* acc_y,
    float* n_spk, int T, int B, int N, int H, int O, int bt, int threads,
    int weights_smem, int infer_all, float alpha, float kappa, float v_th,
    float alpha_c, float kappa_c, float v_lo, float v_hi, int reset_sub,
    int quant, void* stream) {
  TickParams p{alpha, kappa, v_th, alpha_c, kappa_c, v_lo, v_hi, reset_sub,
               quant};
  TileIO io{};
  io.raster = raster; io.live = live; io.valid = valid;
  io.v0 = v0; io.z0 = z0; io.y0 = y0; io.acc0 = acc0; io.nspk0 = nspk0;
  io.w_in = w_in; io.w_rec = w_rec; io.w_out = w_out;
  io.v_out = v; io.z_out = z; io.y_out = y; io.acc_out = acc_y;
  io.nspk_out = n_spk;
  TileDims d{T, B, N, H, O, bt, weights_smem, infer_all};
  const size_t smem =
      rsnn_tile_smem_floats(bt, N, H, O, weights_smem) * sizeof(float);
  int rc = rsnn_prepare_launch(rsnn_step_sessions_kernel, smem, &threads);
  if (rc) return rc;
  const int blocks = (B + bt - 1) / bt;
  rsnn_step_sessions_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      io, d, p);
  return (int)cudaGetLastError();
}

extern "C" const char* rsnn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
