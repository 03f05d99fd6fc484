// The training kernels, built into one library with the serving kernels of
// rsnn_serve.cu.  rsnn_forward, rsnn_train and rsnn_train_exact (exact-mode
// e-prop, its design in rsnn_train.cuh) run the
// warp-per-row event loop of rsnn_tick.cuh (the serving kernels run the
// same loop) and share their forward pieces (rsnn_input_current_items,
// rsnn_row_lif, rsnn_readout_sum, rsnn_leak_out, rsnn_tick_error, and
// rsnn_train and rsnn_train_exact the mbarrier and cluster pieces);
// eprop_update and rsnn_train's device-scratch route share the dw rows
// kernel (rsnn_dw_elem).
//
// rsnn_forward_kernel — the trace-streaming forward behind the backend's
// forward_traces and dynamics ops.  Replaces src/repro/kernels/rsnn_step.py:
// _kernel and :_forward_dma_kernel (wrapper rsnn_forward).  Writes seven
// (T, B, .) tensors: z, h, xbar, pbar, zbar, y and the post-reset v.  It is
// rsnn_train's forward without the readout error, for up to 16 rows a
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
// _train_kernel and :_train_dma_kernel (wrapper rsnn_train).  A batch row
// runs on a thread-block cluster of 1, 2, 4 or 8 blocks of 512 threads
// (kernels/rsnn_step.py:train_plan: one block a row at the END_B tile,
// eight at END_S's one row).  Block 0 of a cluster, the leader, stages
// the weights, the valid mask and the row's raster, and its warps sum
// every tick's input current over its input events (rsnn_input_currents;
// summed beside the chain instead, a tick block ahead of it, they slowed
// the chain by more than they took before it); then its warps take roles
// that hand each tick block of `ticks` ticks on through mbarriers (no
// block barrier inside a tick loop):
//   warp 0, the LIF chain: rsnn_row_lif<ROW_TRACES> a tick block at a time
//     from the carries in its registers, writing h and the spike masks
//     alone, then an arrive on the block's "chained" barrier;
//   warps 1-2, the readout behind the chain: the block's readout currents,
//     the LI leak (y and acc_y carried in registers), the readout error
//     (rsnn_tick_error);
//   warp 3, the xbar filter, a lane per input, ahead of the chain (in
//     place over the raster);
//   warps 5-7, 9-11, 13-15, the pbar and zbar filters behind the chain, a
//     thread per neuron, from the spike masks; warps 4, 8 and 12 (the
//     chain's scheduler) stay idle.
// The other blocks of the cluster mirror the leader's h, pbar, xbar and
// err a tick block at a time (distributed shared memory, the cluster
// address from cg::cluster_group::map_shared_rank), once the readout,
// xbar and filter warps have arrived on their "ready" barrier for it, and
// sum each block's learning signal l = err.B_fb^T beside the chain.  Then
// the reverse pass: one thread per neuron walks the ticks backwards
// through F = l + kappa*F and stores G = h*F over h (rsnn_train_f_walk_l;
// a one-block row sums l as it walks, rsnn_train_f_walk), and the dw
// sums (rsnn_train_dw: an element a thread where a block's share fits
// its threads, else 2 x 2 tiles), each element over t = T-1..0 by one
// thread: in a cluster the leader sums dw_out (zbar and err, no G)
// and the other blocks share dw_in and dw_rec.  Every value is the one the
// contract's order gives, the same operations on the same operands in the
// same order, so the outputs do not depend on the layout (cluster,
// ticks).  Also writes acc_y (B, O) and the valid-masked n_spk (B, 1): in
// quantized mode acc_y, n_spk and the traces equal the plain version's
// bit for bit.
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
// partial is that sample's B=1 dw (whatever cluster train_plan gives a row
// at this B, each element is summed by one thread in the same order), and
// integer addition is associative, so the codes of any split of the rows
// sum to the codes of the whole batch: a commit does not depend on how
// many ranks share its batch.
//
// Design.  On the TPU the trace set of a batch tile stays in VMEM.  One
// row's set takes T*(3H+N+O)*4 bytes: 66 KB at Braille T=128, so it fits
// the 227 KB a block may hold beside the weights, the barriers, the valid
// mask and the spike masks, and every role works in shared memory (the
// row's raster is copied in first; the xbar filter turns it into xbar in
// place, and the input currents are parked in the h slots that the chain
// overwrites).  Where the set does not fit (the 256/256/16 chip-maximum
// net at T=128 takes 532 KB, Braille past T=424), the same roles run on a
// (T, B, .) scratch in device memory, one block a row, and the dw sums run
// as a second kernel over one thread per (dw element, row).  Each row
// writes its partial dw to its own slice of a (B, E) buffer, and
// rsnn_dw_reduce_kernel adds the slices in row order: no atomics, two
// launches give identical bits.
//
// Bound on the H100: the LIF loop is a serial chain, some hundreds of
// cycles a tick; its event-driven sums do 2*H multiply-adds per input
// event and per spike of the last tick, and the readout 2*O per spike
// (kernels/traffic.py:forward_event_flops); the reverse pass does
// 2*T*B*(E + H*O) multiply-adds (E = N*H + H*H + H*O) out of shared memory.
// The chain sets the pace when the roles beside it take less time a tick
// block than it does, and what follows it is short: the F walk (T steps of
// F's two-operation chain a neuron) and a share of the dw sums.  The
// roles' clocks (TrainArgs::clocks) show it.  rsnn_forward's seven streams make it
// bytes-bound on paper (traffic.forward_traces_bytes), but the chain sets
// its pace too.  The feedback b_fb is in normalised weight units (the raw
// w_out or the random B), and the error is taken on y * y_scale
// (1/threshold in quantized mode).
//
// Surrogate.  h is the config's pseudo-derivative: the boxcar, or Bellec's
// triangular (rsnn_tick.cuh:rsnn_triangular), as the reference's scan
// backend takes it (its TPU kernels take the boxcar whatever the config
// says).  The surrogate is a template argument of rsnn_row_lif and of each
// kernel's body (rsnn_train.cuh: rsnn_train_row, rsnn_train_exact_row,
// rsnn_forward_rows); each surrogate's kernels are __global__s of their own
// names, the boxcar's here (rsnn_train_kernel, rsnn_train_exact_kernel,
// rsnn_forward_kernel), the triangular's in rsnn_train_tri.cu (the same
// names with _tri), so the boxcar kernels keep their names and
// instructions and the two sets compile side by side.  h is a float stream
// either way and nothing skips work on h == 0: the triangular h costs a
// few operations a neuron-tick in the LIF loop.
#include "rsnn_train.cuh"

// The three trace kernels under the boxcar surrogate (the triangular's are
// in rsnn_train_tri.cu).
template <int W, bool SMEM_TRACES>
__global__ void __launch_bounds__(RSNN_TRAIN_THREADS, 1)
    rsnn_train_kernel(TrainArgs a, TickParams p) {
  rsnn_train_row<W, SMEM_TRACES, false>(a, p);
}

template <int W>
__global__ void __launch_bounds__(RSNN_EXACT_THREADS, 1)
    rsnn_train_exact_kernel(ExactArgs a, TickParams p) {
  rsnn_train_exact_row<W, false>(a, p);
}

template <int W>
__global__ void rsnn_forward_kernel(ForwardArgs a, TickParams p) {
  rsnn_forward_rows<W, false>(a, p);
}

template <>
struct RsnnTraceKernels<false> {
  template <int W, bool SMEM_TRACES>
  static auto train() { return rsnn_train_kernel<W, SMEM_TRACES>; }
  template <int W>
  static auto exact() { return rsnn_train_exact_kernel<W>; }
  template <int W>
  static auto forward() { return rsnn_forward_kernel<W>; }
};

// The triangular surrogate's dispatch, instantiated in rsnn_train_tri.cu.
extern template int rsnn_forward_dispatch<true>(const ForwardArgs&, const TickParams&, int,
                                                size_t, cudaStream_t);
extern template int rsnn_train_dispatch<true>(const TrainArgs&, const TickParams&, int,
                                              size_t, cudaStream_t);
extern template int rsnn_train_exact_dispatch<true>(const ExactArgs&, const TickParams&,
                                                    size_t, cudaStream_t);

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
    float bw_vth, int tri, float gamma, float inv_vth, void* stream) {
  if (T < 1 || B < 1 || O > RSNN_MAX_OUT || N > 32 * RSNN_MAX_WORDS ||
      H > 32 * RSNN_MAX_WORDS || rows < 1 || threads % 32 ||
      threads < 32 * (rows + 1) || Tl < 1 || Tl > T || (rows_smem && Tl != T) ||
      (size_t)smem_bytes != rsnn_forward_smem_words(rows, T, Tl, N, H, O,
                                                    weights_smem, rows_smem) *
                                sizeof(float)) {
    return (int)cudaErrorInvalidValue;
  }
  TickParams p{alpha, kappa, v_th, alpha_c, kappa_c, v_lo, v_hi, reset_sub,
               quant, bw_vth, 1.f, 0.f, 0, gamma, inv_vth};
  const ForwardArgs a{raster, w_in, w_rec, w_out, z, h, xbar, pbar, zbar, y, v,
                      T, B, N, H, O, rows, Tl, weights_smem, rows_smem};
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = (size_t)smem_bytes;
  return tri ? rsnn_forward_dispatch<true>(a, p, threads, smem, st)
             : rsnn_forward_dispatch<false>(a, p, threads, smem, st);
}

// The plan (threads, cluster, ticks, weights_smem, traces_smem,
// smem_bytes) is the wrapper's (kernels/rsnn_step.py:train_plan); the
// launch is refused unless it is a layout of this kernel: its threads, a
// cluster of 1, 2, 4 or 8 blocks a row (more than one only with the trace
// set in shared memory, which the other blocks mirror), tick blocks of at
// least one tick, the shared-memory bytes of those choices.  commit_lsb 0
// sums the rows' dw in float into dw; commit_lsb > 0 sums their codes on
// the grid of commit_bits bits and step commit_lsb into dw_codes instead.
// clocks: null, or where the kernel records its roles' clocks
// (TrainArgs::clocks).
extern "C" int rsnn_train_launch(
    const float* raster, const float* y_star, const float* valid,
    const float* w_in, const float* w_rec, const float* w_out,
    const float* b_fb, float* tr_h, float* tr_xbar, float* tr_pbar,
    float* tr_zbar, float* tr_err, float* g, float* dw_part, float* dw,
    int* dw_codes, float* acc_y, float* n_spk, int T, int B, int N, int H,
    int O, int threads, int cluster, int ticks, int weights_smem, int traces_smem,
    int infer_all, long long smem_bytes, float alpha, float kappa, float v_th,
    float alpha_c, float kappa_c, float v_lo, float v_hi, int reset_sub,
    int quant, float bw_vth, int tri, float gamma, float inv_vth, float y_scale,
    float target_amp, int err_softmax, float commit_lsb, int commit_bits,
    long long* clocks, void* stream) {
  const bool grid = commit_lsb > 0.f;
  if (T < 1 || B < 1 || O < 1 || O > RSNN_MAX_OUT || N < 1 || H < 1 ||
      N > 32 * RSNN_MAX_WORDS || H > 32 * RSNN_MAX_WORDS ||
      (!traces_smem && !tr_h) || (traces_smem && !weights_smem) ||
      threads != RSNN_TRAIN_THREADS ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) ||
      (cluster > 1 && !traces_smem) || ticks < 1 ||
      (long long)B * cluster > 0x7fffffffLL ||
      (size_t)smem_bytes != rsnn_train_smem_floats(T, N, H, O, ticks, weights_smem,
                                                   traces_smem) * sizeof(float) ||
      (grid ? (!dw_codes || commit_bits < 2 || commit_bits > 24) : !dw)) {
    return (int)cudaErrorInvalidValue;
  }
  TickParams p{alpha, kappa, v_th, alpha_c, kappa_c, v_lo, v_hi, reset_sub,
               quant, bw_vth, y_scale, target_amp, err_softmax, gamma, inv_vth};
  TrainArgs a{raster, y_star, valid, w_in, w_rec, w_out, b_fb, tr_h, tr_xbar,
              tr_pbar, tr_zbar, tr_err, g, dw_part, acc_y, n_spk,
              T, B, N, H, O, cluster, ticks, weights_smem, infer_all, clocks};
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = (size_t)smem_bytes;
  int rc = tri ? rsnn_train_dispatch<true>(a, p, traces_smem, smem, st)
               : rsnn_train_dispatch<false>(a, p, traces_smem, smem, st);
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

// As rsnn_train_launch, with alpha (H) the neurons' decays and, in place
// of the trace buffers, the plan's layout (kernels/rsnn_step.py:
// train_exact_plan): `cluster` blocks a cluster and `groups` clusters a row,
// `slots` ring slots of `ticks` ticks, `inputs` input warps in the leader
// block, g_in, g_rec, g_out walker threads a neuron for the
// input, recurrent and readout lines and k lines a thread; the launch is
// refused unless the layout covers every synapse within k lines a thread
// (a power of two up to RSNN_EXACT_KMAX) and smem_bytes is this kernel's for it.  clocks: null, or
// where the kernel records its roles' clocks (ExactArgs::clocks).
extern "C" int rsnn_train_exact_launch(
    const float* raster, const float* y_star, const float* valid,
    const float* w_in, const float* w_rec, const float* w_out,
    const float* b_fb, const float* alpha, float* dw_part, float* dw,
    int* dw_codes, float* acc_y, float* n_spk, int T, int B, int N, int H,
    int O, int threads, int cluster, int groups, int slots, int ticks, int inputs,
    int g_in, int g_rec, int g_out, int k, int weights_smem, int infer_all,
    long long smem_bytes, float alpha_f, float kappa, float v_th,
    float alpha_c, float kappa_c, float v_lo, float v_hi, int reset_sub,
    int quant, float bw_vth, int tri, float gamma, float inv_vth, float y_scale,
    float target_amp, int err_softmax, float commit_lsb, int commit_bits,
    long long* clocks, void* stream) {
  const bool grid = commit_lsb > 0.f;
  const int nwarps = RSNN_EXACT_THREADS / 32;
  const long long walkers =
      32LL * groups * ((cluster - 1) * nwarps +
                       rsnn_exact_leader_walkers(nwarps, rsnn_exact_role_warps(inputs)));
  if (T < 1 || B < 1 || O < 1 || O > RSNN_MAX_OUT || N < 1 || H < 1 ||
      N > 32 * RSNN_MAX_WORDS || H > 32 * RSNN_MAX_WORDS || !alpha ||
      threads != RSNN_EXACT_THREADS || (cluster != 1 && cluster != 2 && cluster != 4 &&
                                        cluster != 8) ||
      groups < 1 || slots < 1 || slots > RSNN_EXACT_MAX_SLOTS || ticks < 1 ||
      ticks > RSNN_EXACT_MAX_TICKS || inputs < 1 ||
      32 * rsnn_exact_role_warps(inputs) >= RSNN_EXACT_THREADS || k < 1 ||
      k > RSNN_EXACT_KMAX || (k & (k - 1)) || g_in < 1 || g_rec < 1 || g_out < 1 ||
      (long long)g_in * k < N || (long long)g_rec * k < H || (long long)g_out * k < O ||
      (long long)H * (g_in + g_rec + g_out) > walkers ||
      (long long)B * groups * cluster > 0x7fffffffLL ||
      (size_t)smem_bytes != rsnn_exact_smem_words(N, H, O, slots, ticks, weights_smem) *
                                sizeof(float) ||
      (grid ? (!dw_codes || commit_bits < 2 || commit_bits > 24) : !dw)) {
    return (int)cudaErrorInvalidValue;
  }
  TickParams p{alpha_f, kappa, v_th, alpha_c, kappa_c, v_lo, v_hi, reset_sub,
               quant, bw_vth, y_scale, target_amp, err_softmax, gamma, inv_vth};
  const ExactArgs a{raster, y_star, valid, w_in, w_rec, w_out, b_fb, alpha, dw_part,
                    acc_y, n_spk, T, B, N, H, O, cluster, groups, slots, ticks, inputs,
                    g_in, g_rec, g_out, k, weights_smem, infer_all, clocks};
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = (size_t)smem_bytes;
  int rc = tri ? rsnn_train_exact_dispatch<true>(a, p, smem, st)
               : rsnn_train_exact_dispatch<false>(a, p, smem, st);
  if (rc) return rc;
  const int e_all = N * H + H * H + H * O;
  return grid ? rsnn_reduce_codes(dw_part, B, e_all, commit_lsb, commit_bits,
                                  dw_codes, st)
              : rsnn_reduce_dw(dw_part, B, e_all, dw, st);
}
