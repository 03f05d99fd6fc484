// flash_attention_bwd — the gradient of causal GQA attention, dQ, dK and dV
// from q (B, Sq, H, DK), k (B, Skv, Hkv, DK), v (B, Skv, Hkv, DV), the
// forward's output o and row log-sum-exp lse (o and dO DV wide), and dO:
// the backward of the LMs' training (DK = DV in GQA, DK = 192 and DV = 128
// in deepseek-v2's MLA; kernels/flash_attention.py:FlashAttentionFn).  It is the gradient JAX
// takes of src/repro/models/attention.py:49 blocked_attention with
// jax.grad; the Pallas kernel (src/repro/kernels/flash_attention.py) has
// no backward.  It builds into one library with the forward and the RSNN
// kernels.
//
// Function.  delta = rowsum(dO * o) (f32, a pre-pass), o the forward's f32
// output before its rounding: dQ = scale * sum_j P (dP - delta) k_j
// cancels when the keys share a large part (a cross-attention's memory
// does), and a bf16 o's rounding in delta would lead it; P = exp(S - lse)
// with S = q.k * scale, masked as the forward masks (keys after the
// query's position when causal); dV = P^T dO, dP = dO V^T, dS = P * (dP -
// delta), dQ = scale * dS K, dK = scale * dS^T Q; dK and dV summed over
// the G query heads of each KV head.  In bf16 P and dS are rounded to bf16
// as the tensor cores' A operands (the forward rounds p before p.V the
// same way); every sum is f32.
//
// Bound on the H100: the five products (S again, dV, dP, dQ, dK), 2 * B*H *
// (3 DK + 2 DV) * sum_q(valid keys) operations on bf16 tensor cores (989 TFLOP/s),
// against q, k, v, o, dO, lse read once and dq, dk, dv written once (3.35
// TB/s): set by operations at training lengths.
//
// bf16 (every model path), for Hopper: warp-specialised blocks of three
// warpgroups, a producer and two consumers.
//   * The producer warpgroup gives up its registers (setmaxnreg) and one
//     of its threads issues TMA loads (cp.async.bulk.tensor) into a ring
//     of shared-memory stages, each guarded by a full and an empty
//     mbarrier; the consumers wait on a stage's full barrier and release
//     it through its empty barrier.
//   * Every product is a wgmma.mma_async (m64nNk16, bf16 in, f32
//     accumulators): S and dP with both operands in shared memory, the
//     products with P or dS as the A operand straight from the score
//     accumulators (rounded to bf16, the fragment layouts agree), their B
//     operand (dO, Q or K rows, D-contiguous) MN-major through the
//     transpose bit.
//   * Shared-memory tiles are in the layout the TMA writes and the wgmma
//     descriptors read: rows of min(D, 64) elements in the 128-, 64- or
//     32-byte swizzle (a 128-wide row loads as two 64-wide column blocks).
//   * q, k, v and dO are read through 4-d tensor maps (D, heads, S, B)
//     with their real strides, built on the host for each call: a box
//     never crosses into the next batch's rows, and rows past S load as
//     zeros (masked keys and values load as zeros, so no NaN reaches the
//     sums).  The maps need 16-byte strides; the wrapper checks them.
//   * One launch of flash_bwd_kernel runs two walks, a block each:
//     - dK/dV blocks, a block a (batch * KV head, 128 keys), every block of
//       the first KV tile first (under the causal mask it sees the most
//       queries); each consumer owns 64 keys and keeps their dK and dV (64
//       x DK and 64 x DV f32) in registers while the block walks the q tiles
//       of 64 queries (32 at DK = 192: dK is then 96 registers a thread,
//       and halving the S^T and dP^T tiles keeps the consumer within its
//       240) of its G heads (from the diagonal on when causal), each
//       with its lse and delta: S^T = K Q^T, dP^T = V dO^T, then dV +=
//       P^T dO, dK += dS^T Q;
//     - then dQ blocks, a block a (batch, 128 queries, HB heads of one KV
//       head: two when G is even and DK <= 128, so that a k / v tile is
//       read once for both; at DK = 192 two heads' tiles would not fit),
//       the last queries first; each consumer owns 64 queries and
//       keeps their dQ for the HB heads in registers while the block walks
//       the KV tiles of 64 keys: S = Q K^T, dP = dO V^T, then dQ += dS K.
//     Neither walk reads what the other writes, so the dQ blocks fill the
//     SMs that the dK/dV walk's last blocks leave.
// S and dP are computed in both walks (7 products where the bound counts
// 5): the price of summing every output element in an order fixed by the
// shapes, with no atomics, so two launches give the same bits.  The
// pre-pass (flash_bwd_delta_bf16_kernel) writes delta and lse * log2(e)
// in a (B, H, sq_pad) layout padded to 128 positions, +inf past Sq, so
// that a query past Sq gets P = 0 without a mask.
//
// f32 (no model path): tensor-core f32 would be TF32, so CUDA-core
// versions of the two kernels, a thread a row of the block's tile.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

struct FlashBwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* o;    // (B, Sq, H, D) f32, contiguous: the forward's output
                     // before its rounding to q's dtype
  const void* dout;  // (B, Sq, H, D), contiguous
  const float* lse;  // (B, H, Sq)
  float* lse2;       // (B, H, sq_pad): lse * log2(e), +inf past Sq (pre-pass)
  float* delta;      // (B, H, sq_pad): rowsum(dO * o), 0 past Sq (pre-pass)
  void* dq;          // (B, Sq, H, D)
  void* dk;          // (B, Skv, Hkv, D)
  void* dv;          // (B, Skv, Hkv, D)
  int B, Sq, Skv, H, Hkv, causal, sq_pad;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float scale;
};

constexpr int FA_DELTA_ROWS = FA_THREADS / 32;  // f32 pre-pass heads a block

// The pre-pass: grid (B * Sq, heads / rows a block), so that a block's
// rows are heads of one (batch, position) and no thread divides a row
// index.  The thread that writes position pos of a (batch, head) also
// writes its padding rows Sq + pos, 2 Sq + pos, ... below sq_pad (lse2 =
// +inf, delta = 0).
__device__ __forceinline__ void delta_store(const FlashBwdArgs& a, int b, int pos, int h,
                                            float s) {
  const long long bh = (long long)b * a.H + h;
  a.delta[bh * a.sq_pad + pos] = s;
  a.lse2[bh * a.sq_pad + pos] = a.lse[bh * a.Sq + pos] * FA_LOG2E;
  for (int p = a.Sq + pos; p < a.sq_pad; p += a.Sq) {
    a.delta[bh * a.sq_pad + p] = 0.f;
    a.lse2[bh * a.sq_pad + p] = INFINITY;
  }
}

// f32: a warp a head.
__global__ void __launch_bounds__(FA_THREADS)
    flash_bwd_delta_f32_kernel(FlashBwdArgs a, int D) {
  const int b = blockIdx.x / a.Sq, pos = blockIdx.x % a.Sq;
  const int h = blockIdx.y * FA_DELTA_ROWS + threadIdx.x / 32;
  if (h >= a.H) return;
  const int lane = threadIdx.x & 31;
  const long long row = ((long long)blockIdx.x * a.H + h) * D;
  const float* o = a.o + row;
  const float* d = static_cast<const float*>(a.dout) + row;
  float s = 0.f;
  for (int c = lane; c < D; c += 32) s = fmaf(o[c], d[c], s);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) s += __shfl_xor_sync(0xffffffffu, s, w);
  if (lane == 0) delta_store(a, b, pos, h, s);
}

// bf16: D / 8 threads a head, 8 elements of o (32 bytes, f32) and of dO
// (16 bytes) each.
template <int D>
__host__ __device__ constexpr int delta_bf16_rows() {
  return FA_THREADS / (D / 8);
}

template <int D>
__global__ void __launch_bounds__(FA_THREADS)
    flash_bwd_delta_bf16_kernel(FlashBwdArgs a) {
  constexpr int TPR = D / 8;
  const int b = blockIdx.x / a.Sq, pos = blockIdx.x % a.Sq;
  const int h = blockIdx.y * delta_bf16_rows<D>() + threadIdx.x / TPR;
  const bool live = h < a.H;  // no early exit: shuffles follow
  const int c = threadIdx.x % TPR;
  float s = 0.f;
  if (live) {
    const long long at = ((long long)blockIdx.x * a.H + h) * D + c * 8;
    const float4 o0 = *reinterpret_cast<const float4*>(a.o + at);
    const float4 o1 = *reinterpret_cast<const float4*>(a.o + at + 4);
    const uint4 dv =
        *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(a.dout) + at);
    const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
    const float of[8] = {o0.x, o0.y, o0.z, o0.w, o1.x, o1.y, o1.z, o1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 df = __bfloat1622float2(d2[i]);
      s = fmaf(of[2 * i], df.x, s);
      s = fmaf(of[2 * i + 1], df.y, s);
    }
  }
#pragma unroll
  for (int w = TPR / 2; w > 0; w >>= 1) s += __shfl_xor_sync(0xffffffffu, s, w);
  if (live && c == 0) delta_store(a, b, pos, h, s);
}

// ---------------------------------------------------------------------------
// bf16: Hopper (TMA, mbarrier ring, wgmma)
// ---------------------------------------------------------------------------

constexpr int BWD_WG = 128;         // threads a warpgroup
constexpr int BWD_CONSUMERS = 2;    // consumer warpgroups a block
constexpr int BWD_THREADS = BWD_WG * (1 + BWD_CONSUMERS);
constexpr int BWD_ROWS = 64;        // a consumer's keys (dK/dV) or queries (dQ)
constexpr int BWD_BLOCK = BWD_ROWS * BWD_CONSUMERS;  // keys of a dK/dV block,
                                                     // queries of a dQ block
constexpr int BWD_KT = 64;          // keys of a dQ KV tile
constexpr int BWD_DKDV_STAGES = 3;  // q / dO tiles in flight
constexpr int BWD_DQ_STAGES = 3;    // k / v tiles in flight
constexpr int BWD_PRODUCER_REGS = 24;
constexpr int BWD_CONSUMER_REGS = 240;  // 128 x 24 + 256 x 240 <= 65,536

// `bytes` contiguous bytes (16-byte aligned) into shared memory, counted on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], "
      "%2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The bf16 kernels take the q / k head width DK and the v head width DV
// as separate parameters (the equal pairs and MLA's (192, 128) are
// instantiated): S and dQ, dK run over DK, dP and dV over DV.

// Queries of a dK/dV q tile, which is also the rows of every TMA box of
// the pair (kernels/flash_attention.py:bwd_q_tile).
template <int DK, int DV>
__host__ __device__ constexpr int bwd_qt() {
  return DK <= 128 ? 64 : 32;
}

// Heads of a dQ block at most (two when G is even).
template <int DK, int DV>
__host__ __device__ constexpr int bwd_max_hb() {
  return DK <= 128 ? 2 : 1;
}

//
// Shared memory of a dK/dV block, byte offsets from a 1024-byte aligned
// base (the 128-byte swizzle's period): the k and v tiles, the ring's q
// and dO tiles, their lse2 and delta rows, the barriers.
template <int DK, int DV>
struct DkdvSmem {
  static constexpr int ROWS = bwd_qt<DK, DV>();  // queries of a q tile
  static constexpr uint32_t KT = BWD_BLOCK * DK * 2, VT = BWD_BLOCK * DV * 2;
  static constexpr uint32_t QT = ROWS * DK * 2, OT = ROWS * DV * 2;
  static constexpr uint32_t K = 0, V = KT, Q = KT + VT;
  static constexpr uint32_t DO = Q + BWD_DKDV_STAGES * QT;
  static constexpr uint32_t LSE = DO + BWD_DKDV_STAGES * OT;
  static constexpr uint32_t DLT = LSE + BWD_DKDV_STAGES * ROWS * 4;
  static constexpr uint32_t BAR = DLT + BWD_DKDV_STAGES * ROWS * 4;
  static constexpr uint32_t BYTES = 1024 + BAR + 8 * (1 + 2 * BWD_DKDV_STAGES);
};

// Shared memory of a dQ block of HB heads: their q and dO tiles, the
// ring's k and v tiles, the barriers.
template <int DK, int DV, int HB>
struct DqSmem {
  static constexpr uint32_t QT = BWD_BLOCK * DK * 2, OT = BWD_BLOCK * DV * 2;
  static constexpr uint32_t KT = BWD_KT * DK * 2, VT = BWD_KT * DV * 2;
  static constexpr uint32_t Q = 0, DO = HB * QT, K = HB * (QT + OT);
  static constexpr uint32_t V = K + BWD_DQ_STAGES * KT;
  static constexpr uint32_t BAR = V + BWD_DQ_STAGES * VT;
  static constexpr uint32_t BYTES = 1024 + BAR + 8 * (1 + 2 * BWD_DQ_STAGES);
};

// dK and dV of keys [128 y, 128 y + 128) of KV head x % Hkv of batch
// x / Hkv.
template <int DK, int DV>
__device__ __forceinline__ void dkdv_block(const CUtensorMap* tm_q, const CUtensorMap* tm_k,
                                           const CUtensorMap* tm_v, const CUtensorMap* tm_do,
                                           const FlashBwdArgs& a, int x, int y) {
  using L = DkdvSmem<DK, DV>;
  using TK = SwTile<DK>;
  using TV = SwTile<DV>;
  constexpr int ST = BWD_DKDV_STAGES;
  constexpr int QT = L::ROWS;  // queries of a q tile, rows of a TMA box
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  const uint32_t raw = smem_addr(bwd_smem);
  const uint32_t sb = (raw + 1023) & ~1023u;
  const float* lse_s = reinterpret_cast<const float*>(bwd_smem + (sb - raw) + L::LSE);
  const float* dlt_s = reinterpret_cast<const float*>(bwd_smem + (sb - raw) + L::DLT);
  const uint32_t kv_full = sb + L::BAR;
  const uint32_t full0 = kv_full + 8, empty0 = full0 + 8 * ST;

  const int b = x / a.Hkv, hk = x % a.Hkv;
  const int k0 = y * BWD_BLOCK;
  const int G = a.H / a.Hkv;
  const int qt0 = a.causal ? k0 / QT : 0;  // q tiles before see no key here
  const int per_head = max((a.Sq + QT - 1) / QT - qt0, 0);
  const int n_it = G * per_head;  // iteration it: head hk G + it / per_head,
                                  // q tile qt0 + it % per_head
  const int wg = threadIdx.x / BWD_WG;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * BWD_CONSUMERS);  // a warp of each consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(BWD_PRODUCER_REGS));
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, L::KT + L::VT);
      tma_tile<DK, QT>(sb + L::K, tm_k, kv_full, BWD_BLOCK, hk, k0, b);
      tma_tile<DV, QT>(sb + L::V, tm_v, kv_full, BWD_BLOCK, hk, k0, b);
      for (int it = 0; it < n_it; ++it) {
        const int s = it % ST;
        const uint32_t full = full0 + 8 * s;
        mbar_wait(empty0 + 8 * s, ((it / ST) & 1) ^ 1);
        const int h = hk * G + it / per_head;
        const int q0 = (qt0 + it % per_head) * QT;
        mbar_expect_tx(full, L::QT + L::OT + 2 * QT * 4);
        tma_tile<DK, QT>(sb + L::Q + s * L::QT, tm_q, full, QT, h, q0, b);
        tma_tile<DV, QT>(sb + L::DO + s * L::OT, tm_do, full, QT, h, q0, b);
        const long long row = ((long long)b * a.H + h) * a.sq_pad + q0;
        bulk_load(sb + L::LSE + s * QT * 4, a.lse2 + row, QT * 4, full);
        bulk_load(sb + L::DLT + s * QT * 4, a.delta + row, QT * 4, full);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(BWD_CONSUMER_REGS));
  const int cw = wg - 1;
  const int t = threadIdx.x % BWD_WG;
  const int warp = t / 32, lane = t % 32, g = lane / 4, t4 = lane % 4;
  const int key_lo = k0 + cw * BWD_ROWS;
  const int key0 = key_lo + warp * 16 + g;  // key of fragment rows i < 2 (+8: i >= 2)
  const float sl2 = a.scale * FA_LOG2E;
  float dk[DK / 2], dv[DV / 2];
#pragma unroll
  for (int i = 0; i < DK / 2; ++i) dk[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) dv[i] = 0.f;
  mbar_wait(kv_full, 0);

  for (int it = 0; it < n_it; ++it) {
    const int s = it % ST;
    const int q0 = (qt0 + it % per_head) * QT;
    mbar_wait(full0 + 8 * s, (it / ST) & 1);
    const uint32_t qs = sb + L::Q + s * L::QT, dos = sb + L::DO + s * L::OT;
    float st[QT / 2], dp[QT / 2];  // S^T and dP^T: 64 keys x QT queries
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk)
      wgmma_ss(st, TK::kmajor(sb + L::K, BWD_BLOCK, cw * BWD_ROWS, kk),
               TK::kmajor(qs, QT, 0, kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DV / 16; ++kk)
      wgmma_ss(dp, TV::kmajor(sb + L::V, BWD_BLOCK, cw * BWD_ROWS, kk),
               TV::kmajor(dos, QT, 0, kk), kk);
    wgmma_commit();
    wgmma_wait<1>();
    reg_fence(st);
    // P^T = exp2(S^T scale log2(e) - lse2): rows keys, columns queries;
    // lse2 is +inf for queries past Sq
    const float* lt = lse_s + s * QT;
    const float* dl = dlt_s + s * QT;
    const bool edge = a.causal && key_lo + BWD_ROWS - 1 > q0;
#pragma unroll
    for (int j = 0; j < QT / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = j * 8 + t4 * 2 + (i & 1);
        const float p = fast_exp2(st[4 * j + i] * sl2 - lt[c]);
        st[4 * j + i] = edge && key0 + (i >> 1) * 8 > q0 + c ? 0.f : p;
      }
    wgmma_wait<0>();
    reg_fence(dp);
#pragma unroll
    for (int j = 0; j < QT / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dp[4 * j + i] = st[4 * j + i] * (dp[4 * j + i] - dl[j * 8 + t4 * 2 + (i & 1)]);
    // dV += P^T dO, dK += dS^T Q (k over the tile's QT queries)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk) {
      uint32_t af[4];
      a_frag(af, st, kk);
      wgmma_rs(dv, af, TV::mnmajor(dos, QT, kk), 1);
    }
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk) {
      uint32_t af[4];
      a_frag(af, dp, kk);
      wgmma_rs(dk, af, TK::mnmajor(qs, QT, kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(dv);
    reg_fence(dk);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);  // this warp is done with stage s
  }

  __nv_bfloat16* dkg = static_cast<__nv_bfloat16*>(a.dk);
  __nv_bfloat16* dvg = static_cast<__nv_bfloat16*>(a.dv);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + r * 8;
    if (key < a.Skv) {
      const long long row = ((long long)b * a.Skv + key) * a.Hkv + hk;
#pragma unroll
      for (int j = 0; j < DK / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dkg + row * DK + j * 8 + t4 * 2) =
            __floats2bfloat162_rn(dk[4 * j + 2 * r] * a.scale,
                                  dk[4 * j + 2 * r + 1] * a.scale);
#pragma unroll
      for (int j = 0; j < DV / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dvg + row * DV + j * 8 + t4 * 2) =
            __floats2bfloat162_rn(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
    }
  }
}

// dQ of queries [128 (n - 1 - y), ... + 128) (the last first) of heads
// HB x % (H / HB) .. + HB - 1 of batch x / (H / HB), of n q blocks.
template <int DK, int DV, int HB>
__device__ __forceinline__ void dq_block(const CUtensorMap* tm_q, const CUtensorMap* tm_k,
                                         const CUtensorMap* tm_v, const CUtensorMap* tm_do,
                                         const FlashBwdArgs& a, int x, int y, int n) {
  using L = DqSmem<DK, DV, HB>;
  using TK = SwTile<DK>;
  using TV = SwTile<DV>;
  constexpr int ST = BWD_DQ_STAGES;
  constexpr int BOX = bwd_qt<DK, DV>();  // rows of a TMA box
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  const uint32_t raw = smem_addr(bwd_smem);
  const uint32_t sb = (raw + 1023) & ~1023u;
  const uint32_t q_full = sb + L::BAR;
  const uint32_t full0 = q_full + 8, empty0 = full0 + 8 * ST;

  const int b = x / (a.H / HB);
  const int h0 = x % (a.H / HB) * HB;  // heads h0 .. h0 + HB - 1, one KV head
  const int hk = h0 / (a.H / a.Hkv);
  const int q0 = (n - 1 - y) * BWD_BLOCK;
  const int nq = min(BWD_BLOCK, a.Sq - q0);
  int n_kv = (a.Skv + BWD_KT - 1) / BWD_KT;
  if (a.causal) n_kv = min(n_kv, (q0 + nq - 1) / BWD_KT + 1);
  const int wg = threadIdx.x / BWD_WG;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * BWD_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(BWD_PRODUCER_REGS));
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, HB * (L::QT + L::OT));
      for (int j = 0; j < HB; ++j) {
        tma_tile<DK, BOX>(sb + L::Q + j * L::QT, tm_q, q_full, BWD_BLOCK, h0 + j, q0, b);
        tma_tile<DV, BOX>(sb + L::DO + j * L::OT, tm_do, q_full, BWD_BLOCK, h0 + j, q0, b);
      }
      for (int t = 0; t < n_kv; ++t) {
        const int s = t % ST;
        const uint32_t full = full0 + 8 * s;
        mbar_wait(empty0 + 8 * s, ((t / ST) & 1) ^ 1);
        mbar_expect_tx(full, L::KT + L::VT);
        tma_tile<DK, BOX>(sb + L::K + s * L::KT, tm_k, full, BWD_KT, hk, t * BWD_KT, b);
        tma_tile<DV, BOX>(sb + L::V + s * L::VT, tm_v, full, BWD_KT, hk, t * BWD_KT, b);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(BWD_CONSUMER_REGS));
  const int cw = wg - 1;
  const int t = threadIdx.x % BWD_WG;
  const int warp = t / 32, lane = t % 32, g = lane / 4, t4 = lane % 4;
  const int q_lo = q0 + cw * BWD_ROWS;
  const int row0 = q_lo + warp * 16 + g;  // query of fragment rows i < 2 (+8: i >= 2)
  const float sl2 = a.scale * FA_LOG2E;
  float lse2[HB][2], dlt[HB][2];  // rows past Sq: lse2 = +inf, so P = 0
#pragma unroll
  for (int j = 0; j < HB; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long at = ((long long)b * a.H + h0 + j) * a.sq_pad + row0 + r * 8;
      lse2[j][r] = a.lse2[at];
      dlt[j][r] = a.delta[at];
    }
  float dq[HB][DK / 2];
#pragma unroll
  for (int j = 0; j < HB; ++j)
#pragma unroll
    for (int i = 0; i < DK / 2; ++i) dq[j][i] = 0.f;
  mbar_wait(q_full, 0);

  for (int it = 0; it < n_kv; ++it) {
    const int s = it % ST;
    const int k0 = it * BWD_KT;
    mbar_wait(full0 + 8 * s, (it / ST) & 1);
    const uint32_t ks = sb + L::K + s * L::KT, vs = sb + L::V + s * L::VT;
    const bool edge =
        k0 + BWD_KT > a.Skv || (a.causal && k0 + BWD_KT - 1 > q_lo);
#pragma unroll
    for (int j = 0; j < HB; ++j) {  // the block's heads share the k and v tiles
      float st[BWD_KT / 2], dp[BWD_KT / 2];  // S and dP: 64 queries x BWD_KT keys
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk)
        wgmma_ss(st, TK::kmajor(sb + L::Q + j * L::QT, BWD_BLOCK, cw * BWD_ROWS, kk),
                 TK::kmajor(ks, BWD_KT, 0, kk), kk);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk)
        wgmma_ss(dp, TV::kmajor(sb + L::DO + j * L::OT, BWD_BLOCK, cw * BWD_ROWS, kk),
                 TV::kmajor(vs, BWD_KT, 0, kk), kk);
      wgmma_commit();
      wgmma_wait<1>();
      reg_fence(st);
#pragma unroll
      for (int c = 0; c < BWD_KT / 8; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = k0 + c * 8 + t4 * 2 + (i & 1);
          const float p = fast_exp2(st[4 * c + i] * sl2 - lse2[j][i >> 1]);
          const bool masked =
              key >= a.Skv || (a.causal && key > row0 + (i >> 1) * 8);
          st[4 * c + i] = edge && masked ? 0.f : p;
        }
      wgmma_wait<0>();
      reg_fence(dp);
#pragma unroll
      for (int c = 0; c < BWD_KT / 8; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          st[4 * c + i] *= dp[4 * c + i] - dlt[j][i >> 1];  // dS
      // dQ += dS K (k over the tile's keys)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BWD_KT / 16; ++kk) {
        uint32_t af[4];
        a_frag(af, st, kk);
        wgmma_rs(dq[j], af, TK::mnmajor(ks, BWD_KT, kk), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(dq[j]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
  }

  __nv_bfloat16* dqg = static_cast<__nv_bfloat16*>(a.dq);
#pragma unroll
  for (int j = 0; j < HB; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = row0 + r * 8;
      if (q < a.Sq) {
        __nv_bfloat16* row = dqg + ((long long)(b * a.Sq + q) * a.H + h0 + j) * DK;
#pragma unroll
        for (int c = 0; c < DK / 8; ++c)
          *reinterpret_cast<__nv_bfloat162*>(row + c * 8 + t4 * 2) =
              __floats2bfloat162_rn(dq[j][4 * c + 2 * r] * a.scale,
                                    dq[j][4 * c + 2 * r + 1] * a.scale);
      }
    }
}

// One launch runs both walks: blocks [0, dkdv_blocks) are dK/dV blocks
// (x fastest over dkdv_x = B * Hkv, so every block of KV tile 0 starts
// first), the rest dQ blocks (x fastest over B * H / HB, the last q
// blocks first).  Neither reads what the other writes, so the dQ blocks
// fill the SMs that the dK/dV walk's last blocks leave.
template <int DK, int DV, int HB>
__global__ void __launch_bounds__(BWD_THREADS, 1)
    flash_bwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do, FlashBwdArgs a,
                     int dkdv_blocks, int dq_tiles) {
  const int i = blockIdx.x;
  if (i < dkdv_blocks) {
    dkdv_block<DK, DV>(&tm_q, &tm_k, &tm_v, &tm_do, a, i % (a.B * a.Hkv), i / (a.B * a.Hkv));
  } else {
    const int j = i - dkdv_blocks, nx = a.B * a.H / HB;
    dq_block<DK, DV, HB>(&tm_q, &tm_k, &tm_v, &tm_do, a, j % nx, j / nx, dq_tiles);
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

// f32: a KV tile starting at k0 is seen by the q tiles from the diagonal
// on when causal; a q tile starting at q0 with nq rows sees these KV tiles.
__device__ __forceinline__ bool fa_bwd_valid(const FlashBwdArgs& a, int qpos,
                                             int kpos) {
  return qpos < a.Sq && kpos < a.Skv && (!a.causal || kpos <= qpos);
}

__device__ __forceinline__ int fa_first_q_tile(const FlashBwdArgs& a, int k0) {
  return a.causal ? k0 / FA_BQ : 0;
}

__device__ __forceinline__ int fa_bwd_key_tiles(const FlashBwdArgs& a, int q0,
                                                int nq) {
  int n_kv = (a.Skv + FA_BK - 1) / FA_BK;
  if (a.causal) n_kv = min(n_kv, (q0 + nq - 1) / FA_BK + 1);
  return n_kv;
}

// f32, CUDA cores: a thread owns one row of the block's tile (a key for
// dK/dV, a query for dQ) and half of its D outputs; scores are
// recomputed one at a time, staged in shared memory as P and dS, then
// summed into the thread's outputs.

template <int D>
constexpr size_t bwd_dkdv_f32_smem_bytes() {
  return ((size_t)4 * FA_BK * f32_pitch<D>() + 2 * FA_BQ * FA_PLD + 2 * FA_BQ) *
         sizeof(float);
}

template <int D>
constexpr size_t bwd_dq_f32_smem_bytes() {
  return ((size_t)4 * FA_BK * f32_pitch<D>() + FA_BQ * FA_PLD + 2 * FA_BQ) *
         sizeof(float);
}

// rows [r0, r0 + 64) of a (., D) f32 matrix at g (row stride ld) into a
// staged tile; rows at or past `limit` are zeros.
template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* g,
                                              long long ld, int r0, int limit,
                                              int tid) {
  for (int e = tid; e < FA_BK * D; e += FA_THREADS) {
    const int r = e / D, d = e % D;
    dst[r * f32_pitch<D>() + d] = r0 + r < limit ? g[(long long)(r0 + r) * ld + d] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(FA_THREADS)
    flash_bwd_dkdv_f32_kernel(FlashBwdArgs a) {
  constexpr int LD = f32_pitch<D>();
  constexpr int DH = D / 2;
  extern __shared__ __align__(16) unsigned char fa_smem[];
  float* ks = reinterpret_cast<float*>(fa_smem);
  float* vs = ks + FA_BK * LD;
  float* qs = vs + FA_BK * LD;
  float* dos = qs + FA_BQ * LD;
  float* ps = dos + FA_BQ * LD;
  float* dss = ps + FA_BQ * FA_PLD;
  float* lse_s = dss + FA_BQ * FA_PLD;
  float* dlt_s = lse_s + FA_BQ;

  const int tid = threadIdx.x;
  const int k0 = blockIdx.y * FA_BK;
  const int b = blockIdx.x / a.Hkv;
  const int hk = blockIdx.x % a.Hkv;
  const int G = a.H / a.Hkv;
  const int nqt = (a.Sq + FA_BQ - 1) / FA_BQ;
  load_tile_f32<D>(ks, static_cast<const float*>(a.k) + b * a.k_sb + hk * a.k_sh,
                   a.k_ss, k0, a.Skv, tid);
  load_tile_f32<D>(vs, static_cast<const float*>(a.v) + b * a.v_sb + hk * a.v_sh,
                   a.v_ss, k0, a.Skv, tid);

  const int j = tid >> 1;         // key row of the tile
  const int half = tid & 1;       // queries [32 half, +32); outputs [DH half, +DH)
  const int key = k0 + j;
  float dk[DH], dv[DH];
#pragma unroll
  for (int c = 0; c < DH; ++c) dk[c] = dv[c] = 0.f;

  for (int gi = 0; gi < G; ++gi) {
    const int h = hk * G + gi;
    for (int qt = fa_first_q_tile(a, k0); qt < nqt; ++qt) {
      const int q0 = qt * FA_BQ;
      __syncthreads();  // the last tile's sums are done with qs, dos, ps, dss
      load_tile_f32<D>(qs, static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh,
                       a.q_ss, q0, a.Sq, tid);
      load_tile_f32<D>(dos, static_cast<const float*>(a.dout) +
                                (long long)b * a.Sq * a.H * D + h * D,
                       (long long)a.H * D, q0, a.Sq, tid);
      {
        const int r = tid % FA_BQ;
        const long long bh = (long long)b * a.H + h;
        const bool in = q0 + r < a.Sq;
        if (tid < FA_BQ) lse_s[r] = in ? a.lse[bh * a.Sq + q0 + r] : 0.f;
        else dlt_s[r] = in ? a.delta[bh * a.sq_pad + q0 + r] : 0.f;
      }
      __syncthreads();
      for (int ii = 0; ii < FA_BQ / 2; ++ii) {
        const int i = half * (FA_BQ / 2) + ii;
        float s = 0.f, dp = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) {
          s = fmaf(ks[j * LD + d], qs[i * LD + d], s);
          dp = fmaf(vs[j * LD + d], dos[i * LD + d], dp);
        }
        const float p =
            fa_bwd_valid(a, q0 + i, key) ? expf(s * a.scale - lse_s[i]) : 0.f;
        ps[j * FA_PLD + i] = p;
        dss[j * FA_PLD + i] = p * (dp - dlt_s[i]);
      }
      __syncthreads();
      for (int i = 0; i < FA_BQ; ++i) {
        const float p = ps[j * FA_PLD + i], ds = dss[j * FA_PLD + i];
#pragma unroll
        for (int c = 0; c < DH; ++c) {
          dv[c] = fmaf(p, dos[i * LD + half * DH + c], dv[c]);
          dk[c] = fmaf(ds, qs[i * LD + half * DH + c], dk[c]);
        }
      }
    }
  }
  if (key < a.Skv) {
    const long long row = (((long long)b * a.Skv + key) * a.Hkv + hk) * D + half * DH;
    float* dkg = static_cast<float*>(a.dk) + row;
    float* dvg = static_cast<float*>(a.dv) + row;
#pragma unroll
    for (int c = 0; c < DH; ++c) {
      dkg[c] = dk[c] * a.scale;
      dvg[c] = dv[c];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(FA_THREADS)
    flash_bwd_dq_f32_kernel(FlashBwdArgs a) {
  constexpr int LD = f32_pitch<D>();
  constexpr int DH = D / 2;
  extern __shared__ __align__(16) unsigned char fa_smem[];
  float* qs = reinterpret_cast<float*>(fa_smem);
  float* dos = qs + FA_BQ * LD;
  float* ks = dos + FA_BQ * LD;
  float* vs = ks + FA_BK * LD;
  float* dss = vs + FA_BK * LD;
  float* lse_s = dss + FA_BQ * FA_PLD;
  float* dlt_s = lse_s + FA_BQ;

  const int tid = threadIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * FA_BQ;
  const int b = blockIdx.x / a.H;
  const int h = blockIdx.x % a.H;
  const int hk = h / (a.H / a.Hkv);
  const int nq = min(FA_BQ, a.Sq - q0);
  const float* kg = static_cast<const float*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const float* vg = static_cast<const float*>(a.v) + b * a.v_sb + hk * a.v_sh;
  load_tile_f32<D>(qs, static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh,
                   a.q_ss, q0, a.Sq, tid);
  load_tile_f32<D>(dos, static_cast<const float*>(a.dout) +
                            (long long)b * a.Sq * a.H * D + h * D,
                   (long long)a.H * D, q0, a.Sq, tid);
  {
    const int r = tid % FA_BQ;
    const long long bh = (long long)b * a.H + h;
    const bool in = r < nq;
    if (tid < FA_BQ) lse_s[r] = in ? a.lse[bh * a.Sq + q0 + r] : 0.f;
    else dlt_s[r] = in ? a.delta[bh * a.sq_pad + q0 + r] : 0.f;
  }

  const int i = tid >> 1;    // query row of the tile
  const int half = tid & 1;  // keys [32 half, +32); outputs [DH half, +DH)
  float dq[DH];
#pragma unroll
  for (int c = 0; c < DH; ++c) dq[c] = 0.f;

  const int n_kv = fa_bwd_key_tiles(a, q0, nq);
  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * FA_BK;
    __syncthreads();  // the last tile's sums are done with ks, vs, dss
    load_tile_f32<D>(ks, kg, a.k_ss, k0, a.Skv, tid);
    load_tile_f32<D>(vs, vg, a.v_ss, k0, a.Skv, tid);
    __syncthreads();
    for (int jj = 0; jj < FA_BK / 2; ++jj) {
      const int jk = half * (FA_BK / 2) + jj;
      float s = 0.f, dp = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        s = fmaf(qs[i * LD + d], ks[jk * LD + d], s);
        dp = fmaf(dos[i * LD + d], vs[jk * LD + d], dp);
      }
      const float p =
          fa_bwd_valid(a, q0 + i, k0 + jk) ? expf(s * a.scale - lse_s[i]) : 0.f;
      dss[i * FA_PLD + jk] = p * (dp - dlt_s[i]);
    }
    __syncthreads();
    for (int jk = 0; jk < FA_BK; ++jk) {
      const float ds = dss[i * FA_PLD + jk];
#pragma unroll
      for (int c = 0; c < DH; ++c) dq[c] = fmaf(ds, ks[jk * LD + half * DH + c], dq[c]);
    }
  }
  if (i < nq) {
    float* row = static_cast<float*>(a.dq) +
                 ((long long)(b * a.Sq + q0 + i) * a.H + h) * D + half * DH;
#pragma unroll
    for (int c = 0; c < DH; ++c) row[c] = dq[c] * a.scale;
  }
}


// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename Kernel, typename... Args>
int launch_bwd_kernel(Kernel kernel, dim3 grid, int threads, size_t smem,
                      cudaStream_t stream, const Args&... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// The plan (kernels/flash_attention.py:flash_bwd_plan) gives the grids,
// threads, shared memory and lse2 / delta padding; a plan that is not this
// layout's is refused.
struct BwdPlan {
  int delta_grid, dkdv_tiles, dq_tiles, dq_heads, threads;
  size_t dkdv_smem, dq_smem;
};

// f32 (DK == DV only): the pre-pass and two CUDA-core kernels.
template <int D>
int launch_bwd_f32(const FlashBwdArgs& a, const BwdPlan& p, dim3 g_delta, dim3 g_dkdv,
                   dim3 g_dq, cudaStream_t st) {
  if (p.dkdv_smem != bwd_dkdv_f32_smem_bytes<D>() || p.dq_smem != bwd_dq_f32_smem_bytes<D>())
    return (int)cudaErrorInvalidValue;
  flash_bwd_delta_f32_kernel<<<g_delta, FA_THREADS, 0, st>>>(a, D);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  rc = launch_bwd_kernel(flash_bwd_dkdv_f32_kernel<D>, g_dkdv, FA_THREADS, p.dkdv_smem, st,
                         a);
  if (rc) return rc;
  return launch_bwd_kernel(flash_bwd_dq_f32_kernel<D>, g_dq, FA_THREADS, p.dq_smem, st, a);
}

template <int DK, int DV>
int launch_bwd_d(const FlashBwdArgs& a, int bf16, const BwdPlan& p,
                 cudaStream_t st) {
  constexpr int QT = bwd_qt<DK, DV>();
  const int key_tile = bf16 ? BWD_BLOCK : FA_BK, q_tile = bf16 ? BWD_BLOCK : FA_BQ;
  // bf16: a dQ block takes two heads of a KV head's group when G is even
  // and the pair's tiles fit
  const int hb = bf16 && a.H / a.Hkv % 2 == 0 ? bwd_max_hb<DK, DV>() : 1;
  const int delta_rows = bf16 ? delta_bf16_rows<DV>() : FA_DELTA_ROWS;
  if (p.threads != (bf16 ? BWD_THREADS : FA_THREADS) ||
      a.sq_pad != (a.Sq + BWD_BLOCK - 1) / BWD_BLOCK * BWD_BLOCK ||
      p.delta_grid != (a.H + delta_rows - 1) / delta_rows ||
      p.dkdv_tiles != (a.Skv + key_tile - 1) / key_tile ||
      p.dq_tiles != (a.Sq + q_tile - 1) / q_tile || p.dq_heads != hb) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 g_delta(a.B * a.Sq, p.delta_grid);
  const dim3 g_dkdv(a.B * a.Hkv, p.dkdv_tiles), g_dq(a.B * a.H / hb, p.dq_tiles);
  if (!bf16) {
    if constexpr (DK == DV) return launch_bwd_f32<DK>(a, p, g_delta, g_dkdv, g_dq, st);
    return (int)cudaErrorInvalidValue;
  }
  const size_t need_dq = hb == 2 ? DqSmem<DK, DV, 2>::BYTES : DqSmem<DK, DV, 1>::BYTES;
  if (p.dkdv_smem != DkdvSmem<DK, DV>::BYTES || p.dq_smem != need_dq)
    return (int)cudaErrorInvalidValue;
  alignas(64) CUtensorMap tq, tk, tv, tdo;
  const long long do_ss = (long long)a.H * DV;
  int rc = tensor_map<DK, QT>(&tq, a.q, a.Sq, a.H, a.B, a.q_ss, a.q_sh, a.q_sb);
  if (!rc) rc = tensor_map<DK, QT>(&tk, a.k, a.Skv, a.Hkv, a.B, a.k_ss, a.k_sh, a.k_sb);
  if (!rc) rc = tensor_map<DV, QT>(&tv, a.v, a.Skv, a.Hkv, a.B, a.v_ss, a.v_sh, a.v_sb);
  if (!rc)
    rc = tensor_map<DV, QT>(&tdo, a.dout, a.Sq, a.H, a.B, do_ss, DV, do_ss * a.Sq);
  if (rc) return rc;
  flash_bwd_delta_bf16_kernel<DV><<<g_delta, FA_THREADS, 0, st>>>(a);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  const int dkdv_blocks = g_dkdv.x * g_dkdv.y;
  const dim3 grid(dkdv_blocks + g_dq.x * g_dq.y);
  const size_t smem = p.dkdv_smem > p.dq_smem ? p.dkdv_smem : p.dq_smem;
  if constexpr (bwd_max_hb<DK, DV>() == 2) {
    if (hb == 2)
      return launch_bwd_kernel(flash_bwd_kernel<DK, DV, 2>, grid, BWD_THREADS, smem, st, tq,
                               tk, tv, tdo, a, dkdv_blocks, p.dq_tiles);
  }
  return launch_bwd_kernel(flash_bwd_kernel<DK, DV, 1>, grid, BWD_THREADS, smem, st, tq, tk,
                           tv, tdo, a, dkdv_blocks, p.dq_tiles);
}

}  // namespace

extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const float* o,
    const void* dout, const float* lse, float* lse2, float* delta, void* dq,
    void* dk, void* dv, int bf16, int B, int Sq, int Skv, int H, int Hkv, int D, int DV,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, int causal, float scale, int sq_pad, int delta_grid,
    int dkdv_tiles, int dq_tiles, int dq_heads, int threads, long long dkdv_smem,
    long long dq_smem, void* stream) {
  FlashBwdArgs a{q,    k,    v,    o,    dout, lse,  lse2, delta, dq,   dk,
                 dv,   B,    Sq,   Skv,  H,    Hkv,  causal, sq_pad, q_sb, q_ss,
                 q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale};
  const BwdPlan p{delta_grid, dkdv_tiles, dq_tiles, dq_heads, threads,
                  (size_t)dkdv_smem, (size_t)dq_smem};
  cudaStream_t st = (cudaStream_t)stream;
  // the (q/k, v) width pairs of kernels/flash_attention.py:KERNEL_HEAD_DIMS
  if (D == 192 && DV == 128) return launch_bwd_d<192, 128>(a, bf16, p, st);
  if (D != DV) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 16: return launch_bwd_d<16, 16>(a, bf16, p, st);
    case 32: return launch_bwd_d<32, 32>(a, bf16, p, st);
    case 64: return launch_bwd_d<64, 64>(a, bf16, p, st);
    case 128: return launch_bwd_d<128, 128>(a, bf16, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
