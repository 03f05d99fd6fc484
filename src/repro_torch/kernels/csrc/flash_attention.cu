// flash_attention — causal GQA online-softmax attention over q (B, Sq, H, DK),
// k (B, Skv, Hkv, DK) and v (B, Skv, Hkv, DV), behind the prefill of every
// attention layer of the LMs (models/attention.py:blocked_attention; DK = DV
// in GQA, DK = 192 and DV = 128 in deepseek-v2's MLA), cross-attention's
// decode rows and, in its variant that also writes each row's log-sum-exp
// and, in bf16, the output before its rounding (the backward's rowsum(dO *
// o) takes it: a rounded o there can lead a gradient that cancels, such as
// cross-attention's dQ over a memory whose keys share a large part), behind
// the forward of training; flash_attention_bwd.cu holds the training's
// backward.  Replaces src/repro/kernels/flash_attention.py:_kernel (wrapper
// flash_attention); it builds into one library with the RSNN kernels.
//
// Function: the Pallas kernel's, with blocked_attention's padding rule.
// Scores q.k * scale with the products summed in f32; keys at positions
// >= kv_len, and keys after the query's position when causal, masked at
// -1e30 (their p is an exact zero); running max m, running sum l and the
// output accumulator in f32; p rounded to the value dtype before the p.V
// product; output in q's dtype, divided by max(l, 1e-30).  Key tiles wholly
// above the diagonal or past kv_len are skipped (the Pallas kernel's
// pl.when skip): their terms are exact zeros, since every row has seen key
// 0 in the first tile.  Masked keys and values load as zeros, so NaN in an
// unfilled cache tail cannot reach the sums.
//
// Bound on the H100: 2*B*H*(DK + DV)*sum_q(valid keys) operations on bf16
// tensor cores (989 TFLOP/s) against q, k, v read once and o written once
// (3.35 TB/s) — set by operations at prefill lengths, by bytes for a
// decode row (one query against the whole memory).
//
// bf16 (every model path), for Hopper: flash_fwd_kernel, built from the
// pieces the backward uses (flash_common.cuh).  What bounds it is the
// tensor cores at prefill and the exp2 of the softmax at D = 64 (a tile's
// exponentials take as long as its products there); its design keeps the
// tensor cores fed:
//   * Persistent warp-specialised blocks, one an SM, of three warpgroups: a
//     producer and two consumers.  A tile is 128 queries of one (batch,
//     head); tile i is q tile n_qt - 1 - i / (B * H) of batch * head i % (B
//     * H), so every head's last q tile (under the causal mask the one
//     with the most keys) comes before any head's second to last, and the
//     heads of a KV head run side by side (their k and v tiles meet in
//     L2).  Block x takes one tile a round, the rounds running over the
//     blocks forwards and backwards in turn, so that the blocks' sums of
//     key tiles come out even.
//   * The producer gives up its registers (setmaxnreg) and one of its
//     threads issues the TMA loads (cp.async.bulk.tensor): a tile's q once
//     (a full and an empty mbarrier), then its k and v tiles of 128 keys
//     into a ring of FWD_STAGES shared-memory stages, k and v each with a
//     full and an empty mbarrier.  The ring's stages and phases run on
//     from one tile to the next, so the next tile's q and first k / v
//     tiles load while the consumers finish this one and write its output.
//   * Each consumer owns 64 of the tile's queries and keeps their output
//     (64 x DV f32), running max and sum in registers.  S = Q K^T is a
//     wgmma.mma_async with both operands in shared memory (q read there
//     at every key tile, never staged through registers); the online
//     softmax runs on S's accumulator registers (a row in one quad of
//     lanes: two shuffles a reduction) with exp2 and scale * log2(e) folded
//     into one FMA; p, rounded to bf16, is the register A operand of O +=
//     P V, whose B operand, v's D-contiguous rows, is read MN-major
//     through the descriptor's transpose bit.  Key tile t's P V runs on
//     the tensor cores while the softmax of tile t + 1 runs: S of t + 1 is
//     issued before P V of t and waited for alone, and the output takes
//     t's rescale between the two issues (skipped when no row of the warp
//     found a larger max: every factor is exactly 1).  A k tile is
//     released once its S is in, a v tile once its P V is, q once the
//     tile's last S is.  The two consumers take turns to issue their
//     products (named barriers), so that one's softmax runs while the
//     other's products do.  At Sq <= 64 (a decode row) consumer 1 would
//     hold no query and exits at once; the barriers count one consumer.
//   * Shared-memory tiles are in the layout the TMA writes and the wgmma
//     descriptors read: rows of min(D, 64) elements in the 128-, 64- or
//     32-byte swizzle (a 128- or 192-wide row loads as 64-wide column
//     blocks).
//   * q, k and v are read through 4-d tensor maps (D, heads, S, B) with
//     their real strides, encoded on the host for each launch: a box never
//     crosses into the next batch's rows; q's map ends at Sq and k's and
//     v's at kv_len, so rows past either load as zeros (NaN past kv_len is
//     never read) and keys past kv_len are masked in S.  The maps need
//     16-byte strides and addresses; the wrapper checks them.
// A block holds 384 threads (the consumers at 240 registers, the producer
// at 24) and 21-214 KB of shared memory (DK = 16 to 192).
//
// f32 (no model path; DK = DV only): tensor-core f32 would be TF32, which
// cannot meet the f32 limit of 1e-5 * max|o|, so flash_attention_f32_kernel keeps the
// first CUDA-core loop: f32 FMAs, each thread 8 rows x 4 score columns and
// 8 rows x D/16 output columns in registers, tiles staged with plain loads.
//
// The sums run in an order fixed by the shapes: two launches on the same
// inputs give the same bits.  This source builds without -fmad=false (it
// is not on the RSNN bit-true path): the f32 kernel asks for its products
// with fmaf, and contraction elsewhere only moves roundings inside the
// stated tolerances.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (B, H, Sq) row log-sum-exp (the LSE variant), or null
  int B, Sq, Skv, H, Hkv, kv_len, causal;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float scale;
  float* o32;  // (B, Sq, H, DV) f32: the bf16 LSE variant's output before its
               // rounding (the backward's delta takes it)
};

// Keys a q tile starting at q0 with nq rows reads, in whole tiles of bk.
__device__ __forceinline__ int fa_key_tiles(const FlashArgs& a, int q0, int nq,
                                            int bk = FA_BK) {
  int n_kv = (a.kv_len + bk - 1) / bk;
  if (a.causal) n_kv = min(n_kv, (q0 + nq - 1) / bk + 1);
  return n_kv;
}

// ---------------------------------------------------------------------------
// bf16: Hopper (TMA, mbarrier ring, wgmma)
// ---------------------------------------------------------------------------

constexpr int FWD_WG = 128;        // threads a warpgroup
constexpr int FWD_CONSUMERS = 2;   // consumer warpgroups a block
constexpr int FWD_THREADS = FWD_WG * (1 + FWD_CONSUMERS);
constexpr int FWD_ROWS = 64;       // a consumer's queries
constexpr int FWD_BLOCK = FWD_ROWS * FWD_CONSUMERS;  // queries a block
constexpr int FWD_KT = 128;        // keys a k / v tile
constexpr int FWD_STAGES = 2;      // k / v tiles in flight
constexpr int FWD_BOX = 64;        // rows of a TMA box
constexpr int FWD_PRODUCER_REGS = 24;
constexpr int FWD_CONSUMER_REGS = 240;  // 128 x 24 + 256 x 240 <= 65,536

// Shared memory of a block, byte offsets from a 1024-byte aligned base
// (the 128-byte swizzle's period): the q tile, the ring's k and v tiles,
// then the barriers (q full, q empty; each stage's k full, v full, k
// empty, v empty).
template <int DK, int DV>
struct FwdSmem {
  static constexpr uint32_t QT = FWD_BLOCK * DK * 2;
  static constexpr uint32_t KT = FWD_KT * DK * 2, VT = FWD_KT * DV * 2;
  static constexpr uint32_t Q = 0, K = QT, V = K + FWD_STAGES * KT;
  static constexpr uint32_t BAR = V + FWD_STAGES * VT;
  static constexpr uint32_t BYTES = 1024 + BAR + 8 * (2 + 4 * FWD_STAGES);
};

// A tile of the schedule: 128 queries of one (batch, head).  Tile i of
// B * H * n_qt takes q tile n_qt - 1 - i / (B * H) of batch * head i % (B
// * H): every head's last q tile (under the causal mask the one with the
// most keys) comes before any head's second to last.  Block x of G takes
// tile fwd_tile_index(r, x, G) in its round r: the rounds run over the
// blocks forwards and backwards in turn, so that the blocks' sums of key
// tiles come out even (the heaviest of round 0 takes the lightest of
// round 1).
__device__ __forceinline__ int fwd_tile_index(int r, int x, int G) {
  return r * G + ((r & 1) ? G - 1 - x : x);
}

struct FwdTile {
  int b, h, hk, q0, nq, n_kv;
  __device__ __forceinline__ FwdTile(const FlashArgs& a, int i, int n_qt) {
    const int bh = i % (a.B * a.H);
    b = bh / a.H;
    h = bh % a.H;
    hk = h / (a.H / a.Hkv);
    q0 = (n_qt - 1 - i / (a.B * a.H)) * FWD_BLOCK;
    nq = min(FWD_BLOCK, a.Sq - q0);
    n_kv = fa_key_tiles(a, q0, nq, FWD_KT);
  }
};

// S = Q K^T of the consumer's 64 queries against a k tile, unscaled:
// issued and committed as one wgmma group.
template <int DK>
__device__ __forceinline__ void fwd_issue_s(float (&sc)[FWD_KT / 2], uint32_t qs, uint32_t ks,
                                            int cw) {
  using TK = SwTile<DK>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk)
    wgmma_ss(sc, TK::kmajor(qs, FWD_BLOCK, cw * FWD_ROWS, kk), TK::kmajor(ks, FWD_KT, 0, kk),
             kk);
  wgmma_commit();
}

// O += P V over a v tile (k over its keys), P the bf16 A fragments:
// issued and committed as one wgmma group.
template <int DV>
__device__ __forceinline__ void fwd_issue_pv(float (&o)[DV / 2],
                                             const uint32_t (&pf)[FWD_KT / 16][4], uint32_t vs) {
  using TV = SwTile<DV>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < FWD_KT / 16; ++kk)
    wgmma_rs(o, pf[kk], TV::mnmajor(vs, FWD_KT, kk), 1);
  wgmma_commit();
}

// The online softmax of one tile's scores (keys k0 ..), on the lane's
// accumulator rows g (i = 0, 1) and g + 8 (i = 2, 3), in place: keys past
// kv_len, and after the row's query when causal, get p = 0; the running
// max m (log2 units) and this lane's part of the sum l move on; sc becomes
// p = exp2(s * scale * log2(e) - m); corr is each row's factor for the
// older terms of l (applied here) and of the output (applied by the
// caller).
__device__ __forceinline__ void fwd_softmax(float (&sc)[FWD_KT / 2], const FlashArgs& a, int k0,
                                            int q_lo, int row0, int t4, float sl2,
                                            float (&m_r)[2], float (&l_r)[2],
                                            float (&corr)[2]) {
  if (k0 + FWD_KT > a.kv_len || (a.causal && k0 + FWD_KT - 1 > q_lo)) {
#pragma unroll
    for (int j = 0; j < FWD_KT / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + j * 8 + t4 * 2 + (i & 1);
        if (key >= a.kv_len || (a.causal && key > row0 + (i >> 1) * 8))
          sc[4 * j + i] = -INFINITY;
      }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < FWD_KT / 8; ++j)
      mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_r[r], mx * sl2);
    corr[r] = fast_exp2(m_r[r] - m_new);
    m_r[r] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < FWD_KT / 8; ++j) {
      sc[4 * j + 2 * r] = fast_exp2(fmaf(sc[4 * j + 2 * r], sl2, -m_new));
      sc[4 * j + 2 * r + 1] = fast_exp2(fmaf(sc[4 * j + 2 * r + 1], sl2, -m_new));
      sum += sc[4 * j + 2 * r] + sc[4 * j + 2 * r + 1];
    }
    l_r[r] = l_r[r] * corr[r] + sum;
  }
}

// The output's older terms times each row's corr; nothing to do when no
// row of the warp found a larger max (every corr exactly 1).
template <int R>
__device__ __forceinline__ void fwd_rescale(float (&o)[R], const float (&corr)[2]) {
  if (!__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) return;
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    o[4 * j] *= corr[0];
    o[4 * j + 1] *= corr[0];
    o[4 * j + 2] *= corr[1];
    o[4 * j + 3] *= corr[1];
  }
}

// P, rounded to bf16, as P V's A fragments.
__device__ __forceinline__ void fwd_pack(uint32_t (&pf)[FWD_KT / 16][4],
                                         const float (&sc)[FWD_KT / 2]) {
#pragma unroll
  for (int kk = 0; kk < FWD_KT / 16; ++kk) a_frag(pf[kk], sc, kk);
}

// The consumers' turns to issue products: consumer cw waits on named
// barrier 1 + cw until the other has passed it on (256 threads: both
// consumers), and passes the turn on through barrier 2 - cw.
__device__ __forceinline__ void fwd_turn(int cw) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + cw) : "memory");
}

__device__ __forceinline__ void fwd_pass(int cw) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - cw) : "memory");
}

// A persistent block: its tiles of the schedule (FwdTile), one after
// another, the ring's stages and phases running on across them, so that
// the producer loads the next tile's q and first k/v tiles while the
// consumers finish this one's and write its output.
template <int DK, int DV, bool LSE>
__global__ void __launch_bounds__(FWD_THREADS, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, FlashArgs a) {
  using L = FwdSmem<DK, DV>;
  constexpr int ST = FWD_STAGES;
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  const uint32_t raw = smem_addr(fwd_smem);
  const uint32_t sb = (raw + 1023) & ~1023u;
  const uint32_t q_full = sb + L::BAR, q_empty = q_full + 8;
  const uint32_t k_full0 = q_empty + 8, v_full0 = k_full0 + 8 * ST;
  const uint32_t k_empty0 = v_full0 + 8 * ST, v_empty0 = k_empty0 + 8 * ST;
  const int n_qt = (a.Sq + FWD_BLOCK - 1) / FWD_BLOCK;
  const int n_tiles = a.B * a.H * n_qt;
  // Consumers that run: at Sq <= 64 (a decode row's launch) consumer 1
  // would hold no query in any tile, and exits at once.
  const int consumers = a.Sq > FWD_ROWS ? FWD_CONSUMERS : 1;
  const int wg = threadIdx.x / FWD_WG;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 4 * consumers);  // a warp of each running consumer
    for (int s = 0; s < ST; ++s) {
      mbar_init(k_full0 + 8 * s, 1);
      mbar_init(v_full0 + 8 * s, 1);
      mbar_init(k_empty0 + 8 * s, 4 * consumers);
      mbar_init(v_empty0 + 8 * s, 4 * consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(FWD_PRODUCER_REGS));
    if (threadIdx.x == 0) {
      int c = 0;  // k / v tiles loaded so far
      for (int r = 0;; ++r) {  // round r: this block's tile r
        const int i = fwd_tile_index(r, blockIdx.x, gridDim.x);
        if (i >= n_tiles) break;
        const FwdTile w(a, i, n_qt);
        mbar_wait(q_empty, (r & 1) ^ 1);  // the last tile's S products are in
        mbar_expect_tx(q_full, L::QT);
        tma_tile<DK, FWD_BOX>(sb + L::Q, &tm_q, q_full, FWD_BLOCK, w.h, w.q0, w.b);
        for (int t = 0; t < w.n_kv; ++t, ++c) {
          const int s = c % ST;
          const uint32_t phase = ((c / ST) & 1) ^ 1;  // tile c - ST released
          mbar_wait(k_empty0 + 8 * s, phase);
          mbar_expect_tx(k_full0 + 8 * s, L::KT);
          tma_tile<DK, FWD_BOX>(sb + L::K + s * L::KT, &tm_k, k_full0 + 8 * s, FWD_KT, w.hk,
                                t * FWD_KT, w.b);
          mbar_wait(v_empty0 + 8 * s, phase);
          mbar_expect_tx(v_full0 + 8 * s, L::VT);
          tma_tile<DV, FWD_BOX>(sb + L::V + s * L::VT, &tm_v, v_full0 + 8 * s, FWD_KT, w.hk,
                                t * FWD_KT, w.b);
        }
      }
    }
    return;
  }
  if (wg > consumers) return;

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(FWD_CONSUMER_REGS));
  const int cw = wg - 1;
  const int t = threadIdx.x % FWD_WG;
  const int warp = t / 32, lane = t % 32, g = lane / 4, t4 = lane % 4;
  const float sl2 = a.scale * FA_LOG2E;
  float o[DV / 2];
  float m_r[2], l_r[2], corr[2];
  float sc[FWD_KT / 2];         // S of one k tile: 64 queries x 128 keys
  uint32_t pf[FWD_KT / 16][4];  // its P, bf16, as P V's A operand
  // Tile it's P V runs on the tensor cores while the softmax of tile it + 1
  // runs on S's accumulators: S of tile it + 1 is issued before P V of
  // tile it, and waited for alone; the output takes tile it's rescale
  // between the two issues.  A stage's k tile is released as soon as its S
  // is in, its v tile once its P V is, the q tile once the last S is.  The
  // two consumers take turns to issue their products (named barriers 1
  // and 2), so that one's softmax runs while the other's products do;
  // consumer 0 goes first.
  const bool pp = consumers == 2;
  if (pp && cw == 1) asm volatile("bar.arrive 1, 256;\n" ::: "memory");
  int c = 0;  // k / v tiles consumed so far
  for (int r = 0;; ++r) {  // round r: this block's tile r
    const int i = fwd_tile_index(r, blockIdx.x, gridDim.x);
    if (i >= n_tiles) break;
    const FwdTile w(a, i, n_qt);
    const bool last = fwd_tile_index(r + 1, blockIdx.x, gridDim.x) >= n_tiles;
    const int q_lo = w.q0 + cw * FWD_ROWS;
    const int row0 = q_lo + warp * 16 + g;  // query of fragment rows i < 2 (+8: i >= 2)
#pragma unroll
    for (int e = 0; e < DV / 2; ++e) o[e] = 0.f;
    m_r[0] = m_r[1] = FA_NEG_INF;  // running max, log2 units
    l_r[0] = l_r[1] = 0.f;         // this lane's part of the sum

    mbar_wait(q_full, r & 1);
    mbar_wait(k_full0 + 8 * (c % ST), (c / ST) & 1);
    if (pp) fwd_turn(cw);
    fwd_issue_s<DK>(sc, sb + L::Q, sb + L::K + (c % ST) * L::KT, cw);
    if (pp) fwd_pass(cw);
    wgmma_wait<0>();
    reg_fence(sc);
    __syncwarp();
    if (lane == 0) mbar_arrive(k_empty0 + 8 * (c % ST));
    fwd_softmax(sc, a, 0, q_lo, row0, t4, sl2, m_r, l_r, corr);
    fwd_pack(pf, sc);
    for (int it = 0; it + 1 < w.n_kv; ++it) {
      const int s = (c + it) % ST, s1 = (c + it + 1) % ST;
      mbar_wait(k_full0 + 8 * s1, ((c + it + 1) / ST) & 1);
      mbar_wait(v_full0 + 8 * s, ((c + it) / ST) & 1);
      if (pp) fwd_turn(cw);
      fwd_issue_s<DK>(sc, sb + L::Q, sb + L::K + s1 * L::KT, cw);
      fwd_rescale(o, corr);
      fwd_issue_pv<DV>(o, pf, sb + L::V + s * L::VT);
      if (pp) fwd_pass(cw);
      wgmma_wait<1>();  // S of tile it + 1 is in; P V of tile it may still run
      reg_fence(sc);
      __syncwarp();
      if (lane == 0) mbar_arrive(k_empty0 + 8 * s1);
      fwd_softmax(sc, a, (it + 1) * FWD_KT, q_lo, row0, t4, sl2, m_r, l_r, corr);
      wgmma_wait<0>();
      reg_fence(o);
      reg_fence(pf);  // P V read pf until here
      __syncwarp();
      if (lane == 0) mbar_arrive(v_empty0 + 8 * s);
      fwd_pack(pf, sc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(q_empty);  // every S of this tile is in
    {
      const int s = (c + w.n_kv - 1) % ST;
      mbar_wait(v_full0 + 8 * s, ((c + w.n_kv - 1) / ST) & 1);
      if (pp) fwd_turn(cw);
      fwd_rescale(o, corr);
      fwd_issue_pv<DV>(o, pf, sb + L::V + s * L::VT);
      if (pp && !(last && cw == 1)) fwd_pass(cw);  // no turn follows the block's last
      wgmma_wait<0>();
      reg_fence(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(v_empty0 + 8 * s);
    }
    c += w.n_kv;

    __nv_bfloat16* og = static_cast<__nv_bfloat16*>(a.o);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_r[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv_l = 1.f / fmaxf(l, 1e-30f);
      const int q = row0 + r * 8;
      if (q < a.Sq) {
        const long long row = (long long)(w.b * a.Sq + q) * a.H + w.h;
        __nv_bfloat16* orow = og + row * DV;
#pragma unroll
        for (int e = 0; e < DV / 8; ++e)
          *reinterpret_cast<__nv_bfloat162*>(orow + e * 8 + t4 * 2) =
              __floats2bfloat162_rn(o[4 * e + 2 * r] * inv_l, o[4 * e + 2 * r + 1] * inv_l);
        // lse = ln(sum exp(s * scale)) = ln2 * (m + log2 l), m in log2 units
        if (LSE && t4 == 0)
          a.lse[((long long)w.b * a.H + w.h) * a.Sq + q] = (m_r[r] + log2f(l)) * FA_LN2;
        // the same row before its rounding: the bf16 output is this rounded
        if constexpr (LSE) {
          float* frow = a.o32 + row * DV;
#pragma unroll
          for (int e = 0; e < DV / 8; ++e)
            *reinterpret_cast<float2*>(frow + e * 8 + t4 * 2) =
                make_float2(o[4 * e + 2 * r] * inv_l, o[4 * e + 2 * r + 1] * inv_l);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t f32_smem_bytes() {
  return ((size_t)(FA_BQ + 2 * FA_BK) * f32_pitch<D>() + FA_BQ * FA_PLD +
          3 * FA_BQ) * sizeof(float);
}

template <int D, bool LSE>
__global__ void __launch_bounds__(FA_THREADS)
    flash_attention_f32_kernel(FlashArgs a) {
  constexpr int LD = f32_pitch<D>();
  constexpr int DJ = D / 16;  // accumulator columns per thread
  extern __shared__ __align__(16) unsigned char fa_smem[];
  float* qs = reinterpret_cast<float*>(fa_smem);
  float* ks = qs + FA_BQ * LD;
  float* vs = ks + FA_BK * LD;
  float* ps = vs + FA_BK * LD;
  float* m_s = ps + FA_BQ * FA_PLD;
  float* l_s = m_s + FA_BQ;
  float* c_s = l_s + FA_BQ;

  const int tid = threadIdx.x;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * FA_BQ;
  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y % a.H;
  const int hk = h / (a.H / a.Hkv);
  const int nq = min(FA_BQ, a.Sq - q0);
  const float* __restrict__ qg =
      static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* __restrict__ kg =
      static_cast<const float*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const float* __restrict__ vg =
      static_cast<const float*>(a.v) + b * a.v_sb + hk * a.v_sh;

  for (int e = tid; e < FA_BQ * D; e += FA_THREADS) {
    const int r = e / D, d = e % D;
    qs[r * LD + d] = r < nq ? qg[(long long)(q0 + r) * a.q_ss + d] : 0.f;
  }
  if (tid < FA_BQ) {
    m_s[tid] = FA_NEG_INF;
    l_s[tid] = 0.f;
  }

  const int tr = tid / 16;  // rows tr + 8i
  const int tc = tid % 16;  // score columns tc + 16j, output columns tc + 16j
  float acc[8][DJ];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  const int n_kv = fa_key_tiles(a, q0, nq);
  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * FA_BK;
    __syncthreads();  // the last tile's P.V is done with ks, vs and ps
    for (int e = tid; e < FA_BK * D; e += FA_THREADS) {
      const int r = e / D, d = e % D;
      const bool in = k0 + r < a.kv_len;
      ks[r * LD + d] = in ? kg[(long long)(k0 + r) * a.k_ss + d] : 0.f;
      vs[r * LD + d] = in ? vg[(long long)(k0 + r) * a.v_ss + d] : 0.f;
    }
    __syncthreads();

    // S = Q K^T for this thread's 8 x 4 scores
    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[8], kv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) qv[i] = qs[(tr + 8 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tc + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = tr + 8 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tc + 16 * j;
        const int kpos = k0 + col;
        const bool valid = kpos < a.kv_len && (!a.causal || kpos <= q0 + row);
        ps[row * FA_PLD + col] = valid ? s[i][j] * a.scale : FA_NEG_INF;
      }
    }
    __syncthreads();

    // online softmax: two threads per row, 32 columns each
    {
      const int row = tid >> 1;
      float* pr = ps + row * FA_PLD + (tid & 1) * (FA_BK / 2);
      float mx = FA_NEG_INF;
      for (int c = 0; c < FA_BK / 2; ++c) mx = fmaxf(mx, pr[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_old = m_s[row];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = 0; c < FA_BK / 2; ++c) {
        const float p = expf(pr[c] - m_new);
        sum += p;
        pr[c] = p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      if ((tid & 1) == 0) {
        const float corr = expf(m_old - m_new);
        l_s[row] = l_s[row] * corr + sum;
        m_s[row] = m_new;
        c_s[row] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float corr = c_s[tr + 8 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int c = 0; c < FA_BK; ++c) {
      float pv[8], vv[DJ];
#pragma unroll
      for (int i = 0; i < 8; ++i) pv[i] = ps[(tr + 8 * i) * FA_PLD + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = vs[c * LD + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();  // l_s is final

  float* __restrict__ og = static_cast<float*>(a.o);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = tr + 8 * i;
    if (row < nq) {
      const float l = fmaxf(l_s[row], 1e-30f);
      float* orow = og + ((long long)(b * a.Sq + q0 + row) * a.H + h) * D;
#pragma unroll
      for (int j = 0; j < DJ; ++j) orow[tc + 16 * j] = acc[i][j] / l;
    }
  }
  if (LSE && tid < nq)
    a.lse[((long long)b * a.H + h) * a.Sq + q0 + tid] = m_s[tid] + logf(l_s[tid]);
}

// The plan (kernels/flash_attention.py:flash_plan) gives the grid, threads
// and shared memory; a launch whose plan is not this kernel's layout is
// refused.
struct FwdPlan {
  int grid_x, grid_y, threads;
  size_t smem;
};

template <typename Kernel, typename... Args>
int launch_kernel(Kernel kernel, const FwdPlan& p, cudaStream_t stream, const Args&... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(p.grid_x, p.grid_y), p.threads, p.smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// The SMs of the current card, read once.
int card_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 0;
  }
  return sms;
}

// bf16: one persistent block an SM (or a tile, if fewer), the tensor maps
// encoded here.
template <int DK, int DV, bool LSE>
int launch_bf16(const FlashArgs& a, const FwdPlan& p, cudaStream_t stream) {
  const long long tiles = (long long)a.B * a.H * ((a.Sq + FWD_BLOCK - 1) / FWD_BLOCK);
  if (p.grid_x != (tiles < card_sms() ? tiles : card_sms()) || p.grid_y != 1 ||
      p.threads != FWD_THREADS || p.smem != FwdSmem<DK, DV>::BYTES)
    return (int)cudaErrorInvalidValue;
  alignas(64) CUtensorMap tq, tk, tv;
  int rc = tensor_map<DK, FWD_BOX>(&tq, a.q, a.Sq, a.H, a.B, a.q_ss, a.q_sh, a.q_sb);
  if (!rc) rc = tensor_map<DK, FWD_BOX>(&tk, a.k, a.kv_len, a.Hkv, a.B, a.k_ss, a.k_sh, a.k_sb);
  if (!rc) rc = tensor_map<DV, FWD_BOX>(&tv, a.v, a.kv_len, a.Hkv, a.B, a.v_ss, a.v_sh, a.v_sb);
  if (rc) return rc;
  return launch_kernel(flash_fwd_kernel<DK, DV, LSE>, p, stream, tq, tk, tv, a);
}

// f32 (one width for q, k and v): grid (q tiles of 64, B * H).
template <int D, bool LSE>
int launch_f32(const FlashArgs& a, const FwdPlan& p, cudaStream_t stream) {
  if (p.grid_x != (a.Sq + FA_BQ - 1) / FA_BQ || p.grid_y != a.B * a.H ||
      p.threads != FA_THREADS || p.smem != f32_smem_bytes<D>())
    return (int)cudaErrorInvalidValue;
  return launch_kernel(flash_attention_f32_kernel<D, LSE>, p, stream, a);
}

// The lse output is a compile-time variant: without it the kernels are the
// serving prefill's, instruction for instruction.
template <int DK, int DV>
int launch_d(const FlashArgs& a, int bf16, const FwdPlan& p, cudaStream_t stream) {
  const bool lse = a.lse != nullptr;
  if (bf16)
    return lse ? launch_bf16<DK, DV, true>(a, p, stream) : launch_bf16<DK, DV, false>(a, p, stream);
  if constexpr (DK == DV)
    return lse ? launch_f32<DK, true>(a, p, stream) : launch_f32<DK, false>(a, p, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, float* lse, float* o32, int bf16,
    int B, int Sq, int Skv, int H, int Hkv, int D, int DV, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh, int kv_len,
    int causal, float scale, int grid_x, int grid_y, int threads, long long smem,
    void* stream) {
  FlashArgs a{q,    k,    v,    o,    lse,  B,    Sq,   Skv,  H,    Hkv,
              kv_len, causal, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
              v_sh, scale, o32};
  if (bf16 && lse != nullptr && o32 == nullptr) return (int)cudaErrorInvalidValue;
  const FwdPlan p{grid_x, grid_y, threads, (size_t)smem};
  cudaStream_t st = (cudaStream_t)stream;
  // the (q/k, v) width pairs of kernels/flash_attention.py:KERNEL_HEAD_DIMS
  if (D == 192 && DV == 128) return launch_d<192, 128>(a, bf16, p, st);
  if (D != DV) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 16: return launch_d<16, 16>(a, bf16, p, st);
    case 32: return launch_d<32, 32>(a, bf16, p, st);
    case 64: return launch_d<64, 64>(a, bf16, p, st);
    case 128: return launch_d<128, 128>(a, bf16, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
