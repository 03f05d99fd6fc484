// flash_attention — causal GQA online-softmax attention over q (B, Sq, H, DK),
// k (B, Skv, Hkv, DK) and v (B, Skv, Hkv, DV), behind the prefill of every
// attention layer of the LMs (models/attention.py:blocked_attention; DK = DV
// in GQA, DK = 192 and DV = 128 in deepseek-v2's MLA) and, in its variant
// that also writes each row's log-sum-exp and, in bf16, the output before
// its rounding (the backward's rowsum(dO * o) takes it: a rounded o there
// can lead a gradient that cancels, such as cross-attention's dQ over a
// memory whose keys share a large part), behind the forward of training;
// flash_attention_bwd.cu holds the training's backward.  Replaces
// src/repro/kernels/flash_attention.py:_kernel (wrapper flash_attention);
// it builds into one library with the RSNN kernels.
//
// Function: the Pallas kernel's, with blocked_attention's padding rule.
// Scores q.k * scale with the products summed in f32; keys at positions
// >= kv_len, and keys after the query's position when causal, masked at
// -1e30; running max m, running sum l and the output accumulator in f32;
// p rounded to the value dtype before the p.V product; output in q's
// dtype, divided by max(l, 1e-30).  Key tiles wholly above the diagonal or
// past kv_len are skipped (the Pallas kernel's pl.when skip): their terms
// are exact zeros, since every row has seen key 0 in the first tile.
// Masked keys and values load as zeros, so NaN in an unfilled cache tail
// cannot reach the sums.
//
// Bound on the H100: 2*B*H*(DK + DV)*sum_q(valid keys) operations on bf16
// tensor cores (989 TFLOP/s) against q, k, v read once and o written once
// (3.35 TB/s) — set by operations at prefill lengths.
//
// bf16 (every model path): flash_attention_mma_kernel runs both products
// on the tensor cores with mma.sync.m16n8k16 (bf16 in, f32 accumulators):
//   * one block of 4 warps per (q tile of 64 rows, batch*head); each warp
//     owns 16 query rows; tiles with the most keys run first;
//   * the q tile is copied once to shared memory and, up to DK = 128, held
//     in registers as A fragments (ldmatrix); a wider q (MLA's 192, whose
//     48 fragment registers would spill beside the 64 of a 128-wide
//     accumulator) is read from shared memory again at each k step of
//     every key tile, shared-memory traffic only; each 64-key tile of k and v arrives with
//     cp.async into a ring of FA_STAGES shared-memory stages, so tile t+1
//     is in flight while tile t's products run;
//   * S = Q K^T over DK with K as the B operand (ldmatrix of K's rows); the online
//     softmax runs on S's accumulator fragments in registers (a row lives
//     in one quad of lanes: two shuffles per reduction), with exp2f and
//     scale*log2(e) folded in; p is rounded to bf16 while its accumulator
//     fragment becomes the A fragment of O += P V (DV wide), with V the B
//     operand through ldmatrix.trans;
//   * staged rows are padded by 16 bytes, so every ldmatrix phase touches
//     eight distinct 16-byte bank groups.
// q, k and v are read through their batch / sequence / head strides (the
// head dimension is contiguous); cp.async moves 16-byte pieces, so the
// wrapper raises unless every pointer and stride is 16-byte aligned.
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
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

constexpr int FA_STAGES = 2;     // k/v tiles in flight (bf16 kernel)

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

// Keys a q tile starting at q0 with nq rows reads, in whole tiles.
__device__ __forceinline__ int fa_key_tiles(const FlashArgs& a, int q0, int nq) {
  int n_kv = (a.kv_len + FA_BK - 1) / FA_BK;
  if (a.causal) n_kv = min(n_kv, (q0 + nq - 1) / FA_BK + 1);
  return n_kv;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

// Row pitch of a staged bf16 tile, in elements: D plus 16 bytes.
template <int D>
__host__ __device__ constexpr int mma_pitch() {
  return D + 8;
}

// the q tile and FA_STAGES k tiles at DK's pitch, FA_STAGES v tiles at DV's
template <int DK, int DV>
constexpr size_t mma_smem_bytes() {
  return ((size_t)(FA_BQ + FA_STAGES * FA_BK) * mma_pitch<DK>() +
          (size_t)FA_STAGES * FA_BK * mma_pitch<DV>()) * 2;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = full ? 16 : 0;  // 0: write 16 zero bytes, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// c += a b for one m16n8k16 tile: a the 4 A registers, b0 b1 the B pair.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows [r0, r0 + 64) of a (·, D) bf16 matrix at g (row stride ld) into a
// staged tile; rows at or past `limit` are zero-filled and never read.
template <int D>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* g,
                                                long long ld, int r0,
                                                int limit, int tid) {
  constexpr int CHUNKS = D / 8;  // 16-byte pieces a row
#pragma unroll
  for (int i = 0; i < FA_BQ * CHUNKS / FA_THREADS; ++i) {
    const int idx = tid + i * FA_THREADS;
    const int r = idx / CHUNKS, c = idx % CHUNKS;
    const bool in = r0 + r < limit;
    const __nv_bfloat16* src = in ? g + (long long)(r0 + r) * ld + c * 8 : g;
    cp_async16(dst + r * mma_pitch<D>() + c * 8, src, in);
  }
}

// S += Q K^T for k step kk: the warp's 16 rows (A fragment qa) against
// the 64 keys of a staged k tile of pitch LD, 8 n-tiles of 8 keys.
template <int LD>
__device__ __forceinline__ void qk_step(float (&s)[8][4], const uint32_t (&qa)[4],
                                        const __nv_bfloat16* kt, int kk, int lane) {
#pragma unroll
  for (int np = 0; np < 4; ++np) {
    uint32_t bk[4];
    ldsm_x4(bk, kt + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                    ((lane >> 3) & 1) * 8);
    mma_bf16(s[2 * np], qa, bk[0], bk[1]);
    mma_bf16(s[2 * np + 1], qa, bk[2], bk[3]);
  }
}

template <int DK, int DV, bool LSE>
__global__ void __launch_bounds__(FA_THREADS)
    flash_attention_mma_kernel(FlashArgs a) {
  constexpr int LD = mma_pitch<DK>();   // q and k tiles
  constexpr int LDV = mma_pitch<DV>();  // v tiles
  constexpr int KS = DK / 16;  // k-steps of S = Q K^T
  constexpr int DN = DV / 8;   // n-tiles of the output
  constexpr bool Q_REGS = DK <= 128;  // q's A fragments held in registers
  extern __shared__ __align__(16) unsigned char fa_smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(fa_smem);
  __nv_bfloat16* ks = qs + FA_BQ * LD;              // FA_STAGES tiles
  __nv_bfloat16* vs = ks + FA_STAGES * FA_BK * LD;  // FA_STAGES tiles

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * FA_BQ;
  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y % a.H;
  const int hk = h / (a.H / a.Hkv);
  const int nq = min(FA_BQ, a.Sq - q0);
  const __nv_bfloat16* qg =
      static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const __nv_bfloat16* kg =
      static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const __nv_bfloat16* vg =
      static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb + hk * a.v_sh;
  const int n_kv = fa_key_tiles(a, q0, nq);

  load_tile_async<DK>(qs, qg, a.q_ss, q0, a.Sq, tid);
  load_tile_async<DK>(ks, kg, a.k_ss, 0, a.kv_len, tid);
  load_tile_async<DV>(vs, vg, a.v_ss, 0, a.kv_len, tid);
  cp_async_commit();

  // This lane's rows of the C fragments: g and g + 8 of the warp's 16.
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = q0 + warp * 16 + g;  // query position of fragment row 0
  const float sl2 = a.scale * FA_LOG2E;
  uint32_t qf[Q_REGS ? KS : 1][4];
  float acc[DN][4];
#pragma unroll
  for (int j = 0; j < DN; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  float m_r[2] = {FA_NEG_INF, FA_NEG_INF};  // running max, log2 units
  float l_r[2] = {0.f, 0.f};                // this lane's part of the sum

  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * FA_BK;
    if (t + 1 < n_kv) {
      const int st = (t + 1) % FA_STAGES;
      load_tile_async<DK>(ks + st * FA_BK * LD, kg, a.k_ss, k0 + FA_BK,
                          a.kv_len, tid);
      load_tile_async<DV>(vs + st * FA_BK * LDV, vg, a.v_ss, k0 + FA_BK,
                          a.kv_len, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // all but the newest group: tile t has landed
    __syncthreads();
    if constexpr (Q_REGS) {
      if (t == 0) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          ldsm_x4(qf[kk], qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                              kk * 16 + (lane >> 4) * 8);
      }
    }
    const __nv_bfloat16* kt = ks + (t % FA_STAGES) * FA_BK * LD;
    const __nv_bfloat16* vt = vs + (t % FA_STAGES) * FA_BK * LDV;

    // S = Q K^T: 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if constexpr (Q_REGS) {
        qk_step<LD>(s, qf[kk], kt, kk, lane);
      } else {
        uint32_t qa[4];
        ldsm_x4(qa, qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + kk * 16 +
                        (lane >> 4) * 8);
        qk_step<LD>(s, qa, kt, kk, lane);
      }
    }

    // scale to log2 units and mask
    const bool edge = k0 + FA_BK > a.kv_len || (a.causal && k0 + FA_BK - 1 > q0);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kpos = k0 + j * 8 + t4 * 2 + (i & 1);
        const int qpos = row0 + (i >> 1) * 8;
        const bool valid =
            !edge || (kpos < a.kv_len && (!a.causal || kpos <= qpos));
        s[j][i] = valid ? s[j][i] * sl2 : FA_NEG_INF;
      }

    // online softmax on the fragments: lane rows g (i = 0, 1), g + 8 (2, 3)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = FA_NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[r], mx);
      const float corr = exp2f(m_r[r] - m_new);
      m_r[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j][2 * r] = exp2f(s[j][2 * r] - m_new);
        s[j][2 * r + 1] = exp2f(s[j][2 * r + 1] - m_new);
        sum += s[j][2 * r] + s[j][2 * r + 1];
      }
      l_r[r] = l_r[r] * corr + sum;
#pragma unroll
      for (int j = 0; j < DN; ++j) {
        acc[j][2 * r] *= corr;
        acc[j][2 * r + 1] *= corr;
      }
    }

    // O += P V: p rounded to bf16 as the A fragment, V through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < FA_BK / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DN / 2; ++dp) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDV +
                              dp * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], pa, bv[0], bv[1]);
        mma_bf16(acc[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();  // stage t % FA_STAGES is free for tile t + FA_STAGES
  }
  cp_async_wait<0>();

  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(a.o);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv_l = 1.f / fmaxf(l, 1e-30f);
    const int q = row0 + r * 8;
    if (q < a.Sq) {
      __nv_bfloat16* orow = og + ((long long)(b * a.Sq + q) * a.H + h) * DV;
#pragma unroll
      for (int j = 0; j < DN; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + t4 * 2) =
            __floats2bfloat162_rn(acc[j][2 * r] * inv_l, acc[j][2 * r + 1] * inv_l);
      }
      // lse = ln(sum exp(s * scale)) = ln2 * (m + log2 l), m in log2 units
      if (LSE && t4 == 0)
        a.lse[((long long)b * a.H + h) * a.Sq + q] = (m_r[r] + log2f(l)) * FA_LN2;
      // the same row before its rounding: the bf16 output is this rounded
      if constexpr (LSE) {
        float* frow = a.o32 + ((long long)(b * a.Sq + q) * a.H + h) * DV;
#pragma unroll
        for (int j = 0; j < DN; ++j) {
          *reinterpret_cast<float2*>(frow + j * 8 + t4 * 2) =
              make_float2(acc[j][2 * r] * inv_l, acc[j][2 * r + 1] * inv_l);
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

// grid_x and smem come from the wrapper's plan
// (kernels/flash_attention.py:flash_plan); the launch is refused unless
// they are this kernel's q tiling and shared-memory layout.
template <typename Kernel>
int launch_kernel(Kernel kernel, size_t need, size_t smem, int grid_x,
                  const FlashArgs& a, cudaStream_t stream) {
  if (smem != need || grid_x != (a.Sq + FA_BQ - 1) / FA_BQ) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(grid_x, a.B * a.H), FA_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The f32 kernel takes one width for q, k and v: a pair of two widths
// launches only in bf16.
template <int DK, int DV, bool LSE>
int launch_dl(const FlashArgs& a, int bf16, size_t smem, int grid_x,
              cudaStream_t stream) {
  if (bf16)
    return launch_kernel(flash_attention_mma_kernel<DK, DV, LSE>, mma_smem_bytes<DK, DV>(),
                         smem, grid_x, a, stream);
  if constexpr (DK == DV)
    return launch_kernel(flash_attention_f32_kernel<DK, LSE>, f32_smem_bytes<DK>(), smem,
                         grid_x, a, stream);
  return (int)cudaErrorInvalidValue;
}

// The lse output is a compile-time variant: without it the kernels are the
// serving prefill's, instruction for instruction.
template <int DK, int DV>
int launch_d(const FlashArgs& a, int bf16, size_t smem, int grid_x,
             cudaStream_t stream) {
  return a.lse != nullptr ? launch_dl<DK, DV, true>(a, bf16, smem, grid_x, stream)
                          : launch_dl<DK, DV, false>(a, bf16, smem, grid_x, stream);
}

}  // namespace

extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, float* lse, float* o32, int bf16,
    int B, int Sq, int Skv, int H, int Hkv, int D, int DV, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh, int kv_len,
    int causal, float scale, int grid_x, long long smem, void* stream) {
  FlashArgs a{q,    k,    v,    o,    lse,  B,    Sq,   Skv,  H,    Hkv,
              kv_len, causal, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
              v_sh, scale, o32};
  if (bf16 && lse != nullptr && o32 == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t sm = (size_t)smem;
  // the (q/k, v) width pairs of kernels/flash_attention.py:KERNEL_HEAD_DIMS
  if (D == 192 && DV == 128) return launch_d<192, 128>(a, bf16, sm, grid_x, st);
  if (D != DV) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 16: return launch_d<16, 16>(a, bf16, sm, grid_x, st);
    case 32: return launch_d<32, 32>(a, bf16, sm, grid_x, st);
    case 64: return launch_d<64, 64>(a, bf16, sm, grid_x, st);
    case 128: return launch_d<128, 128>(a, bf16, sm, grid_x, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
