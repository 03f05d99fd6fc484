// flash_attention — causal GQA online-softmax attention over q (B, Sq, H, D)
// and k, v (B, Skv, Hkv, D), behind the prefill of every attention layer of
// the dense LM (models/attention.py:blocked_attention) and, in its variant
// that also writes each row's log-sum-exp, behind the forward of training;
// flash_attention_bwd (below) is the training's backward.  Replaces
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
// Bound on the H100: 4*B*H*D*sum_q(valid keys) operations on bf16 tensor
// cores (989 TFLOP/s) against q, k, v read once and o written once (3.35
// TB/s) — set by operations at prefill lengths.
//
// bf16 (every model path): flash_attention_mma_kernel runs both products
// on the tensor cores with mma.sync.m16n8k16 (bf16 in, f32 accumulators):
//   * one block of 4 warps per (q tile of 64 rows, batch*head); each warp
//     owns 16 query rows; tiles with the most keys run first;
//   * the q tile is copied once to shared memory and held in registers as
//     A fragments (ldmatrix); each 64-key tile of k and v arrives with
//     cp.async into a ring of FA_STAGES shared-memory stages, so tile t+1
//     is in flight while tile t's products run;
//   * S = Q K^T with K as the B operand (ldmatrix of K's rows); the online
//     softmax runs on S's accumulator fragments in registers (a row lives
//     in one quad of lanes: two shuffles per reduction), with exp2f and
//     scale*log2(e) folded in; p is rounded to bf16 while its accumulator
//     fragment becomes the A fragment of O += P V, with V the B operand
//     through ldmatrix.trans;
//   * staged rows are padded by 16 bytes, so every ldmatrix phase touches
//     eight distinct 16-byte bank groups.
// q, k and v are read through their batch / sequence / head strides (the
// head dimension is contiguous); cp.async moves 16-byte pieces, so the
// wrapper raises unless every pointer and stride is 16-byte aligned.
//
// f32 (no model path): tensor-core f32 would be TF32, which cannot meet
// the f32 limit of 1e-5 * max|o|, so flash_attention_f32_kernel keeps the
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

namespace {

constexpr int FA_BQ = 64;        // query rows per block
constexpr int FA_BK = 64;        // keys per tile
constexpr int FA_THREADS = 128;  // 4 warps
constexpr int FA_STAGES = 2;     // k/v tiles in flight (bf16 kernel)
constexpr float FA_NEG_INF = -1e30f;
constexpr float FA_LOG2E = 1.4426950408889634f;
constexpr float FA_LN2 = 0.6931471805599453f;

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (B, H, Sq) row log-sum-exp (the LSE variant), or null
  int B, Sq, Skv, H, Hkv, kv_len, causal;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float scale;
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

template <int D>
constexpr size_t mma_smem_bytes() {
  return (size_t)(FA_BQ + 2 * FA_STAGES * FA_BK) * mma_pitch<D>() * 2;
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
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

template <int D, bool LSE>
__global__ void __launch_bounds__(FA_THREADS)
    flash_attention_mma_kernel(FlashArgs a) {
  constexpr int LD = mma_pitch<D>();
  constexpr int DK = D / 16;  // k-steps of S = Q K^T
  constexpr int DN = D / 8;   // n-tiles of the output
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

  load_tile_async<D>(qs, qg, a.q_ss, q0, a.Sq, tid);
  load_tile_async<D>(ks, kg, a.k_ss, 0, a.kv_len, tid);
  load_tile_async<D>(vs, vg, a.v_ss, 0, a.kv_len, tid);
  cp_async_commit();

  // This lane's rows of the C fragments: g and g + 8 of the warp's 16.
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = q0 + warp * 16 + g;  // query position of fragment row 0
  const float sl2 = a.scale * FA_LOG2E;
  uint32_t qf[DK][4];
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
      load_tile_async<D>(ks + st * FA_BK * LD, kg, a.k_ss, k0 + FA_BK,
                         a.kv_len, tid);
      load_tile_async<D>(vs + st * FA_BK * LD, vg, a.v_ss, k0 + FA_BK,
                         a.kv_len, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // all but the newest group: tile t has landed
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < DK; ++kk)
        ldsm_x4(qf[kk], qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                            kk * 16 + (lane >> 4) * 8);
    }
    const __nv_bfloat16* kt = ks + (t % FA_STAGES) * FA_BK * LD;
    const __nv_bfloat16* vt = vs + (t % FA_STAGES) * FA_BK * LD;

    // S = Q K^T: 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4];
        ldsm_x4(bk, kt + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                        ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qf[kk], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qf[kk], bk[2], bk[3]);
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
        ldsm_x4_trans(bv, vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
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
      __nv_bfloat16* orow = og + ((long long)(b * a.Sq + q) * a.H + h) * D;
#pragma unroll
      for (int j = 0; j < DN; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + t4 * 2) =
            __floats2bfloat162_rn(acc[j][2 * r] * inv_l, acc[j][2 * r + 1] * inv_l);
      }
      // lse = ln(sum exp(s * scale)) = ln2 * (m + log2 l), m in log2 units
      if (LSE && t4 == 0)
        a.lse[((long long)b * a.H + h) * a.Sq + q] = (m_r[r] + log2f(l)) * FA_LN2;
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int FA_PLD = FA_BK + 1;

// Row pitch of a staged f32 tile, in elements: D plus 4 bytes.
template <int D>
__host__ __device__ constexpr int f32_pitch() {
  return D + 1;
}

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

template <int D, bool LSE>
int launch_dl(const FlashArgs& a, int bf16, size_t smem, int grid_x,
              cudaStream_t stream) {
  return bf16 ? launch_kernel(flash_attention_mma_kernel<D, LSE>, mma_smem_bytes<D>(),
                              smem, grid_x, a, stream)
              : launch_kernel(flash_attention_f32_kernel<D, LSE>, f32_smem_bytes<D>(),
                              smem, grid_x, a, stream);
}

// The lse output is a compile-time variant: without it the kernels are the
// serving prefill's, instruction for instruction.
template <int D>
int launch_d(const FlashArgs& a, int bf16, size_t smem, int grid_x,
             cudaStream_t stream) {
  return a.lse != nullptr ? launch_dl<D, true>(a, bf16, smem, grid_x, stream)
                          : launch_dl<D, false>(a, bf16, smem, grid_x, stream);
}


// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------
//
// flash_attention_bwd: the gradient JAX takes of blocked_attention
// (src/repro/models/attention.py:49, differentiated by jax.grad; the
// Pallas kernel has no backward).  From the forward's output o and row
// log-sum-exp lse, and dO:
//   delta = rowsum(dO * o)                                  (pre-pass, f32)
//   P = exp(S - lse), S = q.k * scale, masked as the forward masks;
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - delta),
//   dQ = scale * dS K,  dK = scale * dS^T Q,
// dK and dV summed over the G query heads of each KV head.  In bf16 P and
// dS are rounded to bf16 as the tensor cores' A operands (the forward
// rounds p before p.V the same way); every sum is f32.
//
// Bound on the H100: the five products (S again, dV, dP, dQ, dK), 10 *
// B*H*D*sum_q(valid keys) operations on bf16 tensor cores, against q, k,
// v, o, dO, lse read once and dq, dk, dv written once: set by operations
// at training lengths.
//
// Design (a first version that is right; wgmma / TMA are later work):
//   * flash_bwd_delta_kernel: a warp a (b, position, head) row;
//   * dK/dV: one block of 4 warps per (KV tile of 64 keys, batch, KV
//     head); each warp owns 16 keys and keeps their dK and dV rows in
//     registers while the block walks the q tiles of the G heads (from
//     the diagonal on, under the causal mask), each q and dO tile with
//     its lse and delta arriving through a 2-stage cp.async ring;
//     S^T = K Q^T is recomputed with K as the A operand, P^T becomes the A
//     fragment of dV += P^T dO, then dP^T = V dO^T, dS^T, dK += dS^T Q;
//   * dQ: one block per (q tile, batch * head), the forward's walk over
//     the KV tiles (a 2-stage ring of k and v tiles): S = Q K^T, P,
//     dP = dO V^T, dS, dQ += dS K with K through ldmatrix.trans.
// Every output element is written by one thread, once: no atomics, so
// two launches give the same bits.  f32 runs CUDA-core versions of the
// two kernels (tensor-core f32 would be TF32).

struct FlashBwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;     // (B, Sq, H, D), contiguous
  const void* dout;  // (B, Sq, H, D), contiguous
  const float* lse;  // (B, H, Sq)
  float* delta;      // (B, H, Sq)
  void* dq;          // (B, Sq, H, D)
  void* dk;          // (B, Skv, Hkv, D)
  void* dv;          // (B, Skv, Hkv, D)
  int B, Sq, Skv, H, Hkv, causal;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float scale;
};

constexpr int FA_DELTA_ROWS = FA_THREADS / 32;  // pre-pass rows a block

__device__ __forceinline__ float fa_to_f(float x) { return x; }
__device__ __forceinline__ float fa_to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ bool fa_bwd_valid(const FlashBwdArgs& a, int qpos,
                                             int kpos) {
  return qpos < a.Sq && kpos < a.Skv && (!a.causal || kpos <= qpos);
}

// q tiles a KV tile starting at k0 is seen by: from the diagonal on when
// causal.
__device__ __forceinline__ int fa_first_q_tile(const FlashBwdArgs& a, int k0) {
  return a.causal ? k0 / FA_BQ : 0;
}

// KV tiles a q tile starting at q0 with nq rows sees.
__device__ __forceinline__ int fa_bwd_key_tiles(const FlashBwdArgs& a, int q0,
                                                int nq) {
  int n_kv = (a.Skv + FA_BK - 1) / FA_BK;
  if (a.causal) n_kv = min(n_kv, (q0 + nq - 1) / FA_BK + 1);
  return n_kv;
}

template <typename T>
__global__ void __launch_bounds__(FA_THREADS)
    flash_bwd_delta_kernel(FlashBwdArgs a, int D) {
  const long long rows = (long long)a.B * a.Sq * a.H;
  const long long row = (long long)blockIdx.x * FA_DELTA_ROWS + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const T* o = static_cast<const T*>(a.o) + row * D;
  const T* d = static_cast<const T*>(a.dout) + row * D;
  float s = 0.f;
  for (int c = lane; c < D; c += 32) s = fmaf(fa_to_f(o[c]), fa_to_f(d[c]), s);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) s += __shfl_xor_sync(0xffffffffu, s, w);
  if (lane == 0) {
    const long long b = row / ((long long)a.Sq * a.H);
    const long long rem = row % ((long long)a.Sq * a.H);
    const long long pos = rem / a.H, h = rem % a.H;
    a.delta[(b * a.H + h) * a.Sq + pos] = s;
  }
}

template <int D>
constexpr size_t bwd_dkdv_mma_smem_bytes() {
  return (size_t)(2 + 2 * FA_STAGES) * FA_BK * mma_pitch<D>() * 2 +
         (size_t)FA_STAGES * 2 * FA_BQ * sizeof(float);
}

template <int D>
constexpr size_t bwd_dq_mma_smem_bytes() {
  return (size_t)(2 + 2 * FA_STAGES) * FA_BK * mma_pitch<D>() * 2;
}

// acc[0..8) += A (16 rows of this warp, k over D) x B^T (64 rows of bt,
// k over D): the S = Q K^T pattern, A rows from `at` (this warp's 16 rows
// at row offset 0), B rows from `bt` (row-major, 64 rows).
template <int D>
__device__ __forceinline__ void mma_rows_x_rows(float (&acc)[8][4],
                                                const __nv_bfloat16* at,
                                                const __nv_bfloat16* bt,
                                                int lane) {
  constexpr int LD = mma_pitch<D>();
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, at + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + kk * 16 +
                    (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bf[4];
      ldsm_x4(bf, bt + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                      ((lane >> 3) & 1) * 8);
      mma_bf16(acc[2 * np], af, bf[0], bf[1]);
      mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// out[0..D/8) += P (this warp's 16 rows x 64, the C fragments of
// mma_rows_x_rows, rounded to bf16) x M (64 rows of mt, row-major, D wide):
// the O += P V pattern, M through ldmatrix.trans.
template <int D>
__device__ __forceinline__ void mma_frag_x_tile(float (&out)[D / 8][4],
                                                const float (&p)[8][4],
                                                const __nv_bfloat16* mt,
                                                int lane) {
  constexpr int LD = mma_pitch<D>();
#pragma unroll
  for (int kk = 0; kk < FA_BK / 16; ++kk) {
    const uint32_t pa[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                            pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                            pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t bm[4];
      ldsm_x4_trans(bm, mt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                            dp * 16 + (lane >> 4) * 8);
      mma_bf16(out[2 * dp], pa, bm[0], bm[1]);
      mma_bf16(out[2 * dp + 1], pa, bm[2], bm[3]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(FA_THREADS)
    flash_bwd_dkdv_mma_kernel(FlashBwdArgs a) {
  constexpr int LD = mma_pitch<D>();
  constexpr int DN = D / 8;
  extern __shared__ __align__(16) unsigned char fa_smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(fa_smem);
  __nv_bfloat16* vs = ks + FA_BK * LD;
  __nv_bfloat16* qs = vs + FA_BK * LD;                // FA_STAGES tiles
  __nv_bfloat16* dos = qs + FA_STAGES * FA_BQ * LD;   // FA_STAGES tiles
  float* lse_s = reinterpret_cast<float*>(dos + FA_STAGES * FA_BQ * LD);
  float* dlt_s = lse_s + FA_STAGES * FA_BQ;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int k0 = blockIdx.x * FA_BK;
  const int b = blockIdx.y / a.Hkv;
  const int hk = blockIdx.y % a.Hkv;
  const int G = a.H / a.Hkv;
  const int qt0 = fa_first_q_tile(a, k0);
  const int per_head = max((a.Sq + FA_BQ - 1) / FA_BQ - qt0, 0);
  const int n_it = G * per_head;
  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb;
  const __nv_bfloat16* dob =
      static_cast<const __nv_bfloat16*>(a.dout) + (long long)b * a.Sq * a.H * D;
  const long long do_ss = (long long)a.H * D;

  // iteration it: head hk*G + it / per_head, q tile qt0 + it % per_head
  auto issue = [&](int it, int st) {
    const int h = hk * G + it / per_head;
    const int q0 = (qt0 + it % per_head) * FA_BQ;
    load_tile_async<D>(qs + st * FA_BQ * LD, qb + h * a.q_sh, a.q_ss, q0, a.Sq, tid);
    load_tile_async<D>(dos + st * FA_BQ * LD, dob + h * D, do_ss, q0, a.Sq, tid);
    const int r = tid % FA_BQ;
    const long long at = ((long long)b * a.H + h) * a.Sq + q0 + r;
    const bool in = q0 + r < a.Sq;
    if (tid < FA_BQ) lse_s[st * FA_BQ + r] = in ? a.lse[at] : 0.f;
    else dlt_s[st * FA_BQ + r] = in ? a.delta[at] : 0.f;
  };

  load_tile_async<D>(ks, static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb +
                             hk * a.k_sh, a.k_ss, k0, a.Skv, tid);
  load_tile_async<D>(vs, static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb +
                             hk * a.v_sh, a.v_ss, k0, a.Skv, tid);
  if (n_it > 0) issue(0, 0);
  cp_async_commit();

  const int g = lane >> 2, t4 = lane & 3;
  const int key0 = k0 + warp * 16 + g;  // key of fragment row 0 (and + 8)
  const float sl2 = a.scale * FA_LOG2E;
  float dk[DN][4], dv[DN][4];
#pragma unroll
  for (int j = 0; j < DN; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[j][i] = dv[j][i] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) issue(it + 1, (it + 1) % FA_STAGES);
    cp_async_commit();
    cp_async_wait<1>();  // all but the newest group: tile it has landed
    __syncthreads();
    const int st = it % FA_STAGES;
    const int q0 = (qt0 + it % per_head) * FA_BQ;
    const __nv_bfloat16* qt = qs + st * FA_BQ * LD;
    const __nv_bfloat16* dt = dos + st * FA_BQ * LD;
    const float* lt = lse_s + st * FA_BQ;
    const float* dl = dlt_s + st * FA_BQ;

    // P^T = exp(K Q^T * scale - lse): rows keys, columns queries
    float s[8][4];
    mma_rows_x_rows<D>(s, ks + warp * 16 * LD, qt, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = j * 8 + t4 * 2 + (i & 1);
        s[j][i] = fa_bwd_valid(a, q0 + c, key0 + (i >> 1) * 8)
                      ? exp2f(s[j][i] * sl2 - lt[c] * FA_LOG2E)
                      : 0.f;
      }
    mma_frag_x_tile<D>(dv, s, dt, lane);  // dV += P^T dO

    // dS^T = P^T * (V dO^T - delta)
    float dp[8][4];
    mma_rows_x_rows<D>(dp, vs + warp * 16 * LD, dt, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s[j][i] *= dp[j][i] - dl[j * 8 + t4 * 2 + (i & 1)];
    mma_frag_x_tile<D>(dk, s, qt, lane);  // dK += dS^T Q
    __syncthreads();  // stage st is free for tile it + FA_STAGES
  }
  cp_async_wait<0>();

  __nv_bfloat16* dkg = static_cast<__nv_bfloat16*>(a.dk);
  __nv_bfloat16* dvg = static_cast<__nv_bfloat16*>(a.dv);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + r * 8;
    if (key < a.Skv) {
      const long long row = (((long long)b * a.Skv + key) * a.Hkv + hk) * D;
#pragma unroll
      for (int j = 0; j < DN; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(dkg + row + j * 8 + t4 * 2) =
            __floats2bfloat162_rn(dk[j][2 * r] * a.scale, dk[j][2 * r + 1] * a.scale);
        *reinterpret_cast<__nv_bfloat162*>(dvg + row + j * 8 + t4 * 2) =
            __floats2bfloat162_rn(dv[j][2 * r], dv[j][2 * r + 1]);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(FA_THREADS)
    flash_bwd_dq_mma_kernel(FlashBwdArgs a) {
  constexpr int LD = mma_pitch<D>();
  constexpr int DN = D / 8;
  extern __shared__ __align__(16) unsigned char fa_smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(fa_smem);
  __nv_bfloat16* dos = qs + FA_BQ * LD;
  __nv_bfloat16* ks = dos + FA_BQ * LD;              // FA_STAGES tiles
  __nv_bfloat16* vs = ks + FA_STAGES * FA_BK * LD;   // FA_STAGES tiles

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * FA_BQ;
  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y % a.H;
  const int hk = h / (a.H / a.Hkv);
  const int nq = min(FA_BQ, a.Sq - q0);
  const __nv_bfloat16* kg =
      static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const __nv_bfloat16* vg =
      static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb + hk * a.v_sh;
  const int n_kv = fa_bwd_key_tiles(a, q0, nq);

  load_tile_async<D>(qs, static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb +
                             h * a.q_sh, a.q_ss, q0, a.Sq, tid);
  load_tile_async<D>(dos, static_cast<const __nv_bfloat16*>(a.dout) +
                              (long long)b * a.Sq * a.H * D + h * D,
                     (long long)a.H * D, q0, a.Sq, tid);
  load_tile_async<D>(ks, kg, a.k_ss, 0, a.Skv, tid);
  load_tile_async<D>(vs, vg, a.v_ss, 0, a.Skv, tid);
  cp_async_commit();

  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = q0 + warp * 16 + g;  // query of fragment row 0 (and + 8)
  const float sl2 = a.scale * FA_LOG2E;
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = row0 + r * 8;
    const long long at = ((long long)b * a.H + h) * a.Sq + q;
    lse2[r] = q < a.Sq ? a.lse[at] * FA_LOG2E : 0.f;
    dlt[r] = q < a.Sq ? a.delta[at] : 0.f;
  }
  float dq[DN][4];
#pragma unroll
  for (int j = 0; j < DN; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) dq[j][i] = 0.f;

  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * FA_BK;
    if (t + 1 < n_kv) {
      const int st = (t + 1) % FA_STAGES;
      load_tile_async<D>(ks + st * FA_BK * LD, kg, a.k_ss, k0 + FA_BK, a.Skv, tid);
      load_tile_async<D>(vs + st * FA_BK * LD, vg, a.v_ss, k0 + FA_BK, a.Skv, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* kt = ks + (t % FA_STAGES) * FA_BK * LD;
    const __nv_bfloat16* vt = vs + (t % FA_STAGES) * FA_BK * LD;

    // P = exp(Q K^T * scale - lse)
    float s[8][4];
    mma_rows_x_rows<D>(s, qs + warp * 16 * LD, kt, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s[j][i] = fa_bwd_valid(a, row0 + (i >> 1) * 8, k0 + j * 8 + t4 * 2 + (i & 1))
                      ? exp2f(s[j][i] * sl2 - lse2[i >> 1])
                      : 0.f;
    // dS = P * (dO V^T - delta)
    float dp[8][4];
    mma_rows_x_rows<D>(dp, dos + warp * 16 * LD, vt, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] *= dp[j][i] - dlt[i >> 1];
    mma_frag_x_tile<D>(dq, s, kt, lane);  // dQ += dS K
    __syncthreads();  // stage t % FA_STAGES is free for tile t + FA_STAGES
  }
  cp_async_wait<0>();

  __nv_bfloat16* dqg = static_cast<__nv_bfloat16*>(a.dq);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = row0 + r * 8;
    if (q < a.Sq) {
      __nv_bfloat16* row = dqg + ((long long)(b * a.Sq + q) * a.H + h) * D;
#pragma unroll
      for (int j = 0; j < DN; ++j)
        *reinterpret_cast<__nv_bfloat162*>(row + j * 8 + t4 * 2) =
            __floats2bfloat162_rn(dq[j][2 * r] * a.scale, dq[j][2 * r + 1] * a.scale);
    }
  }
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
  const int k0 = blockIdx.x * FA_BK;
  const int b = blockIdx.y / a.Hkv;
  const int hk = blockIdx.y % a.Hkv;
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
        const long long at = ((long long)b * a.H + h) * a.Sq + q0 + r;
        const bool in = q0 + r < a.Sq;
        if (tid < FA_BQ) lse_s[r] = in ? a.lse[at] : 0.f;
        else dlt_s[r] = in ? a.delta[at] : 0.f;
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
  const int q0 = (gridDim.x - 1 - blockIdx.x) * FA_BQ;
  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y % a.H;
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
    const long long at = ((long long)b * a.H + h) * a.Sq + q0 + r;
    const bool in = r < nq;
    if (tid < FA_BQ) lse_s[r] = in ? a.lse[at] : 0.f;
    else dlt_s[r] = in ? a.delta[at] : 0.f;
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

template <typename Kernel>
int launch_bwd_kernel(Kernel kernel, dim3 grid, size_t smem,
                      const FlashBwdArgs& a, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, FA_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The plan's grids and shared memory (kernels/flash_attention.py:
// flash_bwd_plan) must be this layout's, or the launch is refused.
template <int D>
int launch_bwd_d(const FlashBwdArgs& a, int bf16, int delta_grid, int dkdv_x,
                 int dq_x, size_t dkdv_smem, size_t dq_smem, cudaStream_t st) {
  const size_t need_dkdv = bf16 ? bwd_dkdv_mma_smem_bytes<D>()
                                : bwd_dkdv_f32_smem_bytes<D>();
  const size_t need_dq = bf16 ? bwd_dq_mma_smem_bytes<D>() : bwd_dq_f32_smem_bytes<D>();
  const long long rows = (long long)a.B * a.Sq * a.H;
  if (dkdv_smem != need_dkdv || dq_smem != need_dq ||
      delta_grid != (rows + FA_DELTA_ROWS - 1) / FA_DELTA_ROWS ||
      dkdv_x != (a.Skv + FA_BK - 1) / FA_BK || dq_x != (a.Sq + FA_BQ - 1) / FA_BQ) {
    return (int)cudaErrorInvalidValue;
  }
  if (bf16) {
    flash_bwd_delta_kernel<__nv_bfloat16><<<delta_grid, FA_THREADS, 0, st>>>(a, D);
  } else {
    flash_bwd_delta_kernel<float><<<delta_grid, FA_THREADS, 0, st>>>(a, D);
  }
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  const dim3 g_dkdv(dkdv_x, a.B * a.Hkv), g_dq(dq_x, a.B * a.H);
  rc = bf16 ? launch_bwd_kernel(flash_bwd_dkdv_mma_kernel<D>, g_dkdv, dkdv_smem, a, st)
            : launch_bwd_kernel(flash_bwd_dkdv_f32_kernel<D>, g_dkdv, dkdv_smem, a, st);
  if (rc) return rc;
  return bf16 ? launch_bwd_kernel(flash_bwd_dq_mma_kernel<D>, g_dq, dq_smem, a, st)
              : launch_bwd_kernel(flash_bwd_dq_f32_kernel<D>, g_dq, dq_smem, a, st);
}

}  // namespace

extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, float* lse, int bf16,
    int B, int Sq, int Skv, int H, int Hkv, int D, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh, int kv_len,
    int causal, float scale, int grid_x, long long smem, void* stream) {
  FlashArgs a{q,    k,    v,    o,    lse,  B,    Sq,   Skv,  H,    Hkv,
              kv_len, causal, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
              v_sh, scale};
  cudaStream_t st = (cudaStream_t)stream;
  const size_t sm = (size_t)smem;
  switch (D) {
    case 16: return launch_d<16>(a, bf16, sm, grid_x, st);
    case 32: return launch_d<32>(a, bf16, sm, grid_x, st);
    case 64: return launch_d<64>(a, bf16, sm, grid_x, st);
    case 128: return launch_d<128>(a, bf16, sm, grid_x, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int bf16, int B, int Sq, int Skv, int H, int Hkv, int D,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, int causal, float scale, int delta_grid, int dkdv_x,
    int dq_x, long long dkdv_smem, long long dq_smem, void* stream) {
  FlashBwdArgs a{q,    k,    v,    o,    dout, lse,  delta, dq,   dk,   dv,
                 B,    Sq,   Skv,  H,    Hkv,  causal, q_sb, q_ss, q_sh, k_sb,
                 k_ss, k_sh, v_sb, v_ss, v_sh, scale};
  cudaStream_t st = (cudaStream_t)stream;
  const size_t s1 = (size_t)dkdv_smem, s2 = (size_t)dq_smem;
  switch (D) {
    case 16: return launch_bwd_d<16>(a, bf16, delta_grid, dkdv_x, dq_x, s1, s2, st);
    case 32: return launch_bwd_d<32>(a, bf16, delta_grid, dkdv_x, dq_x, s1, s2, st);
    case 64: return launch_bwd_d<64>(a, bf16, delta_grid, dkdv_x, dq_x, s1, s2, st);
    case 128: return launch_bwd_d<128>(a, bf16, delta_grid, dkdv_x, dq_x, s1, s2, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
