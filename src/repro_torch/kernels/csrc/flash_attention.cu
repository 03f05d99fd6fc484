// flash_attention_kernel — causal GQA online-softmax attention over q
// (B, Sq, H, D) and k, v (B, Skv, Hkv, D), behind the prefill of every
// attention layer of the dense LM (models/attention.py:blocked_attention).
// Replaces src/repro/kernels/flash_attention.py:_kernel (wrapper
// flash_attention); it builds into one library with the RSNN kernels.
//
// Function: the Pallas kernel's, with blocked_attention's padding rule.
// Scores q.k * scale with the products summed in f32; keys at positions
// >= kv_len, and keys after the query's position when causal, masked at
// -1e30; running max m, running sum l and the output accumulator in f32;
// p rounded to the value dtype before the p.V product; output in q's
// dtype, divided by max(l, 1e-30).  Key tiles wholly above the diagonal or
// past kv_len are skipped (the Pallas kernel's pl.when skip): their terms
// are exact zeros, since every row has seen key 0 in the first tile.
//
// Bound on the H100: 4*B*H*D*sum_q(valid keys) operations on bf16 tensor
// cores (989 TFLOP/s) against q, k, v read once and o written once (3.35
// TB/s) — set by operations at prefill lengths.  This first kernel runs the
// products as f32 FMAs on the CUDA cores (67 TFLOP/s at most), so it sits
// well above that bound; wgmma, TMA and warp specialisation are left for
// later.  Its design keeps everything a tile touches on chip:
//   * one block of 128 threads per (q tile of 64 rows, batch*head); tiles
//     with the most keys run first;
//   * the q tile and one 64-key tile of k and v staged in shared memory in
//     the input dtype, rows padded by 4 bytes so that a warp's column walk
//     hits 16 different banks; the 64x64 score / probability tile in f32;
//   * each thread owns 8 rows x 4 columns of the score tile and 8 rows x
//     D/16 columns of the output accumulator, in registers;
//   * two threads per row take the row max and sum, with one shuffle.
// q, k and v are read through their batch / sequence / head strides (the
// head dimension is contiguous), so the model's projections go in as they
// are.  The sums run in an order fixed by the shapes: two launches on the
// same inputs give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int FA_BQ = 64;        // query rows per block
constexpr int FA_BK = 64;        // keys per tile
constexpr int FA_THREADS = 128;  // 8 row groups x 16 column groups
constexpr int FA_PLD = FA_BK + 1;
constexpr float FA_NEG_INF = -1e30f;

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, Sq, Skv, H, Hkv, kv_len, causal;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Row pitch of a staged tile, in elements: D plus 4 bytes.
template <typename T, int D>
__host__ __device__ constexpr int tile_pitch() {
  return D + 4 / (int)sizeof(T);
}

template <typename T, int D>
constexpr size_t flash_smem_bytes() {
  return (size_t)(FA_BQ + 2 * FA_BK) * tile_pitch<T, D>() * sizeof(T) +
         (size_t)(FA_BQ * FA_PLD + 3 * FA_BQ) * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(FA_THREADS)
    flash_attention_kernel(FlashArgs a) {
  constexpr int LD = tile_pitch<T, D>();
  constexpr int DJ = D / 16;  // accumulator columns per thread
  extern __shared__ __align__(16) unsigned char fa_smem[];
  T* qs = reinterpret_cast<T*>(fa_smem);
  T* ks = qs + FA_BQ * LD;
  T* vs = ks + FA_BK * LD;
  float* ps = reinterpret_cast<float*>(vs + FA_BK * LD);
  float* m_s = ps + FA_BQ * FA_PLD;
  float* l_s = m_s + FA_BQ;
  float* c_s = l_s + FA_BQ;

  const int tid = threadIdx.x;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * FA_BQ;
  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y % a.H;
  const int hk = h / (a.H / a.Hkv);
  const int nq = min(FA_BQ, a.Sq - q0);
  const T* __restrict__ qg =
      static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* __restrict__ kg =
      static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* __restrict__ vg =
      static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  const T zero = from_f32<T>(0.f);

  for (int e = tid; e < FA_BQ * D; e += FA_THREADS) {
    const int r = e / D, d = e % D;
    qs[r * LD + d] = r < nq ? qg[(long long)(q0 + r) * a.q_ss + d] : zero;
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

  int n_kv = (a.kv_len + FA_BK - 1) / FA_BK;
  if (a.causal) n_kv = min(n_kv, (q0 + nq - 1) / FA_BK + 1);

  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * FA_BK;
    __syncthreads();  // the last tile's P.V is done with ks, vs and ps
    for (int e = tid; e < FA_BK * D; e += FA_THREADS) {
      const int r = e / D, d = e % D;
      const bool in = k0 + r < a.kv_len;
      ks[r * LD + d] = in ? kg[(long long)(k0 + r) * a.k_ss + d] : zero;
      vs[r * LD + d] = in ? vg[(long long)(k0 + r) * a.v_ss + d] : zero;
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
      for (int i = 0; i < 8; ++i) qv[i] = to_f32(qs[(tr + 8 * i) * LD + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = to_f32(ks[(tc + 16 * j) * LD + d]);
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
        pr[c] = to_f32(from_f32<T>(p));  // p in the value dtype for P.V
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
      for (int j = 0; j < DJ; ++j) vv[j] = to_f32(vs[c * LD + tc + 16 * j]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();  // l_s is final

  T* __restrict__ og = static_cast<T*>(a.o);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = tr + 8 * i;
    if (row < nq) {
      const float l = fmaxf(l_s[row], 1e-30f);
      T* orow = og + ((long long)(b * a.Sq + q0 + row) * a.H + h) * D;
#pragma unroll
      for (int j = 0; j < DJ; ++j)
        orow[tc + 16 * j] = from_f32<T>(acc[i][j] / l);
    }
  }
}

template <typename T, int D>
int launch_typed(const FlashArgs& a, cudaStream_t stream) {
  const size_t smem = flash_smem_bytes<T, D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.Sq + FA_BQ - 1) / FA_BQ, a.B * a.H);
  flash_attention_kernel<T, D><<<grid, FA_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dim(const FlashArgs& a, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_typed<T, 16>(a, stream);
    case 32: return launch_typed<T, 32>(a, stream);
    case 64: return launch_typed<T, 64>(a, stream);
    case 128: return launch_typed<T, 128>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int bf16, int B,
    int Sq, int Skv, int H, int Hkv, int D, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, int kv_len, int causal,
    float scale, void* stream) {
  FlashArgs a{q,    k,    v,    o,    B,    Sq,   Skv,  H,    Hkv,  kv_len,
              causal, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
              scale};
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? launch_dim<__nv_bfloat16>(a, D, st) : launch_dim<float>(a, D, st);
}
