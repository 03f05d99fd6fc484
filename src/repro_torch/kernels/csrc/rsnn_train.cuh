// The device side of the training kernels (rsnn_train.cu): rsnn_forward's
// forward phases, each kernel's body as a template over the surrogate
// (TRI), the reverse device functions, and the launch dispatch over W.  Included by rsnn_train.cu (the boxcar
// kernels, the reverse kernels and the launchers) and rsnn_train_tri.cu
// (the triangular surrogate's kernels): the kernels of each surrogate
// compile in a translation unit of their own.  The design notes are in
// rsnn_train.cu.
#pragma once
#include <cooperative_groups.h>

#include "rsnn_tick.cuh"

// Functions that are not templates or inline are static here: each
// translation unit that includes this header keeps its own copy.

// F over the ticks for neuron h of one row (eprop_update): l = sum_o
// err(t, o) b_fb[h, o] in o order, F = l + kappa*F, G(t) = h(t) * F,
// walking t = T-1..0.
static __device__ void rsnn_f_walk(const float* h, size_t sh, float* g, size_t sg,
                            const float* err, size_t se, const float* b_fb_h,
                            int O, int T, float kappa) {
  float bf[RSNN_MAX_OUT];
#pragma unroll
  for (int o = 0; o < RSNN_MAX_OUT; ++o) bf[o] = o < O ? b_fb_h[o] : 0.f;
  float f = 0.f;
  for (int t = T - 1; t >= 0; --t) {
    const float* e = err + (size_t)t * se;
    float l = 0.f;
#pragma unroll
    for (int o = 0; o < RSNN_MAX_OUT; ++o) {
      if (o < O) l += e[o] * bf[o];
    }
    f = l + kappa * f;
    g[(size_t)t * sg] = h[(size_t)t * sh] * f;
  }
}

// One row's traces as the dw sums read them; element (t, i) at
// base + t * stride + i.
struct RowGrad {
  const float* xbar; size_t sN;
  const float* pbar; const float* zbar; size_t sH;
  const float* g; size_t sG;
  const float* err; size_t sO;
};

// dw element e of one row (e over w_in, then w_rec, then w_out, row-major),
// summed over t = T-1..0.
static __device__ float rsnn_dw_elem(const RowGrad& r, int e, int N, int H, int O,
                              int T) {
  const int e_in = N * H, e_rec = H * H;
  const float* a;
  const float* b;
  size_t sa, sb;
  if (e < e_in) {
    a = r.xbar + e / H; sa = r.sN; b = r.g + e % H; sb = r.sG;
  } else if (e < e_in + e_rec) {
    e -= e_in;
    a = r.pbar + e / H; sa = r.sH; b = r.g + e % H; sb = r.sG;
  } else {
    e -= e_in + e_rec;
    a = r.zbar + e / O; sa = r.sH; b = r.err + e % O; sb = r.sO;
  }
  float acc = 0.f;
#pragma unroll 8
  for (int t = T - 1; t >= 0; --t) acc += a[(size_t)t * sa] * b[(size_t)t * sb];
  return acc;
}

// Row b's view of (T, B, .) device traces.
__device__ __forceinline__ RowGrad device_row(const float* xbar,
                                              const float* pbar,
                                              const float* zbar,
                                              const float* g, const float* err,
                                              int b, int B, int N, int H,
                                              int O) {
  return RowGrad{xbar + (size_t)b * N, (size_t)B * N,
                 pbar + (size_t)b * H, zbar + (size_t)b * H, (size_t)B * H,
                 g + (size_t)b * H, (size_t)B * H,
                 err + (size_t)b * O, (size_t)B * O};
}

struct TrainArgs {
  const float* raster;   // (T, B, N)
  const float* y_star;   // (B, O)
  const float* valid;    // (T, B)
  const float* w_in;
  const float* w_rec;
  const float* w_out;
  const float* b_fb;     // (H, O)
  // (T, B, .) device traces h, xbar, pbar, zbar, err and G: the scratch of
  // the device path; in the shared-memory path h is null unless the caller
  // asked for the traces (then the forward writes a copy), and g unused
  float* tr_h;
  float* tr_xbar;
  float* tr_pbar;
  float* tr_zbar;
  float* tr_err;
  float* g;
  float* dw_part;        // (B, E)
  float* acc_y;          // (B, O)
  float* n_spk;          // (B, 1)
  int T, B, N, H, O;
  int cluster;           // blocks a row (a thread-block cluster)
  int ticks;             // ticks a block of the chain
  int weights_smem, infer_all;
  // null, or (RSNN_TRAIN_CLOCK_ROLES, 2) clock64() readings of row 0's
  // roles: when each began and ended its work (the time split by role;
  // nothing else reads them)
  long long* clocks;
};

// The roles whose clocks TrainArgs::clocks records: the leader's setup
// (staging, the barriers and the input currents), chain, xbar filter,
// first filter warp and first readout warp; the F walk and the dw sums of the first block
// that runs them (the leader of a one-block row, else block 1); block 1's
// mirror of the leader's trace set.
#define RSNN_TRAIN_CLOCK_ROLES 8

// Dynamic shared memory of one rsnn_train block, in 4-byte words: two
// mbarriers a tick block of `ticks` ticks, the row's valid mask (T) and
// spike masks (T * ceil(H/32)), the weights when they fit, the row's
// trace set when it fits beside them (kernels/rsnn_step.py:train_plan
// makes the same choice; the trace set stays on chip only with the
// weights).  Every block of a cluster has the leader's layout.
__host__ __device__ inline size_t rsnn_train_smem_floats(int T, int N, int H,
                                                         int O, int ticks,
                                                         int weights_smem,
                                                         int traces_smem) {
  size_t w = weights_smem ? (size_t)N * H + (size_t)H * H + (size_t)H * O : 0;
  size_t tr = traces_smem ? (size_t)T * (3 * (size_t)H + N + O) : 0;
  return 4 * (size_t)((T + ticks - 1) / ticks) + (size_t)T * (1 + (H + 31) / 32) + w + tr;
}

// rsnn_forward's phases besides rsnn_tick.cuh's input sums
// (rsnn_input_currents), LIF loop (rsnn_row_lif) and leaks
// (rsnn_leak_out).

// The xbar filter of input k of one row, xbar = alpha*xbar + x over the
// ticks: x(t, k) at x[t * sx + k], xbar(t, k) to out[t * so + k] (out may
// be x: in place) and, when cp, to copy[t * sc + k].
__device__ __forceinline__ void rsnn_xbar_walk(const float* x, size_t sx,
                                               float* out, size_t so,
                                               float* copy, size_t sc, bool cp,
                                               int k, int T, float alpha) {
  float xb = 0.f;
  for (int t = 0; t < T; ++t) {
    xb = alpha * xb + x[(size_t)t * sx + k];
    rsnn_put(out, so, t, k, xb);
    if (cp) rsnn_put(copy, sc, t, k, xb);
  }
}

// The readout currents of one row over T ticks, after the LIF loop: every
// (tick, output) sums w_out over the tick's spikes in ascending h
// (rsnn_readout_sum) into y(t, o) at y[t * sy + o]; the block's threads
// share the items.
__device__ __forceinline__ void rsnn_readout_currents(const unsigned* spikes,
                                                      int J, const float* w_out,
                                                      int T, int O, float* y,
                                                      size_t sy) {
  for (int i = threadIdx.x; i < T * O; i += blockDim.x) {
    const int t = i / O, o = i - (i / O) * O;
    rsnn_put(y, sy, t, o, rsnn_readout_sum(spikes + t * J, J, w_out, O, o));
  }
}

// ---------------------------------------------------------------------------
// rsnn_train_exact: exact-mode e-prop (per-synapse traces)
// ---------------------------------------------------------------------------

// Presynaptic lines a walker thread carries, the block's threads, the
// ring's most slots and ticks a slot, the leader block's chain and readout
// warps (kernels/rsnn_step.py:train_exact_plan names the same numbers).
#define RSNN_EXACT_KMAX 16
#define RSNN_EXACT_THREADS 512
#define RSNN_EXACT_MAX_SLOTS 4
#define RSNN_EXACT_MAX_TICKS 32
#define RSNN_EXACT_READOUT_WARPS 2

struct ExactArgs {
  const float* raster;   // (T, B, N)
  const float* y_star;   // (B, O)
  const float* valid;    // (T, B)
  const float* w_in;
  const float* w_rec;
  const float* w_out;
  const float* b_fb;     // (H, O)
  const float* alpha;    // (H) the neurons' decays
  float* dw_part;        // (B, E)
  float* acc_y;          // (B, O)
  float* n_spk;          // (B, 1)
  int T, B, N, H, O;
  int cluster;           // blocks a cluster
  int groups;            // clusters a row, each walking its share of the lines
  int slots, ticks;      // ring slots, ticks a slot
  int inputs;            // the leader's input warps
  int g_in, g_rec, g_out;  // walker threads a neuron j per line kind
  int k;                 // lines a walker thread: 1, 2, 4, 8 or RSNN_EXACT_KMAX
  int weights_smem, infer_all;
  // null, or (RSNN_EXACT_CLOCK_ROLES, tick blocks, 2) clock64() readings of
  // the first cluster's roles: when each began and ended its work on each
  // tick block (the time split by role; nothing else reads them)
  long long* clocks;
};

// The roles whose clocks ExactArgs::clocks records: the chain, the first
// input warp, the first readout warp, the leader's first walker warp and
// block 1's first warp (a walker block's copy and walk).
#define RSNN_EXACT_CLOCK_ROLES 5

// The leader block's warps before its walkers: the chain, the readout and
// the input warps.
__host__ __device__ inline int rsnn_exact_role_warps(int inputs) {
  return 1 + RSNN_EXACT_READOUT_WARPS + inputs;
}

// Leader warp w's index among the leader's walker warps, or -1: the warps
// after the roles, but for those that share the chain's scheduler (w % 4
// == 0, as warp 0), which stay idle so that no walker takes the chain's
// issue slots.  rsnn_exact_leader_walker(nwarps, roles) counts them.
__host__ __device__ inline int rsnn_exact_leader_walker(int w, int roles) {
  if (w < roles || (w & 3) == 0) return -1;
  int n = 0;
  for (int i = roles; i < w; ++i) n += (i & 3) != 0;
  return n;
}

__host__ __device__ inline int rsnn_exact_leader_walkers(int nwarps, int roles) {
  int n = 0;
  for (int i = roles; i < nwarps; ++i) n += (i & 3) != 0;
  return n;
}

// One ring slot of `tb` ticks from tick t0, element (t, i) at base + t *
// width + i: the input currents and then h (rows of 32*J words,
// ROW_EXACT's padding), the learning signal l (H), the inputs x (N), the
// readout y and then its error (O), the spike masks (J words; row 0 the
// tick before t0, row t + 1 tick t0 + t), the valid mask.  The words are
// rounded up to a multiple of 4 so that every slot starts 16-byte aligned.
struct ExactSlot {
  float* h;
  float* l;
  float* x;
  float* err;
  unsigned* spk;
  float* vs;
};

__host__ __device__ inline size_t rsnn_exact_slot_words(int N, int H, int O, int tb) {
  const size_t J = (H + 31) / 32;
  const size_t w = (size_t)tb * (32 * J + H + N + O + 1) + (tb + 1) * J;
  return (w + 3) / 4 * 4;
}

__device__ __forceinline__ ExactSlot rsnn_exact_slot(float* base, int N, int H, int O,
                                                     int tb) {
  const int J = (H + 31) / 32;
  ExactSlot q;
  q.h = base;
  q.l = q.h + tb * 32 * J;
  q.x = q.l + tb * H;
  q.err = q.x + tb * N;
  q.spk = reinterpret_cast<unsigned*>(q.err + tb * O);
  q.vs = reinterpret_cast<float*>(q.spk + (tb + 1) * J);
  return q;
}

// Dynamic shared memory of one rsnn_train_exact block, in 4-byte words
// (kernels/rsnn_step.py:train_exact_plan): four mbarriers a slot, the
// decays alpha (H), the readout's w_out and b_fb (H*O each), w_in and w_rec when staged,
// then the ring from a 16-byte boundary.  Nothing grows with T.
__host__ __device__ inline size_t rsnn_exact_ring_offset(int N, int H, int O,
                                                         int slots, int weights_smem) {
  const size_t w = weights_smem ? (size_t)N * H + (size_t)H * H : 0;
  return (8 * (size_t)slots + H + 2 * (size_t)H * O + w + 3) / 4 * 4;
}

__host__ __device__ inline size_t rsnn_exact_smem_words(int N, int H, int O, int slots,
                                                        int tb, int weights_smem) {
  return rsnn_exact_ring_offset(N, H, O, slots, weights_smem) +
         (size_t)slots * rsnn_exact_slot_words(N, H, O, tb);
}

// mbarrier operations (PTX): init; an arrive (release) on this block's
// barrier or, through its cluster address, on the barrier at the same
// offset in block `rank` of the cluster; a wait for a phase's parity, the
// thread suspended until it completes, with acquire at block scope (every
// arrival from this block) or cluster scope (arrivals from other blocks of
// the cluster: what they wrote before they arrived is visible after it).
__device__ __forceinline__ unsigned rsnn_smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void rsnn_mbar_init(unsigned long long* b, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(rsnn_smem_addr(b)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void rsnn_mbar_arrive(unsigned long long* b) {
  asm volatile("mbarrier.arrive.release.cta.shared::cta.b64 _, [%0];" ::"r"(
                   rsnn_smem_addr(b)) : "memory");
}

__device__ __forceinline__ void rsnn_mbar_arrive_at(unsigned long long* b, unsigned rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote)
               : "r"(rsnn_smem_addr(b)), "r"(rank));
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(remote)
               : "memory");
}

template <bool CLUSTER>
__device__ __forceinline__ void rsnn_mbar_wait(unsigned long long* b, unsigned parity) {
  const unsigned addr = rsnn_smem_addr(b);
  unsigned done = 0;
  while (!done) {
    if (CLUSTER) {
      asm volatile(
          "{\n"
          ".reg .pred p;\n"
          "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2, %3;\n"
          "selp.u32 %0, 1, 0, p;\n"
          "}\n"
          : "=r"(done) : "r"(addr), "r"(parity), "r"(10000000) : "memory");
    } else {
      asm volatile(
          "{\n"
          ".reg .pred p;\n"
          "mbarrier.try_wait.parity.acquire.cta.shared::cta.b64 p, [%1], %2, %3;\n"
          "selp.u32 %0, 1, 0, p;\n"
          "}\n"
          : "=r"(done) : "r"(addr), "r"(parity), "r"(10000000) : "memory");
    }
  }
}

// The readout error of one tick over its O <= NO outputs, in place at
// e[o], from the tick's valid mask vd and the one-hot target ys, in the
// contract's order (rsnn_tick.cuh): softmax(y*s) - y* or y*s - amp*y*,
// times vd.  NO bounds the unrolled loops (4, 8 or RSNN_MAX_OUT).
template <int NO>
__device__ __forceinline__ void rsnn_tick_error(float* e, float vd,
                                                const float (&ys)[RSNN_MAX_OUT],
                                                const TickParams& p, int O) {
  float u[NO];
#pragma unroll
  for (int o = 0; o < NO; ++o) u[o] = o < O ? e[o] * p.y_scale : 0.f;
  float m = u[0];
#pragma unroll
  for (int o = 1; o < NO; ++o) {
    if (o < O) m = fmaxf(m, u[o]);
  }
  if (p.err_softmax) {
    float sum = 0.f;
#pragma unroll
    for (int o = 0; o < NO; ++o) {
      if (o < O) {
        u[o] = expf(u[o] - m);
        sum += u[o];
      }
    }
#pragma unroll
    for (int o = 0; o < NO; ++o) {
      if (o < O) u[o] = (u[o] / sum - ys[o]) * vd;
    }
  } else {
#pragma unroll
    for (int o = 0; o < NO; ++o) {
      if (o < O) u[o] = (u[o] - p.target_amp * ys[o]) * vd;
    }
  }
#pragma unroll
  for (int o = 0; o < NO; ++o) {
    if (o < O) e[o] = u[o];
  }
}

// One 4-byte copy from global to shared memory, asynchronous (cp.async):
// complete after this thread's next cp.async.wait_all.
__device__ __forceinline__ void rsnn_copy_async(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(rsnn_smem_addr(dst)),
               "l"(__cvta_generic_to_global(src)) : "memory");
}

// Lines of kind-count L a walker thread at offset gi of G carries: gi,
// gi + G, ... below L.
__device__ __forceinline__ int rsnn_exact_lines(int L, int gi, int G) {
  return gi < L ? (L - 1 - gi) / G + 1 : 0;
}

// The learning signal of one tick block, l(t, j) = sum_o err(t, o) b_fb[j,
// o] in o order, for neurons j = j0, j0 + stride, ... over n ticks; each
// neuron's row of b_fb in registers, O <= NO (4, 8 or RSNN_MAX_OUT).
template <int NO>
__device__ __forceinline__ void rsnn_exact_signal(const ExactSlot& q, int n, int H, int O,
                                                  const float* bf, int j0, int stride) {
  for (int j = j0; j < H; j += stride) {
    float f[NO];
#pragma unroll
    for (int o = 0; o < NO; ++o) f[o] = o < O ? bf[j * O + o] : 0.f;
    for (int t = 0; t < n; ++t) {
      const float* e = q.err + t * O;
      float l = 0.f;
#pragma unroll
      for (int o = 0; o < NO; ++o) {
        if (o < O) l += e[o] * f[o];
      }
      q.l[t * H + j] = l;
    }
  }
}

// The per-synapse walks of one tick block over the slot q (this block's
// or a mirror of the leader's), n ticks, for a walker thread of neuron j
// carrying K lines gi, gi + G, ... of one kind (L lines of that kind; a
// line past them walks line L - 1 again and is never stored), its
// synapses' state in registers from block to block, the ticks in the
// reference's order (repro/core/eprop.py:run_sample_exact):
//   input line i (synapse (i, j)):      eps = a_j*eps + x_i(t);
//   recurrent line k:                   eps = a_j*eps + z_k(t - 1);
//     ebar = kappa*ebar + h_j(t)*eps;  dw += ebar*l_j(t)
//   readout line o (synapse (j, o)):    zbar = kappa*zbar + z_j(t);
//                                       dw += zbar*err_o(t)
// (zbar in eps's registers).  K is a template argument, so that no lane
// steps through lines it does not carry.
template <int KIND, int K>
__device__ __forceinline__ void rsnn_exact_walk(const ExactSlot& q, int n, int N, int H,
                                                int O, int j, int gi, int G, int L,
                                                float aj, float kappa,
                                                float (&eps)[RSNN_EXACT_KMAX],
                                                float (&ebar)[RSNN_EXACT_KMAX],
                                                float (&acc)[RSNN_EXACT_KMAX]) {
  const int J = (H + 31) / 32, HP = 32 * J;
  for (int t = 0; t < n; ++t) {
    if (KIND == 2) {
      const float zj = (q.spk[(t + 1) * J + (j >> 5)] >> (j & 31)) & 1u ? 1.f : 0.f;
      const float* e = q.err + t * O;
#pragma unroll
      for (int g = 0; g < K; ++g) {
        eps[g] = kappa * eps[g] + zj;
        acc[g] += eps[g] * e[min(gi + g * G, L - 1)];
      }
      continue;
    }
    const float hj = q.h[t * HP + j], lj = q.l[t * H + j];
    const float* xt = q.x + t * N;
    const unsigned* zt = q.spk + t * J;
#pragma unroll
    for (int g = 0; g < K; ++g) {
      const int k = min(gi + g * G, L - 1);
      const float s = KIND == 0 ? xt[k] : ((zt[k >> 5] >> (k & 31)) & 1u ? 1.f : 0.f);
      eps[g] = aj * eps[g] + s;
      ebar[g] = kappa * ebar[g] + hj * eps[g];
      acc[g] += ebar[g] * lj;
    }
  }
}

// rsnn_exact_walk at the launch's lines a thread (1, 2, 4, 8 or 16).
template <int KIND>
__device__ __forceinline__ void rsnn_exact_walk_k(int k, const ExactSlot& q, int n, int N,
                                                  int H, int O, int j, int gi, int G, int L,
                                                  float aj, float kappa,
                                                  float (&eps)[RSNN_EXACT_KMAX],
                                                  float (&ebar)[RSNN_EXACT_KMAX],
                                                  float (&acc)[RSNN_EXACT_KMAX]) {
#define RSNN_EXACT_WALK(K) \
  rsnn_exact_walk<KIND, K>(q, n, N, H, O, j, gi, G, L, aj, kappa, eps, ebar, acc)
  switch (k) {
    case 1: RSNN_EXACT_WALK(1); break;
    case 2: RSNN_EXACT_WALK(2); break;
    case 4: RSNN_EXACT_WALK(4); break;
    case 8: RSNN_EXACT_WALK(8); break;
    default: RSNN_EXACT_WALK(RSNN_EXACT_KMAX);
  }
#undef RSNN_EXACT_WALK
}

// rsnn_train_exact_kernel — exact-mode e-prop behind
// ExecutionBackend.train_tile with EpropConfig(mode="exact"): the
// counterpart of the reference's scan backend, which compiles
// src/repro/core/eprop.py:run_sample_exact into one device program a tile
// (no Pallas kernel).
//
// Nothing of the forward reads a synapse's eps or ebar, so the walks of one
// tick block can run beside the forward of the next.  A row runs on
// `groups` thread-block clusters of `cluster` blocks (one group and one
// block at the END_B tile; the plan spreads a row over up to eight blocks
// at small B, and over several groups where the synapses' registers need
// them).  Block 0 of a cluster, the leader, keeps a ring of `slots` tick
// blocks of `ticks` ticks in shared memory (ExactSlot) beside w_out and
// b_fb, and runs the forward in roles, each handing a slot on through
// mbarriers (no block barrier inside a tick loop):
//   the input warps (`inputs` of them, U ticks at a time in turn): once
//     the walkers have freed the slot, copy their ticks' raster rows and
//     valid mask in and sum their input currents
//     (rsnn_input_current_items) — ahead of the chain;
//   warp 0, the LIF chain: writes the carried spike masks as the slot's
//     row 0, then runs rsnn_row_lif<ROW_EXACT> (each neuron leaking by its
//     own alpha) through the block from the carries in its registers,
//     writing h and the spike masks — no pbar or zbar on the chain;
//   warps 1-2, the readout: the readout currents, the LI leak (y and acc_y
//     carried in registers from block to block), the readout error
//     (rsnn_tick_error) and the learning signal (rsnn_exact_signal), then
//     an arrive on every block's "ready" barrier;
//   the other warps (walkers) walk the block's synapses (rsnn_exact_walk)
//     and free the slot; those that share the chain's scheduler (warp % 4
//     == 0) stay idle.
// The other blocks of the cluster are all walkers: each copies the leader's
// slot once into a mirror of its own (distributed shared memory, the
// cluster address from cg::cluster_group::map_shared_rank), frees the
// leader's slot and walks the mirror.  A walker thread owns a neuron j and
// up to RSNN_EXACT_KMAX lines of one kind (g_in, g_rec, g_out threads a
// neuron), whose (eps, ebar, dw) stay in registers through all T ticks;
// the walker warps take turns over the blocks of the cluster.  Every value
// is the one a walk after the whole forward would give, the same
// operations on the same operands in the same order, so dw, acc_y and
// n_spk do not depend on the layout (cluster, groups, slots, ticks).  Then
// rsnn_dw_reduce_kernel, or on the commit grid rsnn_dw_codes_reduce_kernel,
// sums the rows' partials.
//
// Bound on the H100: 7 operations a synapse and tick (eps 2, ebar 3, dw 2)
// over (N + H) * H synapses, plus 4 * H * O a tick for l and dw_out
// (kernels/traffic.py:train_exact_event_flops); the bytes (raster, weights
// in, dw out) are fewer.  The row's LIF chain (some hundreds of cycles a
// tick) sets the pace when every other role takes less time a tick block
// than the chain: the roles' clocks (ExactArgs::clocks) show which does
// not.  Issue slots decide it: a walker that steps through lines it does
// not carry, or a readout loop unrolled to RSNN_MAX_OUT with guards, took
// as long a block as the chain on the card.
template <int W, bool TRI>
__device__ __forceinline__ void rsnn_train_exact_row(const ExactArgs& a, const TickParams& p) {
  namespace cg = cooperative_groups;
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int T = a.T, B = a.B, N = a.N, H = a.H, O = a.O, J = (H + 31) / 32;
  const int C = a.cluster, S = a.slots, tb = a.ticks, NI = a.inputs;
  const int rank = (int)cluster.block_rank();
  const int cid = blockIdx.x / C;   // the cluster: row cid / groups, group cid % groups
  const int b = cid / a.groups, grp = cid - b * a.groups;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int roles = rsnn_exact_role_warps(NI);
  const int nwarps = blockDim.x >> 5, lwarps = rsnn_exact_leader_walkers(nwarps, roles);
  const int nblk = (T + tb - 1) / tb;
  const int M = S < 2 ? S : 2;   // a walker block's mirrors
  // the leader's filled, chained, ready, empty; a walker block's copied,
  // freed (in filled's and chained's places) and ready
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* filled = bar;
  unsigned long long* chained = bar + S;
  unsigned long long* ready = bar + 2 * S;
  unsigned long long* empty = bar + 3 * S;
  float* al = smem + 8 * S;
  float* wo = al + H;
  float* bf = wo + H * O;
  const float* w_in = a.w_in;
  const float* w_rec = a.w_rec;
  if (rank == 0) {
    for (int h = tid; h < H; h += blockDim.x) al[h] = a.alpha[h];
    for (int i = tid; i < H * O; i += blockDim.x) {
      wo[i] = a.w_out[i];
      bf[i] = a.b_fb[i];
    }
    if (a.weights_smem) {
      float* wi = bf + H * O;
      float* wr = wi + N * H;
      for (int i = tid; i < N * H; i += blockDim.x) wi[i] = a.w_in[i];
      for (int i = tid; i < H * H; i += blockDim.x) wr[i] = a.w_rec[i];
      w_in = wi; w_rec = wr;
    }
  }
  float* ring = smem + rsnn_exact_ring_offset(N, H, O, S, a.weights_smem);
  const size_t sw = rsnn_exact_slot_words(N, H, O, tb);
  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      rsnn_mbar_init(&filled[i], rank == 0 ? NI : nwarps);
      rsnn_mbar_init(&chained[i], rank == 0 ? 1 : nwarps);
      rsnn_mbar_init(&ready[i], RSNN_EXACT_READOUT_WARPS);
      rsnn_mbar_init(&empty[i], lwarps + (C - 1) * nwarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster.sync();
  // role r's clock at the start (end 0) or end (end 1) of tick block k
  long long* clocks = a.clocks && (int)blockIdx.x < C && lane == 0 ? a.clocks : nullptr;
  auto mark = [&](int r, int k, int end) {
    if (clocks) clocks[(r * nblk + k) * 2 + end] = clock64();
  };

  if (rank == 0 && warp == 0) {
    // the LIF chain
    RowCarry<W> c;
    rsnn_carry_zero(c);
    for (int k = 0; k < nblk; ++k) {
      const int sl = k % S;
      const ExactSlot q = rsnn_exact_slot(ring + sl * sw, N, H, O, tb);
      rsnn_mbar_wait<false>(&filled[sl], (k / S) & 1);
      mark(0, k, 0);
#pragma unroll
      for (int j = 0; j < W; ++j) {
        if (j < J && lane == 0) q.spk[j] = c.z[j];
      }
      const RowTraces tr{q.h, nullptr, nullptr, nullptr, nullptr, (size_t)(32 * J), 0, 0};
      rsnn_row_lif<W, ROW_EXACT, false, true, TRI>(c, tr, RowTraces{}, w_rec, q.vs, nullptr,
                                                   q.spk + J, min(tb, T - k * tb), H, p, al);
      __syncwarp();
      if (lane == 0) rsnn_mbar_arrive(&chained[sl]);
      mark(0, k, 1);
    }
    if (lane == 0 && grp == 0) a.n_spk[b] = c.nspk;
  } else if (rank == 0 && warp <= RSNN_EXACT_READOUT_WARPS) {
    // the readout: y, acc_y, the error, l
    const int rt = tid - 32, nrt = 32 * RSNN_EXACT_READOUT_WARPS;
    float ys[RSNN_MAX_OUT];
#pragma unroll
    for (int o = 0; o < RSNN_MAX_OUT; ++o) ys[o] = o < O ? a.y_star[(size_t)b * O + o] : 0.f;
    float y = 0.f, acc = 0.f;
    for (int k = 0; k < nblk; ++k) {
      const int sl = k % S, n = min(tb, T - k * tb);
      const ExactSlot q = rsnn_exact_slot(ring + sl * sw, N, H, O, tb);
      rsnn_mbar_wait<false>(&chained[sl], (k / S) & 1);
      if (warp == 1) mark(2, k, 0);
      for (int i = rt; i < n * O; i += nrt) {
        const int t = i / O;
        q.err[i] = rsnn_readout_sum(q.spk + (t + 1) * J, J, wo, O, i - t * O);
      }
      asm volatile("bar.sync 1, %0;" ::"r"(nrt) : "memory");
      if (rt < O) {
#pragma unroll 4
        for (int t = 0; t < n; ++t) {
          float* e = q.err + t * O + rt;
          y = rsnn_leak_out(y, *e, p);
          acc += y * (a.infer_all ? 1.f : q.vs[t]);
          *e = y;
        }
      }
      asm volatile("bar.sync 1, %0;" ::"r"(nrt) : "memory");
      for (int t = rt; t < n; t += nrt) {
        if (O <= 4) {
          rsnn_tick_error<4>(q.err + t * O, q.vs[t], ys, p, O);
        } else if (O <= 8) {
          rsnn_tick_error<8>(q.err + t * O, q.vs[t], ys, p, O);
        } else {
          rsnn_tick_error<RSNN_MAX_OUT>(q.err + t * O, q.vs[t], ys, p, O);
        }
      }
      asm volatile("bar.sync 1, %0;" ::"r"(nrt) : "memory");
      if (O <= 4) {
        rsnn_exact_signal<4>(q, n, H, O, bf, rt, nrt);
      } else if (O <= 8) {
        rsnn_exact_signal<8>(q, n, H, O, bf, rt, nrt);
      } else {
        rsnn_exact_signal<RSNN_MAX_OUT>(q, n, H, O, bf, rt, nrt);
      }
      __syncwarp();
      if (lane < C) rsnn_mbar_arrive_at(&ready[sl], lane);
      if (warp == 1) mark(2, k, 1);
    }
    if (rt < O && grp == 0) a.acc_y[(size_t)b * O + rt] = acc;
  } else if (rank == 0 && warp < roles) {
    // an input warp: raster rows, valid mask and input currents of the
    // block's U-tick chunks c with c % NI == its index
    constexpr int U = RsnnItems<W>::U;
    const int iw = warp - 1 - RSNN_EXACT_READOUT_WARPS;
    for (int k = 0; k < nblk; ++k) {
      const int sl = k % S, t0 = k * tb, n = min(tb, T - t0);
      const ExactSlot q = rsnn_exact_slot(ring + sl * sw, N, H, O, tb);
      if (k >= S) {
        if (C > 1) {
          rsnn_mbar_wait<true>(&empty[sl], (k / S - 1) & 1);
        } else {
          rsnn_mbar_wait<false>(&empty[sl], (k / S - 1) & 1);
        }
      }
      if (iw == 0) mark(1, k, 0);
      // the raster rows and valid masks of this warp's chunks, copied
      // asynchronously, all in flight together
      for (int t = iw * U; t < n; t += NI * U) {
        const int m = min(U, n - t);
        for (int i = lane; i < m * N; i += 32) {
          const int tt = i / N;
          rsnn_copy_async(q.x + t * N + i,
                          a.raster + ((size_t)(t0 + t + tt) * B + b) * N + (i - tt * N));
        }
        if (lane < m) rsnn_copy_async(q.vs + t + lane, a.valid + (size_t)(t0 + t + lane) * B + b);
      }
      asm volatile("cp.async.wait_all;" ::: "memory");
      __syncwarp();
      for (int t = iw * U; t < n; t += NI * U) {
        const int m = min(U, n - t);
        const float* xr[U];
        float* cr[U];
        bool on[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int tt = t + min(u, m - 1);
          on[u] = u < m;
          xr[u] = q.x + tt * N;
          cr[u] = q.h + tt * 32 * J;
        }
        rsnn_input_current_items<W, U>(xr, on, w_in, cr, N, H);
      }
      __syncwarp();
      if (lane == 0) rsnn_mbar_arrive(&filled[sl]);
      if (iw == 0) mark(1, k, 1);
    }
  } else if (rank != 0 || (warp & 3) != 0) {
    // a walker: neuron j, lines gi, gi + G, ... of one kind
    const int lw = rank == 0 ? rsnn_exact_leader_walker(warp, roles) : warp;
    const int ww = lw < lwarps ? lw * C + rank : lwarps * C + (lw - lwarps) * (C - 1) + rank - 1;
    const int v = grp * (lwarps + (C - 1) * nwarps) * 32 + ww * 32 + lane;
    int kind = 3, j = 0, gi = 0, G = 1, L = 1;
    if (v < H * (a.g_in + a.g_rec + a.g_out)) {
      j = v % H;
      gi = v / H;
      if (gi < a.g_in) {
        kind = 0; G = a.g_in; L = N;
      } else if ((gi -= a.g_in) < a.g_rec) {
        kind = 1; G = a.g_rec; L = H;
      } else {
        gi -= a.g_rec;
        kind = 2; G = a.g_out; L = O;
      }
    }
    const int nl = kind == 3 ? 0 : rsnn_exact_lines(L, gi, G);
    const float aj = a.alpha[j], kappa = p.kappa;
    float eps[RSNN_EXACT_KMAX], ebar[RSNN_EXACT_KMAX], acc[RSNN_EXACT_KMAX];
#pragma unroll
    for (int g = 0; g < RSNN_EXACT_KMAX; ++g) { eps[g] = 0.f; ebar[g] = 0.f; acc[g] = 0.f; }
    const float4* lead = reinterpret_cast<const float4*>(cluster.map_shared_rank(ring, 0));
    for (int k = 0; k < nblk; ++k) {
      const int sl = k % S, n = min(tb, T - k * tb);
      float* base = ring + sl * sw;
      if (rank != 0) {
        // copy the leader's slot into mirror m, free the leader's slot
        const int m = k % M;
        base = ring + m * sw;
        if (k >= M) rsnn_mbar_wait<false>(&chained[m], (k / M - 1) & 1);
        rsnn_mbar_wait<true>(&ready[sl], (k / S) & 1);
        if (rank == 1 && warp == 0) mark(4, k, 0);
        const float4* src = lead + sl * sw / 4;
        float4* dst = reinterpret_cast<float4*>(base);
        for (int i = tid; i < (int)(sw / 4); i += blockDim.x) dst[i] = src[i];
        __syncwarp();
        if (lane == 0) {
          rsnn_mbar_arrive_at(&empty[sl], 0);
          rsnn_mbar_arrive(&filled[m]);
        }
        rsnn_mbar_wait<false>(&filled[m], (k / M) & 1);
      } else {
        rsnn_mbar_wait<false>(&ready[sl], (k / S) & 1);
        if (lw == 0) mark(3, k, 0);
      }
      const ExactSlot q = rsnn_exact_slot(base, N, H, O, tb);
      if (kind == 0) {
        rsnn_exact_walk_k<0>(a.k, q, n, N, H, O, j, gi, G, L, aj, kappa, eps, ebar, acc);
      } else if (kind == 1) {
        rsnn_exact_walk_k<1>(a.k, q, n, N, H, O, j, gi, G, L, aj, kappa, eps, ebar, acc);
      } else if (kind == 2) {
        rsnn_exact_walk_k<2>(a.k, q, n, N, H, O, j, gi, G, L, aj, kappa, eps, ebar, acc);
      }
      __syncwarp();
      if (lane == 0) rsnn_mbar_arrive(rank == 0 ? &empty[sl] : &chained[k % M]);
      if (rank == 0 ? lw == 0 : rank == 1 && warp == 0) mark(rank == 0 ? 3 : 4, k, 1);
    }
    float* part = a.dw_part + (size_t)b * ((size_t)(N + H) * H + (size_t)H * O);
#pragma unroll
    for (int g = 0; g < RSNN_EXACT_KMAX; ++g) {
      if (g < nl) {
        const int line = gi + g * G;
        const size_t e = kind == 0   ? (size_t)line * H + j
                         : kind == 1 ? (size_t)(N + line) * H + j
                                     : (size_t)(N + H) * H + (size_t)j * O + line;
        part[e] = acc[g];
      }
    }
  }
  // no block leaves while another may still reach its shared memory
  cluster.sync();
}

// ---------------------------------------------------------------------------
// rsnn_train: factored e-prop (the design notes are in rsnn_train.cu)
// ---------------------------------------------------------------------------

// The block's threads, its readout warps and the warp of the xbar filter
// (kernels/rsnn_step.py:train_plan names the same numbers).  The warps
// after the xbar warp filter pbar and zbar, one thread a neuron (288
// threads: every neuron of the chip's 256), but for those that share the
// chain's scheduler (warp % 4 == 0, as warp 0), which stay idle while the
// chain runs.
#define RSNN_TRAIN_THREADS 512
#define RSNN_TRAIN_READOUT_WARPS 2
#define RSNN_TRAIN_XBAR_WARP (RSNN_TRAIN_READOUT_WARPS + 1)

// Warp w's index among the filter warps, or -1.
__host__ __device__ inline int rsnn_train_filter_warp(int w) {
  if (w <= RSNN_TRAIN_XBAR_WARP || (w & 3) == 0) return -1;
  int n = 0;
  for (int i = RSNN_TRAIN_XBAR_WARP + 1; i < w; ++i) n += (i & 3) != 0;
  return n;
}

// The leader's warps that hand a tick block on to the other blocks of the
// cluster: the readout, the xbar and the filter warps.
__host__ __device__ inline int rsnn_train_arrivals(int nwarps) {
  int n = RSNN_TRAIN_READOUT_WARPS + 1;
  for (int w = RSNN_TRAIN_XBAR_WARP + 1; w < nwarps; ++w) n += (w & 3) != 0;
  return n;
}

// F over the ticks for neuron h of one row, rsnn_f_walk's operations in
// its order (l = sum_o err(t, o) b_fb[h, o] in o order, F = l + kappa*F,
// G(t) = h(t) * F, t = T-1..0), with the feedback row in registers for
// O <= NO (4, 8 or RSNN_MAX_OUT), RSNN_TRAIN_WALK_TICKS ticks at a time:
// their loads and their sums of l before F's chain through them (G may
// overwrite h, so a load after a store would wait for it).
#define RSNN_TRAIN_WALK_TICKS 8
template <int NO>
__device__ __forceinline__ void rsnn_train_f_walk(const float* h, size_t sh, float* g,
                                                  size_t sg, const float* err, size_t se,
                                                  const float* b_fb_h, int O, int T,
                                                  float kappa) {
  constexpr int U = RSNN_TRAIN_WALK_TICKS;
  float bf[NO];
#pragma unroll
  for (int o = 0; o < NO; ++o) bf[o] = o < O ? b_fb_h[o] : 0.f;
  float f = 0.f;
  for (int t1 = T - 1; t1 >= 0; t1 -= U) {
    float l[U], hv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = max(t1 - u, 0);
      const float* e = err + (size_t)t * se;
      float s = 0.f;
#pragma unroll
      for (int o = 0; o < NO; ++o) {
        if (o < O) s += e[o] * bf[o];
      }
      l[u] = s;
      hv[u] = h[(size_t)t * sh];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t1 - u >= 0) {
        f = l[u] + kappa * f;
        g[(size_t)(t1 - u) * sg] = hv[u] * f;
      }
    }
  }
}

// The tiles of one row's dw sums: RT x CT elements each, rows r, r + RN,
// ... and columns c, c + CN, ... (RN, CN the rows and columns over RT and
// CT, rounded up), first of dw_in/dw_rec (rows the N inputs, then the H
// presynaptic neurons; columns the H neurons: xbar or pbar against G),
// then of dw_out (rows the H neurons, columns the O outputs: zbar against
// err).  rsnn_train_dw_tiles<RT, CT>(N, H, O, false) counts the first
// kind, (..., true) both.
template <int RT, int CT>
__host__ __device__ inline int rsnn_train_dw_tiles(int N, int H, int O, bool out) {
  const int m1 = (N + H + RT - 1) / RT * ((H + CT - 1) / CT);
  return out ? m1 + (H + RT - 1) / RT * ((O + CT - 1) / CT) : m1;
}

// The dw sums of tiles lo..hi-1 of one row over its trace set in shared
// memory, the block's threads sharing them.  Each element is
// rsnn_dw_elem's sum, its products added over t = T-1..0 by one thread; a
// tile's sums share their loads.
template <int RT, int CT>
__device__ __forceinline__ void rsnn_train_dw(const RowGrad& r, float* part, int N, int H,
                                              int O, int T, int lo, int hi) {
  const int m1 = rsnn_train_dw_tiles<RT, CT>(N, H, O, false);
  for (int it = lo + (int)threadIdx.x; it < hi; it += blockDim.x) {
    const bool in = it < m1;
    const int rows = in ? N + H : H, cols = in ? H : O;
    const int RN = (rows + RT - 1) / RT, CN = (cols + CT - 1) / CT;
    const int i = in ? it : it - m1, ri = i / CN, ci = i - ri * CN;
    const size_t base = in ? 0 : (size_t)(N + H) * H;
    const float* a[RT];
    const float* bb[CT];
    size_t sa[RT];
    const size_t sb = in ? r.sG : r.sO;
#pragma unroll
    for (int p = 0; p < RT; ++p) {
      const int row = min(ri + p * RN, rows - 1);
      a[p] = !in ? r.zbar + row : row < N ? r.xbar + row : r.pbar + (row - N);
      sa[p] = in && row < N ? r.sN : r.sH;
    }
#pragma unroll
    for (int q = 0; q < CT; ++q) bb[q] = (in ? r.g : r.err) + min(ci + q * CN, cols - 1);
    float acc[RT][CT];
#pragma unroll
    for (int p = 0; p < RT; ++p) {
#pragma unroll
      for (int q = 0; q < CT; ++q) acc[p][q] = 0.f;
    }
#pragma unroll 4
    for (int t = T - 1; t >= 0; --t) {
      float xv[RT], yv[CT];
#pragma unroll
      for (int p = 0; p < RT; ++p) xv[p] = a[p][(size_t)t * sa[p]];
#pragma unroll
      for (int q = 0; q < CT; ++q) yv[q] = bb[q][(size_t)t * sb];
#pragma unroll
      for (int p = 0; p < RT; ++p) {
#pragma unroll
        for (int q = 0; q < CT; ++q) acc[p][q] += xv[p] * yv[q];
      }
    }
#pragma unroll
    for (int p = 0; p < RT; ++p) {
#pragma unroll
      for (int q = 0; q < CT; ++q) {
        const int row = ri + p * RN, col = ci + q * CN;
        if (row < rows && col < cols) part[base + (size_t)row * cols + col] = acc[p][q];
      }
    }
  }
}

// rsnn_train_dw over this block's share w of nw of the tiles of the first
// kind (dw_in/dw_rec), of both (all), or of the second (dw_out): one
// element a tile where the share has no more elements than the block has
// threads, else 2 x 2.
__device__ __forceinline__ void rsnn_train_dw_share(const RowGrad& r, float* part, int N,
                                                    int H, int O, int T, bool first,
                                                    bool second, int w, int nw) {
  const int e1 = (N + H) * H, e2 = H * O;
  const int elems = ((first ? e1 : 0) + (second ? e2 : 0)) / nw;
  if (elems <= (int)blockDim.x) {
    const int m1 = rsnn_train_dw_tiles<1, 1>(N, H, O, false);
    const int lo = first ? 0 : m1, hi = second ? rsnn_train_dw_tiles<1, 1>(N, H, O, true) : m1;
    rsnn_train_dw<1, 1>(r, part, N, H, O, T, lo + (int)((long long)(hi - lo) * w / nw),
                        lo + (int)((long long)(hi - lo) * (w + 1) / nw));
  } else {
    const int m1 = rsnn_train_dw_tiles<2, 2>(N, H, O, false);
    const int lo = first ? 0 : m1, hi = second ? rsnn_train_dw_tiles<2, 2>(N, H, O, true) : m1;
    rsnn_train_dw<2, 2>(r, part, N, H, O, T, lo + (int)((long long)(hi - lo) * w / nw),
                        lo + (int)((long long)(hi - lo) * (w + 1) / nw));
  }
}

// rsnn_train_f_walk at the launch's outputs (O <= 4, 8 or RSNN_MAX_OUT).
__device__ __forceinline__ void rsnn_train_f_walk_o(const float* h, size_t sh, float* g,
                                                    size_t sg, const float* err, size_t se,
                                                    const float* b_fb_h, int O, int T,
                                                    float kappa) {
  if (O <= 4) {
    rsnn_train_f_walk<4>(h, sh, g, sg, err, se, b_fb_h, O, T, kappa);
  } else if (O <= 8) {
    rsnn_train_f_walk<8>(h, sh, g, sg, err, se, b_fb_h, O, T, kappa);
  } else {
    rsnn_train_f_walk<RSNN_MAX_OUT>(h, sh, g, sg, err, se, b_fb_h, O, T, kappa);
  }
}

// The learning signal of one tick for a neuron, l = sum_o err(o) b_fb[o]
// in o order (rsnn_f_walk's sum), O <= NO (4, 8 or RSNN_MAX_OUT).
template <int NO>
__device__ __forceinline__ float rsnn_train_signal(const float* e, const float* bf, int O) {
  float s = 0.f;
#pragma unroll
  for (int o = 0; o < NO; ++o) {
    if (o < O) s += e[o] * bf[o];
  }
  return s;
}

// rsnn_train_f_walk over a learning signal already summed: l(t) at
// l[t * H], h(t) at h[t * H], G(t) to g[t * H] (g may be h), t = T-1..0,
// RSNN_TRAIN_WALK_TICKS ticks' loads before F's chain through them.
__device__ __forceinline__ void rsnn_train_f_walk_l(const float* h, const float* l, float* g,
                                                    int H, int T, float kappa) {
  constexpr int U = RSNN_TRAIN_WALK_TICKS;
  float f = 0.f;
  int t1 = T - 1;
  for (; t1 >= U - 1; t1 -= U) {
    float lv[U], hv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      lv[u] = l[(t1 - u) * H];
      hv[u] = h[(t1 - u) * H];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      f = lv[u] + kappa * f;
      g[(t1 - u) * H] = hv[u] * f;
    }
  }
  for (; t1 >= 0; --t1) {
    f = l[t1 * H] + kappa * f;
    g[t1 * H] = h[t1 * H] * f;
  }
}

// One rsnn_train block's work: block `rank` of row blockIdx.x / cluster,
// TRI the surrogate.  Block 0 of the cluster, the leader, runs the
// forward; the others mirror its trace set a tick block at a time; then
// the reverse pass (rsnn_train.cu has the design).
template <int W, bool SMEM_TRACES, bool TRI>
__device__ __forceinline__ void rsnn_train_row(const TrainArgs& a, const TickParams& p) {
  namespace cg = cooperative_groups;
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int T = a.T, B = a.B, N = a.N, H = a.H, O = a.O, J = (H + 31) / 32;
  const int C = a.cluster, tb = a.ticks, nblk = (T + tb - 1) / tb;
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  const int tid = threadIdx.x, nth = blockDim.x, warp = tid >> 5, lane = tid & 31;
  const int nwarps = nth >> 5;
  // block k of the chain done (the leader's); block k's traces complete in
  // the leader's shared memory (the other blocks')
  unsigned long long* chained = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* ready = chained + nblk;
  float* s = smem + 4 * (size_t)nblk;
  float* vs = s;  s += T;
  unsigned* spikes = reinterpret_cast<unsigned*>(s);  s += (size_t)T * J;
  const bool staged = SMEM_TRACES || a.weights_smem;
  const int nw = staged ? N * H + H * H + H * O : 0;
  float* wi = s;   // w_in, w_rec, w_out when staged; b_fb in the other blocks
  s += nw;
  const float* w_in = staged ? wi : a.w_in;
  const float* w_rec = staged ? wi + (size_t)N * H : a.w_rec;
  const float* w_out = staged ? wi + (size_t)N * H + (size_t)H * H : a.w_out;
  RowTraces dev{};   // row b of the device traces, where there are any
  if (a.tr_h) {
    dev = RowTraces{a.tr_h + (size_t)b * H, a.tr_xbar + (size_t)b * N,
                    a.tr_pbar + (size_t)b * H, a.tr_zbar + (size_t)b * H,
                    a.tr_err + (size_t)b * O, (size_t)B * H, (size_t)B * N,
                    (size_t)B * O};
  }
  RowTraces tr, copy{};
  const float* x;   // x(t, k) at x[t * sx + k]
  size_t sx;
  if (SMEM_TRACES) {
    tr = RowTraces{s, s + 3 * (size_t)T * H, s + (size_t)T * H,
                   s + 2 * (size_t)T * H, s + (size_t)T * (3 * H + N),
                   (size_t)H, (size_t)N, (size_t)O};
    copy = dev;
    x = tr.xbar; sx = N;
  } else {
    tr = dev;
    x = a.raster + (size_t)b * N; sx = (size_t)B * N;
  }
  // role r's clock at its start (end 0) or end (end 1), row 0 only; the
  // tail's readings: the mirror's start and end, the F walk's start and
  // end, the dw sums' end
  long long* clocks = a.clocks && b == 0 ? a.clocks : nullptr;
  long long tail[5] = {0, 0, 0, 0, 0};
  auto mark = [&](int r, int end) {
    if (clocks) clocks[r * 2 + end] = clock64();
  };
  if (rank == 0) {
    if (tid == 0) mark(0, 0);
    // the weights, the valid mask and (on chip) the raster, whose xbar
    // filter turns it into xbar in place: eight loads of a thread in
    // flight before its stores
    const int total = nw + T + (SMEM_TRACES ? T * N : 0);
    for (int i0 = tid; i0 < total; i0 += 8 * nth) {
      float v[8];
      float* at[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = min(i0 + u * nth, total - 1);
        const float* src;
        if (i < nw) {
          src = i < N * H ? a.w_in + i
                : i < N * H + H * H ? a.w_rec + (i - N * H) : a.w_out + (i - N * H - H * H);
          at[u] = wi + i;
        } else if (i < nw + T) {
          src = a.valid + (size_t)(i - nw) * B + b;
          at[u] = vs + (i - nw);
        } else {
          const int j = i - nw - T, t = j / N;
          src = a.raster + ((size_t)t * B + b) * N + (j - t * N);
          at[u] = tr.xbar + j;
        }
        v[u] = *src;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) *at[u] = v[u];
    }
  } else {
    // b_fb for the learning signal the other blocks sum
    for (int i = tid; i < H * O; i += nth) wi[i] = a.b_fb[i];
  }
  for (int k = tid; k < nblk; k += nth) {
    rsnn_mbar_init(&chained[k], 1);
    rsnn_mbar_init(&ready[k], rsnn_train_arrivals(nwarps));
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  __syncthreads();
  // every block's barriers initialized before the first remote arrive (the
  // waits below, before the first remote operation of each thread).  The
  // cluster barrier counts threads: each arrives and waits twice, at
  // points where its warp has reconverged.
  asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");

  if (rank == 0) {
    // the input currents of every tick, parked in the h slots, by all warps
    // before the chain starts (summed beside the chain they slowed it)
    rsnn_input_currents<W>(x, sx, w_in, tr.h, tr.sH, T, N, H);
    __syncthreads();
    const int fw = rsnn_train_filter_warp(warp);
    if (warp != 0) asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
    if (warp == 0) {
      // the LIF chain, a tick block at a time: h and the spike masks
      if (lane == 0) {
        mark(0, 1);
        mark(1, 0);
      }
      RowCarry<W> c;
      rsnn_carry_zero(c);
      for (int k = 0; k < nblk; ++k) {
        const int t0 = k * tb;
        const RowTraces tk{tr.h + (size_t)t0 * tr.sH, nullptr, nullptr, nullptr, nullptr,
                           tr.sH, 0, 0};
        rsnn_row_lif<W, ROW_TRACES, false, false, TRI>(c, tk, RowTraces{}, w_rec, vs + t0,
                                                       nullptr, spikes + (size_t)t0 * J,
                                                       min(tb, T - t0), H, p);
        __syncwarp();
        if (lane == 0) rsnn_mbar_arrive(&chained[k]);
      }
      if (lane == 0) {
        a.n_spk[b] = c.nspk;
        mark(1, 1);
      }
      __syncwarp();
      asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
    } else if (warp <= RSNN_TRAIN_READOUT_WARPS) {
      // the readout behind the chain: the readout currents of the block's
      // (tick, output) items, the LI leak (y and acc_y carried in
      // registers), the readout error
      const int rt = tid - 32, nrt = 32 * RSNN_TRAIN_READOUT_WARPS;
      float ys[RSNN_MAX_OUT];
#pragma unroll
      for (int o = 0; o < RSNN_MAX_OUT; ++o) ys[o] = o < O ? a.y_star[(size_t)b * O + o] : 0.f;
      float y = 0.f, acc = 0.f;
      for (int k = 0; k < nblk; ++k) {
        const int t0 = k * tb, n = min(tb, T - t0);
        float* eb = tr.err + (size_t)t0 * tr.sO;
        rsnn_mbar_wait<false>(&chained[k], 0);
        if (k == 0 && rt == 0) mark(4, 0);
        for (int i = rt; i < n * O; i += nrt) {
          const int t = i / O, o = i - t * O;
          eb[(size_t)t * tr.sO + o] = rsnn_readout_sum(spikes + (size_t)(t0 + t) * J, J, w_out,
                                                       O, o);
        }
        asm volatile("bar.sync 1, %0;" ::"r"(nrt) : "memory");
        if (rt < O) {
          for (int t = 0; t < n; ++t) {
            float* e = eb + (size_t)t * tr.sO + rt;
            y = rsnn_leak_out(y, *e, p);
            acc += y * (a.infer_all ? 1.f : vs[t0 + t]);
            *e = y;
          }
        }
        asm volatile("bar.sync 1, %0;" ::"r"(nrt) : "memory");
        for (int t = rt; t < n; t += nrt) {
          float* e = eb + (size_t)t * tr.sO;
          if (O <= 4) {
            rsnn_tick_error<4>(e, vs[t0 + t], ys, p, O);
          } else if (O <= 8) {
            rsnn_tick_error<8>(e, vs[t0 + t], ys, p, O);
          } else {
            rsnn_tick_error<RSNN_MAX_OUT>(e, vs[t0 + t], ys, p, O);
          }
          if (copy.h) {
            for (int o = 0; o < O; ++o) rsnn_put(copy.err, copy.sO, t0 + t, o, e[o]);
          }
        }
        __syncwarp();
        if (lane > 0 && lane < C) rsnn_mbar_arrive_at(&ready[k], lane);
      }
      if (rt < O) a.acc_y[(size_t)b * O + rt] = acc;
      if (rt == 0) mark(4, 1);
    } else if (warp == RSNN_TRAIN_XBAR_WARP) {
      // xbar = alpha * xbar + x, a lane per input (in place in the shared
      // trace set), ahead of the chain
      if (lane == 0) mark(2, 0);
      float xb[W];
#pragma unroll
      for (int q = 0; q < W; ++q) xb[q] = 0.f;
      for (int k = 0; k < nblk; ++k) {
        const int t0 = k * tb, n = min(tb, T - t0);
#pragma unroll
        for (int q = 0; q < W; ++q) {
          const int i = lane + 32 * q;
          if (i < N) {
            for (int t = t0; t < t0 + n; ++t) {
              xb[q] = p.alpha * xb[q] + x[(size_t)t * sx + i];
              rsnn_put(tr.xbar, tr.sN, t, i, xb[q]);
              if (copy.h) rsnn_put(copy.xbar, copy.sN, t, i, xb[q]);
            }
          }
        }
        __syncwarp();
        if (lane > 0 && lane < C) rsnn_mbar_arrive_at(&ready[k], lane);
      }
      if (lane == 0) mark(2, 1);
    } else if (fw >= 0) {
      // pbar = alpha*pbar + z(t - 1), zbar = kappa*zbar + z(t) behind the
      // chain, a thread per neuron, from the spike masks
      const int h = 32 * fw + lane;
      float pb = 0.f, zb = 0.f, zp = 0.f;
      for (int k = 0; k < nblk; ++k) {
        const int t0 = k * tb, n = min(tb, T - t0);
        rsnn_mbar_wait<false>(&chained[k], 0);
        if (k == 0 && fw == 0 && lane == 0) mark(3, 0);
        if (h < H) {
          for (int t = t0; t < t0 + n; ++t) {
            const float z = (spikes[(size_t)t * J + (h >> 5)] >> (h & 31)) & 1u ? 1.f : 0.f;
            pb = p.alpha * pb + zp;
            zb = p.kappa * zb + z;
            zp = z;
            rsnn_put(tr.pbar, tr.sH, t, h, pb);
            rsnn_put(tr.zbar, tr.sH, t, h, zb);
            if (copy.h) {
              rsnn_put(copy.h, copy.sH, t, h, tr.h[(size_t)t * tr.sH + h]);
              rsnn_put(copy.pbar, copy.sH, t, h, pb);
              rsnn_put(copy.zbar, copy.sH, t, h, zb);
            }
          }
        }
        __syncwarp();
        if (lane > 0 && lane < C) rsnn_mbar_arrive_at(&ready[k], lane);
      }
      if (fw == 0 && lane == 0) mark(3, 1);
    }
    __syncthreads();
  } else if (SMEM_TRACES) {
    // mirror the leader's trace set, a tick block at a time as its roles
    // finish it: the block's rows of h, pbar, xbar and err (not zbar: the
    // leader sums dw_out), four loads of a thread in flight before its
    // stores; then the block's learning signal l into the zbar slots
    asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
    const float* lead = cluster.map_shared_rank(tr.h, 0);
    const int TH = T * H;
    for (int k = 0; k < nblk; ++k) {
      const int t0 = k * tb, n = min(tb, T - t0), nH = n * H;
      const int total = 2 * nH + n * N + n * O;
      rsnn_mbar_wait<true>(&ready[k], 0);
      if (k == 0) tail[0] = clock64();
      for (int i0 = tid; i0 < total; i0 += 4 * nth) {
        int at[4];
        float v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = min(i0 + u * nth, total - 1);
          at[u] = i < nH         ? t0 * H + i
                  : i < 2 * nH   ? TH + t0 * H + (i - nH)
                  : i < 2 * nH + n * N ? 3 * TH + t0 * N + (i - 2 * nH)
                                 : 3 * TH + T * N + t0 * O + (i - 2 * nH - n * N);
          v[u] = lead[at[u]];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) tr.h[at[u]] = v[u];
      }
      __syncthreads();
      for (int i = tid; i < nH; i += nth) {
        const int t = t0 + i / H, j = i % H;
        const float* e = tr.err + t * O;
        const float* bf = wi + j * O;
        tr.zbar[t * H + j] = O <= 4   ? rsnn_train_signal<4>(e, bf, O)
                             : O <= 8 ? rsnn_train_signal<8>(e, bf, O)
                                      : rsnn_train_signal<RSNN_MAX_OUT>(e, bf, O);
      }
    }
    __syncthreads();
    tail[1] = clock64();
  }

  // the reverse pass.  One block a row runs all of it: the F walk, then the
  // dw sums.  In a cluster the leader sums dw_out (no G) while the other
  // blocks walk F over their copies and share dw_in and dw_rec.
  float* part = a.dw_part + (size_t)b * ((size_t)(N + H) * H + (size_t)H * O);
  if (C == 1 || rank > 0) {
    tail[2] = clock64();
    float* g = SMEM_TRACES ? tr.h : a.g + (size_t)b * H;
    const size_t sg = SMEM_TRACES ? (size_t)H : (size_t)B * H;
    for (int h = tid; h < H; h += nth) {
      if (C > 1) {
        rsnn_train_f_walk_l(tr.h + h, tr.zbar + h, g + h, H, T, p.kappa);
      } else {
        rsnn_train_f_walk_o(tr.h + h, tr.sH, g + h, sg, tr.err, tr.sO, a.b_fb + (size_t)h * O,
                            O, T, p.kappa);
      }
    }
    if (SMEM_TRACES) {
      __syncthreads();
      tail[3] = clock64();
      const RowGrad r{tr.xbar, tr.sN, tr.pbar, tr.zbar, tr.sH, g, sg, tr.err, tr.sO};
      rsnn_train_dw_share(r, part, N, H, O, T, true, C == 1, C == 1 ? 0 : rank - 1,
                          C == 1 ? 1 : C - 1);
    } else {
      tail[3] = clock64();
    }
  } else {
    const RowGrad r{tr.xbar, tr.sN, tr.pbar, tr.zbar, tr.sH, nullptr, 0, tr.err, tr.sO};
    rsnn_train_dw_share(r, part, N, H, O, T, false, true, 0, 1);
  }
  // no block leaves while another may still read its shared memory
  if (C > 1 || clocks) __syncthreads();
  tail[4] = clock64();
  if (C > 1) {
    asm volatile("barrier.cluster.arrive.release;" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
  }
  // the tail's clocks, written once the block's work is done (stores to
  // the clock buffer between a worker's phases changed its results): the
  // first block that walks F records the F walk and the dw sums, block 1
  // its mirror
  if (clocks && tid == 0 && (C == 1 || rank == 1)) {
    clocks[5 * 2] = tail[2];
    clocks[5 * 2 + 1] = tail[3];
    if (SMEM_TRACES) {
      clocks[6 * 2] = tail[3];
      clocks[6 * 2 + 1] = tail[4];
    }
    if (rank == 1) {
      clocks[7 * 2] = tail[0];
      clocks[7 * 2 + 1] = tail[1];
    }
  }
}

struct ForwardArgs {
  const float* raster;   // (T, B, N)
  const float* w_in;     // (N, H)
  const float* w_rec;    // (H, H), self-recurrence masked
  const float* w_out;    // (H, O)
  float* z;              // (T, B, H)
  float* h;              // (T, B, H)
  float* xbar;           // (T, B, N)
  float* pbar;           // (T, B, H)
  float* zbar;           // (T, B, H)
  float* y;              // (T, B, O)
  float* v;              // (T, B, H) post-reset membrane
  int T, B, N, H, O;
  int rows;              // batch rows a block, one loop warp each
  int Tl;                // ticks a chunk of the readout
  int weights_smem;      // 1: stage the weights in shared memory
  int rows_smem;         // 1: the rows' raster and input currents in shared
                         //    memory (only when Tl == T)
};

// Dynamic shared memory of one rsnn_forward block, in 4-byte words
// (kernels/rsnn_step.py:forward_plan): the weights when staged; every row's
// spike masks (T * ceil(H/32)) and a chunk of Tl ticks of its readout
// currents (Tl * O); then every row's raster (T*N) and input currents (T*H)
// when they fit.
__host__ __device__ inline size_t rsnn_forward_smem_words(int rows, int T,
                                                          int Tl, int N, int H,
                                                          int O,
                                                          int weights_smem,
                                                          int rows_smem) {
  size_t w = weights_smem ? (size_t)N * H + (size_t)H * H + (size_t)H * O : 0;
  size_t r = (size_t)T * ((H + 31) / 32) + (size_t)Tl * O +
             (rows_smem ? (size_t)T * ((size_t)N + H) : 0);
  return w + (size_t)rows * r;
}

template <int W, bool TRI>
__device__ __forceinline__ void rsnn_forward_rows(const ForwardArgs& a, const TickParams& p) {
  extern __shared__ float smem[];
  const int T = a.T, B = a.B, N = a.N, H = a.H, O = a.O, J = (H + 31) / 32;
  const int R = a.rows, Tl = a.Tl;
  const int b0 = blockIdx.x * R;
  const int nr = min(R, B - b0);
  const int tid = threadIdx.x, nth = blockDim.x, warp = tid >> 5;
  float* s = smem;
  const float* w_in = a.w_in;
  const float* w_rec = a.w_rec;
  const float* w_out = a.w_out;
  if (a.weights_smem) {
    float* wi = s;  s += N * H;
    float* wr = s;  s += H * H;
    float* wo = s;  s += H * O;
    for (int i = tid; i < N * H; i += nth) wi[i] = a.w_in[i];
    for (int i = tid; i < H * H; i += nth) wr[i] = a.w_rec[i];
    for (int i = tid; i < H * O; i += nth) wo[i] = a.w_out[i];
    w_in = wi; w_rec = wr; w_out = wo;
  }
  unsigned* spikes = reinterpret_cast<unsigned*>(s);  s += (size_t)R * T * J;
  float* lin = s;  s += (size_t)R * Tl * O;   // readout currents (r, t, o)
  // row r's inputs x(t, k) at x + r * xr + t * sx + k, its input currents
  // c(t, h) at cur + r * cr + t * sc + h: in shared memory, or the raster
  // and the h stream (which the loop then overwrites with h)
  const size_t sH = (size_t)B * H, sN = (size_t)B * N, sO = (size_t)B * O;
  const float* x;
  float* cur;
  size_t xr, cr, sx, sc;
  if (a.rows_smem) {
    float* xs = s;  s += (size_t)R * T * N;
    // row r's raster at xs + r * T * N: each tick's rows are one run
    for (int i = tid; i < T * nr * N; i += nth) {
      const int t = i / (nr * N), rk = i - t * nr * N;
      const int r = rk / N;
      xs[((size_t)r * T + t) * N + rk - r * N] = a.raster[((size_t)t * B + b0) * N + rk];
    }
    x = xs; xr = (size_t)T * N; sx = N;
    cur = s; cr = (size_t)T * H; sc = H;
  } else {
    x = a.raster + (size_t)b0 * N; xr = N; sx = sN;
    cur = a.h + (size_t)b0 * H; cr = H; sc = sH;
  }
  __syncthreads();
  for (int r = 0; r < nr; ++r) {
    rsnn_input_currents<W>(x + r * xr, sx, w_in, cur + r * cr, sc, T, N, H);
  }
  __syncthreads();
  if (warp < nr) {
    // warp r carries row b0 + r, writing its h, pbar, zbar and v streams
    const int b = b0 + warp;
    const RowTraces in{cur + warp * cr, nullptr, nullptr, nullptr, nullptr, sc, 0, 0};
    const RowTraces dev{a.h + (size_t)b * H, nullptr, a.pbar + (size_t)b * H,
                        a.zbar + (size_t)b * H, nullptr, sH, sN, sO,
                        a.v + (size_t)b * H};
    RowCarry<W> c;
    rsnn_carry_zero(c);
    rsnn_row_lif<W, ROW_STREAMS, false, false, TRI>(c, in, dev, w_rec, nullptr, nullptr,
                                                    spikes + (size_t)warp * T * J, T, H, p);
  } else if (warp >= R) {
    // the other warps: the xbar filter, one thread per (row, input)
    for (int i = tid - 32 * R; i < nr * N; i += nth - 32 * R) {
      const int r = i / N, k = i - r * N;
      rsnn_xbar_walk(x + r * xr, sx, a.xbar + (size_t)(b0 + r) * N, sN, nullptr, 0,
                     false, k, T, p.alpha);
    }
  }
  __syncthreads();
  // z(t, h) from the spike masks
  const int TH = T * H;
  for (int i = tid; i < nr * TH; i += nth) {
    const int r = i / TH, th = i - r * TH;
    const int t = th / H, hh = th - t * H;
    a.z[(size_t)t * sH + (size_t)(b0 + r) * H + hh] =
        (spikes[((size_t)r * T + t) * J + (hh >> 5)] >> (hh & 31)) & 1u ? 1.f : 0.f;
  }
  // the readout a chunk of Tl ticks at a time: the readout currents of the
  // chunk's (row, tick, output), then the LI leak, one thread per (row,
  // output) carrying y across the chunks
  const bool ro = tid < nr * O;
  const int rr = ro ? tid / O : 0, oo = tid - rr * O;
  float* y = a.y + (size_t)(b0 + rr) * O + oo;
  float yv = 0.f;
  for (int t0 = 0; t0 < T; t0 += Tl) {
    const int tl = min(Tl, T - t0);
    for (int r = 0; r < nr; ++r) {
      rsnn_readout_currents(spikes + ((size_t)r * T + t0) * J, J, w_out, tl, O,
                            lin + (size_t)r * Tl * O, O);
    }
    __syncthreads();
    if (ro) {
      for (int t = 0; t < tl; ++t) {
        yv = rsnn_leak_out(yv, lin[((size_t)rr * Tl + t) * O + oo], p);
        y[(size_t)(t0 + t) * sO] = yv;
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Launch dispatch by width W (and trace placement) over the kernels of one
// surrogate, which RsnnTraceKernels<TRI> names: rsnn_train.cu defines the
// boxcar's (TRI false) and the launchers, rsnn_train_tri.cu the triangular
// surrogate's (TRI true) and its dispatch, so that nvcc compiles the two
// sets side by side.
// ---------------------------------------------------------------------------

template <bool TRI> struct RsnnTraceKernels;

template <bool TRI, int W>
static int rsnn_forward_launch_w(const ForwardArgs& a, const TickParams& p, int threads,
                                 size_t smem, cudaStream_t stream) {
  const auto kernel = RsnnTraceKernels<TRI>::template forward<W>();
  int fit = threads;
  int rc = rsnn_prepare_launch(kernel, smem, &fit);
  if (rc) return rc;
  if (fit != threads) return (int)cudaErrorInvalidConfiguration;
  const int blocks = (a.B + a.rows - 1) / a.rows;
  kernel<<<blocks, threads, smem, stream>>>(a, p);
  return (int)cudaGetLastError();
}

template <bool TRI>
int rsnn_forward_dispatch(const ForwardArgs& a, const TickParams& p, int threads,
                          size_t smem, cudaStream_t st) {
  switch ((max(a.N, a.H) + 31) / 32) {
    case 1: return rsnn_forward_launch_w<TRI, 1>(a, p, threads, smem, st);
    case 2: return rsnn_forward_launch_w<TRI, 2>(a, p, threads, smem, st);
    case 3: return rsnn_forward_launch_w<TRI, 3>(a, p, threads, smem, st);
    case 4: return rsnn_forward_launch_w<TRI, 4>(a, p, threads, smem, st);
    case 5: return rsnn_forward_launch_w<TRI, 5>(a, p, threads, smem, st);
    case 6: return rsnn_forward_launch_w<TRI, 6>(a, p, threads, smem, st);
    case 7: return rsnn_forward_launch_w<TRI, 7>(a, p, threads, smem, st);
    case 8: return rsnn_forward_launch_w<TRI, 8>(a, p, threads, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool TRI, int W, bool SMEM_TRACES>
static int rsnn_train_launch_w(const TrainArgs& a, const TickParams& p, size_t smem,
                               cudaStream_t stream) {
  const auto kernel = RsnnTraceKernels<TRI>::template train<W, SMEM_TRACES>();
  int threads = RSNN_TRAIN_THREADS;
  int rc = rsnn_prepare_launch(kernel, smem, &threads);
  if (rc) return rc;
  if (threads != RSNN_TRAIN_THREADS) return (int)cudaErrorInvalidConfiguration;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(a.B * a.cluster));
  cfg.blockDim = dim3(RSNN_TRAIN_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  rc = (int)cudaLaunchKernelEx(&cfg, kernel, a, p);
  return rc ? rc : (int)cudaGetLastError();
}

template <bool TRI, bool SMEM_TRACES>
static int rsnn_train_launch_s(const TrainArgs& a, const TickParams& p, size_t smem,
                               cudaStream_t stream) {
  switch ((max(a.N, a.H) + 31) / 32) {
    case 1: return rsnn_train_launch_w<TRI, 1, SMEM_TRACES>(a, p, smem, stream);
    case 2: return rsnn_train_launch_w<TRI, 2, SMEM_TRACES>(a, p, smem, stream);
    case 3: return rsnn_train_launch_w<TRI, 3, SMEM_TRACES>(a, p, smem, stream);
    case 4: return rsnn_train_launch_w<TRI, 4, SMEM_TRACES>(a, p, smem, stream);
    case 5: return rsnn_train_launch_w<TRI, 5, SMEM_TRACES>(a, p, smem, stream);
    case 6: return rsnn_train_launch_w<TRI, 6, SMEM_TRACES>(a, p, smem, stream);
    case 7: return rsnn_train_launch_w<TRI, 7, SMEM_TRACES>(a, p, smem, stream);
    case 8: return rsnn_train_launch_w<TRI, 8, SMEM_TRACES>(a, p, smem, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool TRI>
int rsnn_train_dispatch(const TrainArgs& a, const TickParams& p, int traces_smem,
                        size_t smem, cudaStream_t st) {
  return traces_smem ? rsnn_train_launch_s<TRI, true>(a, p, smem, st)
                     : rsnn_train_launch_s<TRI, false>(a, p, smem, st);
}

template <bool TRI, int W>
static int rsnn_train_exact_launch_w(const ExactArgs& a, const TickParams& p, size_t smem,
                                     cudaStream_t stream) {
  const auto kernel = RsnnTraceKernels<TRI>::template exact<W>();
  int threads = RSNN_EXACT_THREADS;
  int rc = rsnn_prepare_launch(kernel, smem, &threads);
  if (rc) return rc;
  if (threads != RSNN_EXACT_THREADS) return (int)cudaErrorInvalidConfiguration;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(a.B * a.groups * a.cluster));
  cfg.blockDim = dim3(RSNN_EXACT_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  rc = (int)cudaLaunchKernelEx(&cfg, kernel, a, p);
  return rc ? rc : (int)cudaGetLastError();
}

template <bool TRI>
int rsnn_train_exact_dispatch(const ExactArgs& a, const TickParams& p, size_t smem,
                              cudaStream_t st) {
  switch ((max(a.N, a.H) + 31) / 32) {
    case 1: return rsnn_train_exact_launch_w<TRI, 1>(a, p, smem, st);
    case 2: return rsnn_train_exact_launch_w<TRI, 2>(a, p, smem, st);
    case 3: return rsnn_train_exact_launch_w<TRI, 3>(a, p, smem, st);
    case 4: return rsnn_train_exact_launch_w<TRI, 4>(a, p, smem, st);
    case 5: return rsnn_train_exact_launch_w<TRI, 5>(a, p, smem, st);
    case 6: return rsnn_train_exact_launch_w<TRI, 6>(a, p, smem, st);
    case 7: return rsnn_train_exact_launch_w<TRI, 7>(a, p, smem, st);
    case 8: return rsnn_train_exact_launch_w<TRI, 8>(a, p, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
