// The training kernels under Bellec's triangular surrogate: rsnn_train.cu's
// rsnn_train_kernel, rsnn_train_exact_kernel and rsnn_forward_kernel with
// h = gamma * max(0, 1 - |v_pre - v_th| / v_th) (rsnn_tick.cuh:
// rsnn_triangular), instantiated here over the same bodies
// (rsnn_train.cuh) and reached through rsnn_train.cu's launchers, so that
// they compile beside the boxcar's.  Built with -fmad=false, as
// rsnn_train.cu.
#include "rsnn_train.cuh"

// rsnn_train_kernel under the triangular surrogate.
template <int W, bool SMEM_TRACES>
__global__ void __launch_bounds__(RSNN_TRAIN_THREADS, 1)
    rsnn_train_tri_kernel(TrainArgs a, TickParams p) {
  rsnn_train_row<W, SMEM_TRACES, true>(a, p);
}

// rsnn_train_exact_kernel under the triangular surrogate.
template <int W>
__global__ void __launch_bounds__(RSNN_EXACT_THREADS, 1)
    rsnn_train_exact_tri_kernel(ExactArgs a, TickParams p) {
  rsnn_train_exact_row<W, true>(a, p);
}

// rsnn_forward_kernel under the triangular surrogate.
template <int W>
__global__ void rsnn_forward_tri_kernel(ForwardArgs a, TickParams p) {
  rsnn_forward_rows<W, true>(a, p);
}

template <>
struct RsnnTraceKernels<true> {
  template <int W, bool SMEM_TRACES>
  static auto train() { return rsnn_train_tri_kernel<W, SMEM_TRACES>; }
  template <int W>
  static auto exact() { return rsnn_train_exact_tri_kernel<W>; }
  template <int W>
  static auto forward() { return rsnn_forward_tri_kernel<W>; }
};

template int rsnn_forward_dispatch<true>(const ForwardArgs&, const TickParams&, int, size_t,
                                         cudaStream_t);
template int rsnn_train_dispatch<true>(const TrainArgs&, const TickParams&, int, size_t,
                                       cudaStream_t);
template int rsnn_train_exact_dispatch<true>(const ExactArgs&, const TickParams&, size_t,
                                             cudaStream_t);
