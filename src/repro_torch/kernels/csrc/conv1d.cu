// Causal depthwise conv1d for Hopper (sm_90a), with an optional tail.
//
// Replaces the Pallas kernel repro/kernels/conv1d/kernel.py::_conv_kernel
// (causal_conv1d_pallas). For batch row b, step t and channel c:
//   y[b,t,c] = act( b[c] + sum_{k<K} w[k,c] * xp[b, t + k, c] )
// where xp is x front-padded by K-1 rows: the tail (the previous call's
// last K-1 inputs) where one is given, zeros otherwise; act is SiLU or
// none. float32 arithmetic in the Pallas kernel's order (each product
// rounded, then added, k = 0..K-1, bias last; __fmul_rn/__fadd_rn keep
// the compiler from contracting them into FMAs), output in x's dtype.
//
// Bound: bytes. Each output reads K inputs (re-read from L1/L2 by the
// neighbouring steps) and writes one: ~2 bytes in and 2 out per bf16
// element, plus w and b once; a 512-token Mamba-2 layer (C=1,792) moves
// ~3.7 MB, ~1.1 us at 3.35 TB/s. A decode step (S=1) is one short launch
// and bound by its latency.
//
// Design: the layout is (B,S,C), channel-contiguous, so one thread per
// (b, t, c) with the 128 threads of a block on consecutive channels reads
// and writes coalesced rows; grid.x walks the B*S rows (no 65,535 limit
// on S), grid.y the channel tiles. No VMEM-driven chunking of S: any S
// runs in one launch. The Pallas kernel's vectorised window sums become
// K scalar loads per thread.
#include "common.cuh"

namespace {

using repro::from_f;
using repro::to_f;

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv1d_kernel(const T* __restrict__ x, const T* __restrict__ tail,
              const T* __restrict__ w, const T* __restrict__ bias,
              T* __restrict__ y, int S, int C, int K, int silu) {
  const int c = blockIdx.y * kThreads + threadIdx.x;
  if (c >= C) return;
  const long row = blockIdx.x;          // b * S + t
  const long b = row / S;
  const int t = static_cast<int>(row % S);
  float acc = 0.f;
  for (int k = 0; k < K; ++k) {
    const int src = t - (K - 1) + k;    // input step; < 0 reads the tail
    float xv = 0.f;
    if (src >= 0)
      xv = to_f<T>(x[(b * S + src) * C + c]);
    else if (tail != nullptr)
      xv = to_f<T>(tail[(b * (K - 1) + (K - 1 + src)) * C + c]);
    acc = __fadd_rn(acc, __fmul_rn(xv, to_f<T>(w[(long)k * C + c])));
  }
  acc = __fadd_rn(acc, to_f<T>(bias[c]));
  if (silu) acc = __fmul_rn(acc, 1.f / (1.f + expf(-acc)));
  y[row * C + c] = from_f<T>(acc);
}

template <typename T>
cudaError_t launch(const void* x, const void* tail, const void* w,
                   const void* b, void* y, int B, int S, int C, int K,
                   int silu, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((long)B * S), (C + kThreads - 1) / kThreads);
  conv1d_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(tail),
      static_cast<const T*>(w), static_cast<const T*>(b), static_cast<T*>(y),
      S, C, K, silu);
  return cudaGetLastError();
}

}  // namespace

// x, y (B,S,C), tail (B,K-1,C) or null, w (K,C), b (C,), all of one dtype
// (0: float32, 1: bfloat16) and contiguous on `device`. Returns the
// cudaError_t of the launch.
REPRO_EXPORT int conv1d_launch(const void* x, const void* tail, const void* w,
                               const void* b, void* y, int B, int S, int C,
                               int K, int silu, int dtype, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || S == 0 || C == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = launch<float>(x, tail, w, b, y, B, S, C, K, silu, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(x, tail, w, b, y, B, S, C, K, silu, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
