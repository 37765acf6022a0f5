// Causal depthwise conv1d for Hopper (sm_90a), with an optional tail in
// and the new tail out.
//
// Replaces the Pallas kernel repro/kernels/conv1d/kernel.py::_conv_kernel
// (causal_conv1d_pallas). For batch row b, step t and channel c:
//   y[b,t,c] = act( b[c] + sum_{k<K} w[k,c] * xp[b, t + k, c] )
// where xp is x front-padded by K-1 rows: the tail (the previous call's
// last K-1 inputs) where one is given, zeros otherwise; act is SiLU or
// none. float32 arithmetic in the Pallas kernel's order (each product
// rounded, then added, k = 0..K-1, bias last; __fmul_rn/__fadd_rn keep
// the compiler from contracting them into FMAs), output in x's dtype.
// The same launch writes the new tail, the last K-1 rows of xp, in x's
// dtype: the next decode, chunk or verify step continues from it.
//
// Bound: bytes. x, w and b are read once and y written once: a 512-token
// Mamba-2 prefill layer (bf16, C=1,792) moves ~3.7 MB, 1.10 us at
// 3.35 TB/s; recurrentgemma-2b's 2,560-token layer (C=2,560) 26.2 MB,
// 7.83 us. A decode step (S=1) is one short launch, bound by its latency.
//
// Design: a thread owns V channels (8 in bf16, 4 in fp32: one 16-byte
// access to neighbouring addresses, consecutive threads on consecutive
// channel vectors) and a run of L consecutive steps of one batch row. It
// keeps the K-1 inputs before its current step in registers as a sliding
// window, so each input is read from memory once, plus K-1 halo rows per
// run, and w (K vectors) and b once. L is 1 where the (b, step, vector)
// items alone are fewer than two waves of the card's resident threads, and
// doubles (up to 16) while two waves remain. The thread of each (b,
// vector) whose run ends at step S-1 holds the new tail in its window and
// writes it. No shared memory and no TMA: nothing is reused across
// threads except the K-1 halo rows against an L-row run, and for a
// streaming kernel bound by bytes, 16-byte loads with many in flight
// (every thread's K-1 halo loads and its first input are independent) are
// what the card needs.
//
// A scalar path (one channel a thread, the same window) takes C not a
// multiple of V, any pointer not 16-byte aligned (a contiguous view at a
// storage offset), and launches with fewer channel vectors than one block
// an SM (a decode step: 4 x 1,792 channels). Such a launch is bound by its
// latency, and one channel a thread spreads it over V times the threads:
// on an H100 the 4-slot decode step took 2.5 us of device time on the
// vector path, against 1.7 us for the one-output-a-thread kernel that
// this one replaced. K in {2, 3, 4} is a template parameter (the window
// lives in registers); any other K re-reads its inputs through the cache.
// The plan (path, L, grid) is made once, by kernels/conv1d/ops.py::
// plan_conv, and passed in; the launch function refuses a vector plan that
// would read C or a pointer off the vector's alignment.
#include <cstdint>
#include <cstring>

#include "common.cuh"

namespace {

using repro::from_f;
using repro::to_f;

constexpr int kThreads = 128;

// V elements of T loaded and stored as one access of an unsigned type of
// their size (uint4: one 16-byte access on the vector path).
template <int N> struct RawOf;
template <> struct RawOf<16> { using type = uint4; };
template <> struct RawOf<4> { using type = unsigned int; };
template <> struct RawOf<2> { using type = unsigned short; };

template <typename T, int V>
struct Pack {
  typename RawOf<sizeof(T) * V>::type raw;
  __device__ __forceinline__ float at(int e) const {
    return to_f<T>(reinterpret_cast<const T*>(&raw)[e]);
  }
  __device__ __forceinline__ void put(int e, float v) {
    reinterpret_cast<T*>(&raw)[e] = from_f<T>(v);
  }
};

template <typename T, int V, int KT>
__global__ void __launch_bounds__(kThreads)
conv1d_kernel(const T* __restrict__ x, const T* __restrict__ tail,
              const T* __restrict__ w, const T* __restrict__ bias,
              T* __restrict__ y, T* __restrict__ tail_out, int B, int S,
              int C, int k_rt, int L, int runs, int silu) {
  using P = Pack<T, V>;
  const int K = KT > 0 ? KT : k_rt;
  const int cols = C / V;
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= static_cast<long long>(B) * runs * cols) return;
  const int c0 = static_cast<int>(i % cols) * V;
  const long long rest = i / cols;
  const int run = static_cast<int>(rest % runs);
  const long long b = rest / runs;
  const T* xb = x + b * S * C + c0;
  const T* tb = tail != nullptr ? tail + b * (K - 1) * C + c0 : nullptr;
  // row `src` of [tail or zeros, x], counted in x's steps (< 0: the tail)
  auto row = [&](int src) -> P {
    if (src >= 0) return *reinterpret_cast<const P*>(xb + static_cast<long long>(src) * C);
    if (tb != nullptr)
      return *reinterpret_cast<const P*>(tb + static_cast<long long>(K - 1 + src) * C);
    return P{};   // zeros: the bits of +0 in either dtype
  };
  const P bp = *reinterpret_cast<const P*>(bias + c0);
  const int t0 = run * L;
  const int t1 = min(S, t0 + L);
  T* yb = y + b * S * C + c0;
  T* ob = tail_out + b * (K - 1) * C + c0;

  auto finish = [&](float acc, float bv) {
    acc = __fadd_rn(acc, bv);
    if (silu) acc = __fmul_rn(acc, 1.f / (1.f + expf(-acc)));
    return acc;
  };

  if constexpr (KT > 0) {
    float wk[KT][V];
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      const P wp = *reinterpret_cast<const P*>(w + static_cast<long long>(k) * C + c0);
#pragma unroll
      for (int e = 0; e < V; ++e) wk[k][e] = wp.at(e);
    }
    P win[KT - 1];   // inputs of steps t-K+1 .. t-1
#pragma unroll
    for (int j = 0; j < KT - 1; ++j) win[j] = row(t0 - (KT - 1) + j);
    for (int t = t0; t < t1; ++t) {
      const P cur = row(t);
      P out;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < KT - 1; ++k)
          acc = __fadd_rn(acc, __fmul_rn(win[k].at(e), wk[k][e]));
        acc = __fadd_rn(acc, __fmul_rn(cur.at(e), wk[KT - 1][e]));
        out.put(e, finish(acc, bp.at(e)));
      }
      *reinterpret_cast<P*>(yb + static_cast<long long>(t) * C) = out;
#pragma unroll
      for (int j = 0; j + 1 < KT - 1; ++j) win[j] = win[j + 1];
      win[KT - 2] = cur;
    }
    if (t1 == S) {
#pragma unroll
      for (int j = 0; j < KT - 1; ++j)
        *reinterpret_cast<P*>(ob + static_cast<long long>(j) * C) = win[j];
    }
  } else {
    for (int t = t0; t < t1; ++t) {
      float acc[V];
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = 0.f;
      for (int k = 0; k < K; ++k) {
        const P in = row(t - (K - 1) + k);
        const P wp = *reinterpret_cast<const P*>(w + static_cast<long long>(k) * C + c0);
#pragma unroll
        for (int e = 0; e < V; ++e)
          acc[e] = __fadd_rn(acc[e], __fmul_rn(in.at(e), wp.at(e)));
      }
      P out;
#pragma unroll
      for (int e = 0; e < V; ++e) out.put(e, finish(acc[e], bp.at(e)));
      *reinterpret_cast<P*>(yb + static_cast<long long>(t) * C) = out;
    }
    if (t1 == S)
      for (int j = 0; j < K - 1; ++j)
        *reinterpret_cast<P*>(ob + static_cast<long long>(j) * C) = row(S - (K - 1) + j);
  }
}

// One launch: `blocks` blocks, runs of L steps, V channels a thread.
struct Grid {
  long long blocks;
  int L, runs;
};

template <typename T, int V>
cudaError_t launch_k(const Grid& g, const T* x, const T* tail, const T* w,
                     const T* b, T* y, T* tail_out, int B, int S, int C,
                     int K, int silu, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(g.blocks));
#define REPRO_CONV(KT)                                                       \
  conv1d_kernel<T, V, KT><<<grid, kThreads, 0, stream>>>(                   \
      x, tail, w, b, y, tail_out, B, S, C, K, g.L, g.runs, silu)
  switch (K) {
    case 2: REPRO_CONV(2); break;
    case 3: REPRO_CONV(3); break;
    case 4: REPRO_CONV(4); break;
    default: REPRO_CONV(0); break;
  }
#undef REPRO_CONV
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(bool vector, const Grid& g, const void* x,
                   const void* tail, const void* w, const void* b, void* y,
                   void* tail_out, int B, int S, int C, int K, int silu,
                   cudaStream_t stream) {
  const auto* xt = static_cast<const T*>(x);
  const auto* tt = static_cast<const T*>(tail);
  const auto* wt = static_cast<const T*>(w);
  const auto* bt = static_cast<const T*>(b);
  auto* yt = static_cast<T*>(y);
  auto* ot = static_cast<T*>(tail_out);
  if (vector)
    return launch_k<T, 16 / sizeof(T)>(g, xt, tt, wt, bt, yt, ot, B, S, C, K,
                                       silu, stream);
  return launch_k<T, 1>(g, xt, tt, wt, bt, yt, ot, B, S, C, K, silu, stream);
}

bool all_aligned(const int64_t* a, int n) {
  for (int i = 0; i < n; ++i)
    if (a[i] % 16 != 0) return false;
  return true;
}

}  // namespace

// The launch's arguments, 17 int64 packed by kernels/conv1d/ops.py (one
// ctypes argument converts in a fraction of the time of 17):
//   a[0..5]   x, tail (0: zeros), w, b, y, tail_out
//   a[6..9]   B, S, C, K
//   a[10]     flags: bit 0 SiLU, bit 1 bfloat16 (else float32)
//   a[11]     device, a[12] stream
//   a[13..16] the plan (ops.py::plan_conv): vector, L, runs, blocks
// x, y (B,S,C), tail and tail_out (B,K-1,C), w (K,C), b (C,), all of one
// dtype and contiguous on `device`. Returns the cudaError_t of the launch.
REPRO_EXPORT int conv1d_launch(const char* packed) {
  int64_t a[17];
  std::memcpy(a, packed, sizeof a);
  const int device = static_cast<int>(a[11]);
  cudaError_t err = repro::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int B = static_cast<int>(a[6]), S = static_cast<int>(a[7]);
  const int C = static_cast<int>(a[8]), K = static_cast<int>(a[9]);
  if (B == 0 || C == 0) return 0;
  const int silu = static_cast<int>(a[10] & 1);
  const bool bf16 = (a[10] & 2) != 0;
  const bool vector = a[13] != 0;
  if (vector && (C % (bf16 ? 8 : 4) != 0 || !all_aligned(a, 6)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Grid g{a[16], static_cast<int>(a[14]), static_cast<int>(a[15])};
  const auto* ptr = reinterpret_cast<void* const*>(a);
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(a[12]);
  if (bf16)
    err = launch<__nv_bfloat16>(vector, g, ptr[0], a[1] ? ptr[1] : nullptr,
                                ptr[2], ptr[3], ptr[4], ptr[5], B, S, C, K,
                                silu, s);
  else
    err = launch<float>(vector, g, ptr[0], a[1] ? ptr[1] : nullptr, ptr[2],
                        ptr[3], ptr[4], ptr[5], B, S, C, K, silu, s);
  return static_cast<int>(err);
}
