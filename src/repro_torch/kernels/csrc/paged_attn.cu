// Paged attention for Hopper (sm_90a): T query rows per slot against that
// slot's pages of a shared KV pool, reached through its page table.
//
// Replaces the Pallas kernel repro/kernels/paged_attn/kernel.py::_kernel
// (paged_attention_pallas). For slot b, KV head h and query row (t, g):
//   s_j = round_q(dot(q, k_j) / sqrt(D));  s_j = cap * tanh(s_j / cap)
//   key j attendable iff its page is assigned, pos_j >= 0, pos_j <= qpos
//   and, with a window, qpos - pos_j < window; masked s_j = -1e30
//   out  = sum_j softmax(s)_j v_j  (float32 p and accumulator), and 0 for
//          a row with no attendable key
// where round_q rounds through q's dtype (bfloat16), as the Pallas kernel
// does. One kernel serves decode (T=1), speculative verify (T=k+1) and a
// chunk of a prompt (T=chunk).
//
// Bound: a launch must read the assigned K/V pages of every (b, h) once,
// plus q, pos and out: at qwen2-1.5b's decode shape (4 slots, 2 KV heads,
// ~36 pages of 16 tokens, D=128, bf16) about 2.4 MB, under 1 us at the
// H100's 3.35 TB/s; the arithmetic (2 * rows * keys * D * 2) is smaller
// still beside 67 TFLOP/s of fp32. So a launch is bound by latency: its
// page walk, page after page, and the few blocks the decode shape gives.
//
// Design. One block per (tile of kRows query rows, KV head h, slot b):
// the T*G rows of one (b, h) share every K/V page, so the tile reads each
// page once for all of them. The Pallas grid's sequential page axis
// becomes a loop, split over the block's kWarps warps (warp w takes pages
// w, w + kWarps, ...), so that four pages are in flight at once; each warp
// keeps its own running max, denominator and D-wide accumulator per row in
// registers (lane l owns dims l, l+32, ...), and the warps merge their
// partial softmaxes through shared memory at the end. The block reads the
// page table itself (no scalar prefetch) and skips a page whose id is -1,
// or whose positions no row of the tile can attend to: both leave the
// running max, denominator and accumulator unchanged, as the Pallas
// kernel's all-false mask does. A warp stages its page's K and V rows of
// head h into shared memory with 16-byte loads (the whole page in flight
// at once). Then, per row, lane l forms its share of every key's dot
// (dims l, l+32, ...), the PS partial sums are reduced by one butterfly
// whose levels each carry PS independent shuffles, and lane j keeps key
// j's score; the page's max, exp and sum then run across the lanes at
// once, one update per page as in the Pallas kernel. The page size PS
// (4, 8, 16 or 32 keys) and D (64, 128, 256) are template parameters, so
// the key loops unroll. No fast math: expf/tanhf and IEEE division, held
// to float32 tolerances.
//
// wgmma, TMA and split-K over pages across blocks wait for a later change.
#include <climits>
#include <cstdint>

#include "common.cuh"

namespace {

using repro::from_f;
using repro::to_f;

constexpr int kWarps = 4;
constexpr int kRows = 8;          // query rows (t, g) of one (b, h) per block
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// q, out (B,T,Hkv,G,D); k_pool, v_pool (P,ps,Hkv,D); pos_pool (P,ps);
// page_rows (B,n); qpos (B,T).
template <typename T, int D, int PS>
__global__ void __launch_bounds__(kWarps * 32)
paged_attn_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                  const T* __restrict__ v_pool,
                  const int* __restrict__ pos_pool,
                  const int* __restrict__ page_rows,
                  const int* __restrict__ qpos, T* __restrict__ out,
                  int Tq, int Hkv, int G, int n, int window, float softcap) {
  constexpr int DPL = D / 32;     // accumulator dims per lane
  constexpr int ps = PS;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int r0 = blockIdx.x * kRows;
  const int nrows = min(kRows, Tq * G - r0);
  const float sqrt_d = sqrtf(static_cast<float>(D));

  float qr[kRows][DPL];
  int qp[kRows];
  int qmin = INT_MAX, qmax = INT_MIN;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    qp[r] = INT_MIN;
#pragma unroll
    for (int i = 0; i < DPL; ++i) qr[r][i] = 0.f;
    if (r < nrows) {
      const int t = (r0 + r) / G, g = (r0 + r) % G;
      const T* row = q + ((((size_t)b * Tq + t) * Hkv + h) * G + g) * D;
#pragma unroll
      for (int i = 0; i < DPL; ++i) qr[r][i] = to_f<T>(row[lane + 32 * i]);
      qp[r] = qpos[(size_t)b * Tq + t];
      qmin = min(qmin, qp[r]);
      qmax = max(qmax, qp[r]);
    }
  }

  float m[kRows], l[kRows], acc[kRows][DPL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  // this warp's staging area: the page's K rows, then its V rows, of head h
  const int row_vecs = D * (int)sizeof(T) / 16;
  T* ks = reinterpret_cast<T*>(smem + (size_t)warp * 2 * ps * D * sizeof(T));
  T* vs = ks + (size_t)ps * D;
  for (int j = warp; j < n; j += kWarps) {
    const int page = page_rows[(size_t)b * n + j];
    if (page < 0) continue;                  // unassigned: state unchanged
    const int kp = lane < ps ? pos_pool[(size_t)page * ps + lane] : -1;
    const bool live = kp >= 0 && kp <= qmax && (window <= 0 || kp + window > qmin);
    if (!__any_sync(kFull, live)) continue;  // no row can attend: unchanged
    for (int idx = lane; idx < ps * row_vecs; idx += 32) {
      const int t = idx / row_vecs, c = idx % row_vecs;
      const size_t src = (((size_t)page * ps + t) * Hkv + h) * D;
      reinterpret_cast<uint4*>(ks)[idx] =
          reinterpret_cast<const uint4*>(k_pool + src)[c];
      reinterpret_cast<uint4*>(vs)[idx] =
          reinterpret_cast<const uint4*>(v_pool + src)[c];
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r >= nrows) break;
      // the page's PS partial dots first, then their butterfly sums level
      // by level: PS independent shuffles in flight at each level
      float part[PS];
#pragma unroll
      for (int t = 0; t < PS; ++t) {
        float a = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i)
          a = fmaf(qr[r][i], to_f<T>(ks[t * D + lane + 32 * i]), a);
        part[t] = a;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int t = 0; t < PS; ++t) part[t] += __shfl_xor_sync(kFull, part[t], o);
      }
      float s = kNegInf;                     // lane j's score: key j
#pragma unroll
      for (int t = 0; t < PS; ++t)
        if (lane == t) s = part[t];
      const bool ok = kp >= 0 && kp <= qp[r] && (window <= 0 || qp[r] - kp < window);
      s = to_f<T>(from_f<T>(s / sqrt_d));   // round through q's dtype
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      s = ok ? s : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(s));
      const float alpha = expf(m[r] - m_new);
      const float p = ok ? expf(s - m_new) : 0.f;
      l[r] = l[r] * alpha + warp_sum(p);
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha;
#pragma unroll
      for (int t = 0; t < PS; ++t) {
        const float pt = __shfl_sync(kFull, p, t);
#pragma unroll
        for (int i = 0; i < DPL; ++i)
          acc[r][i] = fmaf(pt, to_f<T>(vs[t * D + lane + 32 * i]), acc[r][i]);
      }
      m[r] = m_new;
    }
    __syncwarp();                            // before the next page lands
  }

  // merge the warps' partial softmaxes: [warp][row] max and denominator,
  // then [warp][row][D] accumulators
  __syncthreads();
  float* ms = reinterpret_cast<float*>(smem);
  float* ls = ms + kWarps * kRows;
  float* as = ls + kWarps * kRows;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r >= nrows) break;
    if (lane == 0) {
      ms[warp * kRows + r] = m[r];
      ls[warp * kRows + r] = l[r];
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      as[(warp * kRows + r) * D + lane + 32 * i] = acc[r][i];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < nrows * D; idx += blockDim.x) {
    const int r = idx / D, d = idx % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, ms[w * kRows + r]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = expf(ms[w * kRows + r] - mx);
      den += ls[w * kRows + r] * e;
      num += as[(w * kRows + r) * D + d] * e;
    }
    const float o = den > 0.f ? num / fmaxf(den, 1e-30f) : 0.f;
    const int t = (r0 + r) / G, g = (r0 + r) % G;
    out[((((size_t)b * Tq + t) * Hkv + h) * G + g) * D + d] = from_f<T>(o);
  }
}

template <typename T, int D, int PS>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const int* pos_pool, const int* page_rows, const int* qpos,
                   void* out, int B, int Tq, int Hkv, int G, int n, int window,
                   float softcap, cudaStream_t stream) {
  const size_t stage = (size_t)kWarps * 2 * PS * D * sizeof(T);
  const size_t merge = (size_t)kWarps * kRows * (D + 2) * sizeof(float);
  const size_t smem = stage > merge ? stage : merge;
  auto kernel = paged_attn_kernel<T, D, PS>;
  const cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq * G + kRows - 1) / kRows, Hkv, B);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), pos_pool, page_rows, qpos,
      static_cast<T*>(out), Tq, Hkv, G, n, window, softcap);
  return cudaGetLastError();
}

#define REPRO_PAGED_ARGS q, k_pool, v_pool, pos_pool, page_rows, qpos, out, \
                         B, Tq, Hkv, G, n, window, softcap, stream

template <typename T, int D>
cudaError_t launch_ps(int ps, const void* q, const void* k_pool,
                      const void* v_pool, const int* pos_pool,
                      const int* page_rows, const int* qpos, void* out, int B,
                      int Tq, int Hkv, int G, int n, int window, float softcap,
                      cudaStream_t stream) {
  switch (ps) {
    case 4: return launch<T, D, 4>(REPRO_PAGED_ARGS);
    case 8: return launch<T, D, 8>(REPRO_PAGED_ARGS);
    case 16: return launch<T, D, 16>(REPRO_PAGED_ARGS);
    case 32: return launch<T, D, 32>(REPRO_PAGED_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_d(int D, int ps, const void* q, const void* k_pool,
                     const void* v_pool, const int* pos_pool,
                     const int* page_rows, const int* qpos, void* out, int B,
                     int Tq, int Hkv, int G, int n, int window, float softcap,
                     cudaStream_t stream) {
  switch (D) {
    case 64: return launch_ps<T, 64>(ps, REPRO_PAGED_ARGS);
    case 128: return launch_ps<T, 128>(ps, REPRO_PAGED_ARGS);
    case 256: return launch_ps<T, 256>(ps, REPRO_PAGED_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

#undef REPRO_PAGED_ARGS

}  // namespace

// q, out (B,T,Hkv,G,D) and k_pool, v_pool (P,ps,Hkv,D) of one dtype
// (dtype 0: float32, 1: bfloat16), pos_pool (P,ps), page_rows (B,n) and
// qpos (B,T) int32, all contiguous on `device`; D in {64, 128, 256}, ps
// in {4, 8, 16, 32}. Returns the cudaError_t of the launch.
REPRO_EXPORT int paged_attn_launch(const void* q, const void* k_pool,
                                   const void* v_pool, const int* pos_pool,
                                   const int* page_rows, const int* qpos,
                                   void* out, int B, int Tq, int Hkv, int G,
                                   int D, int n, int ps, int window,
                                   float softcap, int dtype, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || Tq == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = launch_d<float>(D, ps, q, k_pool, v_pool, pos_pool, page_rows, qpos,
                          out, B, Tq, Hkv, G, n, window, softcap, s);
  else if (dtype == 1)
    err = launch_d<__nv_bfloat16>(D, ps, q, k_pool, v_pool, pos_pool,
                                  page_rows, qpos, out, B, Tq, Hkv, G, n,
                                  window, softcap, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
