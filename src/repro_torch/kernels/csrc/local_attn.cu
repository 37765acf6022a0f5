// Sliding-window (local) attention over a whole prompt for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/local_attn/kernel.py::_kernel
// (local_attention_pallas). For batch b, query head h (KV head h / G) and
// query i of q (B,S,Hq,D) against k, v (B,S,Hkv,D):
//   s_ij = dot(q_i, k_j) / sqrt(D)                  (float32, a division)
//   key j attendable iff 0 <= j < S, i - j < window and
//        causal: i - j >= 0;  non-causal: j - i < window
//   masked s_ij = -1e30; online softmax over key tiles: m, l, acc with
//   p = exp(s - m_new) (0 where masked), l = l*alpha + sum p,
//   acc = acc*alpha + p.v;  out_i = acc / max(l, 1e-30), in q's dtype.
// Key tiles wholly outside the band are never visited: they would leave
// m, l and acc unchanged, as the Pallas kernel's clamped, all-masked
// blocks do. Any S runs; rows and keys past S are bounds-checked.
//
// Bound: at recurrentgemma-2b's longest prefill (S=2,560, window 2,048,
// Hq=10 on Hkv=1, D=256) the band holds ~31.5 M query-key pairs: ~32
// GFLOP, ~33 us on the bf16 tensor cores; the bytes (q, k, v, out once)
// take ~8.6 us. This kernel does its products on the float32 CUDA cores
// (67 TFLOP/s), so it is bound by that arithmetic and far above the
// bound; wgmma and TMA are later work.
//
// Design. One block of 256 threads per (64-query tile, query head, batch
// row). The query tile stays in shared memory (float32) while the block
// walks the 32-key tiles of its band: each tile's K and V are staged
// (the load loop unrolled so that eight loads a thread are in flight; a
// loop that waits on each load in turn leaves the block idle on memory),
// every thread forms a 4 x 2 patch of the 64 x 32 scores over D, the
// scaled and masked scores go to shared memory, one thread per query row
// updates that row's running max and denominator and turns its scores
// into p, and then every thread adds p times V into its 4 rows x D/16
// columns of the accumulator, held in registers. D (64, 128, 256) is a
// template parameter, so the accumulator is a register array; at D=256
// the block uses ~143 KB of shared memory (set with
// cudaFuncAttributeMaxDynamicSharedMemorySize). No fast math: expf and
// IEEE division, held to float32 tolerances.
#include "common.cuh"

namespace {

using repro::from_f;
using repro::to_f;

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 32;         // keys per tile
constexpr int kThreads = 256;   // 16 row groups of 4 x 16 column lanes
constexpr float kNegInf = -1e30f;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)(kBQ + 2 * kBK) * (D + 1) +
                          (size_t)kBQ * (kBK + 1) + 3 * kBQ) +
         (size_t)kBQ * (kBK + 1);  // the mask
}

// q, out (B,S,Hq,D); k, v (B,S,Hkv,D). Grid (ceil(S/64), Hq, B).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
local_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ out, int S,
                  int Hq, int Hkv, int window, int causal) {
  constexpr int LD = D + 1, LS = kBK + 1, DPT = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                         // [64][D+1]
  float* Ks = Qs + kBQ * LD;                // [32][D+1]
  float* Vs = Ks + kBK * LD;                // [32][D+1]
  float* Ps = Vs + kBK * LD;                // [64][33] scores, then p
  float* Ms = Ps + kBQ * LS;                // [64] running max
  float* Ls = Ms + kBQ;                     // [64] running denominator
  float* As = Ls + kBQ;                     // [64] this tile's alpha
  bool* Ok = reinterpret_cast<bool*>(As + kBQ);   // [64][33] attendable
  const int i0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const float sqrt_d = sqrtf(static_cast<float>(D));

  #pragma unroll 8
  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D, i = i0 + r;
    Qs[r * LD + d] = i < S ? to_f<T>(q[(((size_t)b * S + i) * Hq + h) * D + d]) : 0.f;
  }
  if (tid < kBQ) {
    Ms[tid] = kNegInf;
    Ls[tid] = 0.f;
  }
  float acc[4][DPT];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[r][c] = 0.f;

  // the band of keys any row of this tile can attend to
  const int i_last = min(i0 + kBQ, S) - 1;
  const int j_lo = max(0, i0 - window + 1);
  const int j_hi = causal ? i_last : min(S - 1, i_last + window - 1);
  for (int j0 = (j_lo / kBK) * kBK; j0 <= j_hi; j0 += kBK) {
    __syncthreads();                          // the previous tile is consumed
    #pragma unroll 8
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int r = idx / D, d = idx % D, j = j0 + r;
      const size_t src = (((size_t)b * S + j) * Hkv + hk) * D + d;
      Ks[r * LD + d] = j < S ? to_f<T>(k[src]) : 0.f;
      Vs[r * LD + d] = j < S ? to_f<T>(v[src]) : 0.f;
    }
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int r = 0; r < 4; ++r) s[r][0] = s[r][1] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = Qs[(ty * 4 + r) * LD + d];
      const float k0 = Ks[tx * LD + d], k1 = Ks[(tx + 16) * LD + d];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        s[r][0] = fmaf(a[r], k0, s[r][0]);
        s[r][1] = fmaf(a[r], k1, s[r][1]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int ri = ty * 4 + r, i = i0 + ri;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int cj = tx + 16 * c, j = j0 + cj, delta = i - j;
        const bool ok = j >= 0 && j < S && delta < window &&
                        (causal ? delta >= 0 : -delta < window);
        Ps[ri * LS + cj] = ok ? s[r][c] / sqrt_d : kNegInf;
        Ok[ri * LS + cj] = ok;
      }
    }
    __syncthreads();

    if (tid < kBQ) {                           // row tid's online softmax
      float mx = kNegInf;
      for (int j = 0; j < kBK; ++j) mx = fmaxf(mx, Ps[tid * LS + j]);
      const float m_prev = Ms[tid], m_new = fmaxf(m_prev, mx);
      const float alpha = expf(m_prev - m_new);
      float sum = 0.f;
      for (int j = 0; j < kBK; ++j) {
        const float p = Ok[tid * LS + j] ? expf(Ps[tid * LS + j] - m_new) : 0.f;
        Ps[tid * LS + j] = p;
        sum += p;
      }
      Ls[tid] = Ls[tid] * alpha + sum;
      Ms[tid] = m_new;
      As[tid] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float alpha = As[ty * 4 + r];
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[r][c] *= alpha;
    }
    for (int j = 0; j < kBK; ++j) {
      float p[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) p[r] = Ps[(ty * 4 + r) * LS + j];
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        const float vv = Vs[j * LD + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][c] = fmaf(p[r], vv, acc[r][c]);
      }
    }
  }

  __syncthreads();
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty * 4 + r;
    if (i >= S) continue;
    const float l = fmaxf(Ls[ty * 4 + r], 1e-30f);
    T* row = out + (((size_t)b * S + i) * Hq + h) * D;
#pragma unroll
    for (int c = 0; c < DPT; ++c) row[tx + 16 * c] = from_f<T>(acc[r][c] / l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int Hq, int Hkv, int window, int causal,
                   cudaStream_t stream) {
  auto kernel = local_attn_kernel<T, D>;
  const size_t smem = smem_bytes<D>();
  const cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, Hq, Hkv, window,
      causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     void* out, int B, int S, int Hq, int Hkv, int window,
                     int causal, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<T, 64>(q, k, v, out, B, S, Hq, Hkv, window, causal, stream);
    case 128: return launch<T, 128>(q, k, v, out, B, S, Hq, Hkv, window, causal, stream);
    case 256: return launch<T, 256>(q, k, v, out, B, S, Hq, Hkv, window, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, out (B,S,Hq,D) and k, v (B,S,Hkv,D) of one dtype (0: float32,
// 1: bfloat16), contiguous on `device`; D in {64, 128, 256}, window >= 1.
// Returns the cudaError_t of the launch.
REPRO_EXPORT int local_attn_launch(const void* q, const void* k, const void* v,
                                   void* out, int B, int S, int Hq, int Hkv,
                                   int D, int window, int causal, int dtype,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || S == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = launch_d<float>(D, q, k, v, out, B, S, Hq, Hkv, window, causal, s);
  else if (dtype == 1)
    err = launch_d<__nv_bfloat16>(D, q, k, v, out, B, S, Hq, Hkv, window,
                                  causal, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
