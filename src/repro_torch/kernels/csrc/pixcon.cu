// Fused Pix-Con contribution gate for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/pixcon/kernel.py::_pixcon_kernel
// (pixcon_gate_pallas). Per (replica r, example b) row:
//   h   = tanh(feats[p,:] @ w1 + b1)           (F=4 -> Hp, per pixel)
//   s   = h @ w2 + b2
//   w   = sigmoid(s * inv_temp)
//   w  *= P / max(sum_p w, 1e-6)               (if normalize)
//   out = x[t,p] * w[p]                        for every day t
// and, unlike the Pallas kernel, also writes w: the partitioner ranks the
// pixels by it.
//
// Bound: at the forecast's shapes (R=23, B=1, T=30, P=64, F=4, Hp=32) one
// launch moves ~0.4 MB and does ~0.6 MFLOP: 0.12 us of bytes, far below
// one launch's latency on an H100 (~2 us). So the launch is a chain of
// dependent steps, and the design shortens the chain:
//  * one block of 256 threads per row; each thread first loads the x it
//    will gate (16-byte loads where P % 4 == 0), so that load's latency
//    overlaps the rest, then the block stages the replica's w1, b1 and w2
//    in shared memory, all loads in flight at once;
//  * the P x Hp (pixel, unit) tanh terms are spread over all the threads
//    (2,048 terms, 8 a thread at the forecast's shape) into shared memory;
//  * one thread per pixel sums its Hp terms in k order (loads of 8
//    unrolled, then the dependent adds), then the sigmoid;
//  * the normalising sum over P runs on one thread in pixel order from
//    registers (loads of 16 unrolled, then the dependent adds);
//  * each thread gates its x with the w of its fixed column group: 16-byte
//    stores and no per-output modulo where P % 4 == 0 (the `vec` flag of
//    the launch), a scalar path otherwise.
// A row is one block; cutting it into T-tiles over more blocks (the
// Pallas kernel recomputes the MLP per T-tile) would only add blocks: the
// gated write is two 16-byte loads and stores a thread.
//
// The partitioner sorts the pixels by w, and at the forecast's shapes
// neighbouring weights often lie a few ulp apart, so a last-bit difference
// between the kernel and its plain version would reorder pixels and change
// the forecast. So every step runs in the same order, with the same
// rounding, as kernels/pixcon/ref.py: a in f order with no fused
// multiply-add, tanhf(a + b1) * w2, the sum over k in index order, the
// sigmoid as 1 / (1 + exp(-v)), the normalising sum in pixel order, and the
// scale as reciprocal times P, which is how PyTorch evaluates P / x.
#include <cstdint>
#include <cstring>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTerms = 2048;     // (pixel, unit) terms staged a pass
constexpr int kPrefetch = 4;     // x vectors a thread loads before the MLP

struct Args {
  const float* x;
  const float* feats;
  const float* w1;
  const float* b1;
  const float* w2;
  const float* b2;
  float* out;
  float* wout;
  int B, T, P, F, Hp, cp, normalize;
  float inv_temp;
};

// W floats of x loaded and stored as one access (float4 on the vector path)
template <int W> struct Vec;
template <> struct Vec<4> { using type = float4; };
template <> struct Vec<1> { using type = float; };

template <int W>
__device__ __forceinline__ typename Vec<W>::type gate(typename Vec<W>::type v,
                                                      const float* w);
template <>
__device__ __forceinline__ float4 gate<4>(float4 v, const float* w) {
  return make_float4(__fmul_rn(v.x, w[0]), __fmul_rn(v.y, w[1]),
                     __fmul_rn(v.z, w[2]), __fmul_rn(v.w, w[3]));
}
template <>
__device__ __forceinline__ float gate<1>(float v, const float* w) {
  return __fmul_rn(v, w[0]);
}

// W = 4: P % 4 == 0 and x, out 16-byte aligned; W = 1: any P.
template <int W>
__global__ void __launch_bounds__(kThreads) pixcon_gate_kernel(Args a) {
  using VT = typename Vec<W>::type;
  extern __shared__ __align__(16) float smem[];
  const int B = a.B, T = a.T, P = a.P, F = a.F, Hp = a.Hp, LT = Hp + 1;
  float* w1s = smem;                // [F][Hp]
  float* b1s = w1s + F * Hp;        // [Hp]
  float* w2s = b1s + Hp;            // [Hp]
  float* fs = w2s + Hp;             // [cp][F] this pass's pixel features
  float* terms = fs + a.cp * F;     // [cp][Hp+1]
  float* wsh = terms + a.cp * LT;   // [P] the gate weights
  float* scale_sh = wsh + P;        // the normalising scale
  const long row = blockIdx.x;      // r * B + b
  const int r = static_cast<int>(row / B);
  const int tid = threadIdx.x;

  // this thread's outputs: column group cg (W columns), rows t0, t0 + step..
  const int G = P / W;
  const int step = kThreads >= G ? kThreads / G : 1;
  const int cg0 = kThreads >= G ? tid % G : tid;
  const int t0 = kThreads >= G ? tid / G : 0;
  const VT* xr = reinterpret_cast<const VT*>(a.x + row * T * P);
  VT* orow = reinterpret_cast<VT*>(a.out + row * T * P);
  VT xv[kPrefetch];
  const bool mine = t0 < step && cg0 < G;
#pragma unroll
  for (int k = 0; k < kPrefetch; ++k) {
    const int t = t0 + k * step;
    if (mine && t < T) xv[k] = xr[static_cast<long>(t) * G + cg0];
  }

  const float* w1r = a.w1 + static_cast<long>(r) * F * Hp;
  for (int i = tid; i < F * Hp; i += kThreads) w1s[i] = w1r[i];
  for (int i = tid; i < Hp; i += kThreads) {
    b1s[i] = a.b1[static_cast<long>(r) * Hp + i];
    w2s[i] = a.w2[static_cast<long>(r) * Hp + i];
  }
  const float b2r = a.b2[r];
  const float* fr = a.feats + row * P * F;
  auto load_feats = [&](int p0) {   // the features of pixels p0..p0+cp-1
    const int n = min(a.cp, P - p0) * F;
    for (int i = tid; i < n; i += kThreads) fs[i] = fr[static_cast<long>(p0) * F + i];
  };
  load_feats(0);
  __syncthreads();

  for (int p0 = 0; p0 < P; p0 += a.cp) {
    const int np = min(a.cp, P - p0);
    for (int i = tid; i < np * Hp; i += kThreads) {
      const int pl = i / Hp, k = i - pl * Hp;
      const float* fp = fs + pl * F;
      float v = __fmul_rn(fp[0], w1s[k]);
#pragma unroll 4
      for (int f = 1; f < F; ++f) v = __fadd_rn(v, __fmul_rn(fp[f], w1s[f * Hp + k]));
      terms[pl * LT + k] = __fmul_rn(tanhf(__fadd_rn(v, b1s[k])), w2s[k]);
    }
    __syncthreads();
    for (int pl = tid; pl < np; pl += kThreads) {
      const float* tr = terms + pl * LT;
      float s = tr[0];
      int k = 1;
      for (; k + 8 <= Hp; k += 8) {   // 8 loads in flight, then the adds
        float v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = tr[k + j];
#pragma unroll
        for (int j = 0; j < 8; ++j) s = __fadd_rn(s, v[j]);
      }
      for (; k < Hp; ++k) s = __fadd_rn(s, tr[k]);
      const float v = __fmul_rn(__fadd_rn(s, b2r), a.inv_temp);
      wsh[p0 + pl] = 1.f / (1.f + expf(-v));
    }
    if (p0 + a.cp < P) load_feats(p0 + a.cp);   // fs was read before the sync
    __syncthreads();          // wsh is whole; terms are free again
  }

  float scale = 1.f;
  if (a.normalize) {
    if (tid == 0) {           // in pixel order, as the plain version sums
      float total = wsh[0];
      int p = 1;
      for (; p + 16 <= P; p += 16) {
        float v[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) v[j] = wsh[p + j];
#pragma unroll
        for (int j = 0; j < 16; ++j) total = __fadd_rn(total, v[j]);
      }
      for (; p < P; ++p) total = __fadd_rn(total, wsh[p]);
      *scale_sh = __fmul_rn(1.f / fmaxf(total, 1e-6f), static_cast<float>(P));
    }
    __syncthreads();
    scale = *scale_sh;
  }
  for (int p = tid; p < P; p += kThreads)
    a.wout[row * P + p] = a.normalize ? __fmul_rn(wsh[p], scale) : wsh[p];

  if (!mine) return;
  const int cstep = kThreads >= G ? G : kThreads;
  for (int cg = cg0; cg < G; cg += cstep) {
    float w[W];
#pragma unroll
    for (int e = 0; e < W; ++e) {
      const float v = wsh[cg * W + e];
      w[e] = a.normalize ? __fmul_rn(v, scale) : v;
    }
    int t = t0;
    if (cg == cg0) {          // the rows whose x was loaded first
#pragma unroll
      for (int k = 0; k < kPrefetch; ++k, t += step)
        if (t < T) orow[static_cast<long>(t) * G + cg] = gate<W>(xv[k], w);
    }
    for (; t < T; t += step) {
      const long i = static_cast<long>(t) * G + cg;
      orow[i] = gate<W>(xr[i], w);
    }
  }
}

}  // namespace

// The launch's arguments, packed by kernels/pixcon/ops.py: 18 int64, then
// one float32:
//   a[0..7]   x (R,B,T,P), feats (R,B,P,F), w1 (R,F,Hp), b1 (R,Hp),
//             w2 (R,Hp), b2 (R,), out (R,B,T,P), wout (R,B,P)
//   a[8..13]  R, B, T, P, F, Hp
//   a[14]     normalize, a[15] vec (16-byte x and out: P % 4 == 0 and
//             both 16-byte aligned), a[16] device, a[17] stream
//   then      inv_temp, 1 / temperature rounded to float32
// All float32, contiguous, on `device`. Returns the cudaError_t of the
// launch.
REPRO_EXPORT int pixcon_gate_launch(const char* packed) {
  int64_t a[18];
  float inv_temp;
  std::memcpy(a, packed, sizeof a);
  std::memcpy(&inv_temp, packed + sizeof a, sizeof inv_temp);
  cudaError_t err = repro::use_device(static_cast<int>(a[16]));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long R = a[8];
  Args k;
  k.x = reinterpret_cast<const float*>(a[0]);
  k.feats = reinterpret_cast<const float*>(a[1]);
  k.w1 = reinterpret_cast<const float*>(a[2]);
  k.b1 = reinterpret_cast<const float*>(a[3]);
  k.w2 = reinterpret_cast<const float*>(a[4]);
  k.b2 = reinterpret_cast<const float*>(a[5]);
  k.out = reinterpret_cast<float*>(a[6]);
  k.wout = reinterpret_cast<float*>(a[7]);
  k.B = static_cast<int>(a[9]);
  k.T = static_cast<int>(a[10]);
  k.P = static_cast<int>(a[11]);
  k.F = static_cast<int>(a[12]);
  k.Hp = static_cast<int>(a[13]);
  k.normalize = static_cast<int>(a[14]);
  k.inv_temp = inv_temp;
  const bool vec = a[15] != 0;
  if (R == 0 || k.B == 0 || k.P == 0) return 0;
  if (k.F < 1 || k.Hp < 1 ||
      (vec && (k.P % 4 != 0 || a[0] % 16 != 0 || a[6] % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  k.cp = k.Hp >= kTerms ? 1 : (kTerms / k.Hp < k.P ? kTerms / k.Hp : k.P);
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(k.F + 2) * k.Hp +
       static_cast<size_t>(k.cp) * (k.F + k.Hp + 1) + k.P + 1);
  const auto s = reinterpret_cast<cudaStream_t>(a[17]);
  const unsigned blocks = static_cast<unsigned>(R * k.B);
  if (vec) {
    err = repro::allow_smem(pixcon_gate_kernel<4>, smem);
    if (err == cudaSuccess)
      pixcon_gate_kernel<4><<<blocks, kThreads, smem, s>>>(k);
  } else {
    err = repro::allow_smem(pixcon_gate_kernel<1>, smem);
    if (err == cudaSuccess)
      pixcon_gate_kernel<1><<<blocks, kThreads, smem, s>>>(k);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
