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
// Bound: at the forecast's shapes (R=23, B=1, T=30, P=64) one launch moves
// ~0.4 MB and does ~0.6 MFLOP, far below one launch's latency on an H100:
// it is launch-bound. Design: one block per row, the P pixels spread over
// the threads, w kept in shared memory, the normalising sum over P read
// from shared memory, then a coalesced loop over the T*P gated outputs.
//
// The partitioner sorts the pixels by w, and at the forecast's shapes
// neighbouring weights often lie a few ulp apart, so a last-bit difference
// between the kernel and its plain version would reorder pixels and change
// the forecast. So every step runs in the same order, with the same
// rounding, as kernels/pixcon/ref.py: the MLP's sums in index order with
// no fused multiply-add, the normalising sum in pixel order on one thread
// (P adds, nothing beside one launch's latency), and the scale as
// reciprocal times P, which is how PyTorch evaluates P / x.
#include "common.cuh"

__global__ void pixcon_gate_kernel(const float* __restrict__ x,
                                   const float* __restrict__ feats,
                                   const float* __restrict__ w1,
                                   const float* __restrict__ b1,
                                   const float* __restrict__ w2,
                                   const float* __restrict__ b2,
                                   float* __restrict__ out,
                                   float* __restrict__ wout,
                                   int B, int T, int P, int F, int Hp,
                                   float inv_temp, int normalize) {
  extern __shared__ float smem[];
  float* wsh = smem;            // P gate weights
  float* scale_sh = smem + P;   // the normalising scale
  const long row = blockIdx.x;            // r * B + b
  const int r = static_cast<int>(row / B);
  const float* fr = feats + row * P * F;
  const float* w1r = w1 + static_cast<long>(r) * F * Hp;
  const float* b1r = b1 + static_cast<long>(r) * Hp;
  const float* w2r = w2 + static_cast<long>(r) * Hp;
  const float b2r = b2[r];

  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const float* fp = fr + p * F;
    float s = 0.f;
    for (int k = 0; k < Hp; ++k) {
      float a = __fmul_rn(fp[0], w1r[k]);
      for (int f = 1; f < F; ++f)
        a = __fadd_rn(a, __fmul_rn(fp[f], w1r[f * Hp + k]));
      const float t = __fmul_rn(tanhf(__fadd_rn(a, b1r[k])), w2r[k]);
      s = k == 0 ? t : __fadd_rn(s, t);
    }
    const float v = __fmul_rn(__fadd_rn(s, b2r), inv_temp);
    wsh[p] = 1.f / (1.f + expf(-v));
  }
  __syncthreads();
  if (normalize) {
    if (threadIdx.x == 0) {  // in pixel order, as the plain version sums
      float total = wsh[0];
      for (int p = 1; p < P; ++p) total = __fadd_rn(total, wsh[p]);
      *scale_sh = __fmul_rn(1.f / fmaxf(total, 1e-6f), static_cast<float>(P));
    }
    __syncthreads();
  }
  const float scale = normalize ? *scale_sh : 1.f;
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const float w = normalize ? __fmul_rn(wsh[p], scale) : wsh[p];
    wsh[p] = w;
    wout[row * P + p] = w;
  }
  __syncthreads();
  const long n = static_cast<long>(T) * P;
  const float* xr = x + row * n;
  float* orow = out + row * n;
  for (long i = threadIdx.x; i < n; i += blockDim.x)
    orow[i] = __fmul_rn(xr[i], wsh[i % P]);
}

// x (R,B,T,P), feats (R,B,P,F), w1 (R,F,Hp), b1 (R,Hp), w2 (R,Hp), b2 (R,)
// -> out (R,B,T,P), wout (R,B,P). All float32, contiguous, on `device`.
// Returns the cudaError_t of the launch.
REPRO_EXPORT int pixcon_gate_launch(const float* x, const float* feats,
                                    const float* w1, const float* b1,
                                    const float* w2, const float* b2,
                                    float* out, float* wout, int R, int B,
                                    int T, int P, int F, int Hp,
                                    float inv_temp, int normalize,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 256;
  const size_t smem = (static_cast<size_t>(P) + 1) * sizeof(float);
  pixcon_gate_kernel<<<R * B, threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      x, feats, w1, b1, w2, b2, out, wout, B, T, P, F, Hp, inv_temp,
      normalize);
  return static_cast<int>(cudaGetLastError());
}
