// One fused LSTM step for Hopper (sm_90a), with per-replica weights.
//
// Replaces the Pallas kernel repro/kernels/lstm_cell/kernel.py::_lstm_kernel
// (lstm_cell_pallas). For replica r, example b and hidden unit j:
//   gate_g = x[r,b,:] @ wx[r,:,g,j] + h[r,b,:] @ wh[r,:,g,j] + b[r,g,j]
//   c'     = sigmoid(f + 1) * c + sigmoid(i) * tanh(g)
//   h'     = sigmoid(o) * tanh(c')
// with gates in i|f|g|o order and the forget bias +1 of core/temporal.py.
// The (B, 4H) gate tensor never reaches device memory.
//
// Bound: each launch must read every replica's weights once, 23 * (D+H)
// * 4H floats at the forecast's shapes (4.5 MB for layer 0, 3.0 MB for
// layer 1), ~1.3 us and ~0.9 us at the H100's 3.35 TB/s; the arithmetic
// (~2 MFLOP) is far below that. At B=1 there are only R*B = 23 blocks, so
// a launch is latency-bound. Design: one block per (r, b) row, x and h
// staged in shared memory and read as broadcasts, one thread per hidden
// unit j doing its four gate dots in fp32 while neighbouring threads read
// neighbouring weights (coalesced along j). expf/tanhf, not the
// intrinsics: the kernel is held to fp32 tolerances.
#include "common.cuh"

__device__ __forceinline__ float sigm(float v) { return 1.f / (1.f + expf(-v)); }

__global__ void lstm_cell_kernel(const float* __restrict__ x,
                                 const float* __restrict__ h,
                                 const float* __restrict__ c,
                                 const float* __restrict__ wx,
                                 const float* __restrict__ wh,
                                 const float* __restrict__ bias,
                                 float* __restrict__ h_out,
                                 float* __restrict__ c_out,
                                 int B, int D, int H) {
  extern __shared__ float smem[];
  float* xs = smem;      // D
  float* hs = smem + D;  // H
  const long row = blockIdx.x;  // r * B + b
  const long r = row / B;
  for (int d = threadIdx.x; d < D; d += blockDim.x) xs[d] = x[row * D + d];
  for (int k = threadIdx.x; k < H; k += blockDim.x) hs[k] = h[row * H + k];
  __syncthreads();
  const long G = 4L * H;  // stride of one input row of wx / wh
  const float* wxr = wx + r * D * G;
  const float* whr = wh + r * H * G;
  const float* br = bias + r * G;
  for (int j = threadIdx.x; j < H; j += blockDim.x) {
    float ax[4] = {0.f, 0.f, 0.f, 0.f};
    float ah[4] = {0.f, 0.f, 0.f, 0.f};
    for (int d = 0; d < D; ++d) {
      const float xv = xs[d];
      const float* w = wxr + d * G + j;
#pragma unroll
      for (int g = 0; g < 4; ++g) ax[g] = fmaf(xv, w[g * H], ax[g]);
    }
    for (int k = 0; k < H; ++k) {
      const float hv = hs[k];
      const float* w = whr + k * G + j;
#pragma unroll
      for (int g = 0; g < 4; ++g) ah[g] = fmaf(hv, w[g * H], ah[g]);
    }
    const float gi = ax[0] + ah[0] + br[j];
    const float gf = ax[1] + ah[1] + br[H + j];
    const float gg = ax[2] + ah[2] + br[2 * H + j];
    const float go = ax[3] + ah[3] + br[3 * H + j];
    const float cn = sigm(gf + 1.f) * c[row * H + j] + sigm(gi) * tanhf(gg);
    c_out[row * H + j] = cn;
    h_out[row * H + j] = sigm(go) * tanhf(cn);
  }
}

// x (R,B,D), h and c (R,B,H), wx (R,D,4,H), wh (R,H,4,H), b (R,4,H)
// -> h_out, c_out (R,B,H). All float32, contiguous, on `device`.
// Returns the cudaError_t of the launch.
REPRO_EXPORT int lstm_cell_launch(const float* x, const float* h,
                                  const float* c, const float* wx,
                                  const float* wh, const float* b,
                                  float* h_out, float* c_out, int R, int B,
                                  int D, int H, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int threads = ((H + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  const size_t smem = (static_cast<size_t>(D) + H) * sizeof(float);
  lstm_cell_kernel<<<R * B, threads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      x, h, c, wx, wh, b, h_out, c_out, B, D, H);
  return static_cast<int>(cudaGetLastError());
}
