// Mamba-2 SSD intra-chunk dual form for Hopper (sm_90a): steps 1-2 of
// ssd_chunked, per (batch, chunk, head).
//
// Replaces the Pallas kernel repro/kernels/ssd_chunk/kernel.py::_ssd_kernel
// (ssd_chunk_pallas). With C, B (Q,N), xdt (Q,P) and the within-chunk
// cumulative log-decay dA (Q,) of one (batch, chunk, head):
//   y[i,p]     = sum_{j<=i} (C_i . B_j) * exp(dA[i] - dA[j]) * xdt[j,p]
//   state[p,n] = sum_q xdt[q,p] * (B[q,n] * exp(dA[Q-1] - dA[q]))
// float32 arithmetic, y in xdt's dtype, the state in float32. The upper
// triangle (i < j) is selected to 0 and its exp never multiplied: the
// segment sum there is positive and its exp can overflow to inf, and
// inf * 0 is NaN. Any Q >= 1 runs; rows past Q are bounds-checked.
//
// Bound: at a 512-token Mamba-2 prefill (2 chunks of Q=256, H=24, N=128,
// P=64, bf16) the function moves ~11 MB (inputs once, y and the float32
// state once) and does ~0.8 GFLOP over its causal pairs: ~3.3 us of
// bytes at 3.35 TB/s. These products run on the float32 CUDA cores
// (67 TFLOP/s), ~12 us of arithmetic; the tensor cores are later work.
//
// Design. The (Q,Q) decay matrix never reaches device memory, as in the
// Pallas kernel, but a (Q,N) float32 tile of C or B alone is 128 KB at
// Q=256, so the work is cut in 64-row tiles:
//  * ssd_y_kernel, one block per (64-row query tile i, head, batch*chunk):
//    C's tile stays in shared memory while the block walks the key tiles
//    j <= i; for each it stages B's and xdt's tiles, forms the 64x64
//    scores (each thread a 4x4 patch, C.B over N), applies the decay and
//    the causal selection into a shared tile, then adds that tile times
//    xdt into its 4 x P/16 accumulators in registers.
//  * ssd_state_kernel, one block per (32-column slice of P, head,
//    batch*chunk): walks the chunk in 64-row tiles, staging xdt's slice
//    and B scaled by its decay-to-end (rounded once, as the Pallas kernel
//    does), each thread accumulating a 4x4 patch of the (P,N) state.
// Inputs are read in the model's strided (B,nc,Q,H,*) layout directly,
// and every tile-load loop is unrolled so that eight loads a thread are
// in flight (one load after another left the blocks waiting on memory).
#include "common.cuh"

namespace {

using repro::from_f;
using repro::to_f;

constexpr int kTile = 64;       // query and key rows per tile
constexpr int kThreads = 256;   // 16 x 16 threads, each a 4x4 patch
constexpr int kSliceP = 32;     // state kernel: columns of P per block

// C, Bm (BN,Q,H,N); X, Y (BN,Q,H,P); dA (BN,H,Q). Grid (ceil(Q/64), H, BN).
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_y_kernel(const T* __restrict__ C, const T* __restrict__ Bm,
             const T* __restrict__ X, const float* __restrict__ dA,
             T* __restrict__ Y, int Q, int H, int N, int P) {
  extern __shared__ float smem[];
  const int LN = N + 1, LP = P + 1, LS = kTile + 1;
  float* Cs = smem;                       // [64][N+1]
  float* Bs = Cs + kTile * LN;            // [64][N+1]
  float* Xs = Bs + kTile * LN;            // [64][P+1]
  float* Ss = Xs + kTile * LP;            // [64][65] masked, decayed scores
  float* dAi = Ss + kTile * LS;           // [64]
  float* dAj = dAi + kTile;               // [64]
  const int i0 = blockIdx.x * kTile, h = blockIdx.y;
  const long bc = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  #pragma unroll 8
  for (int idx = tid; idx < kTile * N; idx += kThreads) {
    const int r = idx / N, n = idx % N, i = i0 + r;
    Cs[r * LN + n] = i < Q ? to_f<T>(C[((bc * Q + i) * H + h) * N + n]) : 0.f;
  }
  if (tid < kTile) {
    const int i = i0 + tid;
    dAi[tid] = i < Q ? dA[(bc * H + h) * Q + i] : 0.f;
  }

  float acc[4][4];                        // rows ty*4+r, columns tx+16*c
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (int j0 = 0; j0 <= i0 && j0 < Q; j0 += kTile) {
    __syncthreads();                      // the previous tile is consumed
    #pragma unroll 8
    for (int idx = tid; idx < kTile * N; idx += kThreads) {
      const int r = idx / N, n = idx % N, j = j0 + r;
      Bs[r * LN + n] = j < Q ? to_f<T>(Bm[((bc * Q + j) * H + h) * N + n]) : 0.f;
    }
    #pragma unroll 8
    for (int idx = tid; idx < kTile * P; idx += kThreads) {
      const int r = idx / P, p = idx % P, j = j0 + r;
      Xs[r * LP + p] = j < Q ? to_f<T>(X[((bc * Q + j) * H + h) * P + p]) : 0.f;
    }
    if (tid < kTile) {
      const int j = j0 + tid;
      dAj[tid] = j < Q ? dA[(bc * H + h) * Q + j] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
    for (int n = 0; n < N; ++n) {
      float a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = Cs[(ty * 4 + r) * LN + n];
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = Bs[(tx + 16 * c) * LN + n];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(a[r], b[c], s[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int ri = ty * 4 + r, i = i0 + ri;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int cj = tx + 16 * c, j = j0 + cj;
        float v = 0.f;                    // selected, never multiplied
        if (i >= j && i < Q && j < Q) v = s[r][c] * expf(dAi[ri] - dAj[cj]);
        Ss[ri * LS + cj] = v;
      }
    }
    __syncthreads();

    for (int j = 0; j < kTile; ++j) {
      float l[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) l[r] = Ss[(ty * 4 + r) * LS + j];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int p = tx + 16 * c;
        if (p < P) {
          const float xv = Xs[j * LP + p];
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[r][c] = fmaf(l[r], xv, acc[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty * 4 + r;
    if (i >= Q) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int p = tx + 16 * c;
      if (p < P) Y[((bc * Q + i) * H + h) * P + p] = from_f<T>(acc[r][c]);
    }
  }
}

// Bm (BN,Q,H,N); X (BN,Q,H,P); dA (BN,H,Q); ST (BN,H,P,N) float32.
// Grid (ceil(P/32) * ceil(N/64), H, BN).
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_state_kernel(const T* __restrict__ Bm, const T* __restrict__ X,
                 const float* __restrict__ dA, float* __restrict__ ST,
                 int Q, int H, int N, int P) {
  extern __shared__ float smem[];
  constexpr int kSliceN = 64;
  const int LX = kSliceP + 1, LB = kSliceN + 1;
  float* Xs = smem;                       // [64][33]
  float* Bw = Xs + kTile * LX;            // [64][65] B * decay-to-end
  const int n_slices = (N + kSliceN - 1) / kSliceN;
  const int p0 = (blockIdx.x / n_slices) * kSliceP;
  const int n0 = (blockIdx.x % n_slices) * kSliceN;
  const int h = blockIdx.y;
  const long bc = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const float last = dA[(bc * H + h) * Q + Q - 1];

  float acc[2][4];                        // p = p0+ty*2+r, n = n0+tx+16*c
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (int q0 = 0; q0 < Q; q0 += kTile) {
    __syncthreads();
    #pragma unroll 8
    for (int idx = tid; idx < kTile * kSliceP; idx += kThreads) {
      const int r = idx / kSliceP, pp = idx % kSliceP, q = q0 + r, p = p0 + pp;
      Xs[r * LX + pp] = (q < Q && p < P)
          ? to_f<T>(X[((bc * Q + q) * H + h) * P + p]) : 0.f;
    }
    #pragma unroll 8
    for (int idx = tid; idx < kTile * kSliceN; idx += kThreads) {
      const int r = idx / kSliceN, nn = idx % kSliceN, q = q0 + r, n = n0 + nn;
      float v = 0.f;
      if (q < Q && n < N)
        v = to_f<T>(Bm[((bc * Q + q) * H + h) * N + n]) *
            expf(last - dA[(bc * H + h) * Q + q]);
      Bw[r * LB + nn] = v;
    }
    __syncthreads();
    const int rows = min(kTile, Q - q0);
    for (int q = 0; q < rows; ++q) {
      float xv[2], bv[4];
#pragma unroll
      for (int r = 0; r < 2; ++r) xv[r] = Xs[q * LX + ty * 2 + r];
#pragma unroll
      for (int c = 0; c < 4; ++c) bv[c] = Bw[q * LB + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(xv[r], bv[c], acc[r][c]);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int p = p0 + ty * 2 + r;
    if (p >= P) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + tx + 16 * c;
      if (n < N) ST[((bc * H + h) * P + p) * N + n] = acc[r][c];
    }
  }
}

template <typename T>
cudaError_t launch(const void* C, const void* Bm, const void* X,
                   const float* dA, void* Y, float* ST, int BN, int Q, int H,
                   int N, int P, cudaStream_t stream) {
  const size_t y_smem = sizeof(float) *
      (2 * kTile * (N + 1) + kTile * (P + 1) + kTile * (kTile + 1) + 2 * kTile);
  auto yk = ssd_y_kernel<T>;
  cudaError_t err = repro::allow_smem(yk, y_smem);
  if (err != cudaSuccess) return err;
  const dim3 y_grid((Q + kTile - 1) / kTile, H, BN);
  yk<<<y_grid, kThreads, y_smem, stream>>>(
      static_cast<const T*>(C), static_cast<const T*>(Bm),
      static_cast<const T*>(X), dA, static_cast<T*>(Y), Q, H, N, P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t st_smem = sizeof(float) * kTile * (kSliceP + 1 + 64 + 1);
  const int slices = ((P + kSliceP - 1) / kSliceP) * ((N + 63) / 64);
  const dim3 st_grid(slices, H, BN);
  ssd_state_kernel<T><<<st_grid, kThreads, st_smem, stream>>>(
      static_cast<const T*>(Bm), static_cast<const T*>(X), dA, ST, Q, H, N, P);
  return cudaGetLastError();
}

}  // namespace

// C, Bm (BN,Q,H,N) and X, Y (BN,Q,H,P) of one dtype (0: float32,
// 1: bfloat16), dA (BN,H,Q) and ST (BN,H,P,N) float32, all contiguous on
// `device`; N <= 256, P <= 64. Returns the cudaError_t of the launches.
REPRO_EXPORT int ssd_chunk_launch(const void* C, const void* Bm, const void* X,
                                  const float* dA, void* Y, float* ST, int BN,
                                  int Q, int H, int N, int P, int dtype,
                                  int device, void* stream) {
  cudaError_t err = repro::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (BN == 0 || Q == 0 || H == 0) return 0;
  if (N > 256 || P > 64) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = launch<float>(C, Bm, X, dA, Y, ST, BN, Q, H, N, P, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(C, Bm, X, dA, Y, ST, BN, Q, H, N, P, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
