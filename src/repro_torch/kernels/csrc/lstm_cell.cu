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
// Bound: each launch must read every replica's weights once, R * (D+H)
// * 4H floats: 4.5 MB for layer 0 and 3.0 MB for layer 1 at the
// forecast's shapes (23 replicas, B=1, D=128 then 64, H=64), 1.14 us
// averaged over the two at the H100's 3.35 TB/s. The arithmetic (~2 MFLOP)
// is far below that, and the weights sit in the 50 MB L2 across the
// forecast's 4,440 steps, so the floor in practice is one L2 pass plus
// the launch.
//
// Design: the step is spread over the card. One block per (replica, tile
// of bt examples, tile of ju hidden units): at the forecast's shape with
// ju = 8, 23 x 8 = 184 blocks on 132 SMs. A block computes its 4*ju gate
// columns (i|f|g|o of its ju units) over the K = D+H rows of [x | h]:
//  - its (K, 4, ju) weight tile is staged in shared memory by cp.async,
//    16 bytes a copy where H is a multiple of 4 (else 4), every copy
//    issued before the first wait: at K=192, ju=8 that is 24 KB in one
//    stage, all in flight at once, where one thread a unit used to walk
//    the 192 rows one dependent load at a time. A K whose tile passes
//    64 KB walks through a 2-stage ring of row slices;
//  - the block's x and h rows sit in shared memory (broadcast reads);
//  - the 256 threads split K into 256/(4*ju) slices; each owns one (gate,
//    unit) column of one slice and sums bt examples at once (a warp reads
//    one conflict-free weight row). The slices' partial sums meet in
//    shared memory and are added in a fixed order, with no atomics, so a
//    run is reproducible bit for bit; then bt*ju threads apply the cell:
//    forget bias +1, expf and tanhf (not the intrinsics: the kernel is
//    held to fp32 tolerances), both outputs written.
// Not the tensor cores: at B=1 each replica has its own weights, so the
// step is 23 independent matrix-vector products. An mma tile would be
// 1/16 used, and fp32 would need three TF32 products (3xTF32) per step.
//
// The launch's layout (ju, bt, stage rows, grid, shared memory) is made
// once, by kernels/lstm_cell/ops.py::plan_lstm, and passed in; the launch
// function refuses a plan it has no instantiation for, or 16-byte copies
// off alignment.
#include <cstdint>
#include <cstring>

#include "common.cuh"
#include "tile.cuh"

namespace {

constexpr int kThreads = 256;

// A launch as ops.py::plan_lstm lays it out.
struct Plan {
  int ju, bt, rows, stages, vec16;
  long long blocks;
  int smem;
  int btiles, jtiles;
};

__device__ __forceinline__ float sigm(float v) { return 1.f / (1.f + expf(-v)); }

template <int JU, int BT>
__global__ void __launch_bounds__(kThreads)
lstm_cell_kernel(const float* __restrict__ x, const float* __restrict__ h,
                 const float* __restrict__ c, const float* __restrict__ wx,
                 const float* __restrict__ wh, const float* __restrict__ bias,
                 float* __restrict__ h_out, float* __restrict__ c_out, int B,
                 int D, int H, int rows, int stages, int vec16, int btiles,
                 int jtiles) {
  constexpr int NC = 4 * JU;            // gate columns of the block
  constexpr int SL = kThreads / NC;     // slices of K
  const int K = D + H;
  extern __shared__ __align__(16) float smem[];
  float* tile = smem;                             // [stages][rows][NC]
  float* xh = tile + stages * rows * NC;          // [BT][K]
  float* part = xh + BT * K;                      // [SL][BT][NC]
  float* gates = part + SL * BT * NC;             // [BT][NC]

  const int jt = blockIdx.x % jtiles;
  const int rest = blockIdx.x / jtiles;
  const int b0 = (rest % btiles) * BT;
  const long long r = rest / btiles;
  const int j0 = jt * JU;
  const int tid = threadIdx.x;
  const float* wxr = wx + r * D * 4 * H;
  const float* whr = wh + r * H * 4 * H;
  // the first float of (row k, gate g) of the block's unit tile
  auto src = [&](int k, int g) {
    return (k < D ? wxr + (static_cast<long long>(k) * 4 + g) * H
                  : whr + (static_cast<long long>(k - D) * 4 + g) * H) + j0;
  };
  // stage s of the weight tile (rows s*rows ..) into buffer s % stages
  auto issue = [&](int s) {
    const int k0 = s * rows;
    const int n = min(rows, K - k0);
    float* dst = tile + (s % stages) * rows * NC;
    if (vec16) {
      constexpr int CH = NC / 4;        // 16-byte chunks a row
      for (int q = tid; q < n * CH; q += kThreads) {
        const int kr = q / CH, cc = q % CH;
        const int g = cc * 4 / JU, u = cc * 4 % JU;
        const bool ok = j0 + u < H;     // H % 4 == 0: a chunk is all in or out
        repro::cp_async16(dst + kr * NC + cc * 4, ok ? src(k0 + kr, g) + u : wxr,
                          ok ? 16 : 0);
      }
    } else {
      for (int q = tid; q < n * NC; q += kThreads) {
        const int kr = q / NC, col = q % NC;
        const int g = col / JU, u = col % JU;
        if (j0 + u < H)
          repro::cp_async4(dst + q, src(k0 + kr, g) + u);
        else
          dst[q] = 0.f;
      }
    }
    repro::cp_async_commit();
  };

  const int nst = (K + rows - 1) / rows;
  issue(0);
  for (int q = tid; q < BT * K; q += kThreads) {
    const int e = q / K, k = q % K;
    const long long row = r * B + b0 + e;
    float v = 0.f;
    if (b0 + e < B) v = k < D ? x[row * D + k] : h[row * H + (k - D)];
    xh[q] = v;
  }

  const int col = tid % NC, sl = tid / NC;
  float acc[BT];
#pragma unroll
  for (int e = 0; e < BT; ++e) acc[e] = 0.f;
  for (int s = 0; s < nst; ++s) {
    if (s + 1 < nst) {
      issue(s + 1);
      repro::cp_async_wait<1>();
    } else {
      repro::cp_async_wait<0>();
    }
    __syncthreads();
    const float* tl = tile + (s % stages) * rows * NC;
    const int k0 = s * rows;
    const int n = min(rows, K - k0);
    for (int kr = sl; kr < n; kr += SL) {
      const float wv = tl[kr * NC + col];
#pragma unroll
      for (int e = 0; e < BT; ++e) acc[e] = fmaf(xh[e * K + k0 + kr], wv, acc[e]);
    }
    __syncthreads();   // the buffer is free for the stage after next
  }

#pragma unroll
  for (int e = 0; e < BT; ++e) part[(sl * BT + e) * NC + col] = acc[e];
  __syncthreads();
  if (tid < BT * NC) {
    const int e = tid / NC, cl = tid % NC;
    float sum = 0.f;
    for (int q = 0; q < SL; ++q) sum += part[(q * BT + e) * NC + cl];
    gates[tid] = sum;
  }
  __syncthreads();
  if (tid < BT * JU) {
    const int e = tid / JU, u = tid % JU;
    const int j = j0 + u;
    if (b0 + e < B && j < H) {
      const float* br = bias + r * 4 * H;
      const float* gs = gates + e * NC + u;
      const float gi = gs[0] + br[j];
      const float gf = gs[JU] + br[H + j];
      const float gg = gs[2 * JU] + br[2 * H + j];
      const float go = gs[3 * JU] + br[3 * H + j];
      const long long o = (r * B + b0 + e) * H + j;
      const float cn = sigm(gf + 1.f) * c[o] + sigm(gi) * tanhf(gg);
      c_out[o] = cn;
      h_out[o] = sigm(go) * tanhf(cn);
    }
  }
}

template <int JU, int BT>
cudaError_t launch_t(const Plan& p, const float* const* t, float* h_out,
                     float* c_out, int B, int D, int H, cudaStream_t stream) {
  lstm_cell_kernel<JU, BT><<<static_cast<unsigned>(p.blocks), kThreads, p.smem,
                             stream>>>(
      t[0], t[1], t[2], t[3], t[4], t[5], h_out, c_out, B, D, H, p.rows,
      p.stages, p.vec16, p.btiles, p.jtiles);
  return cudaGetLastError();
}

template <int JU>
cudaError_t launch_ju(const Plan& p, const float* const* t, float* h_out,
                      float* c_out, int B, int D, int H, cudaStream_t s) {
  switch (p.bt) {
    case 1: return launch_t<JU, 1>(p, t, h_out, c_out, B, D, H, s);
    case 2: return launch_t<JU, 2>(p, t, h_out, c_out, B, D, H, s);
    case 4: return launch_t<JU, 4>(p, t, h_out, c_out, B, D, H, s);
    default: return launch_t<JU, 8>(p, t, h_out, c_out, B, D, H, s);
  }
}

// Every instantiation may take as much shared memory as a block can
// have; set once per device.
template <int JU>
cudaError_t allow(int bytes) {
  using Kernel = decltype(&lstm_cell_kernel<JU, 1>);
  const Kernel kernels[] = {lstm_cell_kernel<JU, 1>, lstm_cell_kernel<JU, 2>,
                            lstm_cell_kernel<JU, 4>, lstm_cell_kernel<JU, 8>};
  for (const Kernel fn : kernels) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

cudaError_t prepare(int device) {
  static bool ready[64] = {false};
  if (device >= 0 && device < 64 && ready[device]) return cudaSuccess;
  int bytes = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess) err = allow<8>(bytes);
  if (err == cudaSuccess) err = allow<4>(bytes);
  if (err == cudaSuccess && device >= 0 && device < 64) ready[device] = true;
  return err;
}

}  // namespace

// The launch's arguments, 21 int64 packed by kernels/lstm_cell/ops.py:
//   a[0..7]   x (R,B,D), h, c (R,B,H), wx (R,D,4,H), wh (R,H,4,H),
//             b (R,4,H), h_out, c_out (R,B,H)
//   a[8..11]  R, B, D, H
//   a[12]     device, a[13] stream
//   a[14..20] the plan (ops.py::plan_lstm): ju, bt, rows, stages, vec16,
//             blocks, smem
// All float32, contiguous, on `device`. Returns the cudaError_t of the
// launch. The first launch on a device raises the kernels' shared-memory
// limit (cudaFuncSetAttribute), once.
REPRO_EXPORT int lstm_cell_launch(const char* packed) {
  int64_t a[21];
  std::memcpy(a, packed, sizeof a);
  const int device = static_cast<int>(a[12]);
  cudaError_t err = repro::use_device(device);
  if (err == cudaSuccess) err = prepare(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int R = static_cast<int>(a[8]), B = static_cast<int>(a[9]);
  const int D = static_cast<int>(a[10]), H = static_cast<int>(a[11]);
  if (R == 0 || B == 0 || H == 0) return 0;
  Plan p;
  p.ju = static_cast<int>(a[14]);
  p.bt = static_cast<int>(a[15]);
  p.rows = static_cast<int>(a[16]);
  p.stages = static_cast<int>(a[17]);
  p.vec16 = static_cast<int>(a[18]);
  p.blocks = a[19];
  p.smem = static_cast<int>(a[20]);
  const bool bt_ok = p.bt == 1 || p.bt == 2 || p.bt == 4 || p.bt == 8;
  if ((p.ju != 4 && p.ju != 8) || !bt_ok || p.rows <= 0 ||
      (p.stages != 1 && p.stages != 2) ||
      (p.vec16 && (H % 4 != 0 || a[3] % 16 != 0 || a[4] % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  p.btiles = (B + p.bt - 1) / p.bt;
  p.jtiles = (H + p.ju - 1) / p.ju;
  const float* t[6];
  for (int i = 0; i < 6; ++i) t[i] = reinterpret_cast<const float*>(a[i]);
  auto* h_out = reinterpret_cast<float*>(a[6]);
  auto* c_out = reinterpret_cast<float*>(a[7]);
  const auto s = reinterpret_cast<cudaStream_t>(a[13]);
  err = p.ju == 8 ? launch_ju<8>(p, t, h_out, c_out, B, D, H, s)
                  : launch_ju<4>(p, t, h_out, c_out, B, D, H, s);
  return static_cast<int>(err);
}
