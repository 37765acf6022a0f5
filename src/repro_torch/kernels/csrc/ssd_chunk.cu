// Mamba-2 SSD intra-chunk dual form for Hopper (sm_90a): steps 1-2 of
// ssd_chunked, per (batch, chunk, head), in one launch.
//
// Replaces the Pallas kernel repro/kernels/ssd_chunk/kernel.py::_ssd_kernel
// (ssd_chunk_pallas). With C, B (Q,N), xdt (Q,P) and the within-chunk
// cumulative log-decay dA (Q,) of one (batch, chunk, head):
//   y[i,p]     = sum_{j<=i} (C_i . B_j) * exp(dA[i] - dA[j]) * xdt[j,p]
//   state[p,n] = sum_q xdt[q,p] * (B[q,n] * exp(dA[Q-1] - dA[q]))
// y in xdt's dtype, the state in float32. The upper triangle (i < j) is
// selected to 0 and its exp never multiplied: the segment sum there is
// positive and its exp can overflow to inf, and inf * 0 is NaN. Any
// Q >= 1, N <= 256 and P <= 64 run; rows past Q are zero-filled or
// bounds-checked.
//
// Bound: at a 512-token Mamba-2 prefill (2 chunks of Q=256, H=24, N=128,
// P=64, bf16) the function moves ~11 MB (inputs once, y and the float32
// state once): ~3.3 us at 3.35 TB/s. Its ~0.8 GFLOP over the causal pairs
// take under 1 us on the bf16 tensor cores, ~12 us on the float32 CUDA
// cores.
//
// One launch: a grid of y blocks, one per (query tile, head, batch*chunk),
// the heaviest query tiles (the most key tiles) first, and state blocks,
// one per (64 x 64 slice of P x N, head, batch*chunk). The state gets
// blocks of its own rather than riding on a y block: the last query tile
// already walks every key tile and sets the launch's length. At mamba2's
// prefill layer most blocks of the launch are resident at once (3 an SM),
// and each is bound by the latency of its own chain of dependent steps,
// not by the card's tensor-core, FMA or memory rates; so the design
// shortens the longest chains (PERF.md, scripts/ssd_chunk_timeline.py). The plan (query tiles, state slices, block
// order, 16-byte copies or element loads, the k-steps of C.B^T) is made
// once, by kernels/ssd_chunk/ops.py::plan_ssd, and passed in; the launch
// function refuses a plan it cannot run. The dtype picks the instantiation:
//
// bf16: ssd_chunk_mma_kernel<KS>, 4 warps, 3 blocks an SM, the state
// blocks first (they are among its longest blocks).
//  * y: a block takes 32 query rows. Warps 2r and 2r+1 own rows
//    16r..16r+15, the first taking the first half of every 64-key tile,
//    the second the second half; their partial sums meet in shared memory
//    at the end, first half then second. C's tile (32 x N, N padded with
//    zeros to 16*KS) is brought once by 16-byte cp.async, B's and xdt's key
//    tiles through a 2-stage cp.async ring, so key tile j+1 lands while
//    tile j is multiplied. Per key tile a warp forms its 16 x 32 scores
//    C.B^T on mma.sync.m16n8k16 (bf16 in, float32 accumulators: every
//    product is exact), each k-step's fragments loaded by ldmatrix before
//    its products (C's are read from shared memory: held in registers,
//    they spilled under the register budget of 3 blocks an SM); applies
//    the decay exp(dA[i] - dA[j]) and the causal selection to the score
//    registers, by selects; and adds scores x xdt into its 16 x 64 float32
//    partial output, xdt read by ldmatrix.trans as the k-major B operand.
//    The decayed scores are float32 and reach |s| ~ 33 at the model's
//    inputs, so one bf16 rounding (2^-9 of |s|) would cost y most of a
//    bf16 ulp; each score goes in as two bf16 terms, hi = bf16(s) and lo =
//    bf16(s - hi), two products a k-step, each exact, leaving ~2^-17 of
//    |s|. The decay uses the fast exp (ex2.approx, ~2^-21 of its value),
//    far below the bf16 output's 2^-8. On the diagonal key tile a warp
//    stops at its own last row. Rows are padded by 16 bytes, so ldmatrix
//    reads are free of bank conflicts (tile.cuh).
//  * the state: xdt^T (B * decay-to-end) on mma.sync, B * decay-to-end
//    rounded once in float32 as the plain version rounds it and split into
//    three bf16 terms whose sum is that float32 exactly; see
//    mma_state_block.
//  N and P that are not multiples of 8, or inputs off 16-byte alignment,
//  take element loads instead of cp.async (the plan's `vec`).
//
// float32: ssd_chunk_kernel, 256 threads, the y blocks first. Its y blocks
// are the CUDA-core kernel this file had before (C's tile in shared
// memory, each thread a 4 x 4 patch of the 64 x 64 scores over N, then
// the masked, decayed scores times xdt into 4 x P/16 accumulators), and
// its state blocks keep that kernel's arithmetic: B * decay-to-end rounded
// once in float32, then float32 FMAs over q in order. Both match the plain
// version to the bit at the model's shapes, which the float32 greedy
// streams of mamba2 rest on. A state block stages 64-row tiles of its
// xdt and B slices by 16-byte cp.async into a 2-stage ring, computes the
// decay once per row, converts B to float32 times its row's decay in
// shared memory, and each thread adds 16 outputs (4 p x 4 n) per row from
// two 16-byte shared loads, four rows' loads ahead of their FMAs.
#include <cstdint>
#include <cstring>

#include "common.cuh"
#include "tile.cuh"

namespace {

using bf16 = __nv_bfloat16;
using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::ldmatrix_x4;
using repro::ldmatrix_x4_trans;
using repro::mma_bf16_16816;
using repro::pack_bf16;

constexpr int kTile = 64;         // key and state rows a tile; float32 query rows
constexpr int kQTile = 32;        // bf16: query rows a y block
constexpr int kF32Threads = 256;  // float32 kernel: 16 x 16 threads
constexpr int kMmaThreads = 128;  // bf16 kernel: 4 warps
constexpr int kSliceN = 64;       // state: columns of N (and of P) a block
constexpr int kPp = 64;           // bf16 y: P padded to the output tile
constexpr int kLX = kPp + 8;      // pitch of the xdt tile (elements): +16 B
constexpr int kLY = kPp + 8;      // pitch of the partial y rows (floats)

// pitch of the bf16 C and B tiles (elements): 16*KS columns + 16 bytes
template <int KS>
__host__ __device__ constexpr int mma_ldc() { return 16 * KS + 8; }

struct Shape {
  int Q, H, N, P;
  long BN;
};

// The plan of kernels/ssd_chunk/ops.py::plan_ssd.
struct Plan {
  int vec;          // 16-byte cp.async copies (else element loads)
  int ksteps;       // bf16: k-steps of 16 in C.B^T; float32: 0
  int qtiles;       // query tiles a (batch*chunk, head)
  int slices;       // state slices a (batch*chunk, head)
  long y_blocks;    // qtiles * H * BN
  long blocks;      // y_blocks + slices * H * BN
  int state_first;  // the state blocks take the first block indices
};

// The work of this block: y for query tile `idx`, or the state for slice
// `idx`, of head h of batch*chunk bc.
struct Work {
  bool y;
  int idx, h;
  long bc;
};

__device__ __forceinline__ Work block_work(const Plan& p, const Shape& s) {
  // b: the block's place in the order y blocks, then state blocks
  const long ns = p.blocks - p.y_blocks;
  const long b = !p.state_first ? blockIdx.x
                 : blockIdx.x < ns ? blockIdx.x + p.y_blocks : blockIdx.x - ns;
  Work w;
  long rest;
  w.y = b < p.y_blocks;
  if (w.y) {   // heaviest query tile first
    const long per = s.BN * s.H;
    w.idx = p.qtiles - 1 - static_cast<int>(b / per);
    rest = b % per;
  } else {
    const long sb = b - p.y_blocks;
    w.idx = static_cast<int>(sb % p.slices);
    rest = sb / p.slices;
  }
  w.h = static_cast<int>(rest % s.H);
  w.bc = rest / s.H;
  return w;
}

// ---------------------------------------------------------------------------
// float32 state on the CUDA cores
// ---------------------------------------------------------------------------
__host__ __device__ constexpr size_t f32_state_smem() {
  return sizeof(float) * (2 * kTile * 2 * kSliceN +        // X, B ring
                          kTile * 2 * kSliceN + 2 * kTile);  // X, B * decay; decay
}

// ST[bc,h,p,n] for p in slice (idx / ceil(N/64)) of 64 columns and n in
// slice (idx % ceil(N/64)) of 64: sum over q in order of
// xdt[q,p] * (B[q,n] * exp(dA[Q-1] - dA[q])), float32 FMAs.
__device__ __forceinline__ void f32_state_block(
    const float* __restrict__ Bm, const float* __restrict__ X,
    const float* __restrict__ dA, float* __restrict__ ST, const Shape& s,
    const Work& w, bool vec, unsigned char* smem) {
  constexpr int SP = kSliceN;                  // columns of P a block
  constexpr int PG = SP / 4;                   // groups of 4 p; 16 groups of 4 n
  const int Q = s.Q, H = s.H, N = s.N, P = s.P;
  float* raw = reinterpret_cast<float*>(smem); // [stage][X: 64 x SP, B: 64 x 64]
  float* Xs = raw + 2 * kTile * (SP + kSliceN);
  float* Bw = Xs + kTile * SP;                 // [64][64] B * decay-to-end
  float* dec = Bw + kTile * kSliceN;           // [stage][64]
  const int n_slices = (N + kSliceN - 1) / kSliceN;
  const int p0 = (w.idx / n_slices) * SP, n0 = (w.idx % n_slices) * kSliceN;
  const int tid = threadIdx.x, pg = tid % PG, ng = tid / PG;
  const size_t rsN = static_cast<size_t>(H) * N, rsP = static_cast<size_t>(H) * P;
  const float* Bb = Bm + (w.bc * Q * H + w.h) * static_cast<long>(N);   // row q at + q*rsN
  const float* Xb = X + (w.bc * Q * H + w.h) * static_cast<long>(P);
  const float* dAb = dA + (w.bc * H + w.h) * static_cast<long>(Q);
  const float last = dAb[Q - 1];
  const int tiles = (Q + kTile - 1) / kTile;

  // rows q0.. of the xdt and B slices into ring stage st; zeros past Q, P, N
  auto load = [&](int q0, int st) {
    float* rx = raw + st * kTile * (SP + kSliceN);
    float* rb = rx + kTile * SP;
    if (vec) {
      constexpr int CX = SP / 4, CB = kSliceN / 4;
#pragma unroll
      for (int i = tid; i < kTile * CX; i += kF32Threads) {
        const int r = i / CX, c = (i % CX) * 4, q = q0 + r, col = p0 + c;
        const bool ok = q < Q && col < P;
        cp_async16(rx + r * SP + c, ok ? Xb + q * rsP + col : Xb, ok ? 16 : 0);
      }
#pragma unroll
      for (int i = tid; i < kTile * CB; i += kF32Threads) {
        const int r = i / CB, c = (i % CB) * 4, q = q0 + r, col = n0 + c;
        const bool ok = q < Q && col < N;
        cp_async16(rb + r * kSliceN + c, ok ? Bb + q * rsN + col : Bb, ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < kTile * SP; i += kF32Threads) {
        const int r = i / SP, c = i % SP, q = q0 + r, col = p0 + c;
        rx[i] = q < Q && col < P ? Xb[q * rsP + col] : 0.f;
      }
      for (int i = tid; i < kTile * kSliceN; i += kF32Threads) {
        const int r = i / kSliceN, c = i % kSliceN, q = q0 + r, col = n0 + c;
        rb[i] = q < Q && col < N ? Bb[q * rsN + col] : 0.f;
      }
    }
  };
  auto decay = [&](int q0, int st) {   // once per row; 0 past Q
    if (tid < kTile) {
      const int q = q0 + tid;
      dec[st * kTile + tid] = q < Q ? expf(last - dAb[q]) : 0.f;
    }
  };

  float acc[4][4];                     // p = p0+4pg+r, n = n0+4ng+c
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  auto fma_row = [&](const float4 xv, const float4 bv) {
    const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
    const float bs[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(xs[r], bs[c], acc[r][c]);
  };

  load(0, 0);
  cp_async_commit();
  decay(0, 0);
  for (int t = 0; t < tiles; ++t) {
    const int st = t & 1, q0 = t * kTile;
    cp_async_wait<0>();
    __syncthreads();          // tile t and its decay landed; tile t-1 consumed
    if (t + 1 < tiles) {
      load(q0 + kTile, st ^ 1);
      decay(q0 + kTile, st ^ 1);
    }
    cp_async_commit();
    const float* rx = raw + st * kTile * (SP + kSliceN);
    const float* rb = rx + kTile * SP;
    const float* dt = dec + st * kTile;
    // B * decay-to-end, rounded once, 16 bytes at a time
    for (int i = tid; i < kTile * SP / 4; i += kF32Threads)
      reinterpret_cast<float4*>(Xs)[i] = reinterpret_cast<const float4*>(rx)[i];
    for (int i = tid; i < kTile * kSliceN / 4; i += kF32Threads) {
      const float4 v = reinterpret_cast<const float4*>(rb)[i];
      const float f = dt[i * 4 / kSliceN];
      reinterpret_cast<float4*>(Bw)[i] = make_float4(v.x * f, v.y * f, v.z * f, v.w * f);
    }
    __syncthreads();
    // q in order for every output, four rows' loads ahead of their FMAs
    const int rows = min(kTile, Q - q0);
    int q = 0;
    for (; q + 4 <= rows; q += 4) {
      float4 xv[4], bv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        xv[u] = *reinterpret_cast<const float4*>(Xs + (q + u) * SP + 4 * pg);
        bv[u] = *reinterpret_cast<const float4*>(Bw + (q + u) * kSliceN + 4 * ng);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) fma_row(xv[u], bv[u]);
    }
    for (; q < rows; ++q)
      fma_row(*reinterpret_cast<const float4*>(Xs + q * SP + 4 * pg),
              *reinterpret_cast<const float4*>(Bw + q * kSliceN + 4 * ng));
  }
  cp_async_wait<0>();

  float* out = ST + (w.bc * H + w.h) * static_cast<long>(P) * N;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int p = p0 + 4 * pg + r, n = n0 + 4 * ng;
    if (p >= P) continue;
    float* row = out + static_cast<long>(p) * N;
    if (vec && n + 3 < N) {
      *reinterpret_cast<float4*>(row + n) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (n + c < N) row[n + c] = acc[r][c];
    }
  }
}

// ---------------------------------------------------------------------------
// float32 y: the CUDA-core kernel (each thread a 4x4 patch)
// ---------------------------------------------------------------------------
__host__ __device__ constexpr size_t f32_y_smem(int N, int P) {
  return sizeof(float) * (2 * static_cast<size_t>(kTile) * (N + 1) +
                          kTile * (P + 1) + kTile * (kTile + 1) + 2 * kTile);
}

__device__ __forceinline__ void f32_y_block(
    const float* __restrict__ C, const float* __restrict__ Bm,
    const float* __restrict__ X, const float* __restrict__ dA,
    float* __restrict__ Y, const Shape& sh, const Work& w, float* smem) {
  const int Q = sh.Q, H = sh.H, N = sh.N, P = sh.P;
  const int LN = N + 1, LP = P + 1, LS = kTile + 1;
  float* Cs = smem;                       // [64][N+1]
  float* Bs = Cs + kTile * LN;            // [64][N+1]
  float* Xs = Bs + kTile * LN;            // [64][P+1]
  float* Ss = Xs + kTile * LP;            // [64][65] masked, decayed scores
  float* dAi = Ss + kTile * LS;           // [64]
  float* dAj = dAi + kTile;               // [64]
  const int i0 = w.idx * kTile, h = w.h;
  const long bc = w.bc;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  #pragma unroll 8
  for (int idx = tid; idx < kTile * N; idx += kF32Threads) {
    const int r = idx / N, n = idx % N, i = i0 + r;
    Cs[r * LN + n] = i < Q ? C[((bc * Q + i) * H + h) * N + n] : 0.f;
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
    for (int idx = tid; idx < kTile * N; idx += kF32Threads) {
      const int r = idx / N, n = idx % N, j = j0 + r;
      Bs[r * LN + n] = j < Q ? Bm[((bc * Q + j) * H + h) * N + n] : 0.f;
    }
    #pragma unroll 8
    for (int idx = tid; idx < kTile * P; idx += kF32Threads) {
      const int r = idx / P, p = idx % P, j = j0 + r;
      Xs[r * LP + p] = j < Q ? X[((bc * Q + j) * H + h) * P + p] : 0.f;
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
      if (p < P) Y[((bc * Q + i) * H + h) * P + p] = acc[r][c];
    }
  }
}

__global__ void __launch_bounds__(kF32Threads)
ssd_chunk_kernel(const float* __restrict__ C, const float* __restrict__ Bm,
                 const float* __restrict__ X, const float* __restrict__ dA,
                 float* __restrict__ Y, float* __restrict__ ST, Shape s,
                 Plan p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Work w = block_work(p, s);
  if (w.y)
    f32_y_block(C, Bm, X, dA, Y, s, w, reinterpret_cast<float*>(smem_raw));
  else
    f32_state_block(Bm, X, dA, ST, s, w, p.vec != 0, smem_raw);
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: the state and y
// ---------------------------------------------------------------------------
constexpr int kLS = kSliceN + 8;  // pitch of the state's bf16 tiles: +16 B

__host__ __device__ constexpr size_t mma_state_smem() {
  return sizeof(bf16) * kTile * kLS * (2 * 2 + 3) +   // raw X, B ring; 3 terms
         sizeof(float) * 2 * kTile;                    // decay ring
}

template <int KS>
__host__ __device__ constexpr size_t mma_y_smem() {
  return sizeof(bf16) * (static_cast<size_t>(kQTile) * mma_ldc<KS>() +
                         2 * kTile * (mma_ldc<KS>() + kLX)) +
         sizeof(float) * (kQTile + 2 * kTile);
}

template <int KS>
__host__ __device__ constexpr size_t mma_smem() {
  return mma_y_smem<KS>() > mma_state_smem() ? mma_y_smem<KS>()
                                             : mma_state_smem();
}

// rows r0..r0+ROWS-1 of a (Q, rs)-strided bf16 matrix, `cols` real
// columns, into a [ROWS][ld] shared tile WIDTH columns wide; zeros past Q
// and cols
template <int WIDTH, int ROWS = kTile>
__device__ __forceinline__ void load_rows(bf16* dst, int ld, const bf16* src,
                                          size_t rs, int r0, int Q, int cols,
                                          bool vec, int tid) {
  if (vec) {
    constexpr int CH = WIDTH / 8;
#pragma unroll 4
    for (int i = tid; i < ROWS * CH; i += kMmaThreads) {
      const int r = i / CH, c = (i % CH) * 8, q = r0 + r;
      const bool ok = q < Q && c < cols;
      cp_async16(dst + r * ld + c, ok ? src + q * rs + c : src, ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < ROWS * WIDTH; i += kMmaThreads) {
      const int r = i / WIDTH, c = i % WIDTH, q = r0 + r;
      dst[r * ld + c] = q < Q && c < cols ? src[q * rs + c] : __float2bfloat16(0.f);
    }
  }
}

// s ~ hi + lo as two bf16 pairs: hi = bf16(s), lo = bf16(s - hi)
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - hf.x, y - hf.y);
}

// ---------------------------------------------------------------------------
// bf16 state on the tensor cores
// ---------------------------------------------------------------------------
// the bf16 pair's bits in one register
__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (a, b) = x + y + z exactly, three pairs of bf16 terms (bf16 keeps 8 of
// float32's 24 significant bits; each remainder is exact in float32)
__device__ __forceinline__ void split3(float a, float b, uint32_t& x,
                                       uint32_t& y, uint32_t& z) {
  const __nv_bfloat162 hx = __floats2bfloat162_rn(a, b);
  const float2 fx = __bfloat1622float2(hx);
  const float ra = a - fx.x, rb = b - fx.y;
  const __nv_bfloat162 hy = __floats2bfloat162_rn(ra, rb);
  const float2 fy = __bfloat1622float2(hy);
  x = bits(hx);
  y = bits(hy);
  z = bits(__floats2bfloat162_rn(ra - fy.x, rb - fy.y));
}

// ST[bc,h,p,n] for p in slice (idx / ceil(N/64)) of 64 columns and n in
// slice (idx % ceil(N/64)) of 64: xdt^T (B * decay-to-end) on
// mma.sync.m16n8k16. B * decay-to-end is rounded once in float32, as the
// plain version rounds it, then split into three bf16 terms whose sum is
// that float32 exactly; xdt is bf16, so every product is exact. Each
// 16-row k-step's three products (smallest term first) go into a fresh
// accumulator, added to the running sum in float32 by one rounded add.
// Warp w owns columns 16w..16w+15 of the P slice and all 64 of the N
// slice. xdt's tile is the A operand as it lands (ldmatrix.trans of the
// q-major tile), the terms' tiles the B operand (ldmatrix.trans).
__device__ __forceinline__ void mma_state_block(
    const bf16* __restrict__ Bm, const bf16* __restrict__ X,
    const float* __restrict__ dA, float* __restrict__ ST, const Shape& s,
    const Work& w, bool vec, unsigned char* smem) {
  const int Q = s.Q, H = s.H, N = s.N, P = s.P;
  bf16* raw = reinterpret_cast<bf16*>(smem);       // [stage][X, B: 64 x kLS]
  bf16* terms = raw + 2 * 2 * kTile * kLS;         // [3][64 x kLS]
  float* dec = reinterpret_cast<float*>(terms + 3 * kTile * kLS);  // [stage][64]
  const int n_slices = (N + kSliceN - 1) / kSliceN;
  const int p0 = (w.idx / n_slices) * kSliceN, n0 = (w.idx % n_slices) * kSliceN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c4 = lane & 3;
  const size_t rsN = static_cast<size_t>(H) * N, rsP = static_cast<size_t>(H) * P;
  const bf16* Bb = Bm + (w.bc * Q * H + w.h) * static_cast<long>(N);
  const bf16* Xb = X + (w.bc * Q * H + w.h) * static_cast<long>(P);
  const float* dAb = dA + (w.bc * H + w.h) * static_cast<long>(Q);
  const float last = dAb[Q - 1];
  const int tiles = (Q + kTile - 1) / kTile;

  // rows q0.. of the xdt and B slices into ring stage st; zeros past Q, P, N
  auto load = [&](int q0, int st) {
    bf16* rx = raw + st * 2 * kTile * kLS;
    bf16* rb = rx + kTile * kLS;
    load_rows<64>(rx, kLS, Xb + p0, rsP, q0, Q, P - p0, vec, tid);
    load_rows<64>(rb, kLS, Bb + n0, rsN, q0, Q, N - n0, vec, tid);
  };
  auto decay = [&](int q0, int st) {   // once per row; 0 past Q
    if (tid < kTile) {
      const int q = q0 + tid;
      dec[st * kTile + tid] = q < Q ? expf(last - dAb[q]) : 0.f;
    }
  };

  float tot[kSliceN / 8][4];           // p = p0+16w+g(+8), n = n0+8nb+2c4(+1)
#pragma unroll
  for (int nb = 0; nb < kSliceN / 8; ++nb)
    tot[nb][0] = tot[nb][1] = tot[nb][2] = tot[nb][3] = 0.f;
  const bool active = p0 + 16 * warp < P;

  load(0, 0);
  cp_async_commit();
  decay(0, 0);
  for (int t = 0; t < tiles; ++t) {
    const int st = t & 1;
    cp_async_wait<0>();
    __syncthreads();          // tile t and its decay landed; tile t-1 consumed
    if (t + 1 < tiles) {
      load((t + 1) * kTile, st ^ 1);
      decay((t + 1) * kTile, st ^ 1);
    }
    cp_async_commit();
    const bf16* rx = raw + st * 2 * kTile * kLS;
    const bf16* rb = rx + kTile * kLS;
    const float* dt = dec + st * kTile;
    // B * decay-to-end in float32, split into the three terms' tiles
    for (int i = tid; i < kTile * 8; i += kMmaThreads) {
      const int r = i >> 3, c = (i & 7) * 8;
      const uint4 u = *reinterpret_cast<const uint4*>(rb + r * kLS + c);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
      const float f = dt[r];
      uint32_t x[4], y[4], z[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 v = __bfloat1622float2(h[e]);
        split3(v.x * f, v.y * f, x[e], y[e], z[e]);
      }
      *reinterpret_cast<uint4*>(terms + r * kLS + c) = make_uint4(x[0], x[1], x[2], x[3]);
      *reinterpret_cast<uint4*>(terms + (kTile + r) * kLS + c) =
          make_uint4(y[0], y[1], y[2], y[3]);
      *reinterpret_cast<uint4*>(terms + (2 * kTile + r) * kLS + c) =
          make_uint4(z[0], z[1], z[2], z[3]);
    }
    __syncthreads();
    if (!active) continue;
#pragma unroll
    for (int kq = 0; kq < kTile / 16; ++kq) {
      if (t * kTile + 16 * kq >= Q) break;
      // xdt^T's A fragment: matrices (p +0..7, q +0..7), (p +8, q +0),
      // (p +0, q +8), (p +8, q +8) of the q-major tile, transposed
      uint32_t a[4];
      ldmatrix_x4_trans(a, rx + (16 * kq + (lane >> 4) * 8 + (lane & 7)) * kLS +
                               16 * warp + ((lane >> 3) & 1) * 8);
      float d[kSliceN / 8][4];
#pragma unroll
      for (int nb = 0; nb < kSliceN / 8; ++nb) d[nb][0] = d[nb][1] = d[nb][2] = d[nb][3] = 0.f;
#pragma unroll
      for (int term = 2; term >= 0; --term) {
        const bf16* tt = terms + term * kTile * kLS;
#pragma unroll
        for (int np = 0; np < kSliceN / 16; ++np) {
          // matrices: q 16kq+0..7 and +8..15 at n 16np+0..7, then at +8..15
          uint32_t b[4];
          ldmatrix_x4_trans(b, tt + (16 * kq + ((lane >> 3) & 1) * 8 + (lane & 7)) * kLS +
                                   16 * np + (lane >> 4) * 8);
          mma_bf16_16816(d[2 * np], a, b[0], b[1]);
          mma_bf16_16816(d[2 * np + 1], a, b[2], b[3]);
        }
      }
#pragma unroll
      for (int nb = 0; nb < kSliceN / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) tot[nb][e] += d[nb][e];
    }
  }
  cp_async_wait<0>();
  if (!active) return;

  float* out = ST + (w.bc * H + w.h) * static_cast<long>(P) * N;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int p = p0 + 16 * warp + g + 8 * rr;
    if (p >= P) continue;
    float* row = out + static_cast<long>(p) * N;
#pragma unroll
    for (int nb = 0; nb < kSliceN / 8; ++nb) {
      const int n = n0 + 8 * nb + 2 * c4;
      if (vec && n + 1 < N) {   // N % 8 == 0 and ST 16-byte aligned
        *reinterpret_cast<float2*>(row + n) =
            make_float2(tot[nb][2 * rr], tot[nb][2 * rr + 1]);
      } else {
        if (n < N) row[n] = tot[nb][2 * rr];
        if (n + 1 < N) row[n + 1] = tot[nb][2 * rr + 1];
      }
    }
  }
}

template <int KS>
__device__ __forceinline__ void mma_y_block(
    const bf16* __restrict__ C, const bf16* __restrict__ Bm,
    const bf16* __restrict__ X, const float* __restrict__ dA,
    bf16* __restrict__ Y, const Shape& s, const Work& w, bool vec,
    unsigned char* smem) {
  constexpr int NP = 16 * KS, LC = mma_ldc<KS>();
  constexpr int KH = kTile / 2;                    // keys a warp takes of a tile
  const int Q = s.Q, H = s.H, N = s.N, P = s.P;
  bf16* Cs = reinterpret_cast<bf16*>(smem);       // [32][LC]
  bf16* ring = Cs + kQTile * LC;                   // [stage][B: 64 x LC, X: 64 x kLX]
  float* dAq = reinterpret_cast<float*>(ring + 2 * kTile * (LC + kLX));
  float* dAk = dAq + kQTile;                       // [stage][64]
  const int i0 = w.idx * kQTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = warp & 1, kh = warp >> 1;         // row group, key half
  const int g = lane >> 2, c4 = lane & 3;          // fragment group, place in it
  const size_t rsN = static_cast<size_t>(H) * N, rsP = static_cast<size_t>(H) * P;
  const long base = w.bc * Q * H + w.h;
  const bf16* Cb = C + base * N;                   // row q at + q * rsN
  const bf16* Bb = Bm + base * N;
  const bf16* Xb = X + base * P;
  const float* dAb = dA + (w.bc * H + w.h) * static_cast<long>(Q);
  const int n_kt = (i0 + kQTile - 1) / kTile + 1; // key tiles to the last row

  // key tile t's B and xdt rows into ring stage st by cp.async, its dA rows
  // by plain loads
  auto load_kt = [&](int t, int st) {
    bf16* Bs = ring + st * kTile * (LC + kLX);
    load_rows<NP>(Bs, LC, Bb, rsN, t * kTile, Q, N, vec, tid);
    load_rows<kPp>(Bs + kTile * LC, kLX, Xb, rsP, t * kTile, Q, P, vec, tid);
    if (tid < kTile) {
      const int j = t * kTile + tid;
      dAk[st * kTile + tid] = j < Q ? dAb[j] : 0.f;
    }
  };
  load_rows<NP, kQTile>(Cs, LC, Cb, rsN, i0, Q, N, vec, tid);
  if (tid < kQTile) dAq[tid] = i0 + tid < Q ? dAb[i0 + tid] : 0.f;
  load_kt(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int iw0 = i0 + 16 * rg;                    // this warp's first row
  const float dq[2] = {dAq[16 * rg + g], dAq[16 * rg + g + 8]};
  float o[kPp / 8][4];                             // its partial y over its keys
#pragma unroll
  for (int d = 0; d < kPp / 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;

  for (int t = 0; t < n_kt; ++t) {
    if (t > 0) {
      cp_async_wait<0>();
      __syncthreads();        // tile t landed; every warp is done with t - 1
    }
    if (t + 1 < n_kt) load_kt(t + 1, (t + 1) & 1);
    cp_async_commit();
    if (iw0 >= Q) continue;   // no row of this warp exists
    const int jw0 = t * kTile + kh * KH;
    // keys this warp can attend to of its half: up to its last row, before Q
    const int kmax = min(KH, min(iw0 + 15, Q - 1) - jw0 + 1);
    if (kmax <= 0) continue;
    const bf16* Bs = ring + (t & 1) * kTile * (LC + kLX) + kh * KH * LC;
    const bf16* Xs = ring + (t & 1) * kTile * (LC + kLX) + kTile * LC + kh * KH * kLX;
    const float* dk = dAk + (t & 1) * kTile + kh * KH;

    // S = C B^T; per k-step, C's A fragment and B's fragments (16 keys a
    // matrix group) are loaded before their products
    float sc[KH / 8][4];
#pragma unroll
    for (int nb = 0; nb < KH / 8; ++nb)
      sc[nb][0] = sc[nb][1] = sc[nb][2] = sc[nb][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t cak[4], bk[KH / 16][4];
      ldmatrix_x4(cak, Cs + (16 * rg + (lane & 15)) * LC + kk * 16 + (lane >> 4) * 8);
      // matrices: keys 16jp+0..7 at k +0 and +8, keys 16jp+8..15 likewise
#pragma unroll
      for (int jp = 0; jp < KH / 16; ++jp)
        if (16 * jp < kmax)
          ldmatrix_x4(bk[jp], Bs + (16 * jp + (lane >> 4) * 8 + (lane & 7)) * LC +
                                  kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int jp = 0; jp < KH / 16; ++jp)
        if (16 * jp < kmax) {
          mma_bf16_16816(sc[2 * jp], cak, bk[jp][0], bk[jp][1]);
          mma_bf16_16816(sc[2 * jp + 1], cak, bk[jp][2], bk[jp][3]);
        }
    }

    // decay and causal selection on the score registers: rows g (e = 0, 1)
    // and g + 8 (e = 2, 3). The upper triangle and keys past Q are selected
    // to 0; their exp is taken of 0, never of the (positive) segment sum,
    // and never multiplied. Selects rather than branches, so the exps of a
    // row's keys overlap.
#pragma unroll
    for (int nb = 0; nb < KH / 8; ++nb) {
      if (8 * nb >= kmax) continue;
      const float2 dk2 = *reinterpret_cast<const float2*>(dk + nb * 8 + 2 * c4);
      const float dkv[2] = {dk2.x, dk2.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = iw0 + g + (e >> 1) * 8, j = jw0 + nb * 8 + 2 * c4 + (e & 1);
        const bool ok = i >= j && i < Q && j < Q;
        const float ex = __expf(ok ? dq[e >> 1] - dkv[e & 1] : 0.f);
        sc[nb][e] = ok ? sc[nb][e] * ex : 0.f;
      }
    }

    // O += S xdt: S as hi and lo bf16 A fragments, xdt through
    // ldmatrix.trans; the lo products of all 64 columns first, then the hi
    // ones, so no product waits on the one before it
#pragma unroll
    for (int kk = 0; kk < KH / 16; ++kk) {
      if (16 * kk >= kmax) continue;
      uint32_t ah[4], al[4];
      split_bf16(sc[2 * kk][0], sc[2 * kk][1], ah[0], al[0]);
      split_bf16(sc[2 * kk][2], sc[2 * kk][3], ah[1], al[1]);
      split_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1], ah[2], al[2]);
      split_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3], ah[3], al[3]);
      uint32_t bv[kPp / 16][4];
      // matrices: keys 16kk+0..7 and +8..15 at p 16dp+0..7, then at +8..15
#pragma unroll
      for (int dp = 0; dp < kPp / 16; ++dp)
        if (16 * dp < P)
          ldmatrix_x4_trans(bv[dp], Xs + (16 * kk + ((lane >> 3) & 1) * 8 + (lane & 7)) * kLX +
                                        16 * dp + (lane >> 4) * 8);
#pragma unroll
      for (int dp = 0; dp < kPp / 16; ++dp)
        if (16 * dp < P) {
          mma_bf16_16816(o[2 * dp], al, bv[dp][0], bv[dp][1]);
          mma_bf16_16816(o[2 * dp + 1], al, bv[dp][2], bv[dp][3]);
        }
#pragma unroll
      for (int dp = 0; dp < kPp / 16; ++dp)
        if (16 * dp < P) {
          mma_bf16_16816(o[2 * dp], ah, bv[dp][0], bv[dp][1]);
          mma_bf16_16816(o[2 * dp + 1], ah, bv[dp][2], bv[dp][3]);
        }
    }
  }
  cp_async_wait<0>();
  __syncthreads();            // the ring is free: the second key half's
                              // partial y goes through it
  float* part_y = reinterpret_cast<float*>(ring) + rg * 16 * kLY;  // [2][16][kLY]
  if (kh == 1) {
#pragma unroll
    for (int d = 0; d < kPp / 8; ++d)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        *reinterpret_cast<float2*>(part_y + (g + 8 * rr) * kLY + 8 * d + 2 * c4) =
            make_float2(o[d][2 * rr], o[d][2 * rr + 1]);
  }
  __syncthreads();
  if (kh == 1) return;

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int i = iw0 + g + 8 * rr;
    if (i >= Q) continue;
    bf16* row = Y + (w.bc * Q + i) * static_cast<long>(H) * P + static_cast<long>(w.h) * P;
#pragma unroll
    for (int d = 0; d < kPp / 8; ++d) {
      const int p = 8 * d + 2 * c4;
      if (p >= P) continue;
      // the two key halves in a fixed order: the first, then the second
      const float2 h2 = *reinterpret_cast<const float2*>(part_y + (g + 8 * rr) * kLY + p);
      const float y0 = o[d][2 * rr] + h2.x, y1 = o[d][2 * rr + 1] + h2.y;
      if (vec) {   // P % 8 == 0 and Y 16-byte aligned: p + 1 < P
        *reinterpret_cast<__nv_bfloat162*>(row + p) = __floats2bfloat162_rn(y0, y1);
      } else {
        row[p] = __float2bfloat16_rn(y0);
        if (p + 1 < P) row[p + 1] = __float2bfloat16_rn(y1);
      }
    }
  }
}

template <int KS>
__global__ void __launch_bounds__(kMmaThreads, KS >= 16 ? 2 : 3)
ssd_chunk_mma_kernel(const bf16* __restrict__ C, const bf16* __restrict__ Bm,
                     const bf16* __restrict__ X, const float* __restrict__ dA,
                     bf16* __restrict__ Y, float* __restrict__ ST, Shape s,
                     Plan p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Work w = block_work(p, s);
  if (w.y)
    mma_y_block<KS>(C, Bm, X, dA, Y, s, w, p.vec != 0, smem_raw);
  else
    mma_state_block(Bm, X, dA, ST, s, w, p.vec != 0, smem_raw);
}

constexpr size_t kF32MaxSmem =
    f32_y_smem(256, 64) > f32_state_smem() ? f32_y_smem(256, 64) : f32_state_smem();

// Raise each kernel's shared-memory limit once per device.
cudaError_t prepare(int device) {
  static bool ready[64] = {false};
  if (device >= 0 && device < 64 && ready[device]) return cudaSuccess;
  cudaError_t err = repro::allow_smem(ssd_chunk_kernel, kF32MaxSmem);
  if (err == cudaSuccess)
    err = repro::allow_smem(ssd_chunk_mma_kernel<4>, mma_smem<4>());
  if (err == cudaSuccess)
    err = repro::allow_smem(ssd_chunk_mma_kernel<8>, mma_smem<8>());
  if (err == cudaSuccess)
    err = repro::allow_smem(ssd_chunk_mma_kernel<16>, mma_smem<16>());
  if (err == cudaSuccess && device >= 0 && device < 64) ready[device] = true;
  return err;
}

template <int KS>
cudaError_t launch_mma(const int64_t* a, const Shape& s, const Plan& p,
                       cudaStream_t stream) {
  const auto* ptr = reinterpret_cast<void* const*>(a);
  const long nb = p.blocks;
  ssd_chunk_mma_kernel<KS><<<static_cast<unsigned>(nb), kMmaThreads,
                             mma_smem<KS>(), stream>>>(
      static_cast<const bf16*>(ptr[0]), static_cast<const bf16*>(ptr[1]),
      static_cast<const bf16*>(ptr[2]), static_cast<const float*>(ptr[3]),
      static_cast<bf16*>(ptr[4]), static_cast<float*>(ptr[5]), s, p);
  return cudaGetLastError();
}

}  // namespace

// The launch's arguments, 21 int64 packed by kernels/ssd_chunk/ops.py:
//   a[0..5]   C, B (BN,Q,H,N), xdt, y (BN,Q,H,P) of one dtype, dA (BN,H,Q)
//             and the state (BN,H,P,N) float32
//   a[6..10]  BN, Q, H, N, P
//   a[11]     dtype (0: float32, 1: bfloat16), a[12] device, a[13] stream
//   a[14..20] the plan (ops.py::plan_ssd): vec, ksteps, qtiles, slices,
//             y_blocks, blocks, state_first
// All contiguous on `device`; N <= 256, P <= 64. Returns the cudaError_t
// of the launch. The first launch on a device raises the kernels'
// shared-memory limits.
REPRO_EXPORT int ssd_chunk_launch(const char* packed) {
  int64_t a[21];
  std::memcpy(a, packed, sizeof a);
  const int device = static_cast<int>(a[12]);
  cudaError_t err = repro::use_device(device);
  if (err == cudaSuccess) err = prepare(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Shape s;
  s.BN = a[6];
  s.Q = static_cast<int>(a[7]);
  s.H = static_cast<int>(a[8]);
  s.N = static_cast<int>(a[9]);
  s.P = static_cast<int>(a[10]);
  if (s.BN == 0 || s.Q == 0 || s.H == 0) return 0;
  const int dtype = static_cast<int>(a[11]);
  Plan p;
  p.vec = static_cast<int>(a[14]);
  p.ksteps = static_cast<int>(a[15]);
  p.qtiles = static_cast<int>(a[16]);
  p.slices = static_cast<int>(a[17]);
  p.y_blocks = a[18];
  p.blocks = a[19];
  p.state_first = static_cast<int>(a[20]);

  const int v = dtype == 1 ? 8 : 4;
  const int qt = dtype == 1 ? kQTile : kTile;      // query rows a y block
  bool ok = (dtype == 0 || dtype == 1) && s.N >= 1 && s.N <= 256 &&
            s.P >= 1 && s.P <= 64 &&
            p.qtiles == (s.Q + qt - 1) / qt &&
            p.slices == ((s.P + kSliceN - 1) / kSliceN) * ((s.N + kSliceN - 1) / kSliceN) &&
            p.y_blocks == static_cast<long>(p.qtiles) * s.H * s.BN &&
            p.blocks == p.y_blocks + static_cast<long>(p.slices) * s.H * s.BN;
  if (dtype == 1)
    ok = ok && (p.ksteps == 4 || p.ksteps == 8 || p.ksteps == 16) &&
         16 * p.ksteps >= s.N;
  else
    ok = ok && p.ksteps == 0;
  if (p.vec) {
    ok = ok && s.N % v == 0 && s.P % v == 0;
    for (int i = 0; i < 6; ++i) ok = ok && a[i] % 16 == 0;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const auto stream = reinterpret_cast<cudaStream_t>(a[13]);
  if (dtype == 0) {
    const auto* ptr = reinterpret_cast<void* const*>(a);
    ssd_chunk_kernel<<<static_cast<unsigned>(p.blocks), kF32Threads,
                       f32_y_smem(s.N, s.P) > f32_state_smem()
                           ? f32_y_smem(s.N, s.P) : f32_state_smem(),
                       stream>>>(
        static_cast<const float*>(ptr[0]), static_cast<const float*>(ptr[1]),
        static_cast<const float*>(ptr[2]), static_cast<const float*>(ptr[3]),
        static_cast<float*>(ptr[4]), static_cast<float*>(ptr[5]), s, p);
    err = cudaGetLastError();
  } else if (p.ksteps == 4) {
    err = launch_mma<4>(a, s, p, stream);
  } else if (p.ksteps == 8) {
    err = launch_mma<8>(a, s, p, stream);
  } else {
    err = launch_mma<16>(a, s, p, stream);
  }
  return static_cast<int>(err);
}
