// Sliding-window (local) attention over a whole prompt for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/local_attn/kernel.py::_kernel
// (local_attention_pallas). For batch b, query head h (KV head h / G) and
// query i of q (B,S,Hq,D) against k, v (B,S,Hkv,D):
//   s_ij = dot(q_i, k_j) / sqrt(D)                  (float32, a division)
//   with a softcap c > 0: s_ij = c * tanh(s_ij / c)  (before the mask)
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
// take ~8.6 us. So bf16 is bound by the tensor cores' arithmetic, and
// its kernel does both products there; float32 inputs keep the kernel
// on the CUDA cores (67 TFLOP/s), which is exact to float32 tolerances.
//
// bf16: local_attn_mma_kernel, a FlashAttention-2-style kernel on
// mma.sync.m16n8k16 (fragment layouts in tile.cuh). One block of 4 warps
// per (64-query tile, query head, batch row); warp w owns query rows
// 16w..16w+15. The Q tile is copied once into shared memory with
// cp.async and read per 16-dim step into A fragments with ldmatrix. The
// band's key tiles (BK keys: 32 at D=256, 64 below) come through a
// 2-stage cp.async ring of K and V, so tile t+1 lands while tile t is
// computed; one __syncthreads a tile guards the ring, none sits between
// the two products. Rows are padded by 16 bytes, so ldmatrix reads are
// free of bank conflicts. S = Q.K^T goes to float32 registers, is divided
// by sqrt(D) and masked with the four conditions above (only on tiles
// that cross the warp's band edge or S: the others are wholly inside);
// the online softmax runs on those registers, a row's max over its group
// of 4 lanes by two __shfl_xor_sync, its denominator kept per lane and
// summed over the group at the end. P is packed from the S registers
// straight into bf16 A fragments, and V, read with ldmatrix.trans, is
// the B operand of P.V; the float32 O accumulator stays in registers (16
// rows x D per warp: 128 registers a thread at D=256). A warp skips a
// key tile that none of its rows can attend to (its state would not
// change). The query tile is the grid's slowest axis, taken from the
// last: the longest bands start first, and a tile's heads run together,
// sharing their K/V tiles in L2. At D=256 a block takes 99 KB of
// shared memory and ~240 registers a thread, so 2 blocks fit an SM.
// Precision: P is rounded to bf16 for the P.V product, where the Pallas
// kernel keeps it in float32: that moves an output by up to ~2^-9 of the
// row's largest |v|, below the bf16 output's own rounding; m, l, the
// scores and O stay float32.
//
// float32: local_attn_kernel, one block of 256 threads per (64-query
// tile, query head, batch row). The query tile stays in shared memory
// (float32) while the block walks the 32-key tiles of its band: each
// tile's K and V are staged (the load loop unrolled so that eight loads a
// thread are in flight), every thread forms a 4 x 2 patch of the 64 x 32
// scores over D, the scaled and masked scores go to shared memory, one
// thread per query row updates that row's running max and denominator
// and turns its scores into p, and then every thread adds p times V into
// its 4 rows x D/16 columns of the accumulator, held in registers. At
// D=256 the block uses ~143 KB of shared memory (set with
// cudaFuncAttributeMaxDynamicSharedMemorySize).
//
// Softcap (gemma2's attention softcap, which the reference's model code
// applies in local_attention and the Pallas kernel lacks): s = c *
// tanhf(s / c) on the float32 score, after the division and before the
// mask. It is a template parameter (CAP) of both kernels, so the
// instantiations without it compile to what they were before, to the
// bit; with it, the bf16 kernel takes the tanh in place on the score
// registers (no second score array). At gemma2-2b's longest prefill
// (S=4,608, window 4,096, 8 on 4 heads, D=256) that is one tanhf a
// (query, key) pair, ~84 M a launch, on the special-function units,
// beside ~86 GFLOP on the tensor cores.
//
// D (64, 128, 256) and CAP are template parameters of both. No fast
// math: expf, tanhf and IEEE division.
#include <cstdint>
#include <cstring>

#include "common.cuh"
#include "tile.cuh"

namespace {

using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::from_f;
using repro::ldmatrix_x4;
using repro::ldmatrix_x4_trans;
using repro::mma_bf16_16816;
using repro::pack_bf16;
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
template <typename T, int D, bool CAP>
__global__ void __launch_bounds__(kThreads)
local_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ out, int S,
                  int Hq, int Hkv, int window, int causal, float cap) {
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
        float x = s[r][c] / sqrt_d;
        if constexpr (CAP) x = cap * tanhf(x / cap);
        Ps[ri * LS + cj] = ok ? x : kNegInf;
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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
constexpr int kMmaWarps = 4;       // 16 query rows each
constexpr int kMmaStages = 2;      // K/V tiles in flight

template <int D>
__host__ __device__ constexpr int mma_bk() { return D >= 256 ? 32 : 64; }   // keys per tile

template <int D>
__host__ __device__ constexpr int mma_pitch() { return D + 8; }   // row pitch (elements): +16 B

template <int D>
__host__ __device__ constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (size_t)mma_pitch<D>() *
         (kBQ + kMmaStages * 2 * mma_bk<D>());
}

// q, out (B,S,Hq,D); k, v (B,S,Hkv,D), bf16. Grid (Hq, B, ceil(S/64)),
// 128 threads.
template <typename T, int D, bool CAP>
__global__ void __launch_bounds__(kMmaWarps * 32, 2)
local_attn_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ out, int S,
                      int Hq, int Hkv, int window, int causal, float cap) {
  static_assert(sizeof(T) == 2, "bf16 only");
  constexpr int BK = mma_bk<D>(), LD = mma_pitch<D>(), CH = D / 8;
  constexpr int NB = BK / 8;          // 16x8 score tiles a warp per key tile
  constexpr int ND = D / 8;           // 16x8 output tiles a warp
  // the sqrt(D) of the division, as sqrtf rounds it (8 and 16 are exact)
  constexpr float kSqrtD = D == 64 ? 8.f : D == 128 ? 11.313708498984761f : 16.f;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);          // [64][LD]
  T* KVs = Qs + kBQ * LD;                           // [stage][K, V][BK][LD]

  // the query tile is the slowest grid axis, taken from the last: the
  // longest bands start first, and the heads of a tile run together
  // (sharing their K/V tiles in L2)
  const int tile = gridDim.z - 1 - blockIdx.z;
  const int i0 = tile * kBQ, h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t q_stride = (size_t)Hq * D, kv_stride = (size_t)Hkv * D;
  const T* qb = q + ((size_t)b * S * Hq + h) * D;   // query i at qb + i * q_stride
  const T* kb = k + ((size_t)b * S * Hkv + hk) * D;
  const T* vb = v + ((size_t)b * S * Hkv + hk) * D;

  // the Q tile; rows past S are zeros
  for (int idx = tid; idx < kBQ * CH; idx += kMmaWarps * 32) {
    const int r = idx / CH, c = idx % CH, i = i0 + r;
    cp_async16(Qs + r * LD + c * 8, qb + (size_t)min(i, S - 1) * q_stride + c * 8,
               i < S ? 16 : 0);
  }

  // the band of keys any row of this block can attend to, in key tiles
  const int i_last = min(i0 + kBQ, S) - 1;
  const int j_lo = max(0, i0 - window + 1);
  const int j_hi = causal ? i_last : min(S - 1, i_last + window - 1);
  const int t_first = j_lo / BK, n_tiles = j_hi / BK - t_first + 1;

  // key tile t of the band into ring stage st; keys past S are zeros
  auto load_kv = [&](int t, int st) {
    T* Ks = KVs + (size_t)st * 2 * BK * LD;
    T* Vs = Ks + BK * LD;
    const int j0 = (t_first + t) * BK;
#pragma unroll 4
    for (int idx = tid; idx < BK * CH; idx += kMmaWarps * 32) {
      const int r = idx / CH, c = idx % CH, j = j0 + r;
      const size_t off = (size_t)min(j, S - 1) * kv_stride + c * 8;
      const int nbytes = j < S ? 16 : 0;
      cp_async16(Ks + r * LD + c * 8, kb + off, nbytes);
      cp_async16(Vs + r * LD + c * 8, vb + off, nbytes);
    }
  };
  load_kv(0, 0);
  cp_async_commit();                          // Q and the first tile

  // this warp's rows and the band they can attend to
  const int iw0 = i0 + 16 * warp;
  const int wj_lo = max(0, iw0 - window + 1);
  const int wj_hi = causal ? iw0 + 15 : iw0 + 15 + window - 1;
  const int g = lane >> 2, c4 = lane & 3;     // fragment group, place in it

  float o[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};        // rows g and g + 8
  float l_run[2] = {0.f, 0.f};                // this lane's share of l

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();        // tile t landed; every warp is done with t - 1
    if (t + 1 < n_tiles) load_kv(t + 1, (t + 1) % kMmaStages);
    cp_async_commit();
    const int j0 = (t_first + t) * BK;
    if (j0 > wj_hi || j0 + BK - 1 < wj_lo) continue;   // nothing to attend
    const T* Ks = KVs + (size_t)(t % kMmaStages) * 2 * BK * LD;
    const T* Vs = Ks + BK * LD;

    // S = Q K^T: per 16-dim step, Q's A fragment and K's B fragments
    float s[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, Qs + (16 * warp + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int jp = 0; jp < NB / 2; ++jp) {
        // matrices: keys 16jp+0..7 at dims +0 and +8, keys 16jp+8..15 likewise
        uint32_t bk[4];
        ldmatrix_x4(bk, Ks + (16 * jp + (lane >> 4) * 8 + (lane & 7)) * LD +
                            kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16_16816(s[2 * jp], a, bk[0], bk[1]);
        mma_bf16_16816(s[2 * jp + 1], a, bk[2], bk[3]);
      }
    }

    // scale, cap, and mask where the tile crosses the warp's band edge or S
    const bool inside = j0 + BK - 1 < S && iw0 + 15 - j0 < window &&
                        (causal ? iw0 - (j0 + BK - 1) >= 0
                                : j0 + BK - 1 - iw0 < window);
    uint32_t ok = 0xffffffffu;                 // bit 4 nb + e: s[nb][e]
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nb][e] / kSqrtD;
        if constexpr (CAP) x = cap * tanhf(x / cap);
        if (!inside) {
          const int i = iw0 + g + (e >> 1) * 8, j = j0 + nb * 8 + 2 * c4 + (e & 1);
          const int delta = i - j;
          const bool att = j < S && delta < window &&
                           (causal ? delta >= 0 : -delta < window);
          x = att ? x : kNegInf;
          ok &= att ? ~0u : ~(1u << (4 * nb + e));
        }
        s[nb][e] = x;
      }
    }

    // online softmax of rows g (e = 0, 1) and g + 8 (e = 2, 3)
    float alpha_r[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = kNegInf;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        mx = fmaxf(mx, fmaxf(s[nb][2 * rr], s[nb][2 * rr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[rr], mx);
      const float alpha = expf(m_run[rr] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int e = 2 * rr; e < 2 * rr + 2; ++e) {
          // exp first, then the mask as a factor (0 or 1; the exp is at
          // most 1): a branch around each exp would serialise them
          const float p = expf(s[nb][e] - m_new) *
                          static_cast<float>((ok >> (4 * nb + e)) & 1u);
          s[nb][e] = p;
          sum += p;
        }
      }
      l_run[rr] = l_run[rr] * alpha + sum;
      m_run[rr] = m_new;
      alpha_r[rr] = alpha;
    }
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      o[d][0] *= alpha_r[0];
      o[d][1] *= alpha_r[0];
      o[d][2] *= alpha_r[1];
      o[d][3] *= alpha_r[1];
    }

    // O += P V: P from the score registers, V through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        // matrices: keys 16kk+0..7 and +8..15 at dims 16dp+0..7, then at +8..15
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, Vs + (16 * kk + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD +
                                  16 * dp + (lane >> 4) * 8);
        mma_bf16_16816(o[2 * dp], a, bv[0], bv[1]);
        mma_bf16_16816(o[2 * dp + 1], a, bv[2], bv[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float l = l_run[rr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l = fmaxf(l, 1e-30f);
    const int i = iw0 + g + 8 * rr;
    if (i >= S) continue;
    T* row = out + ((size_t)b * S + i) * q_stride + (size_t)h * D;
#pragma unroll
    for (int d = 0; d < ND; ++d)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * d + 2 * c4) =
          __floats2bfloat162_rn(o[d][2 * rr] / l, o[d][2 * rr + 1] / l);
  }
}

// The launch's arguments: the kernel's (with the softcap's instantiation
// taken where cap > 0) and the launch's own.
struct Launch {
  const void *q, *k, *v;
  void* out;
  int B, S, Hq, Hkv, window, causal;
  float cap;
  cudaStream_t stream;
};

template <typename T, typename K>
cudaError_t run(K kernel, size_t smem, dim3 grid, int threads, const Launch& a) {
  const cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.out), a.S, a.Hq, a.Hkv,
      a.window, a.causal, a.cap);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_mma(const Launch& a) {
  using T = __nv_bfloat16;
  const dim3 grid(a.Hq, a.B, (a.S + kBQ - 1) / kBQ);
  const size_t smem = mma_smem_bytes<D>();
  return a.cap > 0.f
      ? run<T>(local_attn_mma_kernel<T, D, true>, smem, grid, kMmaWarps * 32, a)
      : run<T>(local_attn_mma_kernel<T, D, false>, smem, grid, kMmaWarps * 32, a);
}

template <int D>
cudaError_t launch_f32(const Launch& a) {
  const dim3 grid((a.S + kBQ - 1) / kBQ, a.Hq, a.B);
  const size_t smem = smem_bytes<D>();
  return a.cap > 0.f
      ? run<float>(local_attn_kernel<float, D, true>, smem, grid, kThreads, a)
      : run<float>(local_attn_kernel<float, D, false>, smem, grid, kThreads, a);
}

// float32: the CUDA-core kernel; bf16: the tensor-core kernel
cudaError_t launch_d(int dtype, int D, const Launch& a) {
  if (dtype == 0) {
    switch (D) {
      case 64: return launch_f32<64>(a);
      case 128: return launch_f32<128>(a);
      case 256: return launch_f32<256>(a);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype == 1) {
    switch (D) {
      case 64: return launch_mma<64>(a);
      case 128: return launch_mma<128>(a);
      case 256: return launch_mma<256>(a);
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// The launch's arguments, packed by kernels/local_attn/ops.py: 14 int64,
// then one float32:
//   a[0..3]   q, k, v, out: q, out (B,S,Hq,D) and k, v (B,S,Hkv,D) of one
//             dtype, contiguous on `device`
//   a[4..8]   B, S, Hq, Hkv, D (D in {64, 128, 256}, Hq a multiple of Hkv)
//   a[9]      window (>= 1), a[10] causal, a[11] dtype (0: float32,
//             1: bfloat16), a[12] device, a[13] stream
//   then      the softcap (0: none; else > 0)
// Returns the cudaError_t of the launch.
REPRO_EXPORT int local_attn_launch(const char* packed) {
  int64_t f[14];
  float cap;
  std::memcpy(f, packed, sizeof f);
  std::memcpy(&cap, packed + sizeof f, sizeof cap);
  cudaError_t err = repro::use_device(static_cast<int>(f[12]));
  if (err != cudaSuccess) return static_cast<int>(err);
  Launch a;
  a.q = reinterpret_cast<const void*>(f[0]);
  a.k = reinterpret_cast<const void*>(f[1]);
  a.v = reinterpret_cast<const void*>(f[2]);
  a.out = reinterpret_cast<void*>(f[3]);
  a.B = static_cast<int>(f[4]);
  a.S = static_cast<int>(f[5]);
  a.Hq = static_cast<int>(f[6]);
  a.Hkv = static_cast<int>(f[7]);
  a.window = static_cast<int>(f[9]);
  a.causal = static_cast<int>(f[10]);
  a.cap = cap;
  a.stream = reinterpret_cast<cudaStream_t>(f[13]);
  if (a.B == 0 || a.S == 0) return 0;
  if (a.Hkv < 1 || a.Hq % a.Hkv != 0 || a.window < 1 || !(cap >= 0.f))
    return static_cast<int>(cudaErrorInvalidValue);
  err = launch_d(static_cast<int>(f[11]), static_cast<int>(f[8]), a);
  return static_cast<int>(err);
}
