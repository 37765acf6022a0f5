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
// plus q, pos and out. At recurrentgemma-2b's decode shape (4 slots, 1 KV
// head, D=256, 16-token pages, ~130 pages a slot in its 2,048-token
// window, bf16) that is ~8.5 MB, ~2.5 us at the H100's 3.35 TB/s; at
// G=10 query rows a key costs ~10 operations per byte read, far below the
// ~295 where the tensor cores would matter. So decode and verify are
// bound by bytes, and a launch by how many pages are in flight at once.
//
// Design: split-K over pages. A work item is (tile of kRows = 16 of the
// T*G query rows of one (b, h), split, h, b); a split is a contiguous
// range of `pages_per_split` columns of the slot's page table, chosen by
// the wrapper (ops.py::plan_splits) so that decode and verify put at
// least one block on every SM. A block first reads its split's page ids
// and positions and lists the pages some row of its tile can attend to
// (an unassigned page, or one whose keys are all outside every row's
// mask, would leave the state unchanged, so it costs only this read).
// It then stages each listed page's K and V rows of head h, and its
// positions, once into shared memory through a 3-stage cp.async ring (2
// where a page takes over 32 KB), so the next pages land while this one
// is scored. Its 4 warps divide the tile's rows (warp w: rows w, w + 4,
// w + 8, w + 12), and the lanes divide D (lane l: dims (l + 32c) * V ..
// + V, V the elements of one access of at most 16 bytes); so at D=256 a
// lane holds 4 rows x 8 dims of q and of the accumulator. Per group of up
// to 16 keys (a page, or half of a 32-key one), each lane forms its
// partial dots of every (row, key) and a tree of shuffles over the keys
// (dots below) leaves each key's full score in 32 / KG lanes (2 for a
// 16-key group); the group's max, exp and masks run across the lanes,
// one softmax update a group; p goes through a small shared buffer; and
// every lane adds p times V into its dims. Products stay float32 FMAs on
// the CUDA cores, with float32 p as in the Pallas kernel: decode and
// verify are bound by bytes.
//
// With one split the block writes the output itself. With more, each
// split writes its float32 partial (m, l, acc[D]) per row to scratch the
// wrapper allocates, and paged_attn_merge_kernel, on the same stream,
// merges them: m* = max m_s, out = sum acc_s e^(m_s - m*) /
// max(sum l_s e^(m_s - m*), 1e-30), 0 where sum l_s = 0. At
// recurrentgemma-2b's decode shape (41 splits of 4 pages) the scratch is
// 40 rows x 41 splits x (D + 2) floats, ~1.7 MB written and read once,
// against ~8.5 MB of K/V; a long chunk of one slot splits more finely
// (its FMAs, not its bytes, bound it), a chunk over several slots not at
// all. The page size PS (4, 8, 16 or 32 keys) and D (64, 128, 256) are
// template parameters, so the key and dim loops unroll. No fast math: expf/tanhf and IEEE division (the merge's one
// exception is noted there), held to float32 tolerances.
#include <climits>
#include <cstdint>
#include <cstring>

#include "common.cuh"
#include "tile.cuh"

namespace {

using repro::cp_async16;
using repro::cp_async4;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::from_f;
using repro::to_f;

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;   // query rows per block
constexpr int kMergeWarps = 4;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__host__ __device__ constexpr int log2i(int x) {
  return x <= 1 ? 0 : 1 + log2i(x / 2);
}

// 32-bit words of a 4-, 8- or 16-byte vector access, by a compile-time
// index once the loops unroll (no local array for the compiler to keep).
template <int BYTES> struct Vec;
template <> struct Vec<4> { using type = uint32_t; };
template <> struct Vec<8> { using type = uint2; };
template <> struct Vec<16> { using type = uint4; };
__device__ __forceinline__ uint32_t word(uint32_t v, int) { return v; }
__device__ __forceinline__ uint32_t word(uint2 v, int i) { return i ? v.y : v.x; }
__device__ __forceinline__ uint32_t word(uint4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ void set_word(uint32_t& v, int, uint32_t w) { v = w; }
__device__ __forceinline__ void set_word(uint2& v, int i, uint32_t w) {
  (i ? v.y : v.x) = w;
}
__device__ __forceinline__ void set_word(uint4& v, int i, uint32_t w) {
  (i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w) = w;
}

// The per-lane layout of a D-wide row of T: lane l owns NC accesses of W
// consecutive elements, at elements (l + 32c) * W. A lane's float32
// partials go to scratch and back through RowLayout<float, D>, whose own
// order they keep: the merge reads each lane's values in the order that
// lane wrote them.
template <typename T, int D>
struct RowLayout {
  static constexpr int DPL = D / 32;                       // dims a lane
  static constexpr int W = DPL < 16 / (int)sizeof(T) ? DPL : 16 / (int)sizeof(T);
  static constexpr int NC = DPL / W;
  static constexpr int E = 4 / (int)sizeof(T);             // elements a word
  using V = typename Vec<W * sizeof(T)>::type;
  __device__ static void load(const T* row, int lane, float (&x)[DPL]) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const V v = *reinterpret_cast<const V*>(row + (lane + 32 * c) * W);
#pragma unroll
      for (int i = 0; i < W / E; ++i) {
        const uint32_t w = word(v, i);
        if constexpr (E == 2) {                 // bf16: the high halves
          x[c * W + 2 * i] = __uint_as_float(w << 16);
          x[c * W + 2 * i + 1] = __uint_as_float(w & 0xffff0000u);
        } else {
          x[c * W + i] = __uint_as_float(w);
        }
      }
    }
  }
  __device__ static void store(T* row, int lane, const float (&x)[DPL]) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      V v;
#pragma unroll
      for (int i = 0; i < W / E; ++i) {
        if constexpr (E == 2)
          set_word(v, i, repro::pack_bf16(x[c * W + 2 * i], x[c * W + 2 * i + 1]));
        else
          set_word(v, i, __float_as_uint(x[c * W + i]));
      }
      *reinterpret_cast<V*>(row + (lane + 32 * c) * W) = v;
    }
  }
};

// The R rows' dots with the N keys of a group (N a power of two <= 16),
// summed over the lanes (each holds its dims' share) in a tree that
// follows the keys: two blocks of N/2 keys combine at lane bit 32/N, the
// lane keeping one block's sum and trading the other with its partner,
// so the shuffles interleave with the next keys' FMAs and at most
// log2(N) + 1 partial arrays are live. A lane walks the group's keys in
// the order i ^ mask (mask = key_of<N>(lane)), so that the block it keeps
// is always the one it formed first and no select is needed. After the
// tree and the plain butterfly levels below lane bit 32/N (the
// caller's), lane l holds the full dot of key key_of<N>(l): bits 4, 3,
// ... of l, reversed. N - 1 shuffles a row for N keys, against 5N for
// keys summed one by one.
template <int N, typename L, typename T, int R>
__device__ __forceinline__ void dots(const T* ks, int i0, int mask, int lane,
                                     const float (&qr)[R][L::DPL],
                                     float (&out)[R]) {
  if constexpr (N == 1) {
    constexpr int D = 32 * L::DPL;
    float kv[L::DPL];
    L::load(ks + (i0 ^ mask) * D, lane, kv);
#pragma unroll
    for (int kr = 0; kr < R; ++kr) {
      float a = 0.f;
#pragma unroll
      for (int d = 0; d < L::DPL; ++d) a = fmaf(qr[kr][d], kv[d], a);
      out[kr] = a;
    }
  } else {
    float keep[R], send[R];
    dots<N / 2, L>(ks, i0, mask, lane, qr, keep);
    dots<N / 2, L>(ks, i0 + N / 2, mask, lane, qr, send);
#pragma unroll
    for (int kr = 0; kr < R; ++kr)
      out[kr] = keep[kr] + __shfl_xor_sync(kFull, send[kr], 32 / N);
  }
}

template <int N>
__device__ __forceinline__ int key_of(int lane) {
  int k = 0;
#pragma unroll
  for (int j = 1; (1 << j) <= N; ++j) k |= ((lane >> (5 - j)) & 1) << (j - 1);
  return k;
}

template <typename T, int D, int PS>
struct PagedSmem {
  static constexpr size_t kv_bytes = (size_t)2 * PS * D * sizeof(T);
  static constexpr int stages = kv_bytes <= 32768 ? 3 : 2;
  static constexpr size_t stage_bytes = kv_bytes + PS * sizeof(int);
  static constexpr int KG = PS < 16 ? PS : 16;     // keys per softmax update
  static constexpr size_t pbuf_bytes = sizeof(float) * kWarps * kRowsPerWarp * KG;
  static size_t bytes(int pages_per_split) {
    return stages * stage_bytes + pbuf_bytes + sizeof(int) * pages_per_split;
  }
};

// q, out (B,T,Hkv,G,D); k_pool, v_pool (P,ps,Hkv,D); pos_pool (P,ps);
// page_rows (B,n); qpos (B,T). Grid (row tiles * nsplit, Hkv, B). With
// nsplit > 1, part_acc (B,Hkv,nsplit,T*G,D) and part_ml (B,Hkv,nsplit,
// T*G,2) float32 take each split's partial in place of out.
// 3 blocks an SM (170 registers a thread at most): with no occupancy
// stated, ptxas aims at occupancy steps of its own and spills a few bytes
// to reach them; with this one it fits every instance in registers.
template <typename T, int D, int PS>
__global__ void __launch_bounds__(kWarps * 32, 3)
paged_attn_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                  const T* __restrict__ v_pool,
                  const int* __restrict__ pos_pool,
                  const int* __restrict__ page_rows,
                  const int* __restrict__ qpos, T* __restrict__ out,
                  float* __restrict__ part_acc, float* __restrict__ part_ml,
                  int Tq, int Hkv, int G, int n, int pages_per_split,
                  int nsplit, int window, float softcap) {
  using L = RowLayout<T, D>;
  using M = PagedSmem<T, D, PS>;
  constexpr int DPL = L::DPL, KG = M::KG, R = kRowsPerWarp;
  constexpr int SHIFT = 5 - log2i(KG);           // 1 << SHIFT lanes a key
  constexpr int VEC = 16 / (int)sizeof(T);       // elements a cp.async
  constexpr int RV = D / VEC;                    // cp.asyncs a K row
  extern __shared__ __align__(16) unsigned char smem[];
  float* pbuf = reinterpret_cast<float*>(smem + M::stages * M::stage_bytes);
  int* live = reinterpret_cast<int*>(smem + M::stages * M::stage_bytes + M::pbuf_bytes);
  __shared__ int warp_live[kWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x % nsplit, r0 = (blockIdx.x / nsplit) * kRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int TG = Tq * G, nrows = min(kRows, TG - r0);
  const int c0 = split * pages_per_split, c1 = min(n, c0 + pages_per_split);
  // the sqrt(D) of the division, as sqrtf rounds it (8 and 16 are exact)
  constexpr float kSqrtD = D == 64 ? 8.f : D == 128 ? 11.313708498984761f : 16.f;

  // the tile's query positions: their range for the page test, and this
  // warp's rows (w, w + 4, ...) with their q in registers
  int qmin = INT_MAX, qmax = INT_MIN;
  for (int t = r0 / G; t <= (r0 + nrows - 1) / G; ++t) {
    const int p = qpos[(size_t)b * Tq + t];
    qmin = min(qmin, p);
    qmax = max(qmax, p);
  }
  const int nk = (nrows - warp + kWarps - 1) / kWarps;   // rows of this warp
  float qr[R][DPL];
  int qp[R];
#pragma unroll
  for (int kr = 0; kr < R; ++kr) {
    qp[kr] = INT_MIN;
#pragma unroll
    for (int i = 0; i < DPL; ++i) qr[kr][i] = 0.f;
    if (kr < nk) {
      const int r = r0 + warp + kWarps * kr, t = r / G, g = r % G;
      L::load(q + ((((size_t)b * Tq + t) * Hkv + h) * G + g) * D, lane, qr[kr]);
      qp[kr] = qpos[(size_t)b * Tq + t];
    }
  }

  // the split's pages some row of the tile can attend to, in order
  int nlive = 0;
  for (int base = c0; base < c1; base += kWarps * 32) {
    const int j = base + tid;
    const int page = j < c1 ? page_rows[(size_t)b * n + j] : -1;
    bool ok = false;
    if (page >= 0) {
      const int* pp = pos_pool + (size_t)page * PS;
#pragma unroll
      for (int t = 0; t < PS; ++t) {
        const int kp = pp[t];
        ok |= kp >= 0 && kp <= qmax && (window <= 0 || kp + window > qmin);
      }
    }
    const unsigned ballot = __ballot_sync(kFull, ok);
    if (lane == 0) warp_live[warp] = __popc(ballot);
    __syncthreads();
    int at = nlive;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) at += warp_live[w];
      nlive += warp_live[w];
    }
    if (ok) live[at + __popc(ballot & ((1u << lane) - 1u))] = page;
    __syncthreads();
  }

  // page i of the list into ring stage i % stages: K, V rows of head h, pos
  auto stage_of = [&](int i) { return smem + (i % M::stages) * M::stage_bytes; };
  auto issue = [&](int i) {
    const int page = live[i];
    T* ks = reinterpret_cast<T*>(stage_of(i));
    T* vs = ks + PS * D;
    int* kps = reinterpret_cast<int*>(vs + PS * D);
#pragma unroll
    for (int idx = tid; idx < PS * RV; idx += kWarps * 32) {
      const int t = idx / RV, c = idx % RV;
      const size_t src = (((size_t)page * PS + t) * Hkv + h) * D + c * VEC;
      cp_async16(ks + t * D + c * VEC, k_pool + src);
      cp_async16(vs + t * D + c * VEC, v_pool + src);
    }
    if (tid < PS) cp_async4(kps + tid, pos_pool + (size_t)page * PS + tid);
  };

  float m[R], l[R], acc[R][DPL];   // l: this lane's share (its keys)
#pragma unroll
  for (int kr = 0; kr < R; ++kr) {
    m[kr] = kNegInf;
    l[kr] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[kr][i] = 0.f;
  }
  float* pw = pbuf + warp * R * KG;             // this warp's [row][key] p
  const int kt = key_of<KG>(lane);              // this lane's key in a group

#pragma unroll
  for (int i = 0; i < M::stages - 1; ++i) {
    if (i < nlive) issue(i);
    cp_async_commit();
  }
  for (int i = 0; i < nlive; ++i) {
    cp_async_wait<M::stages - 2>();
    __syncthreads();        // page i landed; every warp is done with i - 1
    if (i + M::stages - 1 < nlive) issue(i + M::stages - 1);
    cp_async_commit();
    const T* ks = reinterpret_cast<const T*>(stage_of(i));
    const T* vs = ks + PS * D;
    const int* kps = reinterpret_cast<const int*>(vs + PS * D);

#pragma unroll
    for (int g0 = 0; g0 < PS; g0 += KG) {
      // every row, those past the tile's too (they attend to nothing), so
      // that the rows' shuffle and exp chains interleave
      float sc[R];
      dots<KG, L>(ks + g0 * D, 0, kt, lane, qr, sc);
      const int kp = kps[g0 + kt];
#pragma unroll
      for (int kr = 0; kr < R; ++kr) {
        float s = sc[kr];
#pragma unroll
        for (int o = 16 / KG; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
        const bool ok = kp >= 0 && kp <= qp[kr] &&
                        (window <= 0 || qp[kr] - kp < window);
        s = to_f<T>(from_f<T>(s / kSqrtD));   // round through q's dtype
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        s = ok ? s : kNegInf;
        float mx = s;
#pragma unroll
        for (int o = 1 << SHIFT; o < 32; o <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
        const float m_new = fmaxf(m[kr], mx);
        const float alpha = expf(m[kr] - m_new);
        // exp first, then the mask as a factor (the exp is at most 1): a
        // branch around each exp would serialise the rows' chains
        const float p = expf(s - m_new) * static_cast<float>(ok);
        const bool leader = (lane & ((1 << SHIFT) - 1)) == 0;
        l[kr] = l[kr] * alpha + (leader ? p : 0.f);
        m[kr] = m_new;
        if (leader) pw[kr * KG + kt] = p;
#pragma unroll
        for (int d = 0; d < DPL; ++d) acc[kr][d] *= alpha;
      }
      __syncwarp();
#pragma unroll
      for (int t4 = 0; t4 < KG; t4 += 4) {       // p of 4 keys a row at once
        float4 p4[R];
#pragma unroll
        for (int kr = 0; kr < R; ++kr)
          p4[kr] = *reinterpret_cast<const float4*>(pw + kr * KG + t4);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          float vv[DPL];
          L::load(vs + (g0 + t4 + t) * D, lane, vv);
#pragma unroll
          for (int kr = 0; kr < R; ++kr) {
            const float pt = t == 0 ? p4[kr].x : t == 1 ? p4[kr].y
                           : t == 2 ? p4[kr].z : p4[kr].w;
#pragma unroll
            for (int d = 0; d < DPL; ++d) acc[kr][d] = fmaf(pt, vv[d], acc[kr][d]);
          }
        }
      }
      __syncwarp();                             // before p is rewritten
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int kr = 0; kr < R; ++kr) {
    if (kr >= nk) break;
    const float den = warp_sum(l[kr]);
    const int r = r0 + warp + kWarps * kr;
    if (nsplit == 1) {
      const int t = r / G, g = r % G;
      float o[DPL];
#pragma unroll
      for (int d = 0; d < DPL; ++d)
        o[d] = den > 0.f ? acc[kr][d] / fmaxf(den, 1e-30f) : 0.f;
      L::store(out + ((((size_t)b * Tq + t) * Hkv + h) * G + g) * D, lane, o);
    } else {
      const size_t row = (((size_t)b * Hkv + h) * nsplit + split) * TG + r;
      if (lane == 0) {
        part_ml[2 * row] = m[kr];
        part_ml[2 * row + 1] = den;
      }
      RowLayout<float, D>::store(part_acc + row * D, lane, acc[kr]);
    }
  }
}

// Merge of the splits' partials: one block per (b, h, row), warp w taking
// splits w, w + 4, ... (so that many partials are read at once), the
// warps' sums then added through shared memory. Grid (B*Hkv*T*G), 128
// threads. The division is __fdividef (within 2 ulp, den >= 1 wherever it
// is > 0): the IEEE division's slow path would cost this small kernel a
// stack frame.
template <typename T, int D>
__global__ void __launch_bounds__(kMergeWarps * 32)
paged_attn_merge_kernel(const float* __restrict__ part_acc,
                        const float* __restrict__ part_ml,
                        T* __restrict__ out, int Tq, int Hkv, int G,
                        int nsplit) {
  using F = RowLayout<float, D>;
  constexpr int DPL = F::DPL;
  __shared__ float num_w[kMergeWarps][D], den_w[kMergeWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int TG = Tq * G;
  const int r = blockIdx.x % TG, bh = blockIdx.x / TG;
  const int h = bh % Hkv, b = bh / Hkv;
  const size_t first = (size_t)bh * nsplit * TG + r;   // split s: + s * TG

  float mx = kNegInf;
  for (int s = lane; s < nsplit; s += 32)
    mx = fmaxf(mx, part_ml[2 * (first + (size_t)s * TG)]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));

  float den = 0.f, num[DPL];
#pragma unroll
  for (int d = 0; d < DPL; ++d) num[d] = 0.f;
#pragma unroll 4
  for (int s = warp; s < nsplit; s += kMergeWarps) {
    const size_t row = first + (size_t)s * TG;
    const float e = expf(part_ml[2 * row] - mx);
    den = fmaf(part_ml[2 * row + 1], e, den);
    float a[DPL];
    F::load(part_acc + row * D, lane, a);
#pragma unroll
    for (int d = 0; d < DPL; ++d) num[d] = fmaf(a[d], e, num[d]);
  }
#pragma unroll
  for (int d = 0; d < DPL; ++d) num_w[warp][d * 32 + lane] = num[d];
  if (lane == 0) den_w[warp] = den;
  __syncthreads();
  if (warp != 0) return;
  den = 0.f;
#pragma unroll
  for (int w = 0; w < kMergeWarps; ++w) den += den_w[w];
  float o[DPL];
#pragma unroll
  for (int d = 0; d < DPL; ++d) {
    float x = 0.f;
#pragma unroll
    for (int w = 0; w < kMergeWarps; ++w) x += num_w[w][d * 32 + lane];
    o[d] = den > 0.f ? __fdividef(x, fmaxf(den, 1e-30f)) : 0.f;
  }
  const int t = r / G, g = r % G;
  RowLayout<T, D>::store(out + ((((size_t)b * Tq + t) * Hkv + h) * G + g) * D,
                         lane, o);
}

template <typename T, int D, int PS>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const int* pos_pool, const int* page_rows, const int* qpos,
                   void* out, float* part, int B, int Tq, int Hkv, int G,
                   int n, int pages_per_split, int window, float softcap,
                   cudaStream_t stream) {
  const int TG = Tq * G;
  const int nsplit = n > 0 ? (n + pages_per_split - 1) / pages_per_split : 1;
  if (nsplit > 1 && part == nullptr) return cudaErrorInvalidValue;
  float* part_acc = part;
  float* part_ml = nsplit > 1 ? part + (size_t)B * Hkv * nsplit * TG * D : nullptr;
  auto kernel = paged_attn_kernel<T, D, PS>;
  const size_t smem = PagedSmem<T, D, PS>::bytes(pages_per_split);
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((TG + kRows - 1) / kRows * nsplit, Hkv, B);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), pos_pool, page_rows, qpos,
      static_cast<T*>(out), part_acc, part_ml, Tq, Hkv, G, n,
      pages_per_split, nsplit, window, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  paged_attn_merge_kernel<T, D><<<B * Hkv * TG, kMergeWarps * 32, 0, stream>>>(
      part_acc, part_ml, static_cast<T*>(out), Tq, Hkv, G, nsplit);
  return cudaGetLastError();
}

#define REPRO_PAGED_ARGS q, k_pool, v_pool, pos_pool, page_rows, qpos, out, \
                         part, B, Tq, Hkv, G, n, pages_per_split, window,   \
                         softcap, stream

template <typename T, int D>
cudaError_t launch_ps(int ps, const void* q, const void* k_pool,
                      const void* v_pool, const int* pos_pool,
                      const int* page_rows, const int* qpos, void* out,
                      float* part, int B, int Tq, int Hkv, int G, int n,
                      int pages_per_split, int window, float softcap,
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
                     const int* page_rows, const int* qpos, void* out,
                     float* part, int B, int Tq, int Hkv, int G, int n,
                     int pages_per_split, int window, float softcap,
                     cudaStream_t stream) {
  switch (D) {
    case 64: return launch_ps<T, 64>(ps, REPRO_PAGED_ARGS);
    case 128: return launch_ps<T, 128>(ps, REPRO_PAGED_ARGS);
    case 256: return launch_ps<T, 256>(ps, REPRO_PAGED_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The launch's arguments, packed by kernels/paged_attn/ops.py: 20 int64,
// then one float32:
//   f[0..7]   q, k_pool, v_pool, pos_pool, page_rows, qpos, out, part:
//             q, out (B,T,Hkv,G,D) and k_pool, v_pool (P,ps,Hkv,D) of one
//             dtype, pos_pool (P,ps), page_rows (B,n) and qpos (B,T)
//             int32, all contiguous on `device`; with ceil(n /
//             pages_per_split) > 1 splits, `part` is float32 scratch of
//             B*Hkv*splits*T*G*(D+2) values (else it may be 0)
//   f[8..15]  B, T, Hkv, G, D (64, 128 or 256), n, ps (4, 8, 16 or 32),
//             pages_per_split (>= 1)
//   f[16]     window (0: none), f[17] dtype (0: float32, 1: bfloat16),
//             f[18] device, f[19] stream
//   then      the softcap (0: none)
// Returns the cudaError_t of the launches.
REPRO_EXPORT int paged_attn_launch(const char* packed) {
  int64_t f[20];
  float softcap;
  std::memcpy(f, packed, sizeof f);
  std::memcpy(&softcap, packed + sizeof f, sizeof softcap);
  cudaError_t err = repro::use_device(static_cast<int>(f[18]));
  if (err != cudaSuccess) return static_cast<int>(err);
  const void* q = reinterpret_cast<const void*>(f[0]);
  const void* k_pool = reinterpret_cast<const void*>(f[1]);
  const void* v_pool = reinterpret_cast<const void*>(f[2]);
  const int* pos_pool = reinterpret_cast<const int*>(f[3]);
  const int* page_rows = reinterpret_cast<const int*>(f[4]);
  const int* qpos = reinterpret_cast<const int*>(f[5]);
  void* out = reinterpret_cast<void*>(f[6]);
  float* part = reinterpret_cast<float*>(f[7]);
  const int B = static_cast<int>(f[8]), Tq = static_cast<int>(f[9]);
  const int Hkv = static_cast<int>(f[10]), G = static_cast<int>(f[11]);
  const int D = static_cast<int>(f[12]), n = static_cast<int>(f[13]);
  const int ps = static_cast<int>(f[14]);
  const int pages_per_split = static_cast<int>(f[15]);
  const int window = static_cast<int>(f[16]), dtype = static_cast<int>(f[17]);
  const auto stream = reinterpret_cast<cudaStream_t>(f[19]);
  if (B == 0 || Tq == 0) return 0;
  if (pages_per_split < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    err = launch_d<float>(D, ps, REPRO_PAGED_ARGS);
  else if (dtype == 1)
    err = launch_d<__nv_bfloat16>(D, ps, REPRO_PAGED_ARGS);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
