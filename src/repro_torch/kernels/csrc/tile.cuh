// Tile helpers for the port's Hopper (sm_90a) kernels, in inline PTX:
// asynchronous copies from global to shared memory (cp.async), ldmatrix,
// and the bf16 tensor-core product mma.sync.m16n8k16 with float32
// accumulators.
//
// Fragment layouts of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32
// (D = A * B + C, A 16x16 row-major, B 16x8 "col": stored as 8 rows of
// 16 k values, C and D 16x8). For lane l, let g = l / 4 (its group) and
// c = l % 4 (its place in the group). Each 32-bit A or B register holds
// two bf16 values, the lower k (or column) in the low 16 bits.
//   A (4 regs): a0 = A[g][2c, 2c+1]      a1 = A[g+8][2c, 2c+1]
//               a2 = A[g][2c+8, 2c+9]    a3 = A[g+8][2c+8, 2c+9]
//   B (2 regs): b0 = B[2c, 2c+1][g]      b1 = B[2c+8, 2c+9][g]
//   C, D (4 floats): d0, d1 = D[g][2c, 2c+1]   d2, d3 = D[g+8][2c, 2c+1]
// So a row of D is spread over the 4 lanes of one group (a reduction over
// a row's columns is two __shfl_xor_sync, over lane bits 0 and 1), and two
// neighbouring 16x8 D tiles (columns 0-7 and 8-15) hold exactly the
// values of one 16x16 A fragment over those columns:
//   a0 = pack(D0[0], D0[1])  a1 = pack(D0[2], D0[3])
//   a2 = pack(D1[0], D1[1])  a3 = pack(D1[2], D1[3])
// which is how a score tile becomes the A operand of the next product.
//
// ldmatrix.sync.aligned.m8n8.x4.shared.b16 loads four 8x8 b16 matrices;
// lanes 8i..8i+7 give the shared addresses of matrix i's rows (16 bytes
// each, 16-byte aligned), and register i of lane l receives row l / 4,
// columns 2(l % 4) and 2(l % 4) + 1 of matrix i: the A or B fragment
// layout above. With .trans lane l receives column l / 4, rows 2(l % 4)
// and 2(l % 4) + 1 instead: a B fragment read from a matrix stored k-major
// (V's rows are keys, the k of P.V). Eight rows read at one column fall in
// eight distinct bank groups when the row pitch is an odd multiple of 16
// bytes, so the callers pad each row by 16 bytes.
#pragma once
#include <cstdint>

#include <cuda_bf16.h>

namespace repro {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, cached in L2 only. With src_bytes < 16 the
// rest is zero-filled; with 0 the source is not read (but must be a valid
// address expression).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

// 4 bytes global -> shared (cp.async.ca: the .cg form takes 16 only).
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem)
               : "memory");
}

// Close the group of copies issued since the last commit.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups are still in flight. The copies
// are then visible to this thread; a __syncthreads makes them visible to
// the block.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(smem))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* smem) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(smem))
               : "memory");
}

// d += A * B on the tensor cores: a is an A fragment, b0/b1 a B fragment.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 in one register, lo in the low 16 bits.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace repro
