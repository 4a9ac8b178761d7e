// Hopper (sm_90a) building blocks of the flash-attention kernels:
// swizzled shared-memory tiles, wgmma descriptors and products (bf16, and
// tf32 for the f32 kernels), cp.async copies with zero-fill, and the
// fences between them.
//
// Tile layout. A tile of R rows by D columns of E-byte elements (bf16:
// one row per sequence position, the head dim contiguous) is stored as
// column blocks of R rows, each row ROWB = min(E * D, 128) bytes long,
// with the hardware swizzle of that width: 128 B, 64 B or 32 B (CuTe's
// Swizzle<3|2|1, 4, 3>: the 16-byte chunk index is XORed with bits 7.. of
// the byte offset). In bf16 the same bytes serve as a K-major operand (Q,
// K, V or dO as the row operand of a product over D) and as an MN-major B
// operand (V, dO or Q as the right operand of a product over the
// sequence), so no tile is ever transposed. tf32 operands must be K-major
// (wgmma transposes 16-bit types only), so the f32 kernels also keep
// transposed tiles (head dim by sequence) in the same layout. Every tile
// base is aligned to 1024 bytes, the 128-byte swizzle's period.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace raydp_flash {

template <int D, int E = 2>
struct TileLayout {
  static_assert(D == 16 || D == 32 || D == 64 || D == 128, "tile width");
  static_assert(E == 2 || E == 4, "element bytes");
  static constexpr int COLS = E * D < 128 ? D : 128 / E;  // columns a block
  static constexpr int ROWB = E * COLS;  // bytes per row of a block
  static constexpr int SWZ = ROWB == 128 ? 3 : ROWB == 64 ? 2 : 1;
  // wgmma descriptor layout type: 1 = 128 B, 2 = 64 B, 3 = 32 B swizzle.
  static constexpr uint64_t DESC_LAYOUT = SWZ == 3 ? 1 : SWZ == 2 ? 2 : 3;
  static constexpr int CHUNKS = D * E / 16;  // 16-byte chunks per row

  template <int R>
  __host__ __device__ static constexpr int bytes() {
    return R * D * E;
  }

  // Byte offset of element (r, c) of an R-row tile, swizzled.
  template <int R>
  static __device__ __forceinline__ uint32_t offset(int r, int c) {
    const uint32_t off =
        (uint32_t)((c / COLS) * R * ROWB + r * ROWB + (c % COLS) * E);
    return off ^ ((off >> 3) & (((1u << SWZ) - 1u) << 4));
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// K-major operand: the rows of an R-row tile from row r0 on, columns
// [k0, k0 + 32 / E) of the product's depth D (one k16 bf16 or k8 tf32
// step: 32 bytes).
template <int D, int R, int E = 2>
__device__ __forceinline__ uint64_t desc_k_major(uint32_t base, int r0,
                                                 int k0) {
  using L = TileLayout<D, E>;
  const uint32_t addr = base + (k0 / L::COLS) * R * L::ROWB + r0 * L::ROWB +
                        (k0 % L::COLS) * E;
  return make_desc(addr, 16, 8 * L::ROWB, L::DESC_LAYOUT);
}

// MN-major B operand: rows [k0, k0 + 16) of an R-row tile as the depth,
// all D columns as N. LBO steps from one column block to the next.
template <int D, int R>
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t base, int k0) {
  using L = TileLayout<D>;
  return make_desc(base + k0 * L::ROWB, R * L::ROWB, 8 * L::ROWB,
                   L::DESC_LAYOUT);
}

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copies written by the generic proxy become visible to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

constexpr int WG_THREADS = 128;  // one warpgroup

// The dynamic shared memory, its base rounded up to 1024 bytes (callers
// ask for 1024 bytes more than their tiles take).
__device__ __forceinline__ uint32_t aligned_smem(uint8_t* raw,
                                                 uint8_t** generic) {
  const uint32_t addr = smem_addr(raw);
  const uint32_t base = (addr + 1023u) & ~1023u;
  *generic = raw + (base - addr);
  return base;
}

// Rows [row0, row0 + R) of one (batch, head) slice of a [B, S, H, D]
// tensor of T (bf16 or f32) into an R-row tile at shared address dst, one
// 16-byte cp.async per chunk, spread over the warpgroup. Rows at or past S
// are zero-filled and read nothing. src points at sequence row 0; rows are
// row_stride elements apart.
template <int D, int R, typename T>
__device__ __forceinline__ void load_tile(uint32_t dst, const T* src,
                                          long long row_stride, int row0,
                                          int S, int tid) {
  using L = TileLayout<D, sizeof(T)>;
  constexpr int N = R * L::CHUNKS;
#pragma unroll
  for (int it = 0; it < (N + WG_THREADS - 1) / WG_THREADS; ++it) {
    const int i = tid + it * WG_THREADS;
    if (N % WG_THREADS != 0 && i >= N) break;
    const int r = i / L::CHUNKS, c = (i % L::CHUNKS) * (16 / sizeof(T));
    const bool live = row0 + r < S;
    const T* g = src + (live ? row0 + r : 0) * row_stride + c;
    cp_async_16(dst + L::template offset<R>(r, c), g, live ? 16 : 0);
  }
}

// The reverse for a finished R-row tile staged in shared memory: rows
// below S are written to global memory with 16-byte stores.
template <int D, int R, typename T>
__device__ __forceinline__ void store_tile(T* dst, long long row_stride,
                                           const uint8_t* tile, int row0,
                                           int S, int tid) {
  using L = TileLayout<D, sizeof(T)>;
  constexpr int N = R * L::CHUNKS;
#pragma unroll
  for (int it = 0; it < (N + WG_THREADS - 1) / WG_THREADS; ++it) {
    const int i = tid + it * WG_THREADS;
    if (N % WG_THREADS != 0 && i >= N) break;
    const int r = i / L::CHUNKS, c = (i % L::CHUNKS) * (16 / sizeof(T));
    if (row0 + r < S) {
      *reinterpret_cast<uint4*>(dst + (row0 + r) * row_stride + c) =
          *reinterpret_cast<const uint4*>(tile +
                                          L::template offset<R>(r, c));
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Accumulator fragment of a 64 x N f32 wgmma result, thread t of the
// warpgroup, register i: row (t / 32) * 16 + (t % 32) / 4 + 8 * ((i / 2) % 2),
// column (i / 4) * 8 + (t % 4) * 2 + i % 2.
__device__ __forceinline__ int frag_row(int tid, int i) {
  return (tid / 32) * 16 + (tid % 32) / 4 + 8 * ((i / 2) % 2);
}
__device__ __forceinline__ int frag_col(int tid, int i) {
  return (i / 4) * 8 + (tid % 4) * 2 + i % 2;
}

// The A operand of a register-sourced wgmma, columns [16 kk, 16 kk + 16)
// of a 64 x N f32 accumulator fragment rounded to bf16: the fragment
// layouts agree, so this is a repacking in registers.
template <int R>
__device__ __forceinline__ void frag_to_a(const float (&d)[R], int kk,
                                          uint32_t (&a)[4]) {
  a[0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
}

// D (64 x N, f32) = or += A . B with bf16 inputs. _ss: A and B from shared
// memory, both K-major. _rs: A from registers, B MN-major (transposed).
template <int N>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                         int scale_d);
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                         uint64_t db, int scale_d);

// Stores a 64 x D f32 accumulator fragment, times mul (per fragment row
// half), as bf16 into a 64-row tile in shared memory.
template <int D>
__device__ __forceinline__ void stage_frag(uint8_t* tile,
                                           const float (&d)[D / 2],
                                           const float (&mul)[2], int tid) {
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const float f = mul[(i / 2) % 2];
    *reinterpret_cast<uint32_t*>(
        tile + TileLayout<D>::template offset<64>(frag_row(tid, i),
                                                  frag_col(tid, i))) =
        pack_bf16(d[i] * f, d[i + 1] * f);
  }
}

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}


// ------------------------------------------------------------------- tf32
//
// The f32 kernels multiply on the tensor cores in TF32 x3: x = big + small
// with big = x with its 13 low mantissa bits cleared (a TF32 value) and
// small = x - big (exact in f32), and a.b = a_big.b_big + a_big.b_small +
// a_small.b_big. What is dropped, a_small.b_small and the low bits of
// small that TF32 does not hold, is ~2^-21 of a.b, where one TF32 product
// (~11 bits) is off by ~2^-11.

__device__ __forceinline__ float tf32_big(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}

// The tf32 A fragment of m64k8 gives thread t the columns t%4 and t%4 + 4
// of each 8-column group, where an f32 accumulator fragment holds the
// columns 2(t%4) and 2(t%4) + 1 (frag_col). So the contracted index is
// permuted inside each group of 8: k-slot c holds position 2c and slot
// c + 4 position 2c + 1. The B tile of a product whose A is an accumulator
// stores position p at slot tf32_slot(p).
__device__ __forceinline__ int tf32_slot(int p) {
  return (p & ~7) | ((p & 1) << 2) | ((p >> 1) & 3);
}

// Columns [8 kk, 8 kk + 8) of a 64 x N f32 accumulator fragment as the big
// and small A operands of a register-sourced tf32 wgmma, in tf32_slot
// order: a repacking in registers.
template <int N>
__device__ __forceinline__ void frag_to_a_tf32(const float (&d)[N], int kk,
                                               uint32_t (&big)[4],
                                               uint32_t (&small)[4]) {
  const float x[4] = {d[4 * kk], d[4 * kk + 2], d[4 * kk + 1],
                      d[4 * kk + 3]};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float b = tf32_big(x[j]);
    big[j] = __float_as_uint(b);
    small[j] = __float_as_uint(x[j] - b);
  }
}

// x, opaque to the compiler: the tile helpers below take tid through it,
// so the addresses they compute from it stay inside the kernels' loops
// instead of each holding a register across the whole loop (which takes
// the f32 forward at D 128 to the 255-register limit).
__device__ __forceinline__ int opaque(int x) {
  asm volatile("" : "+r"(x));
  return x;
}

__device__ __forceinline__ float4 tf32_big4(float4 v) {
  return make_float4(tf32_big(v.x), tf32_big(v.y), tf32_big(v.z),
                     tf32_big(v.w));
}

__device__ __forceinline__ float4 sub4(float4 a, float4 b) {
  return make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
}

// After this thread's load_tile<D, R, float> copies into big have landed
// (cp_async_wait): the chunks it copied are split in place, the big part
// left in big and the small part written to small (same layout).
template <int D, int R>
__device__ __forceinline__ void split_tile(uint8_t* big, uint8_t* small,
                                           int tid) {
  using L = TileLayout<D, 4>;
  tid = opaque(tid);
  constexpr int N = R * L::CHUNKS;
#pragma unroll
  for (int it = 0; it < (N + WG_THREADS - 1) / WG_THREADS; ++it) {
    const int i = tid + it * WG_THREADS;
    if (N % WG_THREADS != 0 && i >= N) break;
    const uint32_t off =
        L::template offset<R>(i / L::CHUNKS, (i % L::CHUNKS) * 4);
    const float4 v = *reinterpret_cast<const float4*>(big + off);
    const float4 b = tf32_big4(v);
    *reinterpret_cast<float4*>(big + off) = b;
    *reinterpret_cast<float4*>(small + off) = sub4(v, b);
  }
}

// An R-row tile of a [B, S, H, D] f32 tensor copied raw into shared
// memory by cp.async, so no registers are held while it lands, then split
// into big and small tiles as is (rows are positions) or transposed (rows
// are the head dim) by the thread that copied each chunk. Chunk i (16
// bytes at raw + 16 i) is row row(i), columns [col(i), col(i) + 4),
// copied by thread i % WG_THREADS: a warp copies 8 rows of 64 contiguous
// bytes, and its transposed stores fall on 16 banks.
template <int D, int R>
struct RawTile {
  static constexpr int CH = D / 4;  // 16-byte chunks per row
  static constexpr int N = R * CH / WG_THREADS;
  static_assert(N * WG_THREADS == R * CH && R % 8 == 0 && CH >= 4,
                "raw tile shape");

  static __device__ __forceinline__ int row(int i) {
    return i % 8 + 8 * (i / (8 * CH));
  }
  static __device__ __forceinline__ int col(int i) {
    return 4 * ((i / 8) % CH);
  }

  // Rows [row0, row0 + R) from src (sequence row 0, rows row_stride
  // elements apart) into raw; rows at or past S are zero-filled.
  static __device__ __forceinline__ void load(uint32_t raw, const float* src,
                                              long long row_stride, int row0,
                                              int S, int tid) {
    tid = opaque(tid);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int i = tid + j * WG_THREADS, r = row0 + row(i);
      const bool live = r < S;
      cp_async_16(raw + 16 * i, src + (live ? r : 0) * row_stride + col(i),
                  live ? 16 : 0);
    }
  }

  // After this thread's copies have landed: split into big and small
  // R x D tiles.
  static __device__ __forceinline__ void store(const uint8_t* raw,
                                               uint8_t* big, uint8_t* small,
                                               int tid) {
    tid = opaque(tid);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int i = tid + j * WG_THREADS;
      const float4 v = *reinterpret_cast<const float4*>(raw + 16 * i);
      const uint32_t off =
          TileLayout<D, 4>::template offset<R>(row(i), col(i));
      const float4 b = tf32_big4(v);
      *reinterpret_cast<float4*>(big + off) = b;
      *reinterpret_cast<float4*>(small + off) = sub4(v, b);
    }
  }

  // The same into one 2R x D tile, big at rows [0, R) and small at rows
  // [R, 2R): the B operand of a product twice as wide, whose one A read
  // yields a.big and a.small side by side.
  static __device__ __forceinline__ void store_stacked(const uint8_t* raw,
                                                       uint8_t* tile,
                                                       int tid) {
    using L = TileLayout<D, 4>;
    tid = opaque(tid);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int i = tid + j * WG_THREADS;
      const float4 v = *reinterpret_cast<const float4*>(raw + 16 * i);
      const float4 b = tf32_big4(v);
      *reinterpret_cast<float4*>(
          tile + L::template offset<2 * R>(row(i), col(i))) = b;
      *reinterpret_cast<float4*>(
          tile + L::template offset<2 * R>(row(i) + R, col(i))) = sub4(v, b);
    }
  }

  // The same into big and small D x R tiles: element (r, c) goes to row c,
  // column tf32_slot(r), the K-major B operand of a product over the
  // positions whose A is an accumulator fragment.
  static __device__ __forceinline__ void store_t(const uint8_t* raw,
                                                 uint8_t* big,
                                                 uint8_t* small, int tid) {
    tid = opaque(tid);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int i = tid + j * WG_THREADS;
      const float4 v = *reinterpret_cast<const float4*>(raw + 16 * i);
      const float x[4] = {v.x, v.y, v.z, v.w};
      const int slot = tf32_slot(row(i)), c = col(i);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t off =
            TileLayout<R, 4>::template offset<D>(c + e, slot);
        const float b = tf32_big(x[e]);
        *reinterpret_cast<float*>(big + off) = b;
        *reinterpret_cast<float*>(small + off) = x[e] - b;
      }
    }
  }
};

// Stores a 64 x D f32 accumulator fragment, times mul (per fragment row
// half), as f32 into a 64-row tile in shared memory.
template <int D>
__device__ __forceinline__ void stage_frag_f32(uint8_t* tile,
                                               const float (&d)[D / 2],
                                               const float (&mul)[2],
                                               int tid) {
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const float f = mul[(i / 2) % 2];
    *reinterpret_cast<float2*>(
        tile + TileLayout<D, 4>::template offset<64>(frag_row(tid, i),
                                                     frag_col(tid, i))) =
        make_float2(d[i] * f, d[i + 1] * f);
  }
}

// Keeps register A operands alive and in place until the products that
// read them have been waited for.
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// D (64 x N, f32) += A . B with tf32 inputs, both K-major. _ss: A and B
// from shared memory. _rs: A from registers (frag_to_a_tf32).
template <int N>
__device__ void wgmma_ss_tf32(float (&d)[N / 2], uint64_t da, uint64_t db,
                              int scale_d);
template <int N>
__device__ void wgmma_rs_tf32(float (&d)[N / 2], const uint32_t (&a)[4],
                              uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss_tf32<16>(float (&d)[8], uint64_t da,
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss_tf32<32>(float (&d)[16], uint64_t da,
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss_tf32<64>(float (&d)[32], uint64_t da,
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs_tf32<16>(float (&d)[8],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs_tf32<32>(float (&d)[16],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs_tf32<64>(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs_tf32<128>(float (&d)[64],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}


}  // namespace raydp_flash
