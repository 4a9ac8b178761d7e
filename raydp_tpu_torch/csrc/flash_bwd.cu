// Flash-attention backward for Hopper (sm_90a): the delta pre-pass and
// the dq and dk/dv kernels.
//
// Replaces the TPU kernels of raydp_tpu/ops/flash_attention.py launched by
// `_flash_bwd_rule`:
//   flash_bwd_delta_kernel   <- the delta einsum, delta = rowsum(dO * O)
//                               in f32 (an XLA op there, a pre-pass here);
//   flash_bwd_dq_bf16_kernel,
//   flash_bwd_dq_f32_kernel  <- `_bwd_dq_kernel` (bf16, f32);
//   flash_bwd_dkv_bf16_kernel,
//   flash_bwd_dkv_f32_kernel <- `_bwd_dkv_kernel` (bf16, f32).
// Same function as the TPU kernels: p = exp(s - lse) from the forward's row
// logsumexp with s = (q . k) * scale in f32 and causal entries at -1e30;
// dp = dO . v in f32; ds = p * (dp - delta);
// dq = scale * sum over kv tiles of (ds rounded to k's dtype) . k;
// dv = sum over q tiles of (p rounded to dO's dtype)^T . dO;
// dk = scale * sum over q tiles of (ds rounded to q's dtype)^T . q;
// f32 accumulators cast to the output dtype at the end. As in the JAX
// package, dq and dk/dv are two kernels that each recompute p: no atomics,
// so every result is deterministic.
//
// Layout: q, k, v, dO, dq, dk, dv are [B, S, H, D] read and written
// through their element strides (the last dimension contiguous), so views
// of a fused qkv projection need no copies. lse and delta are f32
// [B, H, S].
//
// Grids: dq runs one CTA per (q tile, head, batch) and loops over kv tiles
// inside the CTA (the TPU's sequential kv grid axis), causal loops ending
// at the last live kv tile; dk/dv runs one CTA per (kv tile, head, batch)
// and loops over q tiles, causal loops starting at the first live q tile.
// Rows past S arrive as zeros and their p is forced to 0, so they add
// nothing; columns past S are masked the same way.
//
// What bounds it: at the BERT-base training shape (B 32, S 128, H 12,
// D 64, bf16) dq moves 31.9 MB and dk/dv 38.1 MB, 9.5 and 11.4 us at the
// data-sheet 3.35 TB/s, while their 2.4 and 3.2 GFLOP take 2.4 and 3.3 us
// at 989 TFLOP/s bf16: memory-bound on the H100. In f32 dq moves 63.3 MB
// (18.9 us) and dk/dv 75.9 MB (22.7 us); their 2.4 and 3.2 GFLOP as three
// TF32 products each take 14.6 and 19.5 us at 495 TFLOP/s, so both stay
// memory-bound, where f32 FMAs on the CUDA cores (36 and 48 us at 67
// TFLOP/s) would bound them by operations.
//
// The wgmma kernels are one warpgroup (128 threads) per 64-row tile, with
// products on the tensor cores, tiles in the swizzled layout of
// hopper_mma.cuh, and P and dS kept in registers as the A operand of the
// second product:
//
// dq, flash_bwd_dq_bf16_kernel: one CTA per 64 q rows. Q and dO are copied
// into shared memory once, lse and delta of the thread's two fragment rows
// into registers; K and V tiles of 64 rows stream through a two-stage
// cp.async ring, the next tile's copy under the current tile's products.
// S = Q.K^T and dP = dO.V^T are wgmma products with all four operands
// K-major in shared memory; P and dS are formed on the f32 fragments; dQ +=
// bf16(dS).K takes dS as the register A operand and K's tile, the same
// bytes, as an MN-major B operand. dQ's scale is applied once in the
// epilogue, and dQ leaves through shared memory with 16-byte stores.
//
// dk/dv, flash_bwd_dkv_bf16_kernel: one CTA per 64 kv rows. K and V are
// copied into shared memory once; Q, dO, lse and delta of each q tile (64
// rows, 32 at D 128) arrive by cp.async, double-buffered. It works in the
// transposed frame so that P and dS never leave registers: S^T = K.Q^T
// and dP^T = V.dO^T are wgmma products with both operands K-major; dV +=
// bf16(P^T).dO and dK += bf16(dS^T).Q take P^T and dS^T as register A
// operands, with dO and Q as MN-major B operands. dK's scale is applied
// once in the epilogue.
//
// dk/dv in f32, flash_bwd_dkv_f32_kernel: the bf16 plan with every product
// a tf32 wgmma taken three times (TF32 x3, hopper_mma.cuh): one TF32
// product keeps ~11 bits of each operand and misses the f32 bound;
// big.big + big.small + small.big, x split into a TF32 big part and its
// exact f32 remainder, is off by ~2^-21. Two warpgroups share a CTA of 64
// kv rows: one accumulates dV (S^T, then P^T.dO), the other dK (S^T and
// dP^T, then dS^T.Q), so each holds one D-wide accumulator and S^T is
// computed twice; held together with the split P^T and dS^T, both spill at
// D 128. K and V arrive by cp.async and are split in place. tf32 operands
// must be K-major, so the B operands of the second products are dO^T and
// Q^T: each q tile of Q and dO (with its lse and delta) lands raw by
// cp.async a tile ahead, then is split and stored both as is (for S^T and
// dP^T) and transposed with the q positions in the A fragment's order
// (tf32_slot), so P^T and dS^T stay in registers. 32-row q tiles in a
// two-stage ring up to D 64 (210 KB of shared memory, 1 CTA per SM);
// 16-row tiles in one stage at D 128.
//
// dq in f32, flash_bwd_dq_f32_kernel: the bf16 dq plan with every product
// a tf32 wgmma taken three times, as in the f32 dk/dv. One warpgroup per
// 64 q rows; Q and dO arrive by cp.async once and are split in place, lse
// and delta of the thread's two fragment rows sit in registers. S = Q.K^T
// and dP = dO.V^T are SS products, all operands K-major over D. dQ += dS.K
// takes dS from registers (split, not rounded: k is f32) and needs K^T as
// its B operand, tf32 having no MN-major B. So each K and V tile lands raw
// by cp.async a tile ahead; K is then split and stored transposed in
// tf32_slot order (RawTile::store_t), and K and V stacked, big rows over
// small rows (RawTile::store_stacked). Against a stacked tile, one
// product of twice the width gives q_big.k_big and q_big.k_small side by
// side, so the SS products read Q's and dO's A tiles twice a kv tile
// instead of three times (Q and dO as register A operands would hold 128
// registers at D 64). dQ's scale once in the epilogue; no atomics.
//
// Its shared memory, with BKV kv rows a tile: Q and dO big and small,
// 4 x 64 x D x 4 B; K and V stacked and K^T big and small, 6 x BKV x D x
// 4 B a stage; the raw K and V tiles, 2 x BKV x D x 4 B; 1 KB of
// alignment slack. At D 64 a two-stage ring of 32-row tiles comes to
// 64 + 96 + 16 + 1 = 177 KB, one CTA (4 warps) per SM; one stage of
// 16-row tiles to 64 + 24 + 8 + 1 = 97 KB, two CTAs (8 warps) per SM. The
// f32 kernels are latency-bound at 4-8 warps an SM, so it takes one stage
// of 16 rows: the next tile's copies still land under the products (into
// the raw tiles), and the other CTA's products fill this one's split and
// barriers. That makes 33, 49, 97 and 193 KB at D 16 (32-row tiles
// there), 32, 64 and 128.
//
// The delta pass is a plain streaming reduction and reads O and dO once.
//
// Build (plain C interface, loaded with ctypes; flash_common.cuh and
// hopper_mma.cuh sit beside it):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -Xptxas=-v -o libflash_bwd.so flash_bwd.cu

#include <math.h>

#include "flash_common.cuh"
#include "hopper_mma.cuh"

namespace {

using namespace raydp_flash;

constexpr int DELTA_TPR = 8;  // threads per row in the delta pass

// ------------------------------------------------------------------ delta

// delta[b, h, s] = sum_d dO[b, s, h, d] * O[b, s, h, d] in f32. Rows are
// walked in [B, S, H] order so neighbouring thread groups read
// neighbouring rows of a contiguous tensor.
template <typename T>
__global__ void __launch_bounds__(256)
    flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ g,
                           float* __restrict__ delta, int S, int H, int D,
                           long long rows, Strides os, Strides gs) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long r = gid / DELTA_TPR;
  const int lane = (int)(gid % DELTA_TPR);
  float sum = 0.f;
  int b = 0, s = 0, h = 0;
  if (r < rows) {
    h = (int)(r % H);
    s = (int)((r / H) % S);
    b = (int)(r / ((long long)H * S));
    const T* orow = o + b * os.b + s * os.s + h * os.h;
    const T* grow = g + b * gs.b + s * gs.s + h * gs.h;
    for (int d = lane; d < D; d += DELTA_TPR) {
      sum = fmaf(to_f32(grow[d]), to_f32(orow[d]), sum);
    }
  }
  // The eight lanes of a row are adjacent in one warp; every lane of the
  // warp reaches the shuffles.
  sum += __shfl_xor_sync(0xffffffffu, sum, 4);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  if (r < rows && lane == 0) {
    delta[((long long)b * H + h) * S + s] = sum;
  }
}

// ---------------------------------------------------------------- dq bf16

constexpr int DQ_ROWS = 64;  // q rows per CTA, kv rows per tile

template <int D>
constexpr size_t dq_bf16_smem() {
  // q (then the dq staging), dO, k[2], v[2]; plus the alignment slack.
  return 6 * (size_t)TileLayout<D>::template bytes<DQ_ROWS>() + 1024;
}

template <int D>
__global__ void __launch_bounds__(WG_THREADS)
    flash_bwd_dq_bf16_kernel(
        const __nv_bfloat16* __restrict__ q,
        const __nv_bfloat16* __restrict__ k,
        const __nv_bfloat16* __restrict__ v,
        const __nv_bfloat16* __restrict__ g, const float* __restrict__ lse,
        const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
        int S, int H, int causal, float scale, Strides qs, Strides ks,
        Strides vs, Strides gs, Strides dqs) {
  constexpr int R = DQ_ROWS;
  constexpr uint32_t TILE = TileLayout<D>::template bytes<R>();
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem;
  const uint32_t q_s = aligned_smem(smem_raw, &smem);
  const uint32_t g_s = q_s + TILE;
  const uint32_t k_s = q_s + 2 * TILE;  // stage st at k_s + st * TILE
  const uint32_t v_s = q_s + 4 * TILE;  // stage st at v_s + st * TILE

  const int q0 = blockIdx.x * R;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + h * vs.h;
  const __nv_bfloat16* gb = g + b * gs.b + h * gs.h;
  const long long row_base = ((long long)b * H + h) * S;
  // This thread's two query rows in the accumulator fragments, and their
  // lse and delta (defined only inside the sequence; a row past S has
  // zero Q and dO, so its ds is 0 whatever these are).
  const int qpos[2] = {q0 + frag_row(tid, 0), q0 + frag_row(tid, 2)};
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse_r[r] = qpos[r] < S ? lse[row_base + qpos[r]] : 0.f;
    delta_r[r] = qpos[r] < S ? delta[row_base + qpos[r]] : 0.f;
  }

  // Causal: kv tiles that start past the CTA's last query row are skipped.
  const int kv_end = causal ? min(S, q0 + R) : S;
  const int n_tiles = (kv_end + R - 1) / R;

  load_tile<D, R>(q_s, qb, qs.s, q0, S, tid);
  load_tile<D, R>(g_s, gb, gs.s, q0, S, tid);
  load_tile<D, R>(k_s, kb, ks.s, 0, S, tid);
  load_tile<D, R>(v_s, vb, vs.s, 0, S, tid);
  cp_async_commit();

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const uint32_t st = (uint32_t)(t & 1) * TILE;
    if (t + 1 < n_tiles) {  // the next tile's copy runs under this tile
      const uint32_t nx = TILE - st;
      load_tile<D, R>(k_s + nx, kb, ks.s, (t + 1) * R, S, tid);
      load_tile<D, R>(v_s + nx, vb, vs.s, (t + 1) * R, S, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of tile t have landed
    fence_proxy_async();
    __syncthreads();     // and everyone's

    // S = Q.K^T and dP = dO.V^T: q rows by kv columns, all four operands
    // K-major in shared memory; one commit, one wait.
    float s[R / 2], dp[R / 2];
#pragma unroll
    for (int i = 0; i < R / 2; ++i) {
      s[i] = 0.f;
      dp[i] = 0.f;
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<R>(s, desc_k_major<D, R>(q_s, 0, kk * 16),
                  desc_k_major<D, R>(k_s + st, 0, kk * 16), 1);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<R>(dp, desc_k_major<D, R>(g_s, 0, kk * 16),
                  desc_k_major<D, R>(v_s + st, 0, kk * 16), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // P = exp(scale S - lse) and dS = P (dP - delta) in f32 on the
    // fragments; dS overwrites S. Columns past S get p = 0.
    const int kv0 = t * R;
#pragma unroll
    for (int i = 0; i < R / 2; ++i) {
      const int kpos = kv0 + frag_col(tid, i);
      const int r = (i / 2) % 2;
      float x = s[i] * scale;
      if (causal && qpos[r] < kpos) x = NEG_INF;
      const float p = kpos < S ? exp2f((x - lse_r[r]) * LOG2E) : 0.f;
      s[i] = p * (dp[i] - delta_r[r]);
    }

    // dQ += bf16(dS).K: dS rounded to k's dtype, as the TPU kernel casts,
    // is the register A operand; K's tile, the same bytes the S product
    // read K-major, is the MN-major B operand. dS never touches shared
    // memory.
    uint32_t a[R / 16][4];
#pragma unroll
    for (int kk = 0; kk < R / 16; ++kk) frag_to_a(s, kk, a[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < R / 16; ++kk) {
      wgmma_rs<D>(acc, a[kk], desc_mn_major<D, R>(k_s + st, kk * 16), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();  // stage st is free for tile t + 2
  }

  // dQ's scale is applied once here, not per kv tile product as in the TPU
  // kernel: the two differ by f32 rounding only.
  const float mul[2] = {scale, scale};
  stage_frag<D>(smem, acc, mul, tid);  // into q's tile, no longer read
  __syncthreads();
  store_tile<D, R>(dq + b * dqs.b + h * dqs.h, dqs.s, smem, q0, S, tid);
}

// ----------------------------------------------------------------- dq f32

// kv rows per tile of the f32 dq: 16, in one stage (see the header), and
// 32 at D 16, where a 16-row raw tile has fewer 16-byte chunks than the
// warpgroup has threads.
template <int D>
__host__ __device__ constexpr int dq_f32_bkv() {
  return D == 16 ? 32 : 16;
}

template <int D>
__host__ __device__ constexpr size_t dq_f32_smem() {
  using L = TileLayout<D, 4>;
  // q and dO big and small (q big then the dq staging); k and v stacked
  // (big over small) and k^T big and small; the next k and v tiles as
  // they land; the alignment slack.
  return 4 * (size_t)L::template bytes<DQ_ROWS>() +
         8 * (size_t)L::template bytes<dq_f32_bkv<D>()>() + 1024;
}

template <int D>
__global__ void __launch_bounds__(WG_THREADS)
    flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ g,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dq, int S, int H, int causal,
                            float scale, Strides qs, Strides ks, Strides vs,
                            Strides gs, Strides dqs) {
  constexpr int R = DQ_ROWS, KV = dq_f32_bkv<D>();
  using L = TileLayout<D, 4>;
  constexpr uint32_t QT = L::template bytes<R>();
  constexpr uint32_t KT = L::template bytes<KV>();  // and k^T's D x KV
  static_assert(dq_f32_smem<D>() <= 232448, "shared memory budget");
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem;
  const uint32_t base = aligned_smem(smem_raw, &smem);
  // Byte offsets: q big, q small, dO big and dO small at 0, QT, 2 QT and
  // 3 QT; k stacked (2 KV rows: big, then small) at kv_tile(0), k^T big
  // and small at kv_tile(2) and kv_tile(3), v stacked at kv_tile(4); the
  // raw k and v tiles at kv_tile(6) and kv_tile(7).
  auto kv_tile = [](int j) -> uint32_t { return 4 * QT + j * KT; };
  using KVRaw = RawTile<D, KV>;

  const int q0 = blockIdx.x * R;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  const long long row_base = ((long long)b * H + h) * S;
  // This thread's two query rows in the accumulator fragments, and their
  // lse and delta (defined only inside the sequence; a row past S has
  // zero Q and dO, so its ds is 0 whatever these are).
  const int qpos[2] = {q0 + frag_row(tid, 0), q0 + frag_row(tid, 2)};
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse_r[r] = qpos[r] < S ? lse[row_base + qpos[r]] : 0.f;
    delta_r[r] = qpos[r] < S ? delta[row_base + qpos[r]] : 0.f;
  }

  // Causal: kv tiles that start past the CTA's last query row are skipped.
  const int kv_end = causal ? min(S, q0 + R) : S;
  const int n_tiles = (kv_end + KV - 1) / KV;

  // K and V of kv tile t land raw; after this thread's copies have landed
  // it splits the chunks it copied: K and V stacked (for S and dP), K
  // transposed in tf32_slot order (for dQ).
  auto load_kv = [&](int t) {
    KVRaw::load(base + kv_tile(6), kb, ks.s, t * KV, S, tid);
    KVRaw::load(base + kv_tile(7), vb, vs.s, t * KV, S, tid);
    cp_async_commit();
  };
  auto store_kv = [&]() {
    KVRaw::store_stacked(smem + kv_tile(6), smem + kv_tile(0), tid);
    KVRaw::store_t(smem + kv_tile(6), smem + kv_tile(2), smem + kv_tile(3),
                   tid);
    KVRaw::store_stacked(smem + kv_tile(7), smem + kv_tile(4), tid);
  };

  // Q and dO once, split in place.
  load_tile<D, R>(base, q + b * qs.b + h * qs.h, qs.s, q0, S, tid);
  load_tile<D, R>(base + 2 * QT, g + b * gs.b + h * gs.h, gs.s, q0, S, tid);
  load_kv(0);
  cp_async_wait<0>();
  split_tile<D, R>(smem, smem + QT, tid);
  split_tile<D, R>(smem + 2 * QT, smem + 3 * QT, tid);
  store_kv();
  fence_proxy_async();
  __syncthreads();

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const bool more = t + 1 < n_tiles;
    if (more) load_kv(t + 1);  // lands under this tile's products

    // S = Q.K^T and dP = dO.V^T in TF32 x3, q rows by kv columns, all
    // operands K-major in shared memory. Q big against stacked K is one
    // product 2 KV columns wide, q_big.k_big beside q_big.k_small;
    // q_small.k_big goes first into the first KV columns, and the halves
    // are added after. Q's and dO's A tiles are read twice a kv tile, not
    // three times.
    float s2[KV], dp2[KV];
#pragma unroll
    for (int i = 0; i < KV; ++i) {
      s2[i] = 0.f;
      dp2[i] = 0.f;
    }
    // The first KV columns of a 64 x 2 KV fragment are its first KV / 2
    // registers, laid out as a 64 x KV fragment.
    float(&s_lo)[KV / 2] = *reinterpret_cast<float(*)[KV / 2]>(s2);
    float(&dp_lo)[KV / 2] = *reinterpret_cast<float(*)[KV / 2]>(dp2);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const int k0 = kk * 8;
      wgmma_ss_tf32<KV>(s_lo, desc_k_major<D, R, 4>(base + QT, 0, k0),
                        desc_k_major<D, 2 * KV, 4>(base + kv_tile(0), 0, k0),
                        1);
      wgmma_ss_tf32<KV>(dp_lo, desc_k_major<D, R, 4>(base + 3 * QT, 0, k0),
                        desc_k_major<D, 2 * KV, 4>(base + kv_tile(4), 0, k0),
                        1);
    }
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const int k0 = kk * 8;
      wgmma_ss_tf32<2 * KV>(
          s2, desc_k_major<D, R, 4>(base, 0, k0),
          desc_k_major<D, 2 * KV, 4>(base + kv_tile(0), 0, k0), 1);
      wgmma_ss_tf32<2 * KV>(
          dp2, desc_k_major<D, R, 4>(base + 2 * QT, 0, k0),
          desc_k_major<D, 2 * KV, 4>(base + kv_tile(4), 0, k0), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s2);
    fence_regs(dp2);
    float s[KV / 2], dp[KV / 2];
#pragma unroll
    for (int i = 0; i < KV / 2; ++i) {
      s[i] = s2[i] + s2[i + KV / 2];
      dp[i] = dp2[i] + dp2[i + KV / 2];
    }

    // P = exp(scale S - lse) and dS = P (dP - delta) in f32 on the
    // fragments, as the bf16 kernel; dS overwrites S. Columns past S get
    // p = 0.
    const int kv0 = t * KV;
#pragma unroll
    for (int i = 0; i < KV / 2; ++i) {
      const int kpos = kv0 + frag_col(tid, i);
      const int r = (i / 2) % 2;
      float x = s[i] * scale;
      if (causal && qpos[r] < kpos) x = NEG_INF;
      const float p = kpos < S ? exp2f((x - lse_r[r]) * LOG2E) : 0.f;
      s[i] = p * (dp[i] - delta_r[r]);
    }

    // dQ += dS.K in TF32 x3: dS split in registers is the A operand (ds
    // in k's dtype, f32, so no rounding), K^T big and small the B
    // operands.
    uint32_t a_big[KV / 8][4], a_small[KV / 8][4];
#pragma unroll
    for (int kk = 0; kk < KV / 8; ++kk) {
      frag_to_a_tf32(s, kk, a_big[kk], a_small[kk]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KV / 8; ++kk) {
      const int k0 = kk * 8;
      wgmma_rs_tf32<D>(acc, a_small[kk],
                       desc_k_major<KV, D, 4>(base + kv_tile(2), 0, k0), 1);
      wgmma_rs_tf32<D>(acc, a_big[kk],
                       desc_k_major<KV, D, 4>(base + kv_tile(3), 0, k0), 1);
    }
#pragma unroll
    for (int kk = 0; kk < KV / 8; ++kk) {
      wgmma_rs_tf32<D>(
          acc, a_big[kk],
          desc_k_major<KV, D, 4>(base + kv_tile(2), 0, kk * 8), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < KV / 8; ++kk) {
      fence_regs(a_big[kk]);
      fence_regs(a_small[kk]);
    }
    __syncthreads();  // the stage is free
    if (more) {       // one stage: the next tile after the wait
      cp_async_wait<0>();
      store_kv();
      fence_proxy_async();
      __syncthreads();
    }
  }

  // dQ's scale is applied once here, as in the bf16 kernel.
  const float mul[2] = {scale, scale};
  stage_frag_f32<D>(smem, acc, mul, tid);  // into q's big tile
  __syncthreads();
  store_tile<D, R>(dq + b * dqs.b + h * dqs.h, dqs.s, smem, q0, S, tid);
}

// ------------------------------------------------------------- dk/dv bf16

constexpr int DKV_ROWS = 64;  // kv rows per CTA

// q rows per tile: 32 at D 128 keeps dK, dV (64 registers each), S^T and
// dP^T in registers without spills.
template <int D>
__host__ __device__ constexpr int dkv_bq() {
  return D == 128 ? 32 : 64;
}

template <int D>
constexpr size_t dkv_bf16_smem() {
  using L = TileLayout<D>;
  // k, v (then the dk, dv staging); q[2], dO[2]; lse and delta [2]; slack.
  return 2 * (size_t)L::template bytes<DKV_ROWS>() +
         4 * (size_t)L::template bytes<dkv_bq<D>()>() +
         4 * dkv_bq<D>() * sizeof(float) + 1024;
}

template <int D>
__global__ void __launch_bounds__(WG_THREADS)
    flash_bwd_dkv_bf16_kernel(
        const __nv_bfloat16* __restrict__ q,
        const __nv_bfloat16* __restrict__ k,
        const __nv_bfloat16* __restrict__ v,
        const __nv_bfloat16* __restrict__ g, const float* __restrict__ lse,
        const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
        __nv_bfloat16* __restrict__ dv, int S, int H, int causal,
        float scale, Strides qs, Strides ks, Strides vs, Strides gs,
        Strides dks, Strides dvs) {
  constexpr int R = DKV_ROWS;
  constexpr int BQ_ = dkv_bq<D>();
  constexpr uint32_t KT = TileLayout<D>::template bytes<R>();
  constexpr uint32_t QT = TileLayout<D>::template bytes<BQ_>();
  constexpr uint32_t STATS = 2 * BQ_ * sizeof(float);  // lse, delta a stage
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem;
  const uint32_t k_s = aligned_smem(smem_raw, &smem);
  const uint32_t v_s = k_s + KT;
  const uint32_t q_s = k_s + 2 * KT;           // stage st at + st * QT
  const uint32_t g_s = q_s + 2 * QT;           // stage st at + st * QT
  const uint32_t stats_s = g_s + 2 * QT;       // stage st at + st * STATS
  const float* stats = reinterpret_cast<const float*>(smem + (stats_s - k_s));

  const int kv0 = blockIdx.x * R;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + h * vs.h;
  const __nv_bfloat16* gb = g + b * gs.b + h * gs.h;
  const long long row_base = ((long long)b * H + h) * S;
  // This thread's two kv rows in the accumulator fragments.
  const int kpos[2] = {kv0 + frag_row(tid, 0), kv0 + frag_row(tid, 2)};

  // Causal: q tiles that end before this kv tile starts are skipped.
  const int q_start = causal ? (kv0 / BQ_) * BQ_ : 0;
  const int n_tiles = (S - q_start + BQ_ - 1) / BQ_;

  // Q, dO, lse and delta of q tile t into stage st (0 or 1).
  auto load_q_tile = [&](int t, uint32_t st) {
    const int q0 = q_start + t * BQ_;
    load_tile<D, BQ_>(q_s + st * QT, qb, qs.s, q0, S, tid);
    load_tile<D, BQ_>(g_s + st * QT, gb, gs.s, q0, S, tid);
    if (tid < 2 * BQ_) {
      const int j = tid % BQ_, which = tid / BQ_;
      const bool live = q0 + j < S;
      const float* src = (which ? delta : lse) + row_base + (live ? q0 + j : 0);
      cp_async_4(stats_s + st * STATS + (which * BQ_ + j) * 4, src,
                 live ? 4 : 0);
    }
  };

  load_tile<D, R>(k_s, kb, ks.s, kv0, S, tid);
  load_tile<D, R>(v_s, vb, vs.s, kv0, S, tid);
  load_q_tile(0, 0);
  cp_async_commit();

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    dk_acc[i] = 0.f;
    dv_acc[i] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const uint32_t st = (uint32_t)(t & 1);
    if (t + 1 < n_tiles) load_q_tile(t + 1, st ^ 1u);  // under this tile
    cp_async_commit();
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();

    const int q0 = q_start + t * BQ_;
    const uint32_t qt = q_s + st * QT, gt = g_s + st * QT;
    // S^T = K.Q^T and dP^T = V.dO^T: kv rows by q columns, both operands
    // K-major in shared memory.
    float s[BQ_ / 2], dp[BQ_ / 2];
#pragma unroll
    for (int i = 0; i < BQ_ / 2; ++i) {
      s[i] = 0.f;
      dp[i] = 0.f;
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<BQ_>(s, desc_k_major<D, R>(k_s, 0, kk * 16),
                    desc_k_major<D, BQ_>(qt, 0, kk * 16), 1);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<BQ_>(dp, desc_k_major<D, R>(v_s, 0, kk * 16),
                    desc_k_major<D, BQ_>(gt, 0, kk * 16), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // P^T = exp(scale S^T - lse[q]) and dS^T = P^T (dP^T - delta[q]) in
    // f32 on the fragments. Columns past S get p = 0.
    const float* lse_t = stats + st * 2 * BQ_;
    const float* delta_t = lse_t + BQ_;
#pragma unroll
    for (int i = 0; i < BQ_ / 2; ++i) {
      const int j = frag_col(tid, i);
      const int qpos = q0 + j;
      float x = s[i] * scale;
      if (causal && qpos < kpos[(i / 2) % 2]) x = NEG_INF;
      const float p = qpos < S ? exp2f((x - lse_t[j]) * LOG2E) : 0.f;
      s[i] = p;
      dp[i] = p * (dp[i] - delta_t[j]);
    }

    // dV += bf16(P^T).dO and dK += bf16(dS^T).Q: A from registers (p
    // rounded to dO's dtype, ds to q's, as the TPU kernel casts), dO and
    // Q as MN-major B operands.
    uint32_t pa[BQ_ / 16][4], da[BQ_ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ_ / 16; ++kk) {
      frag_to_a(s, kk, pa[kk]);
      frag_to_a(dp, kk, da[kk]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ_ / 16; ++kk) {
      wgmma_rs<D>(dv_acc, pa[kk], desc_mn_major<D, BQ_>(gt, kk * 16), 1);
      wgmma_rs<D>(dk_acc, da[kk], desc_mn_major<D, BQ_>(qt, kk * 16), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    __syncthreads();  // stage st is free for tile t + 2
  }

  // dK's scale is applied once here, not per tile product as in the TPU
  // kernel: the two differ by f32 rounding only.
  const float dk_mul[2] = {scale, scale}, dv_mul[2] = {1.f, 1.f};
  stage_frag<D>(smem, dk_acc, dk_mul, tid);       // into k's tile
  stage_frag<D>(smem + KT, dv_acc, dv_mul, tid);  // into v's tile
  __syncthreads();
  store_tile<D, R>(dk + b * dks.b + h * dks.h, dks.s, smem, kv0, S, tid);
  store_tile<D, R>(dv + b * dvs.b + h * dvs.h, dvs.s, smem + KT, kv0, S,
                   tid);
}

// -------------------------------------------------------------- dk/dv f32

// q rows per tile and stages of the f32 dk/dv: 32-row tiles in a two-stage
// ring up to D 64; at D 128, where the tiles are twice as wide, 16-row
// tiles in one stage.
template <int D>
__host__ __device__ constexpr int dkv_f32_bq() {
  return D == 128 ? 16 : 32;
}
template <int D>
__host__ __device__ constexpr int dkv_f32_stages() {
  return D == 128 ? 1 : 2;
}

constexpr int DKV_F32_THREADS = 2 * WG_THREADS;  // the dV and dK warpgroups

template <int D>
__host__ __device__ constexpr size_t dkv_f32_smem() {
  using L = TileLayout<D, 4>;
  constexpr int BQ_ = dkv_f32_bq<D>();
  constexpr int STAGES = dkv_f32_stages<D>();
  // k and v big and small (k big and v big then the dv, dk staging); per
  // stage q, dO, q^T and dO^T big and small; the next q and dO tiles as
  // they land; lse and delta per stage and as they land; slack.
  return 4 * (size_t)L::template bytes<DKV_ROWS>() +
         (8 * STAGES + 2) * (size_t)L::template bytes<BQ_>() +
         (STAGES + 1) * 2 * BQ_ * sizeof(float) + 1024;
}

template <int D>
__global__ void __launch_bounds__(DKV_F32_THREADS)
    flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ g,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             float* __restrict__ dk, float* __restrict__ dv,
                             int S, int H, int causal, float scale,
                             Strides qs, Strides ks, Strides vs, Strides gs,
                             Strides dks, Strides dvs) {
  constexpr int R = DKV_ROWS;
  constexpr int BQ_ = dkv_f32_bq<D>();
  constexpr int STAGES = dkv_f32_stages<D>();
  using L = TileLayout<D, 4>;
  constexpr uint32_t KT = L::template bytes<R>();
  constexpr uint32_t QT = L::template bytes<BQ_>();  // and q^T's D x BQ_
  static_assert(dkv_f32_smem<D>() <= 232448, "shared memory budget");
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem;
  const uint32_t base = aligned_smem(smem_raw, &smem);
  // Byte offsets: k big, k small, v big, v small at 0, KT, 2 KT, 3 KT;
  // stage st's q big, q small, dO big, dO small, q^T big, q^T small,
  // dO^T big and dO^T small at q_tile(st, 0..7); the raw q and dO tiles
  // at Q_RAW and Q_RAW + QT; lse and delta of stage st at stats + 2 st BQ_
  // and as they land at stats + 2 STAGES BQ_.
  auto q_tile = [](int st, int j) -> uint32_t {
    return 4 * KT + (8 * st + j) * QT;
  };
  constexpr uint32_t Q_RAW = 4 * KT + 8 * STAGES * QT;
  constexpr uint32_t STATS = Q_RAW + 2 * QT;
  using QRaw = RawTile<D, BQ_>;
  float* stats = reinterpret_cast<float*>(smem + STATS);
  const float* stats_raw = stats + 2 * STAGES * BQ_;

  // Warpgroup 0 accumulates dV: it needs S^T, P^T and dO^T. Warpgroup 1
  // accumulates dK: S^T, dP^T, dS^T and Q^T. Each holds one D-wide
  // accumulator; S^T is computed by both. Warpgroup 0 copies K, Q and lse,
  // warpgroup 1 V, dO and delta.
  const int wg = threadIdx.x / WG_THREADS;
  const int tid = threadIdx.x % WG_THREADS;
  const int kv0 = blockIdx.x * R;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float* kvb = wg ? v + b * vs.b + h * vs.h : k + b * ks.b + h * ks.h;
  const float* qgb = wg ? g + b * gs.b + h * gs.h : q + b * qs.b + h * qs.h;
  const long long qg_stride = wg ? gs.s : qs.s;
  const long long row_base = ((long long)b * H + h) * S;
  // This thread's two kv rows in the accumulator fragments.
  const int kpos[2] = {kv0 + frag_row(tid, 0), kv0 + frag_row(tid, 2)};

  // Causal: q tiles that end before this kv tile starts are skipped.
  const int q_start = causal ? (kv0 / BQ_) * BQ_ : 0;
  const int n_tiles = (S - q_start + BQ_ - 1) / BQ_;

  // Q or dO, and lse or delta, of a q tile land raw by cp.async a tile
  // ahead; each thread then splits the chunks it copied into a stage, as
  // they are (tiles 0-1: Q, 2-3: dO) and transposed (4-5: Q^T, 6-7: dO^T).
  auto load_q_tile = [&](int t) {
    const int q0 = q_start + t * BQ_;
    QRaw::load(base + Q_RAW + wg * QT, qgb, qg_stride, q0, S, tid);
    if (tid < BQ_) {
      const bool live = q0 + tid < S;
      cp_async_4(base + STATS + (2 * STAGES * BQ_ + wg * BQ_ + tid) * 4,
                 (wg ? delta : lse) + row_base + (live ? q0 + tid : 0),
                 live ? 4 : 0);
    }
    cp_async_commit();
  };
  auto store_q_tile = [&](int st) {  // after this thread's copies landed
    const uint8_t* raw = smem + Q_RAW + wg * QT;
    QRaw::store(raw, smem + q_tile(st, 2 * wg), smem + q_tile(st, 2 * wg + 1),
                tid);
    QRaw::store_t(raw, smem + q_tile(st, 4 + 2 * wg),
                  smem + q_tile(st, 5 + 2 * wg), tid);
    if (tid < BQ_) {
      stats[2 * st * BQ_ + wg * BQ_ + tid] = stats_raw[wg * BQ_ + tid];
    }
  };

  // K (warpgroup 0) or V (warpgroup 1) once, split in place.
  load_tile<D, R>(base + 2 * wg * KT, kvb, wg ? vs.s : ks.s, kv0, S, tid);
  load_q_tile(0);
  cp_async_wait<0>();
  split_tile<D, R>(smem + 2 * wg * KT, smem + (2 * wg + 1) * KT, tid);
  store_q_tile(0);
  fence_proxy_async();
  __syncthreads();

  float acc[D / 2];  // dV (warpgroup 0) or dK (warpgroup 1)
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int st = STAGES == 2 ? (t & 1) : 0;
    const bool more = t + 1 < n_tiles;
    if (more) load_q_tile(t + 1);  // lands under this tile's products

    // S^T = K.Q^T (both warpgroups) and dP^T = V.dO^T (warpgroup 1) in
    // TF32 x3: kv rows by q columns, all operands K-major in shared
    // memory; the small products first.
    float s[BQ_ / 2], dp[BQ_ / 2];
#pragma unroll
    for (int i = 0; i < BQ_ / 2; ++i) {
      s[i] = 0.f;
      dp[i] = 0.f;
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const int k0 = kk * 8;
      wgmma_ss_tf32<BQ_>(
          s, desc_k_major<D, R, 4>(base, 0, k0),
          desc_k_major<D, BQ_, 4>(base + q_tile(st, 1), 0, k0), 1);
      wgmma_ss_tf32<BQ_>(
          s, desc_k_major<D, R, 4>(base + KT, 0, k0),
          desc_k_major<D, BQ_, 4>(base + q_tile(st, 0), 0, k0), 1);
      if (wg) {
        wgmma_ss_tf32<BQ_>(
            dp, desc_k_major<D, R, 4>(base + 2 * KT, 0, k0),
            desc_k_major<D, BQ_, 4>(base + q_tile(st, 3), 0, k0), 1);
        wgmma_ss_tf32<BQ_>(
            dp, desc_k_major<D, R, 4>(base + 3 * KT, 0, k0),
            desc_k_major<D, BQ_, 4>(base + q_tile(st, 2), 0, k0), 1);
      }
    }
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const int k0 = kk * 8;
      wgmma_ss_tf32<BQ_>(
          s, desc_k_major<D, R, 4>(base, 0, k0),
          desc_k_major<D, BQ_, 4>(base + q_tile(st, 0), 0, k0), 1);
      if (wg) {
        wgmma_ss_tf32<BQ_>(
            dp, desc_k_major<D, R, 4>(base + 2 * KT, 0, k0),
            desc_k_major<D, BQ_, 4>(base + q_tile(st, 2), 0, k0), 1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // P^T = exp(scale S^T - lse[q]) (warpgroup 0 keeps it) and
    // dS^T = P^T (dP^T - delta[q]) (warpgroup 1) on the fragments, as the
    // bf16 kernel. Columns past S get p = 0.
    const int q0 = q_start + t * BQ_;
    const float* lse_t = stats + 2 * st * BQ_;
    const float* delta_t = lse_t + BQ_;
#pragma unroll
    for (int i = 0; i < BQ_ / 2; ++i) {
      const int j = frag_col(tid, i);
      const int qpos = q0 + j;
      float x = s[i] * scale;
      if (causal && qpos < kpos[(i / 2) % 2]) x = NEG_INF;
      const float p = qpos < S ? exp2f((x - lse_t[j]) * LOG2E) : 0.f;
      s[i] = wg ? p * (dp[i] - delta_t[j]) : p;
    }

    // dV += P^T.dO (B: dO^T, tiles 6-7) or dK += dS^T.Q (B: Q^T, tiles
    // 4-5) in TF32 x3, the A operand split in registers (no rounding: dO
    // and q are f32).
    const int bt = wg ? 4 : 6;
    uint32_t a_big[BQ_ / 8][4], a_small[BQ_ / 8][4];
#pragma unroll
    for (int kk = 0; kk < BQ_ / 8; ++kk) {
      frag_to_a_tf32(s, kk, a_big[kk], a_small[kk]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ_ / 8; ++kk) {
      const int k0 = kk * 8;
      wgmma_rs_tf32<D>(
          acc, a_small[kk],
          desc_k_major<BQ_, D, 4>(base + q_tile(st, bt), 0, k0), 1);
      wgmma_rs_tf32<D>(
          acc, a_big[kk],
          desc_k_major<BQ_, D, 4>(base + q_tile(st, bt + 1), 0, k0), 1);
    }
#pragma unroll
    for (int kk = 0; kk < BQ_ / 8; ++kk) {
      wgmma_rs_tf32<D>(
          acc, a_big[kk],
          desc_k_major<BQ_, D, 4>(base + q_tile(st, bt), 0, kk * 8), 1);
    }
    wgmma_commit();
    if (STAGES == 2 && more) {  // the next tile into the other stage
      cp_async_wait<0>();
      store_q_tile(st ^ 1);
      fence_proxy_async();
    }
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < BQ_ / 8; ++kk) {
      fence_regs(a_big[kk]);
      fence_regs(a_small[kk]);
    }
    __syncthreads();  // stage st is free
    if (STAGES == 1 && more) {  // one stage: the next tile after the wait
      cp_async_wait<0>();
      store_q_tile(0);
      fence_proxy_async();
      __syncthreads();
    }
  }

  // dK's scale is applied once here, as in the bf16 kernel. Warpgroup 0
  // stages dV in k's big tile, warpgroup 1 dK in v's.
  const float mul[2] = {wg ? scale : 1.f, wg ? scale : 1.f};
  stage_frag_f32<D>(smem + 2 * wg * KT, acc, mul, tid);
  __syncthreads();
  if (wg) {
    store_tile<D, R>(dk + b * dks.b + h * dks.h, dks.s, smem + 2 * KT, kv0, S,
                     tid);
  } else {
    store_tile<D, R>(dv + b * dvs.b + h * dvs.h, dvs.s, smem, kv0, S, tid);
  }
}

// ----------------------------------------------------------------- launch

struct BwdArgs {
  const void *q, *k, *v, *g;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int B, S, H, causal;
  float scale;
  Strides qs, ks, vs, gs, dqs, dks, dvs;
};

template <int D>
int launch_dq_f32(const BwdArgs& a, cudaStream_t stream) {
  using T = float;
  return launch_kernel(
      flash_bwd_dq_f32_kernel<D>,
      dim3((a.S + DQ_ROWS - 1) / DQ_ROWS, a.H, a.B), WG_THREADS,
      dq_f32_smem<D>(), stream, static_cast<const T*>(a.q),
      static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.g), a.lse, a.delta, static_cast<T*>(a.dq),
      a.S, a.H, a.causal, a.scale, a.qs, a.ks, a.vs, a.gs, a.dqs);
}

template <int D>
int launch_dq_bf16(const BwdArgs& a, cudaStream_t stream) {
  using T = __nv_bfloat16;
  return launch_kernel(
      flash_bwd_dq_bf16_kernel<D>,
      dim3((a.S + DQ_ROWS - 1) / DQ_ROWS, a.H, a.B), WG_THREADS,
      dq_bf16_smem<D>(), stream, static_cast<const T*>(a.q),
      static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.g), a.lse, a.delta, static_cast<T*>(a.dq),
      a.S, a.H, a.causal, a.scale, a.qs, a.ks, a.vs, a.gs, a.dqs);
}

template <int D>
int launch_dkv_f32(const BwdArgs& a, cudaStream_t stream) {
  using T = float;
  return launch_kernel(
      flash_bwd_dkv_f32_kernel<D>,
      dim3((a.S + DKV_ROWS - 1) / DKV_ROWS, a.H, a.B), DKV_F32_THREADS,
      dkv_f32_smem<D>(), stream, static_cast<const T*>(a.q),
      static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.g), a.lse, a.delta, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.S, a.H, a.causal, a.scale, a.qs, a.ks, a.vs,
      a.gs, a.dks, a.dvs);
}

template <int D>
int launch_dkv_bf16(const BwdArgs& a, cudaStream_t stream) {
  using T = __nv_bfloat16;
  return launch_kernel(
      flash_bwd_dkv_bf16_kernel<D>,
      dim3((a.S + DKV_ROWS - 1) / DKV_ROWS, a.H, a.B), WG_THREADS,
      dkv_bf16_smem<D>(), stream, static_cast<const T*>(a.q),
      static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.g), a.lse, a.delta, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.S, a.H, a.causal, a.scale, a.qs, a.ks, a.vs,
      a.gs, a.dks, a.dvs);
}

// which: 0 = dq, 1 = dk/dv.
int dispatch(int which, int dtype, int D, const BwdArgs& a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  return by_head_dim(D, [&](auto d) {
    constexpr int DD = decltype(d)::value;
    if (which == 0) {
      return dtype == 1 ? launch_dq_bf16<DD>(a, st)
                        : launch_dq_f32<DD>(a, st);
    }
    return dtype == 1 ? launch_dkv_bf16<DD>(a, st)
                      : launch_dkv_f32<DD>(a, st);
  });
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each entry returns a cudaError_t (0 on
// success). Strides are element strides of [B, S, H, D] tensors: (b, s, h).

extern "C" int raydp_flash_bwd_delta(
    const void* o, const void* g, float* delta, int dtype, int B, int S,
    int H, int D, long long o_sb, long long o_ss, long long o_sh,
    long long g_sb, long long g_ss, long long g_sh, void* stream) {
  const Strides os{o_sb, o_ss, o_sh}, gs{g_sb, g_ss, g_sh};
  const long long rows = (long long)B * S * H;
  if (rows == 0) return 0;
  const int threads = 256;
  const long long blocks = (rows * DELTA_TPR + threads - 1) / threads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    flash_bwd_delta_kernel<float><<<(unsigned)blocks, threads, 0, st>>>(
        static_cast<const float*>(o), static_cast<const float*>(g), delta, S,
        H, D, rows, os, gs);
  } else if (dtype == 1) {
    flash_bwd_delta_kernel<__nv_bfloat16>
        <<<(unsigned)blocks, threads, 0, st>>>(
            static_cast<const __nv_bfloat16*>(o),
            static_cast<const __nv_bfloat16*>(g), delta, S, H, D, rows, os,
            gs);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int raydp_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* g,
    const float* lse, const float* delta, void* dq, int dtype, int B, int S,
    int H, int D, int causal, float scale, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long g_sb,
    long long g_ss, long long g_sh, long long dq_sb, long long dq_ss,
    long long dq_sh, void* stream) {
  BwdArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.g = g;
  a.lse = lse;
  a.delta = delta;
  a.dq = dq;
  a.B = B;
  a.S = S;
  a.H = H;
  a.causal = causal;
  a.scale = scale;
  a.qs = Strides{q_sb, q_ss, q_sh};
  a.ks = Strides{k_sb, k_ss, k_sh};
  a.vs = Strides{v_sb, v_ss, v_sh};
  a.gs = Strides{g_sb, g_ss, g_sh};
  a.dqs = Strides{dq_sb, dq_ss, dq_sh};
  return dispatch(0, dtype, D, a, stream);
}

extern "C" int raydp_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* g,
    const float* lse, const float* delta, void* dk, void* dv, int dtype,
    int B, int S, int H, int D, int causal, float scale, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long g_sb, long long g_ss, long long g_sh, long long dk_sb,
    long long dk_ss, long long dk_sh, long long dv_sb, long long dv_ss,
    long long dv_sh, void* stream) {
  BwdArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.g = g;
  a.lse = lse;
  a.delta = delta;
  a.dk = dk;
  a.dv = dv;
  a.B = B;
  a.S = S;
  a.H = H;
  a.causal = causal;
  a.scale = scale;
  a.qs = Strides{q_sb, q_ss, q_sh};
  a.ks = Strides{k_sb, k_ss, k_sh};
  a.vs = Strides{v_sb, v_ss, v_sh};
  a.gs = Strides{g_sb, g_ss, g_sh};
  a.dks = Strides{dk_sb, dk_ss, dk_sh};
  a.dvs = Strides{dv_sb, dv_ss, dv_sh};
  return dispatch(1, dtype, D, a, stream);
}

// The resources (see kernel_resources) of the dq (which 0) or dk/dv
// (which 1) kernel for dtype and D.
extern "C" int raydp_flash_bwd_resources(int* out, int which, int dtype,
                                         int D, void* stream) {
  (void)stream;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  return by_head_dim(D, [&](auto d) {
    constexpr int DD = decltype(d)::value;
    if (which == 0) {
      return dtype == 1
                 ? kernel_resources(flash_bwd_dq_bf16_kernel<DD>, WG_THREADS,
                                    dq_bf16_smem<DD>(), out)
                 : kernel_resources(flash_bwd_dq_f32_kernel<DD>, WG_THREADS,
                                    dq_f32_smem<DD>(), out);
    }
    return dtype == 1
               ? kernel_resources(flash_bwd_dkv_bf16_kernel<DD>, WG_THREADS,
                                  dkv_bf16_smem<DD>(), out)
               : kernel_resources(flash_bwd_dkv_f32_kernel<DD>,
                                  DKV_F32_THREADS, dkv_f32_smem<DD>(), out);
  });
}
