// Flash-attention backward for Hopper (sm_90a): the delta pre-pass and
// the dq and dk/dv kernels.
//
// Replaces the TPU kernels of raydp_tpu/ops/flash_attention.py launched by
// `_flash_bwd_rule`:
//   flash_bwd_delta_kernel   <- the delta einsum, delta = rowsum(dO * O)
//                               in f32 (an XLA op there, a pre-pass here);
//   flash_bwd_dq_bf16_kernel,
//   flash_bwd_dq_kernel      <- `_bwd_dq_kernel` (bf16, f32);
//   flash_bwd_dkv_bf16_kernel,
//   flash_bwd_dkv_kernel     <- `_bwd_dkv_kernel` (bf16, f32).
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
// at 989 TFLOP/s bf16: memory-bound on the H100.
//
// The bf16 kernels are one warpgroup (128 threads) per 64-row tile, with
// wgmma products on the tensor cores, tiles copied by 16-byte cp.async in
// the swizzled layout of hopper_mma.cuh, and the rounded P and dS kept in
// registers as the A operand of the second product:
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
// dq and dk/dv in f32: the first, scalar design, kept because TF32 cannot
// meet the f32 bound. Four threads share a tile row; operand tiles are
// staged in shared memory as f32, padded by one column against bank
// conflicts; p and ds go through shared memory to the second product;
// every product is a scalar f32 FMA, so the FP32 pipe and shared-memory
// bandwidth bound them, not HBM. The delta pass is a plain streaming
// reduction and reads O and dO once.
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

// --------------------------------------------------------------------- dq

template <int D>
constexpr size_t dq_smem_bytes() {
  // q_s, g_s [BQ][D+1]; k_s, v_s [BKV][D+1]; ds_s [BQ][BKV+1]; all f32.
  return sizeof(float) *
         (size_t)(2 * BQ * (D + 1) + 2 * BKV * (D + 1) + BQ * (BKV + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ g,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int S, int H, int causal, float scale, Strides qs,
                        Strides ks, Strides vs, Strides gs, Strides dqs) {
  static_assert(D % TPR == 0 && BKV % TPR == 0, "tile shape");
  constexpr int DP = D + 1;
  constexpr int KP = BKV + 1;
  constexpr int NJ = BKV / TPR;  // scores per thread per kv tile
  constexpr int ND = D / TPR;    // dq columns per thread

  extern __shared__ float smem[];
  float* q_s = smem;
  float* g_s = q_s + BQ * DP;
  float* k_s = g_s + BQ * DP;
  float* v_s = k_s + BKV * DP;
  float* ds_s = v_s + BKV * DP;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int lane = tid % TPR;
  const int qpos = q0 + row;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  const T* gb = g + b * gs.b + h * gs.h;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D, s = q0 + r;
    float qq = 0.f, gg = 0.f;
    if (s < S) {
      qq = to_f32(qb[s * qs.s + d]);
      gg = to_f32(gb[s * gs.s + d]);
    }
    q_s[r * DP + d] = qq;
    g_s[r * DP + d] = gg;
  }
  // lse and delta are defined only for rows inside the sequence.
  const long long row_base = ((long long)b * H + h) * S;
  const float lse_r = qpos < S ? lse[row_base + qpos] : 0.f;
  const float delta_r = qpos < S ? delta[row_base + qpos] : 0.f;

  float acc[ND];
#pragma unroll
  for (int t = 0; t < ND; ++t) acc[t] = 0.f;

  // Causal: kv tiles that start past the CTA's last query row are skipped.
  const int kv_end = causal ? min(S, q0 + BQ) : S;
  for (int kv0 = 0; kv0 < kv_end; kv0 += BKV) {
    __syncthreads();  // the previous tile's readers are done (Q is staged)
    for (int i = tid; i < BKV * D; i += THREADS) {
      const int r = i / D, d = i % D, s = kv0 + r;
      float kk = 0.f, vv = 0.f;
      if (s < S) {
        kk = to_f32(kb[s * ks.s + d]);
        vv = to_f32(vb[s * vs.s + d]);
      }
      k_s[r * DP + d] = kk;
      v_s[r * DP + d] = vv;
    }
    __syncthreads();

#pragma unroll 4
    for (int jj = 0; jj < NJ; ++jj) {
      const int j = lane + jj * TPR;
      const int kpos = kv0 + j;
      float sdot = 0.f, dpdot = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) {
        sdot = fmaf(q_s[row * DP + d], k_s[j * DP + d], sdot);
        dpdot = fmaf(g_s[row * DP + d], v_s[j * DP + d], dpdot);
      }
      float sc = sdot * scale;
      if (causal && qpos < kpos) sc = NEG_INF;
      const float p = kpos < S ? expf(sc - lse_r) : 0.f;
      // ds.astype(k.dtype) before ds . k, as the TPU kernel feeds its MXU.
      ds_s[row * KP + j] = round_to<T>(p * (dpdot - delta_r));
    }
    __syncwarp();  // a row's ds is written and read by its own four lanes

#pragma unroll
    for (int t = 0; t < ND; ++t) {
      const int d = lane + t * TPR;
      float a = 0.f;
#pragma unroll 16
      for (int j = 0; j < BKV; ++j) {
        a = fmaf(ds_s[row * KP + j], k_s[j * DP + d], a);
      }
      acc[t] += a * scale;  // scaled per tile product, as the TPU kernel
    }
  }

  if (qpos < S) {
    T* out = dq + b * dqs.b + qpos * dqs.s + h * dqs.h;
#pragma unroll
    for (int t = 0; t < ND; ++t) out[lane + t * TPR] = from_f32<T>(acc[t]);
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

// ------------------------------------------------------------------ dk/dv

template <int D>
constexpr size_t dkv_smem_bytes() {
  // k_s, v_s [BKV][D+1]; q_s, g_s [BQ][D+1]; p_s, ds_s [BKV][BQ+1];
  // lse_s, delta_s [BQ]; all f32.
  return sizeof(float) * (size_t)(2 * BKV * (D + 1) + 2 * BQ * (D + 1) +
                                  2 * BKV * (BQ + 1) + 2 * BQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ g,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, int S, int H,
                         int causal, float scale, Strides qs, Strides ks,
                         Strides vs, Strides gs, Strides dks, Strides dvs) {
  static_assert(D % TPR == 0 && BQ % TPR == 0, "tile shape");
  static_assert(THREADS == BKV * TPR, "one thread group per kv row");
  constexpr int DP = D + 1;
  constexpr int QP = BQ + 1;
  constexpr int NI = BQ / TPR;  // scores per thread per q tile
  constexpr int ND = D / TPR;   // dk and dv columns per thread

  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + BKV * DP;
  float* q_s = v_s + BKV * DP;
  float* g_s = q_s + BQ * DP;
  float* p_s = g_s + BQ * DP;
  float* ds_s = p_s + BKV * QP;
  float* lse_s = ds_s + BKV * QP;
  float* delta_s = lse_s + BQ;

  const int kv0 = blockIdx.x * BKV;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int row = tid / TPR;  // this thread group's kv row
  const int lane = tid % TPR;
  const int kpos = kv0 + row;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  const T* gb = g + b * gs.b + h * gs.h;
  const long long row_base = ((long long)b * H + h) * S;

  for (int i = tid; i < BKV * D; i += THREADS) {
    const int r = i / D, d = i % D, s = kv0 + r;
    float kk = 0.f, vv = 0.f;
    if (s < S) {
      kk = to_f32(kb[s * ks.s + d]);
      vv = to_f32(vb[s * vs.s + d]);
    }
    k_s[r * DP + d] = kk;
    v_s[r * DP + d] = vv;
  }

  float dk_acc[ND], dv_acc[ND];
#pragma unroll
  for (int t = 0; t < ND; ++t) {
    dk_acc[t] = 0.f;
    dv_acc[t] = 0.f;
  }

  // Causal: q tiles that end before this kv tile starts are skipped.
  const int q_start = causal ? (kv0 / BQ) * BQ : 0;
  for (int q0 = q_start; q0 < S; q0 += BQ) {
    __syncthreads();  // the previous q tile's readers are done
    for (int i = tid; i < BQ * D; i += THREADS) {
      const int r = i / D, d = i % D, s = q0 + r;
      float qq = 0.f, gg = 0.f;
      if (s < S) {
        qq = to_f32(qb[s * qs.s + d]);
        gg = to_f32(gb[s * gs.s + d]);
      }
      q_s[r * DP + d] = qq;
      g_s[r * DP + d] = gg;
    }
    for (int i = tid; i < BQ; i += THREADS) {
      const int s = q0 + i;
      lse_s[i] = s < S ? lse[row_base + s] : 0.f;
      delta_s[i] = s < S ? delta[row_base + s] : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int ii = 0; ii < NI; ++ii) {
      const int i = lane + ii * TPR;
      const int qpos = q0 + i;
      float sdot = 0.f, dpdot = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) {
        sdot = fmaf(q_s[i * DP + d], k_s[row * DP + d], sdot);
        dpdot = fmaf(g_s[i * DP + d], v_s[row * DP + d], dpdot);
      }
      float sc = sdot * scale;
      if (causal && qpos < kpos) sc = NEG_INF;
      const float p = qpos < S ? expf(sc - lse_s[i]) : 0.f;
      const float ds = p * (dpdot - delta_s[i]);
      // p.astype(dO.dtype) and ds.astype(q.dtype) before the products.
      p_s[row * QP + i] = round_to<T>(p);
      ds_s[row * QP + i] = round_to<T>(ds);
    }
    __syncwarp();  // a row's p and ds are written and read by its own lanes

#pragma unroll
    for (int t = 0; t < ND; ++t) {
      const int d = lane + t * TPR;
      float av = 0.f, ak = 0.f;
#pragma unroll 16
      for (int i = 0; i < BQ; ++i) {
        av = fmaf(p_s[row * QP + i], g_s[i * DP + d], av);
        ak = fmaf(ds_s[row * QP + i], q_s[i * DP + d], ak);
      }
      dv_acc[t] += av;
      dk_acc[t] += ak * scale;  // scaled per tile product, as the TPU kernel
    }
  }

  if (kpos < S) {
    T* dk_row = dk + b * dks.b + kpos * dks.s + h * dks.h;
    T* dv_row = dv + b * dvs.b + kpos * dvs.s + h * dvs.h;
#pragma unroll
    for (int t = 0; t < ND; ++t) {
      dk_row[lane + t * TPR] = from_f32<T>(dk_acc[t]);
      dv_row[lane + t * TPR] = from_f32<T>(dv_acc[t]);
    }
  }
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
      flash_bwd_dq_kernel<T, D>, dim3((a.S + BQ - 1) / BQ, a.H, a.B),
      THREADS, dq_smem_bytes<D>(), stream, static_cast<const T*>(a.q),
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
      flash_bwd_dkv_kernel<T, D>, dim3((a.S + BKV - 1) / BKV, a.H, a.B),
      THREADS, dkv_smem_bytes<D>(), stream, static_cast<const T*>(a.q),
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
                 : kernel_resources(flash_bwd_dq_kernel<float, DD>, THREADS,
                                    dq_smem_bytes<DD>(), out);
    }
    return dtype == 1
               ? kernel_resources(flash_bwd_dkv_bf16_kernel<DD>, WG_THREADS,
                                  dkv_bf16_smem<DD>(), out)
               : kernel_resources(flash_bwd_dkv_kernel<float, DD>, THREADS,
                                  dkv_smem_bytes<DD>(), out);
  });
}
