// Flash-attention forward for Hopper (sm_90a): out and row logsumexp.
//
// Replaces the TPU kernel `_flash_kernel` launched by `_flash_forward`
// in raydp_tpu/ops/flash_attention.py. Same function: online softmax over
// kv tiles with s = (q . k) * scale in f32, causal entries masked to
// -1e30, P rounded to V's dtype before P.V, f32 accumulation,
// O = acc / max(l, 1e-30) and lse = m + log(max(l, 1e-30)) of the scaled
// scores.
//
// Layout: q, k, v and o are [B, S, H, D] read and written through their
// element strides (the last dimension contiguous), so the caller's views
// of a fused qkv projection need no transpose copies. lse is f32
// [B, H, S] (the caller views it as [B, H, S, 1]).
//
// What bounds it: at the BERT-GLUE shape (B 32, S 128, H 12, D 64, bf16)
// q, k, v and o are 25.2 MB per launch, 7.5 us at the data-sheet 3.35 TB/s,
// and the 1.61 GFLOP are 1.6 us at 989 TFLOP/s bf16, so the function is
// memory-bound on the H100. Two kernels compute it:
//
// bf16, flash_fwd_bf16_kernel: one warpgroup (128 threads) per (64 query
// rows, head, batch). Q is copied into shared memory once; K and V tiles
// of 64 rows arrive by 16-byte cp.async into a two-stage ring, so tile
// t + 1 is in flight while tile t is multiplied. S = Q.K^T is a wgmma
// m64n64k16 with both operands in shared memory (both K-major, swizzled
// as hopper_mma.cuh lays tiles out); the online softmax runs on the f32
// accumulator fragment in registers (row max and sum over the four
// threads of a row by shuffles); P is rounded to bf16 in registers and is
// the register A operand of O += P.V (wgmma m64nDk16, V as an MN-major B
// operand), so P never touches shared memory. Rows and columns past S
// arrive as zeros (cp.async src-size 0, nothing read past the sequence)
// and their scores are -inf. The epilogue stages O through shared memory
// and writes it with 16-byte stores. Many CTAs per SM hide the latency
// that the two-stage ring cannot at S 128 (two kv tiles).
//
// f32, flash_fwd_kernel: the first, scalar design, kept for the f32 path
// (the decode oracle), whose bound (rtol 2e-4) TF32 cannot meet: one CTA
// per (64 query rows, head, batch), four threads per query row, K/V tiles
// staged in shared memory as f32 and every product a scalar f32 FMA.
// Causal: both skip kv tiles that start past the CTA's last query row.
//
// Build (plain C interface, loaded with ctypes; flash_common.cuh and
// hopper_mma.cuh sit beside it):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -Xptxas=-v -o libflash_fwd.so flash_fwd.cu

#include <math.h>

#include "flash_common.cuh"
#include "hopper_mma.cuh"

namespace {

using namespace raydp_flash;

template <typename T, int D>
constexpr size_t smem_bytes() {
  // q_s [BQ][D+1], k_s [BKV][D+1], v_s [BKV][D], p_s [BQ][BKV+1], all f32.
  return sizeof(float) *
         (size_t)(BQ * (D + 1) + BKV * (D + 1) + BKV * D + BQ * (BKV + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int S, int H, int causal,
                     float scale, Strides qs, Strides ks, Strides vs,
                     Strides os) {
  static_assert(D % TPR == 0 && BKV % TPR == 0, "tile shape");
  constexpr int DP = D + 1;    // padded rows: conflict-free column reads
  constexpr int KP = BKV + 1;
  constexpr int NJ = BKV / TPR;  // scores per thread per tile
  constexpr int ND = D / TPR;    // output columns per thread

  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + BQ * DP;
  float* v_s = k_s + BKV * DP;
  float* p_s = v_s + BKV * D;

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

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D, s = q0 + r;
    q_s[r * DP + d] = s < S ? to_f32(qb[s * qs.s + d]) : 0.f;
  }

  float m = NEG_INF, l = 0.f;
  float acc[ND];
#pragma unroll
  for (int t = 0; t < ND; ++t) acc[t] = 0.f;

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
      v_s[r * D + d] = vv;
    }
    __syncthreads();

    float sc[NJ];
    float tile_max = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int j = lane + jj * TPR;
      const int kpos = kv0 + j;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) {
        dot = fmaf(q_s[row * DP + d], k_s[j * DP + d], dot);
      }
      float s = dot * scale;
      if (causal && qpos < kpos) s = NEG_INF;
      if (kpos >= S) s = -INFINITY;  // past the sequence: no weight at all
      sc[jj] = s;
      tile_max = fmaxf(tile_max, s);
    }
    // The four lanes of a row are adjacent in one warp.
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const float p = expf(sc[jj] - m_new);
      psum += p;
      // P.V takes P in V's dtype, as the TPU kernel feeds its MXU.
      p_s[row * KP + lane + jj * TPR] = to_f32(from_f32<T>(p));
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * corr + psum;
    m = m_new;
    __syncwarp();  // a row's P is written and read by its own four lanes

#pragma unroll
    for (int t = 0; t < ND; ++t) {
      const int d = lane + t * TPR;
      float a = 0.f;
#pragma unroll 16
      for (int j = 0; j < BKV; ++j) {
        a = fmaf(p_s[row * KP + j], v_s[j * D + d], a);
      }
      acc[t] = acc[t] * corr + a;
    }
  }

  if (qpos < S) {
    const float ls = fmaxf(l, 1e-30f);
    T* orow = o + b * os.b + qpos * os.s + h * os.h;
#pragma unroll
    for (int t = 0; t < ND; ++t) {
      orow[lane + t * TPR] = from_f32<T>(acc[t] / ls);
    }
    if (lane == 0) {
      lse[((long long)b * H + h) * S + qpos] = m + logf(ls);
    }
  }
}

// ------------------------------------------------------------------- bf16

constexpr int FWD_ROWS = 64;  // query rows per CTA, kv rows per tile

template <int D>
constexpr size_t fwd_bf16_smem() {
  // q (then the output staging), k[2], v[2]; plus the alignment slack.
  return 5 * (size_t)TileLayout<D>::template bytes<FWD_ROWS>() + 1024;
}

template <int D>
__global__ void __launch_bounds__(WG_THREADS)
    flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int S, int H, int causal,
                          float scale, Strides qs, Strides ks, Strides vs,
                          Strides os) {
  constexpr int R = FWD_ROWS;
  constexpr uint32_t TILE = TileLayout<D>::template bytes<R>();
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem;
  const uint32_t q_s = aligned_smem(smem_raw, &smem);
  const uint32_t k_s = q_s + TILE;      // stage st at k_s + st * TILE
  const uint32_t v_s = q_s + 3 * TILE;  // stage st at v_s + st * TILE

  const int q0 = blockIdx.x * R;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + h * vs.h;
  // This thread's two query rows in the accumulator fragment.
  const int qpos[2] = {q0 + frag_row(tid, 0), q0 + frag_row(tid, 2)};

  const int kv_end = causal ? min(S, q0 + R) : S;
  const int n_tiles = (kv_end + R - 1) / R;

  load_tile<D, R>(q_s, qb, qs.s, q0, S, tid);
  load_tile<D, R>(k_s, kb, ks.s, 0, S, tid);
  load_tile<D, R>(v_s, vb, vs.s, 0, S, tid);
  cp_async_commit();

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

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

    float sc[R / 2];
#pragma unroll
    for (int i = 0; i < R / 2; ++i) sc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<R>(sc, desc_k_major<D, R>(q_s, 0, kk * 16),
                  desc_k_major<D, R>(k_s + st, 0, kk * 16), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // Online softmax on the fragment: scale, mask, row max and sum over
    // the four threads (adjacent lanes) that share a row.
    const int kv0 = t * R;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < R / 2; ++i) {
      const int kpos = kv0 + frag_col(tid, i);
      const int r = (i / 2) % 2;
      float s = sc[i] * scale;
      if (causal && qpos[r] < kpos) s = NEG_INF;
      if (kpos >= S) s = -INFINITY;  // past the sequence: no weight at all
      sc[i] = s;
      mx[r] = fmaxf(mx[r], s);
    }
    float corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = exp2f((m[r] - m_new) * LOG2E);
      m[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < R / 2; ++i) {
      const int r = (i / 2) % 2;
      sc[i] = exp2f((sc[i] - m[r]) * LOG2E);
      psum[r] += sc[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
      l[r] = l[r] * corr[r] + psum[r];
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i / 2) % 2];

    // O += P.V with P rounded to V's dtype (bf16) in registers, as the TPU
    // kernel casts p before its MXU product.
    uint32_t a[R / 16][4];
#pragma unroll
    for (int kk = 0; kk < R / 16; ++kk) frag_to_a(sc, kk, a[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < R / 16; ++kk) {
      wgmma_rs<D>(acc, a[kk], desc_mn_major<D, R>(v_s + st, kk * 16), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();  // stage t is free for tile t + 2
  }

  float inv[2], ls[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    ls[r] = fmaxf(l[r], 1e-30f);
    inv[r] = 1.f / ls[r];
  }
  stage_frag<D>(smem, acc, inv, tid);  // into q's tile, no longer read
  if (tid % 4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (qpos[r] < S) {
        lse[((long long)b * H + h) * S + qpos[r]] = m[r] + logf(ls[r]);
      }
    }
  }
  __syncthreads();
  store_tile<D, R>(o + b * os.b + h * os.h, os.s, smem, q0, S, tid);
}

struct FwdArgs {
  const void *q, *k, *v;
  void* o;
  float* lse;
  int B, S, H, causal;
  float scale;
  Strides qs, ks, vs, os;
};

template <int D>
int launch_bf16(const FwdArgs& a, cudaStream_t stream) {
  using T = __nv_bfloat16;
  return launch_kernel(flash_fwd_bf16_kernel<D>,
                       dim3((a.S + FWD_ROWS - 1) / FWD_ROWS, a.H, a.B),
                       WG_THREADS, fwd_bf16_smem<D>(), stream,
                       static_cast<const T*>(a.q), static_cast<const T*>(a.k),
                       static_cast<const T*>(a.v), static_cast<T*>(a.o),
                       a.lse, a.S, a.H, a.causal, a.scale, a.qs, a.ks, a.vs,
                       a.os);
}

template <int D>
int launch_f32(const FwdArgs& a, cudaStream_t stream) {
  using T = float;
  return launch_kernel(flash_fwd_kernel<T, D>,
                       dim3((a.S + BQ - 1) / BQ, a.H, a.B), THREADS,
                       smem_bytes<T, D>(), stream, static_cast<const T*>(a.q),
                       static_cast<const T*>(a.k), static_cast<const T*>(a.v),
                       static_cast<T*>(a.o), a.lse, a.S, a.H, a.causal,
                       a.scale, a.qs, a.ks, a.vs, a.os);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success).
extern "C" int raydp_flash_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int dtype, int B, int S, int H, int D, int causal, float scale,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    void* stream) {
  const FwdArgs a{q, k, v, o, lse, B, S, H, causal, scale,
                  Strides{q_sb, q_ss, q_sh}, Strides{k_sb, k_ss, k_sh},
                  Strides{v_sb, v_ss, v_sh}, Strides{o_sb, o_ss, o_sh}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  return by_head_dim(D, [&](auto d) {
    constexpr int DD = decltype(d)::value;
    return dtype == 1 ? launch_bf16<DD>(a, st) : launch_f32<DD>(a, st);
  });
}

// The forward kernel's resources (see kernel_resources) for dtype and D.
extern "C" int raydp_flash_fwd_resources(int* out, int dtype, int D,
                                         void* stream) {
  (void)stream;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  return by_head_dim(D, [&](auto d) {
    constexpr int DD = decltype(d)::value;
    return dtype == 1
               ? kernel_resources(flash_fwd_bf16_kernel<DD>, WG_THREADS,
                                  fwd_bf16_smem<DD>(), out)
               : kernel_resources(flash_fwd_kernel<float, DD>, THREADS,
                                  smem_bytes<float, DD>(), out);
  });
}
