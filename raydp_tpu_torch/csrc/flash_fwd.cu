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
// What bounds it: at the BERT-GLUE shape (B 32, S 128, H 12, D 64) q, k,
// v and o are 25.2 MB per launch in bf16 and 50.5 MB in f32, 7.5 and 15.1
// us at the data-sheet 3.35 TB/s. The 1.61 GFLOP take 1.6 us at 989
// TFLOP/s bf16, and 9.8 us as three TF32 products each at 495 TFLOP/s,
// so the function is memory-bound on the H100 in both types. Two kernels
// compute it, one warpgroup (128 threads) per (64 query rows, head,
// batch):
//
// bf16, flash_fwd_bf16_kernel: Q is copied into shared memory once; K and
// V tiles of 64 rows arrive by 16-byte cp.async into a two-stage ring, so
// tile t + 1 is in flight while tile t is multiplied. S = Q.K^T is a wgmma
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
// f32, flash_fwd_f32_kernel: the same plan with every product a tf32
// wgmma taken three times (TF32 x3, hopper_mma.cuh). One TF32 product
// keeps ~11 bits of each operand and misses the f32 bound (rtol 2e-4);
// big.big + big.small + small.big, with x split into a TF32 big part and
// its exact f32 remainder, is off by ~2^-21 of each product, and at 495/3
// TFLOP/s it still takes less time than the bytes (f32 FMAs on the CUDA
// cores would take 24 us). tf32 operands must be K-major, so V is kept
// transposed: each V tile lands raw by cp.async a tile ahead, then is
// split and written as V^T with the kv positions in the A fragment's
// order (tf32_slot), and P stays in registers as the A operand of
// O += P.V. Q and K arrive by cp.async and are split in place. kv tiles
// are 32 rows in a two-stage ring: 105 KB of shared memory at D 64 (2 CTAs
// per SM), 209 KB at D 128.
//
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

// -------------------------------------------------------------------- f32

constexpr int F32_KV = 32;  // kv rows per tile of the f32 kernel

template <int D>
__host__ __device__ constexpr size_t fwd_f32_smem() {
  // q big and small (q big then the output staging); k big and small and
  // v^T (D x 32) big and small, two stages each; the next v tile as it
  // lands; the alignment slack.
  using L = TileLayout<D, 4>;
  return 2 * (size_t)L::template bytes<FWD_ROWS>() +
         9 * (size_t)L::template bytes<F32_KV>() + 1024;
}

template <int D>
__global__ void __launch_bounds__(WG_THREADS)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int S, int H, int causal,
                         float scale, Strides qs, Strides ks, Strides vs,
                         Strides os) {
  constexpr int R = FWD_ROWS, KV = F32_KV;
  using L = TileLayout<D, 4>;
  constexpr uint32_t QT = L::template bytes<R>();
  constexpr uint32_t KT = L::template bytes<KV>();  // and v^T's D x KV
  static_assert(fwd_f32_smem<D>() <= 232448, "shared memory budget");
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem;
  const uint32_t base = aligned_smem(smem_raw, &smem);
  // Byte offsets: q big at 0, q small at QT; stage st's k big, k small,
  // v^T big and v^T small from kv_tile(st, 0) on; the raw v tile at V_RAW.
  auto kv_tile = [](int st, int j) -> uint32_t {
    return 2 * QT + (4 * st + j) * KT;
  };
  constexpr uint32_t V_RAW = 2 * QT + 8 * KT;
  using VRaw = RawTile<D, KV>;

  const int q0 = blockIdx.x * R;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  // This thread's two query rows in the accumulator fragment.
  const int qpos[2] = {q0 + frag_row(tid, 0), q0 + frag_row(tid, 2)};

  const int kv_end = causal ? min(S, q0 + R) : S;
  const int n_tiles = (kv_end + KV - 1) / KV;

  load_tile<D, R>(base, qb, qs.s, q0, S, tid);
  load_tile<D, KV>(base + kv_tile(0, 0), kb, ks.s, 0, S, tid);
  VRaw::load(base + V_RAW, vb, vs.s, 0, S, tid);
  cp_async_commit();
  cp_async_wait<0>();
  split_tile<D, R>(smem, smem + QT, tid);
  split_tile<D, KV>(smem + kv_tile(0, 0), smem + kv_tile(0, 1), tid);
  VRaw::store_t(smem + V_RAW, smem + kv_tile(0, 2), smem + kv_tile(0, 3),
                tid);
  fence_proxy_async();
  __syncthreads();

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1, nx = st ^ 1;
    const bool more = t + 1 < n_tiles;
    if (more) {  // the next tile's copies run under this tile's products
      load_tile<D, KV>(base + kv_tile(nx, 0), kb, ks.s, (t + 1) * KV, S,
                       tid);
      VRaw::load(base + V_RAW, vb, vs.s, (t + 1) * KV, S, tid);
      cp_async_commit();
    }

    // S = Q.K^T in TF32 x3, both operands K-major in shared memory: the
    // two small products, then big.big, into one accumulator.
    float sc[KV / 2];
#pragma unroll
    for (int i = 0; i < KV / 2; ++i) sc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const int k0 = kk * 8;
      wgmma_ss_tf32<KV>(
          sc, desc_k_major<D, R, 4>(base, 0, k0),
          desc_k_major<D, KV, 4>(base + kv_tile(st, 1), 0, k0), 1);
      wgmma_ss_tf32<KV>(
          sc, desc_k_major<D, R, 4>(base + QT, 0, k0),
          desc_k_major<D, KV, 4>(base + kv_tile(st, 0), 0, k0), 1);
    }
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const int k0 = kk * 8;
      wgmma_ss_tf32<KV>(
          sc, desc_k_major<D, R, 4>(base, 0, k0),
          desc_k_major<D, KV, 4>(base + kv_tile(st, 0), 0, k0), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // Online softmax on the fragment, as the bf16 kernel.
    const int kv0 = t * KV;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < KV / 2; ++i) {
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
    for (int i = 0; i < KV / 2; ++i) {
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

    // O += P.V in TF32 x3: P split in registers is the A operand (P in
    // V's dtype, f32, so no rounding), V^T big and small the B operands.
    uint32_t pb[KV / 8][4], ps[KV / 8][4];
#pragma unroll
    for (int kk = 0; kk < KV / 8; ++kk) {
      frag_to_a_tf32(sc, kk, pb[kk], ps[kk]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KV / 8; ++kk) {
      const int k0 = kk * 8;
      wgmma_rs_tf32<D>(acc, ps[kk],
                       desc_k_major<KV, D, 4>(base + kv_tile(st, 2), 0, k0), 1);
      wgmma_rs_tf32<D>(acc, pb[kk],
                       desc_k_major<KV, D, 4>(base + kv_tile(st, 3), 0, k0), 1);
    }
#pragma unroll
    for (int kk = 0; kk < KV / 8; ++kk) {
      wgmma_rs_tf32<D>(
          acc, pb[kk],
          desc_k_major<KV, D, 4>(base + kv_tile(st, 2), 0, kk * 8), 1);
    }
    wgmma_commit();
    if (more) {  // split the next tile into the other stage meanwhile
      cp_async_wait<0>();
      split_tile<D, KV>(smem + kv_tile(nx, 0), smem + kv_tile(nx, 1), tid);
      VRaw::store_t(smem + V_RAW, smem + kv_tile(nx, 2),
                    smem + kv_tile(nx, 3), tid);
      fence_proxy_async();
    }
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < KV / 8; ++kk) {
      fence_regs(pb[kk]);
      fence_regs(ps[kk]);
    }
    __syncthreads();  // stage st is free, stage nx is ready
  }

  float inv[2], ls[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    ls[r] = fmaxf(l[r], 1e-30f);
    inv[r] = 1.f / ls[r];
  }
  stage_frag_f32<D>(smem, acc, inv, tid);  // into q's big tile
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
  return launch_kernel(flash_fwd_f32_kernel<D>,
                       dim3((a.S + FWD_ROWS - 1) / FWD_ROWS, a.H, a.B),
                       WG_THREADS, fwd_f32_smem<D>(), stream,
                       static_cast<const T*>(a.q), static_cast<const T*>(a.k),
                       static_cast<const T*>(a.v), static_cast<T*>(a.o),
                       a.lse, a.S, a.H, a.causal, a.scale, a.qs, a.ks, a.vs,
                       a.os);
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
               : kernel_resources(flash_fwd_f32_kernel<DD>, WG_THREADS,
                                  fwd_f32_smem<DD>(), out);
  });
}
