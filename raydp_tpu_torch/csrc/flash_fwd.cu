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
// Grid: one CTA per (q tile of BQ rows, head, batch). The TPU's sequential
// kv grid axis becomes the loop inside the CTA: each pass stages one BKV-row
// K/V tile in shared memory (as f32) and carries the running max m, sum l
// and the f32 accumulator in registers. Four threads share a query row:
// each computes a quarter of the row's scores and owns a quarter of its D
// output columns; the row max and sum are reduced with warp shuffles.
// Causal: kv tiles that start past the CTA's last query row are skipped.
//
// What bounds it: at the BERT-GLUE shape (B 32, S 128, H 12, D 64, bf16)
// q, k, v and o are 25.2 MB per launch, 7.5 us at the data-sheet 3.35 TB/s,
// and the 1.61 GFLOP are 1.6 us at 989 TFLOP/s bf16, so the function is
// memory-bound on the H100. This first kernel is simpler than that: its
// products run as scalar f32 FMAs on the CUDA cores (67 TFLOP/s peak, 24 us
// for the same work) with shared-memory operands, so the FP32 pipe and
// shared-memory bandwidth bound it, not HBM. Tensor-core MMA (mma.sync or
// wgmma), TMA staging and pipelined tiles are the later work that moves it
// toward the HBM bound.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libflash_fwd.so flash_fwd.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;             // query rows per CTA
constexpr int BKV = 64;            // key/value rows per shared-memory tile
constexpr int TPR = 4;             // threads per query row
constexpr int THREADS = BQ * TPR;  // 256
constexpr float NEG_INF = -1e30f;  // the TPU kernel's causal mask value

struct Strides {
  long long b, s, h;  // element strides; the D dimension is contiguous
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

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

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int S, int H, int causal, float scale, Strides qs,
           Strides ks, Strides vs, Strides os, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, S, H, causal, scale,
      qs, ks, vs, os);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int S, int H, int causal, float scale,
               Strides qs, Strides ks, Strides vs, Strides os,
               cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, o, lse, B, S, H, causal, scale, qs, ks,
                           vs, os, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, lse, B, S, H, causal, scale, qs, ks,
                           vs, os, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, B, S, H, causal, scale, qs, ks,
                           vs, os, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, B, S, H, causal, scale, qs, ks,
                            vs, os, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
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
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch_d<float>(D, q, k, v, o, lse, B, S, H, causal, scale, qs,
                             ks, vs, os, st);
  }
  if (dtype == 1) {
    return dispatch_d<__nv_bfloat16>(D, q, k, v, o, lse, B, S, H, causal,
                                     scale, qs, ks, vs, os, st);
  }
  return (int)cudaErrorInvalidValue;
}
