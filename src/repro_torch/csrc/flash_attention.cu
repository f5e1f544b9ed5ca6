// Flash-attention forward for Hopper (sm_90a), f32 and bf16.
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention` in
// src/repro/kernels/flash_attention.py and computes the same function:
// online-softmax attention with f32 running max m, denominator l and
// accumulator acc; scale 1/sqrt(hd); GQA kv head h*KV/H; top-left causal
// mask kpos <= qpos; sliding window kpos > qpos - window; padded keys
// masked; key tiles that no query of the block can see are skipped; a row
// with no visible key gives 0.
//
// Layout as in the JAX package: q (B, Sq, H, hd), k/v (B, Sk, KV, hd),
// o (B, Sq, H, hd), all contiguous.
//
// Design (first, simple version): one thread block per (64-query tile, h, b);
// four threads share a query row, each owning every fourth head-dim element
// of q and acc in registers, so a score is four partial dot products joined
// by two warp shuffles.  K and V tiles of 32 keys are staged through shared
// memory as f32.  Products run as FMAs on the CUDA cores: at the prefill
// shapes of the serving path this work is bounded by operations, and
// tensor cores (mma.sync / wgmma) with TMA loads are the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BLOCK_Q = 64;               // query rows per thread block
constexpr int BLOCK_K = 32;               // keys per shared-memory tile
constexpr int LANES = 4;                  // threads per query row
constexpr int THREADS = BLOCK_Q * LANES;  // 256

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
                 int H, int KV, float scale, int causal, int window) {
  constexpr int PER = HD / LANES;  // head-dim elements owned by one thread
  __shared__ float ks[BLOCK_K][HD];
  __shared__ float vs[BLOCK_K][HD];

  const int tid = threadIdx.x;
  const int row = tid / LANES;
  const int lane = tid % LANES;  // owns dims lane, lane + LANES, ...
  const int q_start = blockIdx.x * BLOCK_Q;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h * KV / H;
  const int qpos = q_start + row;
  const bool row_ok = qpos < Sq;

  float qr[PER];
  float acc[PER];
  const T* qrow = q + ((size_t)b * Sq + (row_ok ? qpos : 0)) * H * HD +
                  (size_t)h * HD;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    qr[i] = row_ok ? to_f32(qrow[lane + i * LANES]) : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  // keys any query of this tile can see: [k_begin, k_end)
  const int q_last = min(q_start + BLOCK_Q, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  int k_begin = window > 0 ? max(0, q_start - window + 1) : 0;
  k_begin = (k_begin / BLOCK_K) * BLOCK_K;

  for (int k0 = k_begin; k0 < k_end; k0 += BLOCK_K) {
    __syncthreads();  // the previous tile is no longer read
    for (int idx = tid; idx < BLOCK_K * HD; idx += THREADS) {
      const int j = idx / HD;
      const int d = idx % HD;
      const int kp = k0 + j;
      float kk = 0.f, vv = 0.f;
      if (kp < Sk) {
        const size_t off = (((size_t)b * Sk + kp) * KV + g) * HD + d;
        kk = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      ks[j][d] = kk;
      vs[j][d] = vv;
    }
    __syncthreads();

    float s[BLOCK_K];
    float m_tile = -INFINITY;
#pragma unroll
    for (int j = 0; j < BLOCK_K; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < PER; ++i)
        part = fmaf(qr[i], ks[j][lane + i * LANES], part);
      // all 32 lanes take part, rows past Sq included
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int kp = k0 + j;
      bool ok = kp < Sk;
      if (causal) ok = ok && kp <= qpos;
      if (window > 0) ok = ok && kp > qpos - window;
      s[j] = ok ? part * scale : -INFINITY;
      m_tile = fmaxf(m_tile, s[j]);
    }
    const float m_new = fmaxf(m, m_tile);
    if (m_new == -INFINITY) continue;  // no key of this row seen yet
    const float alpha = expf(m - m_new);  // 0 while m is still -inf
    l *= alpha;
#pragma unroll
    for (int i = 0; i < PER; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < BLOCK_K; ++j) {
      const float p = expf(s[j] - m_new);  // masked keys: exp(-inf) = 0
      l += p;
#pragma unroll
      for (int i = 0; i < PER; ++i)
        acc[i] = fmaf(p, vs[j][lane + i * LANES], acc[i]);
    }
    m = m_new;
  }

  if (!row_ok) return;
  T* orow = o + ((size_t)b * Sq + qpos) * H * HD + (size_t)h * HD;
#pragma unroll
  for (int i = 0; i < PER; ++i)
    store(orow + lane + i * LANES, l > 0.f ? acc[i] / l : 0.f);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int H, int KV, int hd, int causal, int window,
           cudaStream_t stream) {
  const dim3 grid((Sq + BLOCK_Q - 1) / BLOCK_Q, H, B);
  const float scale = 1.0f / sqrtf((float)hd);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
#define REPRO_FA_CASE(HD_)                                               \
  case HD_:                                                              \
    flash_fwd_kernel<T, HD_><<<grid, THREADS, 0, stream>>>(              \
        qt, kt, vt, ot, Sq, Sk, H, KV, scale, causal, window);           \
    break;
  switch (hd) {
    REPRO_FA_CASE(16)
    REPRO_FA_CASE(32)
    REPRO_FA_CASE(48)
    REPRO_FA_CASE(64)
    REPRO_FA_CASE(80)
    REPRO_FA_CASE(96)
    REPRO_FA_CASE(112)
    REPRO_FA_CASE(128)
    default:
      return -1;
  }
#undef REPRO_FA_CASE
  return (int)cudaGetLastError();
}

}  // namespace

// Returns 0 on success, -1 for an unsupported head dim or dtype, else the
// cudaError_t of the launch.
extern "C" int repro_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, void* o, int B,
                                         int Sq, int Sk, int H, int KV,
                                         int hd, int causal, int window,
                                         int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, KV, hd, causal,
                                 window, s);
  return launch<float>(q, k, v, o, B, Sq, Sk, H, KV, hd, causal, window, s);
}
