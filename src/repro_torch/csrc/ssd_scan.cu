// Mamba2 SSD chunked scan for Hopper (sm_90a), f32 and bf16 inputs.
//
// Replaces the Pallas TPU kernel `_ssd_kernel` / `ssd_scan` in
// src/repro/kernels/ssd_scan.py and computes the same function: for each
// (batch b, head h) the state h (P x N, f32) is carried across the
// sequence, and per tile of steps
//
//   cum   = cumsum(dt * A)                    (inclusive)
//   G     = (C . B^T) * exp(cum_i - cum_j) * dt_j      for j <= i, else 0
//   y     = G . x + exp(cum) * (C . h^T)
//   h    <- exp(cum[-1]) * h + x^T . (exp(cum[-1] - cum) * dt * B)
//
// Layout as in the JAX package: x (B, S, nh, P), dt (B, S, nh) f32
// post-softplus, A (nh,) f32, Bm/Cm (B, S, N); y (B, S, nh, P) in the
// input type, h_final (B, nh, P, N) f32; h starts at 0.  All math is f32.
//
// The Pallas kernel carries h in VMEM across the TPU's sequential grid.
// Here one thread block per (h, b) walks the sequence itself, tile by
// tile, with h in shared memory; x, B, C and dt of a tile are staged
// through shared memory as f32.  A tile is min(chunk, 64) steps: SSD's
// result does not depend on the chunk length (tests/test_kernels.py:
// 92-107), and 64 keeps h, B, C, x and G of a tile at P=64, N=128 within
// one SM's shared memory (133,120 bytes).  Steps past S are dt=0 no-ops
// (decay 1, contribution 0), the reference's padding, done by bounds
// checks.  The upper triangle of G is never passed to exp (cum_i - cum_j
// > 0 there can overflow, and inf * 0 is NaN).
//
// Products run as f32 FMAs on the CUDA cores; every sum has one owner
// thread and a fixed order (no atomics), so runs repeat bit for bit.  At
// the serving path's prefill shapes the work is bounded by operations;
// tensor cores (mma.sync / wgmma), TMA and a parallel intra-tile pass plus
// a scan over tile states are the next steps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 64;  // most steps per tile
constexpr int TI = 16;    // thread-tile stride: rows ti + 16r, cols tc + 16c

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Shared-memory layout, in floats.  Rows of B, C and h are padded by one
// float so that threads reading one column of different rows hit
// different banks.
template <int P, int N>
struct Layout {
  static constexpr int NS = N + 1;                // row stride of h, B, C
  static constexpr int GS = TILE + 1;             // row stride of G
  static constexpr int H = 0;                     // h[P][NS]
  static constexpr int BM = H + P * NS;           // B, then W [TILE][NS]
  static constexpr int CM = BM + TILE * NS;       // C[TILE][NS]
  static constexpr int X = CM + TILE * NS;        // x[TILE][P]
  static constexpr int G = X + TILE * P;          // G[TILE][GS]
  static constexpr int CUM = G + TILE * GS;       // cum[TILE]
  static constexpr int DIN = CUM + TILE;          // exp(cum)
  static constexpr int DT = DIN + TILE;           // dt
  static constexpr int WSC = DT + TILE;           // exp(total - cum) * dt
  static constexpr int FLOATS = WSC + TILE;
  static constexpr int BYTES = FLOATS * (int)sizeof(float);
};

template <typename T, int P, int N>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, T* __restrict__ y,
                float* __restrict__ hout, int S, int nh, int tile) {
  using L = Layout<P, N>;
  constexpr int NS = L::NS;
  constexpr int GS = L::GS;
  constexpr int PC = P / TI;           // y columns per thread
  constexpr int HK = P * N / THREADS;  // h elements per thread
  static_assert(P % TI == 0 && P <= TILE, "P must be 16, 32 or 64");
  static_assert(P * N % THREADS == 0, "P*N must be a multiple of 256");

  extern __shared__ float smem[];
  float* hs = smem + L::H;
  float* bs = smem + L::BM;
  float* cs = smem + L::CM;
  float* xs = smem + L::X;
  float* gs = smem + L::G;
  float* cum = smem + L::CUM;
  float* din = smem + L::DIN;
  float* dts = smem + L::DT;
  float* wsc = smem + L::WSC;

  const int tid = threadIdx.x;
  const int ti = tid / TI;
  const int tc = tid % TI;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const float a = A[h];
  const size_t hoff = ((size_t)b * nh + h) * P * N;

  for (int e = tid; e < P * N; e += THREADS)
    hs[(e / N) * NS + e % N] = 0.f;

  for (int s0 = 0; s0 < S; s0 += tile) {
    const int len = min(tile, S - s0);  // steps of this tile inside S
    __syncthreads();  // the previous tile is no longer read

    // stage the tile as f32; steps past S are zeros (dt = 0: no-ops)
    for (int idx = tid; idx < tile * P; idx += THREADS) {
      const int i = idx / P;
      const int p = idx % P;
      xs[i * P + p] =
          i < len ? to_f32(x[(((size_t)b * S + s0 + i) * nh + h) * P + p])
                  : 0.f;
    }
    for (int idx = tid; idx < tile * N; idx += THREADS) {
      const int i = idx / N;
      const int n = idx % N;
      const size_t off = ((size_t)b * S + s0 + i) * N + n;
      bs[i * NS + n] = i < len ? to_f32(Bm[off]) : 0.f;
      cs[i * NS + n] = i < len ? to_f32(Cm[off]) : 0.f;
    }
    if (tid < tile)
      dts[tid] = tid < len ? dt[((size_t)b * S + s0 + tid) * nh + h] : 0.f;
    __syncthreads();

    // inclusive cumsum of dt * A, in step order (at most 64 adds)
    if (tid == 0) {
      float run = 0.f;
      for (int i = 0; i < tile; ++i) {
        run += dts[i] * a;
        cum[i] = run;
      }
    }
    __syncthreads();
    const float total = cum[tile - 1];
    if (tid < tile) {
      din[tid] = expf(cum[tid]);
      wsc[tid] = expf(total - cum[tid]) * dts[tid];
    }

    // G[i][j] = (C_i . B_j) * exp(cum_i - cum_j) * dt_j for j <= i
    {
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
      if (ti < tile) {
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) cv[r] = cs[(ti + TI * r) * NS + n];
#pragma unroll
          for (int c = 0; c < 4; ++c) bv[c] = bs[(tc + TI * c) * NS + n];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[r][c] = fmaf(cv[r], bv[c], acc[r][c]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ti + TI * r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = tc + TI * c;
          float g = 0.f;
          if (j <= i && i < tile)  // masked before the exp, never after
            g = acc[r][c] * expf(cum[i] - cum[j]) * dts[j];
          gs[i * GS + j] = g;
        }
      }
    }
    __syncthreads();

    // y_i = sum_{j<=i} G[i][j] x_j + exp(cum_i) (C_i . h); meanwhile B
    // becomes W = exp(total - cum) * dt * B for the state update
    {
      float yi[4][PC], yh[4][PC];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < PC; ++c) yi[r][c] = yh[r][c] = 0.f;
      const int jend = min(tile, ti + TI * 3 + 1);  // G is 0 past the row
      for (int j = 0; j < jend; ++j) {
        float gv[4], xv[PC];
#pragma unroll
        for (int r = 0; r < 4; ++r) gv[r] = gs[(ti + TI * r) * GS + j];
#pragma unroll
        for (int c = 0; c < PC; ++c) xv[c] = xs[j * P + tc + TI * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < PC; ++c) yi[r][c] = fmaf(gv[r], xv[c], yi[r][c]);
      }
      if (ti < len) {
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float cv[4], hv[PC];
#pragma unroll
          for (int r = 0; r < 4; ++r) cv[r] = cs[(ti + TI * r) * NS + n];
#pragma unroll
          for (int c = 0; c < PC; ++c) hv[c] = hs[(tc + TI * c) * NS + n];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < PC; ++c)
              yh[r][c] = fmaf(cv[r], hv[c], yh[r][c]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ti + TI * r;
        if (i >= len) continue;
        T* yrow = y + (((size_t)b * S + s0 + i) * nh + h) * P;
#pragma unroll
        for (int c = 0; c < PC; ++c)
          store(yrow + tc + TI * c, yi[r][c] + din[i] * yh[r][c]);
      }
      for (int idx = tid; idx < tile * N; idx += THREADS) {
        const int i = idx / N;
        bs[i * NS + idx % N] *= wsc[i];
      }
    }
    __syncthreads();

    // h <- exp(total) h + x^T . W; each thread owns HK elements of h
    {
      const float decay = expf(total);
      float acc[HK];
#pragma unroll
      for (int k = 0; k < HK; ++k) acc[k] = 0.f;
      for (int j = 0; j < tile; ++j) {
#pragma unroll
        for (int k = 0; k < HK; ++k) {
          const int e = tid + THREADS * k;
          acc[k] = fmaf(xs[j * P + e / N], bs[j * NS + e % N], acc[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < HK; ++k) {
        const int e = tid + THREADS * k;
        float* hp = hs + (e / N) * NS + e % N;
        *hp = *hp * decay + acc[k];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < P * N; e += THREADS)
    hout[hoff + e] = hs[(e / N) * NS + e % N];
}

template <typename T, int P, int N>
int launch_pn(const void* x, const float* dt, const float* A, const void* Bm,
              const void* Cm, void* y, float* hout, int B, int S, int nh,
              int tile, cudaStream_t stream) {
  constexpr int bytes = Layout<P, N>::BYTES;
  auto kernel = ssd_scan_kernel<T, P, N>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(nh, B), THREADS, bytes, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y), hout, S, nh, tile);
  return (int)cudaGetLastError();
}

template <typename T, int P>
int launch_p(int N, const void* x, const float* dt, const float* A,
             const void* Bm, const void* Cm, void* y, float* hout, int B,
             int S, int nh, int tile, cudaStream_t stream) {
  switch (N) {
    case 16:
      return launch_pn<T, P, 16>(x, dt, A, Bm, Cm, y, hout, B, S, nh,
                                 tile, stream);
    case 32:
      return launch_pn<T, P, 32>(x, dt, A, Bm, Cm, y, hout, B, S, nh,
                                 tile, stream);
    case 64:
      return launch_pn<T, P, 64>(x, dt, A, Bm, Cm, y, hout, B, S, nh,
                                 tile, stream);
    case 128:
      return launch_pn<T, P, 128>(x, dt, A, Bm, Cm, y, hout, B, S, nh,
                                  tile, stream);
    default:
      return -1;
  }
}

template <typename T>
int launch(int P, int N, const void* x, const float* dt, const float* A,
           const void* Bm, const void* Cm, void* y, float* hout, int B,
           int S, int nh, int tile, cudaStream_t stream) {
  switch (P) {
    case 16:
      return launch_p<T, 16>(N, x, dt, A, Bm, Cm, y, hout, B, S, nh,
                             tile, stream);
    case 32:
      return launch_p<T, 32>(N, x, dt, A, Bm, Cm, y, hout, B, S, nh,
                             tile, stream);
    case 64:
      return launch_p<T, 64>(N, x, dt, A, Bm, Cm, y, hout, B, S, nh,
                             tile, stream);
    default:
      return -1;
  }
}

}  // namespace

// Returns 0 on success, -1 for an unsupported P, N or tile, else the
// cudaError_t of the launch.
extern "C" int repro_ssd_scan_fwd(const void* x, const void* dt,
                                  const void* A, const void* Bm,
                                  const void* Cm, void* y, void* hout, int B,
                                  int S, int nh, int P, int N, int tile,
                                  int is_bf16, void* stream) {
  if (tile < 1 || tile > TILE) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* houtf = static_cast<float*>(hout);
  if (is_bf16)
    return launch<__nv_bfloat16>(P, N, x, dtf, Af, Bm, Cm, y, houtf, B, S, nh,
                                 tile, s);
  return launch<float>(P, N, x, dtf, Af, Bm, Cm, y, houtf, B, S, nh, tile,
                       s);
}
