// Mamba2 SSD chunked scan on Hopper's tensor cores (sm_90a), bf16 x/B/C.
//
// Replaces the Pallas TPU kernel `_ssd_kernel` / `ssd_scan` in
// src/repro/kernels/ssd_scan.py for bf16 inputs at head dim P = 64 (f32,
// and P = 16 or 32, run on the CUDA-core kernel of ssd_scan.cu).  Same
// function: per (batch b, head h) and chunk of Q steps,
//
//   cum   = cumsum(dt * A)                              (inclusive)
//   G     = (C . B^T) * exp(cum_i - cum_j) * dt_j       for j <= i, else 0
//   y     = G . x + exp(cum) * (C . h^T)
//   h    <- exp(cum[-1]) * h + x^T . (exp(cum[-1] - cum) * dt * B)
//
// Layout as in the JAX package: x (B, S, nh, P) bf16, dt (B, S, nh) f32,
// A (nh,) f32, Bm/Cm (B, S, N) bf16; y (B, S, nh, P) bf16, h_final
// (B, nh, P, N) f32; h starts at 0.  Steps past S are dt = 0 no-ops (TMA
// reads x, B and C there as zeros), the reference's padding.
//
// What bounds it: at mamba2-2.7b's prefill (B=4, S=512, nh=80, N=128) the
// bytes (54 MB of inputs and outputs: 16 us at 3.35 TB/s) against ~6 GFLOP
// of products (6 us at the bf16 peak).  The TPU kernel carried h across a
// sequential grid; here the scan is split into three launches so that the
// products run in parallel over (batch, chunk, head) on the tensor cores:
//
// 1. chunk_state_kernel, per (chunk, batch, group of heads): the chunk's
//    own state s_c = x^T . W with W = exp(total - cum) * dt * B (P x N f32,
//    the state the chunk would leave behind from h = 0), into a scratch
//    buffer `states` (B, nC, nh, P, N), and `totals` = cum[-1] (B, nC, nh).
//    Computed transposed, s_c^T = W^T . x: W^T is built in registers as
//    wgmma's A operand from the B tile (TMA, once per block) and x is the
//    shared-memory B operand read MN-major from its TMA tile.
// 2. state_pass_kernel, per (batch, head): h_c = exp(total_c) h_{c-1} + s_c
//    over the chunks, elementwise.  The state entering chunk c > 0 goes to
//    a scratch buffer `hprev` already split into bf16 hi and lo and laid
//    out as pass 3's wgmma reads it from shared memory; the last state is
//    h_final.
// 3. chunk_out_kernel, per (chunk, batch, group of heads): C . B^T once per
//    block with wgmma (both K-major from the TMA tiles), kept in registers
//    for every head of the group; per head y = G . x + exp(cum) *
//    (C . h_prev^T): C . h_prev^T runs on the tensor cores while G is formed
//    on the C . B^T accumulator, which is then the register A operand of
//    G . x (as P in flash_attention_tc.cu), x MN-major.
//
// Passes 1 and 3 give a block one producer warpgroup, whose first thread
// loads each head's tiles (TMA, bulk copy) through a ring of two stages
// guarded by full/empty mbarriers, and one or two consumer warpgroups
// (64 state rows, or 64 chunk rows, each); the next head loads under the
// math on this one.  Heads per block are chosen on the host so that the
// blocks fill the SMs in whole waves.
//
// What holds it back: the scratch.  At the slice shape `states` (42 MB) is
// written and read once and `hprev` (31 MB) likewise, so the three passes
// move ~222 MB, not 54 MB (PERF.md has each pass's time).  Carrying h in
// registers over the chunks of one (batch, head) instead, in one pass with
// the chunk states, removes `states` but leaves too few blocks for the
// serial walk: it was slower in turns at S=512 and S=4096.
//
// Precision.  x, B and C are bf16 and exact on the tensor cores; the f32
// operands are not: W, h_prev and G are each split into hi + lo bf16 parts
// (hi = bf16(v), lo = bf16(v - hi)) and go through two products, which is
// exact to ~2^-16 of each term (one bf16 product would cost ~2^-8 and miss
// the state's 1e-4).  Sums accumulate in f32.  ssd_scan.py's
// `ssd_tc_plain` rounds at the same places.
//
// Determinism: every output element and every state has one owner thread
// and a fixed order of sums, no atomics; the cumsum is a warp scan in a
// fixed order.  Two runs agree bit for bit.
#include <math.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

constexpr int P = 64;           // head dim: 128-byte rows of x
constexpr int XSTAGES = 2;      // ring depth of the per-head loads
constexpr int MAX_GROUP = 16;   // heads per block, at most
// A block is consumer warpgroups plus one producer warpgroup, of which one
// thread issues the loads.  With two consumer warpgroups the producer hands
// its registers to them (40 + 2 x 232 <= 3 x 168, the share of 384 threads
// of the SM's 65,536); with one, every thread has up to 255 anyway.
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;

__device__ __forceinline__ void split(float a, float b, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Inclusive cumsum of dt * A over the chunk's Q steps of head h, by one warp
// in a fixed order: each lane sums Q/32 consecutive steps, then a scan over
// the lanes.  Writes cum and dt (0 past S) of each step into shared memory
// and returns the chunk's total (its last cum).
template <int Q>
__device__ float chunk_cumsum(const float* __restrict__ dt, float a, int b,
                              int s0, int S, int nh, int h, float* cum,
                              float* dts) {
  constexpr int E = Q / 32;
  const int lane = threadIdx.x % 32;
  float v[E], d[E];
  float run = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int s = s0 + lane * E + e;
    d[e] = s < S ? dt[((size_t)b * S + s) * nh + h] : 0.f;
    run += d[e] * a;
    v[e] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const float t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += t;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    cum[lane * E + e] = excl + v[e];
    dts[lane * E + e] = d[e];
  }
  return __shfl_sync(0xffffffffu, excl + v[E - 1], 31);
}

// A ring of per-head loads: the producer thread fills stage k % XSTAGES for
// head k once every consumer warp has released it (full/empty mbarriers),
// so the load of the next heads runs under the math on this one.
struct Ring {
  uint32_t full0, empty0;   // + 8·stage
  __device__ void init(uint64_t* bars, int consumer_warps) {
    full0 = smem_u32(bars);
    empty0 = smem_u32(bars + XSTAGES);
    if (threadIdx.x == 0) {
      for (int s = 0; s < XSTAGES; ++s) {
        mbar_init(full0 + 8 * s, 1);
        mbar_init(empty0 + 8 * s, consumer_warps);
      }
    }
  }
  // producer: stage of head k, once free, armed for `bytes`
  __device__ uint32_t acquire(int k, uint32_t bytes) const {
    const int s = k % XSTAGES;
    if (k >= XSTAGES) mbar_wait(empty0 + 8 * s, (k / XSTAGES - 1) & 1);
    mbar_expect_tx(full0 + 8 * s, bytes);
    return full0 + 8 * s;
  }
  __device__ void wait(int k) const {
    mbar_wait(full0 + 8 * (k % XSTAGES), (k / XSTAGES) & 1);
  }
  __device__ void release(int k) const {   // by every consumer warp
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(empty0 + 8 * (k % XSTAGES));
  }
};

// ---------------------------------------------------------------- pass 1
template <int Q, int N>
struct StateCfg {
  using R = Rows<N>;
  static constexpr int WGS = N > 64 ? 2 : 1;      // 64 state rows each
  static constexpr int THREADS = (WGS + 1) * 128;  // + the producer
  static constexpr int B_BYTES = Q * N * 2;
  static constexpr int X_BYTES = Q * P * 2;
  static constexpr int SMEM = 1024 + B_BYTES + XSTAGES * X_BYTES +
                              (MAX_GROUP + WGS * 4) * Q * 4 + 64;
};

template <int Q, int N>
__global__ void __launch_bounds__(StateCfg<Q, N>::THREADS, 1)
chunk_state_kernel(const __grid_constant__ CUtensorMap tm_x,
                   const __grid_constant__ CUtensorMap tm_b,
                   const float* __restrict__ dt, const float* __restrict__ A,
                   float* __restrict__ states, float* __restrict__ totals,
                   int S, int nh, int group) {
  using C = StateCfg<Q, N>;
  using R = typename C::R;
  constexpr int CWARPS = C::WGS * 4;                 // consumer warps
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* bt = smem;                                // NCH x (Q x SWB)
  uint8_t* xs = bt + C::B_BYTES;                     // XSTAGES x (Q x 128)
  float* wsc = reinterpret_cast<float*>(xs + XSTAGES * C::X_BYTES);
  float* cums = wsc + MAX_GROUP * Q;                 // one row per warp
  uint64_t* bars = reinterpret_cast<uint64_t*>(cums + CWARPS * Q);
  const uint32_t b_bar = smem_u32(bars + 2 * XSTAGES);

  const int c = blockIdx.x;
  const int b = blockIdx.y;
  const int h0 = blockIdx.z * group;
  const int nheads = min(group, nh - h0);
  const int nC = gridDim.x;
  const int s0 = c * Q;

  Ring ring;
  ring.init(bars, CWARPS);
  if (threadIdx.x == 0) {
    mbar_init(b_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= CWARPS) {
    // ------------------------------------------------ producer
    if constexpr (C::THREADS == 384) regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == CWARPS * 32) {
      mbar_expect_tx(b_bar, C::B_BYTES);
      for (int k = 0; k < R::NCH; ++k)
        tma_load(smem_u32(bt + k * Q * R::SWB), &tm_b, b_bar, k * R::CH, 0,
                 s0, b);
      for (int k = 0; k < nheads; ++k) {
        const uint32_t bar = ring.acquire(k, C::X_BYTES);
        tma_load(smem_u32(xs + k % XSTAGES * C::X_BYTES), &tm_x, bar, 0,
                 h0 + k, s0, b);
      }
    }
    return;
  }
  if constexpr (C::THREADS == 384) regs_inc<CONSUMER_REGS>();

  // every head's W factor exp(total - cum) * dt, one warp per head
  for (int k = warp; k < nheads; k += CWARPS) {
    float* w = wsc + k * Q;
    float* cum = cums + warp * Q;
    const float total = chunk_cumsum<Q>(dt, A[h0 + k], b, s0, S, nh, h0 + k,
                                        cum, w);
    __syncwarp();
    for (int j = lane; j < Q; j += 32) w[j] = expf(total - cum[j]) * w[j];
    if (lane == 0) totals[((size_t)b * nC + c) * nh + h0 + k] = total;
  }
  asm volatile("bar.sync 1, %0;\n" :: "n"(CWARPS * 32) : "memory");

  const int wg = warp / 4;
  const int n0 = 64 * wg + 16 * (warp % 4) + lane / 4;   // state rows n0,
  const int cq = 2 * (lane % 4);                         // n0 + 8
  mbar_wait(b_bar, 0);
  for (int k = 0; k < nheads; ++k) {
    const float* w = wsc + k * Q;
    // A = W^T (state rows x steps), hi and lo parts, in registers
    uint32_t ahi[Q / 16][4], alo[Q / 16][4];
#pragma unroll
    for (int kk = 0; kk < Q / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int n = (r & 1) ? n0 + 8 : n0;
        const int j = 16 * kk + cq + ((r & 2) ? 8 : 0);
        float v0 = 0.f, v1 = 0.f;
        if (n < N) {
          const uint32_t o = (n / R::CH) * Q * R::SWB + (n % R::CH) * 2;
          v0 = w[j] * __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
                          bt + swizzle(o + j * R::SWB, R::SWB)));
          v1 = w[j + 1] * __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
                              bt + swizzle(o + (j + 1) * R::SWB, R::SWB)));
        }
        split(v0, v1, ahi[kk][r], alo[kk][r]);
      }
    }
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    ring.wait(k);
    const uint32_t x_addr = smem_u32(xs + k % XSTAGES * C::X_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < Q / 16; ++kk) {
      const uint64_t dx = make_desc(x_addr + kk * 16 * 128, Q * 128, 8 * 128, 1);
      Mma<64>::rs(acc, ahi[kk], dx);
      Mma<64>::rs(acc, alo[kk], dx);
    }
    wgmma_commit_and_wait();
    fence_regs(acc);
    ring.release(k);
    // acc holds s_c^T: row n, column p
    float* out = states + (((size_t)b * nC + c) * nh + h0 + k) * P * N;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int n = (i & 2) ? n0 + 8 : n0;
      const int p = 8 * (i / 4) + cq + (i & 1);
      if (n < N) out[p * N + n] = acc[i];
    }
  }
}

// ---------------------------------------------------------------- pass 2
// The state entering each chunk: h_c = exp(total_c) h_{c-1} + s_c, from
// `states` (B, nC, nh, P, N) f32.  For chunk c > 0 it goes to `hprev`
// (B, nC, nh, 2, P x N) bf16 as pass 3 feeds it to wgmma: hi, then lo,
// each in the K-major swizzled layout of a (P rows x N) tile; the last
// state goes to hout (B, nh, P, N) f32.  One thread per 4 elements.
template <int N>
__global__ void __launch_bounds__(256)
state_pass_kernel(const float4* __restrict__ states,
                  const float* __restrict__ totals,
                  __nv_bfloat16* __restrict__ hprev, float4* __restrict__ hout,
                  int nC, int nh) {
  using R = Rows<N>;
  constexpr int PN4 = P * N / 4;
  const int e = blockIdx.x * 256 + threadIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  if (e >= PN4) return;
  const int p = 4 * e / N;
  const int n = 4 * e % N;
  const uint32_t o = swizzle((n / R::CH) * P * R::SWB + p * R::SWB +
                             (n % R::CH) * 2, R::SWB);
  float4 cur = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nC; c0 += 4) {
    float4 s[4];
    float d[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (c0 + u < nC) {
        const size_t slot = ((size_t)b * nC + c0 + u) * nh + h;
        s[u] = states[slot * PN4 + e];
        d[u] = expf(totals[slot]);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (c0 + u < nC) {
        if (c0 + u > 0) {
          const size_t slot = ((size_t)b * nC + c0 + u) * nh + h;
          uint8_t* img = reinterpret_cast<uint8_t*>(hprev + slot * 2 * P * N);
          uint2 hi, lo;
          split(cur.x, cur.y, hi.x, lo.x);
          split(cur.z, cur.w, hi.y, lo.y);
          *reinterpret_cast<uint2*>(img + o) = hi;
          *reinterpret_cast<uint2*>(img + P * N * 2 + o) = lo;
        }
        // h * decay, then + s: two roundings, as the plain version
        cur.x = __fadd_rn(__fmul_rn(cur.x, d[u]), s[u].x);
        cur.y = __fadd_rn(__fmul_rn(cur.y, d[u]), s[u].y);
        cur.z = __fadd_rn(__fmul_rn(cur.z, d[u]), s[u].z);
        cur.w = __fadd_rn(__fmul_rn(cur.w, d[u]), s[u].w);
      }
    }
  }
  hout[((size_t)b * nh + h) * PN4 + e] = cur;
}

// ---------------------------------------------------------------- pass 3
template <int Q, int N>
struct OutCfg {
  using R = Rows<N>;
  static constexpr int NWG = Q / 64;              // 64 chunk rows each
  static constexpr int THREADS = (NWG + 1) * 128;  // + the producer
  static constexpr int BC_BYTES = Q * N * 2;      // the B or the C tile
  static constexpr int X_BYTES = Q * P * 2;
  static constexpr int HL_BYTES = P * N * 2;      // h_prev hi or lo
  static constexpr int STAGE = X_BYTES + 2 * HL_BYTES;
  static constexpr int SMEM = 1024 + 2 * BC_BYTES + XSTAGES * STAGE +
                              2 * MAX_GROUP * Q * 4 + 64;
};

template <int Q, int N>
__global__ void __launch_bounds__(OutCfg<Q, N>::THREADS, 1)
chunk_out_kernel(const __grid_constant__ CUtensorMap tm_x,
                 const __grid_constant__ CUtensorMap tm_b,
                 const __grid_constant__ CUtensorMap tm_c,
                 const float* __restrict__ dt, const float* __restrict__ A,
                 const __nv_bfloat16* __restrict__ hprev,
                 __nv_bfloat16* __restrict__ y, int S, int nh, int group) {
  using C = OutCfg<Q, N>;
  using R = typename C::R;
  constexpr int CWARPS = C::NWG * 4;                 // consumer warps
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ct = smem;                                // NCH x (Q x SWB)
  uint8_t* bt = ct + C::BC_BYTES;
  uint8_t* stages = bt + C::BC_BYTES;                // XSTAGES x (x, hi, lo)
  float* cumg = reinterpret_cast<float*>(stages + XSTAGES * C::STAGE);
  float* dtg = cumg + MAX_GROUP * Q;
  uint64_t* bars = reinterpret_cast<uint64_t*>(dtg + MAX_GROUP * Q);
  const uint32_t bc_bar = smem_u32(bars + 2 * XSTAGES);

  const int c = blockIdx.x;
  const int b = blockIdx.y;
  const int h0 = blockIdx.z * group;
  const int nheads = min(group, nh - h0);
  const int nC = gridDim.x;
  const int s0 = c * Q;
  const bool carry = c > 0;      // chunk 0 starts from h = 0

  Ring ring;
  ring.init(bars, CWARPS);
  if (threadIdx.x == 0) {
    mbar_init(bc_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= CWARPS) {
    // ------------------------------------------------ producer
    if constexpr (C::THREADS == 384) regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == CWARPS * 32) {
      mbar_expect_tx(bc_bar, 2 * C::BC_BYTES);
      for (int k = 0; k < R::NCH; ++k) {
        tma_load(smem_u32(ct + k * Q * R::SWB), &tm_c, bc_bar, k * R::CH, 0,
                 s0, b);
        tma_load(smem_u32(bt + k * Q * R::SWB), &tm_b, bc_bar, k * R::CH, 0,
                 s0, b);
      }
      for (int k = 0; k < nheads; ++k) {
        uint8_t* dst = stages + k % XSTAGES * C::STAGE;
        const uint32_t bar =
            ring.acquire(k, C::X_BYTES + (carry ? 2 * C::HL_BYTES : 0));
        tma_load(smem_u32(dst), &tm_x, bar, 0, h0 + k, s0, b);
        if (carry)
          bulk_load(smem_u32(dst + C::X_BYTES),
                    hprev + (((size_t)b * nC + c) * nh + h0 + k) * 2 * P * N,
                    2 * C::HL_BYTES, bar);
      }
    }
    return;
  }
  if constexpr (C::THREADS == 384) regs_inc<CONSUMER_REGS>();

  for (int k = warp; k < nheads; k += CWARPS)
    chunk_cumsum<Q>(dt, A[h0 + k], b, s0, S, nh, h0 + k, cumg + k * Q,
                    dtg + k * Q);

  const int wg = warp / 4;
  const int row0 = 64 * wg + 16 * (warp % 4) + lane / 4;   // chunk rows
  const int row1 = row0 + 8;                              // row0, row1
  const int cq = 2 * (lane % 4);
  const int kmax = 4 * (wg + 1);       // key steps at or below the diagonal
  const uint32_t c_addr = smem_u32(ct) + 64 * wg * R::SWB;

  // C . B^T for this warpgroup's 64 rows, shared by every head
  float cb[Q / 2];
#pragma unroll
  for (int i = 0; i < Q / 2; ++i) cb[i] = 0.f;
  mbar_wait(bc_bar, 0);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    const int ch = kk * 16 / R::CH;
    const int off = (kk * 16 % R::CH) * 2;
    Mma<Q>::ss(cb,
               make_desc(c_addr + ch * Q * R::SWB + off, 16, 8 * R::SWB,
                         R::LAYOUT),
               make_desc(smem_u32(bt) + ch * Q * R::SWB + off, 16,
                         8 * R::SWB, R::LAYOUT),
               kk > 0);
  }
  wgmma_commit_and_wait();
  fence_regs(cb);
  asm volatile("bar.sync 1, %0;\n" :: "n"(CWARPS * 32) : "memory");

  const int kdiag = (64 * wg + 16 * (warp % 4)) / 16;   // this warp's
  for (int k = 0; k < nheads; ++k) {                     // diagonal step
    const int h = h0 + k;
    const float* cum = cumg + k * Q;
    const float* dts = dtg + k * Q;
    const uint32_t stage = smem_u32(stages + k % XSTAGES * C::STAGE);
    ring.wait(k);

    // ch = C . h_prev^T (hi + lo), on the tensor cores while G is formed
    float ch[32];
    if (carry) {
#pragma unroll
      for (int i = 0; i < 32; ++i) ch[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        const int chk = kk * 16 / R::CH;
        const int off = (kk * 16 % R::CH) * 2;
        const uint64_t dc = make_desc(c_addr + chk * Q * R::SWB + off, 16,
                                      8 * R::SWB, R::LAYOUT);
        const uint32_t hi = stage + C::X_BYTES + chk * P * R::SWB + off;
        Mma<64>::ss(ch, dc, make_desc(hi, 16, 8 * R::SWB, R::LAYOUT), 1);
        Mma<64>::ss(ch, dc,
                    make_desc(hi + C::HL_BYTES, 16, 8 * R::SWB, R::LAYOUT),
                    1);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      fence_regs(ch);
    }

    // G = (C . B^T) * exp(cum_i - cum_j) * dt_j below the diagonal, hi and
    // lo, in wgmma's A-fragment layout (that of the accumulator); a warp's
    // steps past its diagonal are zeros, only the diagonal step is masked
    const float ci0 = cum[row0], ci1 = cum[row1];
    uint32_t ghi[Q / 16][4], glo[Q / 16][4];
#pragma unroll
    for (int kk = 0; kk < Q / 16; ++kk) {
      if (kk < kmax) {
        if (kk > kdiag) {
#pragma unroll
          for (int r = 0; r < 4; ++r) ghi[kk][r] = glo[kk][r] = 0u;
          continue;
        }
        float g[8];
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int j = 16 * kk + 8 * t + cq;
          const float cj0 = cum[j], cj1 = cum[j + 1];
          const float d0 = dts[j], d1 = dts[j + 1];
          const float* cbt = cb + 8 * kk + 4 * t;
          g[4 * t + 0] = cbt[0] * __expf(ci0 - cj0) * d0;
          g[4 * t + 1] = cbt[1] * __expf(ci0 - cj1) * d1;
          g[4 * t + 2] = cbt[2] * __expf(ci1 - cj0) * d0;
          g[4 * t + 3] = cbt[3] * __expf(ci1 - cj1) * d1;
          if (kk == kdiag) {
            // masked after the exp by a select: above the diagonal the exp
            // may be inf, and it is never multiplied into a sum
            if (j > row0) g[4 * t + 0] = 0.f;
            if (j + 1 > row0) g[4 * t + 1] = 0.f;
            if (j > row1) g[4 * t + 2] = 0.f;
            if (j + 1 > row1) g[4 * t + 3] = 0.f;
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) split(g[2 * r], g[2 * r + 1], ghi[kk][r],
                                          glo[kk][r]);
      }
    }

    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < Q / 16; ++kk) {
      if (kk < kmax) {
        const uint64_t dx = make_desc(stage + kk * 16 * 128, Q * 128,
                                      8 * 128, 1);
        Mma<64>::rs(acc, ghi[kk], dx);
        Mma<64>::rs(acc, glo[kk], dx);
      }
    }
    wgmma_commit_and_wait();
    fence_regs(acc);
    ring.release(k);
    if (carry) {
      fence_regs(ch);
      // y = G . x + exp(cum) * (C . h_prev^T)
      const float d0 = expf(ci0);
      const float d1 = expf(ci1);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] += ((i & 2) ? d1 : d0) * ch[i];
    }

    __nv_bfloat16* y0 = y + (((size_t)b * S + s0 + row0) * nh + h) * P;
    __nv_bfloat16* y1 = y0 + (size_t)8 * nh * P;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      if (s0 + row0 < S)
        *reinterpret_cast<__nv_bfloat162*>(y0 + 8 * t + cq) =
            __floats2bfloat162_rn(acc[4 * t], acc[4 * t + 1]);
      if (s0 + row1 < S)
        *reinterpret_cast<__nv_bfloat162*>(y1 + 8 * t + cq) =
            __floats2bfloat162_rn(acc[4 * t + 2], acc[4 * t + 3]);
    }
  }
}

// ------------------------------------------------------------------- host
// Heads per block: the group size g (at most MAX_GROUP) that minimises
// waves x (g + 1), where a block costs one unit per head plus one for its
// shared tiles and `slots` blocks run at once.
int heads_per_block(int tiles, int nh, int slots) {
  int best = 1;
  long best_cost = -1;
  for (int g = 1; g <= std::min(nh, MAX_GROUP); ++g) {
    const long blocks = (long)tiles * ((nh + g - 1) / g);
    const long cost = (blocks + slots - 1) / slots * (g + 1);
    if (best_cost < 0 || cost < best_cost) {
      best = g;
      best_cost = cost;
    }
  }
  return best;
}

template <typename K>
int slots_for(K kernel, int threads, int smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                smem);
  return std::max(1, sms * per_sm);
}

// the tensors of one call (device pointers) and its sizes
struct Args {
  const void *x, *Bm, *Cm;
  const float *dt, *A;
  void* y;
  float *hout, *states, *totals;
  void* hprev;
  int B, S, nh;
};

template <int Q, int N>
int launch(const Args& a, cudaStream_t stream) {
  using SC = StateCfg<Q, N>;
  using OC = OutCfg<Q, N>;
  using R = Rows<N>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -2;
  CUtensorMap mx, mb, mc;
  if (!make_map(encode, &mx, a.x, a.B, a.S, a.nh, P, P, Q,
                CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(encode, &mb, a.Bm, a.B, a.S, 1, N, R::CH, Q, R::SWIZZLE) ||
      !make_map(encode, &mc, a.Cm, a.B, a.S, 1, N, R::CH, Q, R::SWIZZLE))
    return -3;
  const int nC = (a.S + Q - 1) / Q;
  auto k1 = chunk_state_kernel<Q, N>;
  auto k3 = chunk_out_kernel<Q, N>;
  cudaError_t rc = cudaFuncSetAttribute(
      k1, cudaFuncAttributeMaxDynamicSharedMemorySize, SC::SMEM);
  if (rc == cudaSuccess)
    rc = cudaFuncSetAttribute(
        k3, cudaFuncAttributeMaxDynamicSharedMemorySize, OC::SMEM);
  if (rc != cudaSuccess) return (int)rc;

  const int g1 = heads_per_block(nC * a.B, a.nh,
                                 slots_for(k1, SC::THREADS, SC::SMEM));
  k1<<<dim3(nC, a.B, (a.nh + g1 - 1) / g1), SC::THREADS, SC::SMEM, stream>>>(
      mx, mb, a.dt, a.A, a.states, a.totals, a.S, a.nh, g1);
  if ((rc = cudaGetLastError()) != cudaSuccess) return (int)rc;

  state_pass_kernel<N><<<dim3((P * N / 4 + 255) / 256, a.nh, a.B), 256, 0,
                         stream>>>(
      reinterpret_cast<const float4*>(a.states), a.totals,
      static_cast<__nv_bfloat16*>(a.hprev), reinterpret_cast<float4*>(a.hout),
      nC, a.nh);
  if ((rc = cudaGetLastError()) != cudaSuccess) return (int)rc;

  const int g3 = heads_per_block(nC * a.B, a.nh,
                                 slots_for(k3, OC::THREADS, OC::SMEM));
  k3<<<dim3(nC, a.B, (a.nh + g3 - 1) / g3), OC::THREADS, OC::SMEM, stream>>>(
      mx, mb, mc, a.dt, a.A, static_cast<const __nv_bfloat16*>(a.hprev),
      static_cast<__nv_bfloat16*>(a.y), a.S, a.nh, g3);
  return (int)cudaGetLastError();
}

template <int Q>
int launch_q(int N, const Args& a, cudaStream_t s) {
  switch (N) {
    case 16: return launch<Q, 16>(a, s);
    case 32: return launch<Q, 32>(a, s);
    case 64: return launch<Q, 64>(a, s);
    case 128: return launch<Q, 128>(a, s);
    default: return -1;
  }
}

}  // namespace

// The wrapper allocates the scratch: `states` (B, ceil(S/Q), nh, P, N) f32,
// `totals` (B, ceil(S/Q), nh) f32 and `hprev` (B, ceil(S/Q), nh, 2, P, N)
// bf16.  Returns 0 on success, -1 for a P, N or tile Q this kernel does not
// take, -2 if libcuda has no cuTensorMapEncodeTiled, -3 if a tensor map
// was refused, else the cudaError_t of a launch.
extern "C" int repro_ssd_scan_tc_fwd(const void* x, const void* dt,
                                     const void* A, const void* Bm,
                                     const void* Cm, void* y, void* hout,
                                     void* states, void* totals, void* hprev,
                                     int B, int S, int nh, int P_, int N,
                                     int Q, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P_ != P) return -1;
  if (S == 0)   // no step: the state stays 0
    return (int)cudaMemsetAsync(hout, 0, (size_t)B * nh * P * N * 4, s);
  const Args a{x, Bm, Cm, static_cast<const float*>(dt),
               static_cast<const float*>(A), y, static_cast<float*>(hout),
               static_cast<float*>(states), static_cast<float*>(totals),
               hprev, B, S, nh};
  switch (Q) {
    case 64: return launch_q<64>(N, a, s);
    case 128: return launch_q<128>(N, a, s);
    default: return -1;
  }
}
