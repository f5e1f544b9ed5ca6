// Flash-attention forward on Hopper's tensor cores (sm_90a), bf16.
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention` in
// src/repro/kernels/flash_attention.py for bf16 inputs and computes the
// same function: online softmax with f32 running max m, denominator l and
// accumulator acc; scale 1/sqrt(hd); GQA kv head h*KV/H; top-left causal
// mask kpos <= qpos; sliding window kpos > qpos - window; padded keys
// masked; key tiles that no query of the block sees are skipped; a row
// with no visible key gives 0.  (f32 inputs, and bf16 head dims this
// kernel does not take, run on the CUDA-core kernel of flash_attention.cu.)
//
// Layout as in the JAX package: q (B, Sq, H, hd), k/v (B, Sk, KV, hd),
// o (B, Sq, H, hd), all contiguous.
//
// What bounds it: 4·B·H·hd·(visible pairs) operations against q, k, v and
// o crossing device memory once.  At the serving path's prefill (B=4,
// S=512, H=16, hd=64, causal) that is 2.15 GFLOP against 16.8 MB, so the
// bytes bound it (5.0 us at 3.35 TB/s against 2.2 us at 989 TFLOP/s) and
// the kernel is in practice bounded by latency (a few key tiles per
// block).  At long prompts the operations bound it: phi3-medium's
// attention at S=4096 (H=40, KV=10, hd=128) is 172 GFLOP against 105 MB.
//
// Design.  One thread block per (head, batch, 128-query tile); heavy
// (late) query tiles are issued first.  Two consumer warpgroups own 64
// query rows each; one producer warp issues TMA loads:
// - Q, and K and V tiles of BK keys, come through TMA (cp.async.bulk.tensor
//   on a 4-D tensor map (hd, heads, S, B), so rows of one head are strided)
//   into swizzled shared memory, K/V through a ring of 2 stages guarded by
//   full/empty mbarriers: the load of tile j+1 overlaps the math on tile j.
//   Keys past Sk arrive as zeros and are masked by position.
// - S = Q·Kᵀ is wgmma m64nBKk16 with both operands read from shared memory
//   (K-major), accumulated in f32 registers.
// - The online softmax runs on the accumulator fragment: a thread holds two
//   rows, whose max and sum need shuffles within a group of four lanes
//   only.  Only tiles on the causal diagonal, at the window's edge or past
//   Sk are masked element by element; tiles that a warpgroup's rows cannot
//   see are not computed, and tiles above the block's diagonal are never
//   loaded.
// - P is rounded to bf16 in registers and is the register A operand of
//   O += P·V (wgmma m64n{hd}k16, V read MN-major from shared memory): P
//   never goes through shared memory.
// - Each output element has one owner thread and a fixed order of sums, no
//   atomics: results are deterministic from run to run.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NWG = 2;                    // consumer warpgroups per block
constexpr int BLOCK_Q = 64 * NWG;         // query rows per block
constexpr int THREADS = NWG * 128 + 32;   // + one producer warp
constexpr int STAGES = 2;                 // K/V ring depth

// Per head dim: rows of a tile are cut into chunks of one swizzle width
// (128, 64 or 32 bytes, the widest that divides hd·2), each chunk a TMA box
// and a run of wgmma's canonical layout.
template <int HD>
struct Cfg {
  static constexpr int SWB = (HD * 2) % 128 == 0 ? 128
                             : (HD * 2) % 64 == 0 ? 64 : 32;
  static constexpr int CH = SWB / 2;       // bf16 columns per chunk
  static constexpr int NCH = HD / CH;      // chunks per row
  static constexpr int BK = HD <= 64 ? 128 : 64;   // keys per tile
  // wgmma descriptor layout type: 1 = 128B, 2 = 64B, 3 = 32B swizzle
  static constexpr int LAYOUT = SWB == 128 ? 1 : SWB == 64 ? 2 : 3;
  static constexpr CUtensorMapSwizzle SWIZZLE =
      SWB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : SWB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
  static constexpr int Q_BYTES = BLOCK_Q * HD * 2;
  static constexpr int KV_BYTES = BK * HD * 2;     // one K or V tile
  // + 1024 to align the base for the 128B swizzle, + the mbarriers
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 64;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n"
      :: "r"(bar), "r"(parity) : "memory");
}

// TMA: the box at element coordinates (c0, c1, c2, c3) of `map` into
// shared memory at `dst`, completion counted on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle layout type.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads of an accumulator across the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// wgmma m64nNk16, f32 += bf16 · bf16.  ss: S = Q·Kᵀ, A and B read from
// shared memory, both K-major.  rs: O += P·V, A (P) from registers in the
// accumulator's own layout, B (V) from shared memory, MN-major.
template <int N>
struct Mma;

template <>
struct Mma<16> {
  static __device__ __forceinline__ void rs(float (&d)[8],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Mma<32> {
  static __device__ __forceinline__ void rs(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Mma<64> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a,
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Mma<80> {
  static __device__ __forceinline__ void rs(float (&d)[40],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39}, "
        "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Mma<128> {
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a,
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
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
        : "l"(a), "l"(b), "r"(scale_d));
  }
  static __device__ __forceinline__ void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63}, "
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
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                __nv_bfloat16* __restrict__ o, int Sq, int Sk, int H, int KV,
                float scale_log2, int causal, int window) {
  using C = Cfg<HD>;
  constexpr int BK = C::BK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = smem;                              // NCH x (BLOCK_Q x SWB)
  uint8_t* ks = qs + C::Q_BYTES;                   // STAGES x NCH x (BK x SWB)
  uint8_t* vs = ks + STAGES * C::KV_BYTES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(vs + STAGES * C::KV_BYTES);
  const uint32_t q_bar = smem_u32(bars);
  const uint32_t full0 = smem_u32(bars + 1);            // + 8·stage
  const uint32_t empty0 = smem_u32(bars + 1 + STAGES);  // + 8·stage

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q_start = (gridDim.z - 1 - blockIdx.z) * BLOCK_Q;  // heavy first
  const int g = h * KV / H;

  // key tiles any query of this block can see: [k_begin, k_end)
  const int q_last = min(q_start + BLOCK_Q, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  int k_begin = window > 0 ? max(0, q_start - window + 1) : 0;
  k_begin = (k_begin / BK) * BK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, NWG * 4);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp == NWG * 4) {
    // ------------------------------------------------ producer warp
    if (lane == 0) {
      mbar_expect_tx(q_bar, C::Q_BYTES);
      for (int c = 0; c < C::NCH; ++c)
        tma_load(smem_u32(qs + c * BLOCK_Q * C::SWB), &tm_q, q_bar,
                 c * C::CH, h, q_start, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) mbar_wait(empty0 + 8 * s, (t / STAGES - 1) & 1);
        mbar_expect_tx(full0 + 8 * s, 2 * C::KV_BYTES);
        const int k0 = k_begin + t * BK;
        uint8_t* kt = ks + s * C::KV_BYTES;
        uint8_t* vt = vs + s * C::KV_BYTES;
        for (int c = 0; c < C::NCH; ++c) {
          tma_load(smem_u32(kt + c * BK * C::SWB), &tm_k, full0 + 8 * s,
                   c * C::CH, g, k0, b);
          tma_load(smem_u32(vt + c * BK * C::SWB), &tm_v, full0 + 8 * s,
                   c * C::CH, g, k0, b);
        }
      }
    }
    return;
  }

  // -------------------------------------------------- consumer warpgroups
  const int wg = warp / 4;
  const int wq0 = q_start + 64 * wg;          // this warpgroup's first row
  const int row0 = wq0 + 16 * (warp % 4) + lane / 4;
  const int row1 = row0 + 8;
  const int cq = 2 * (lane % 4);              // first column in each 8
  const bool wg_live = wq0 < Sq;
  const uint32_t q_addr = smem_u32(qs) + 64 * wg * C::SWB;

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;   // running max, raw score units
  float l0 = 0.f, l1 = 0.f;               // this thread's share of the sum

  mbar_wait(q_bar, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES;
    mbar_wait(full0 + 8 * s, (t / STAGES) & 1);
    const int k0 = k_begin + t * BK;
    bool run = wg_live;
    if (causal) run = run && k0 <= wq0 + 63;
    if (window > 0) run = run && k0 + BK - 1 > wq0 - window;
    if (run) {
      float sc[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
      const uint32_t k_addr = smem_u32(ks + s * C::KV_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int c = kk * 16 / C::CH;
        const int off = (kk * 16 % C::CH) * 2;
        Mma<BK>::ss(sc,
                    make_desc(q_addr + c * BLOCK_Q * C::SWB + off, 16,
                              8 * C::SWB, C::LAYOUT),
                    make_desc(k_addr + c * BK * C::SWB + off, 16,
                              8 * C::SWB, C::LAYOUT),
                    kk > 0);
      }
      wgmma_commit_and_wait();
      fence_regs(sc);

      // element masks only where some pair of the tile is not visible
      const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > wq0) ||
                        (window > 0 && k0 <= wq0 + 63 - window);
      if (edge) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int kp = k0 + 8 * (i / 4) + cq + (i & 1);
          const int qp = (i & 2) ? row1 : row0;
          bool ok = kp < Sk;   // keys past Sk were zero-filled: score 0
          if (causal) ok = ok && kp <= qp;
          if (window > 0) ok = ok && kp > qp - window;
          if (!ok) sc[i] = -INFINITY;
        }
      }
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        if (i & 2) mx1 = fmaxf(mx1, sc[i]);
        else mx0 = fmaxf(mx0, sc[i]);
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0);
      const float mn1 = fmaxf(m1, mx1);
      // a row that has seen no key yet keeps m = -inf: base 0 there, so
      // no exp sees (-inf) - (-inf); its p and alpha are exp(-inf) = 0
      const float b0 = mn0 == -INFINITY ? 0.f : mn0 * scale_log2;
      const float b1 = mn1 == -INFINITY ? 0.f : mn1 * scale_log2;
      const float al0 = ex2(m0 * scale_log2 - b0);
      const float al1 = ex2(m1 * scale_log2 - b1);
      m0 = mn0;
      m1 = mn1;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const float p = ex2(fmaf(sc[i], scale_log2, (i & 2) ? -b1 : -b0));
        sc[i] = p;
        if (i & 2) rs1 += p;
        else rs0 += p;
      }
      l0 = l0 * al0 + rs0;
      l1 = l1 * al1 + rs1;
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] *= (i & 2) ? al1 : al0;

      // the S accumulator's layout is wgmma's A-fragment layout: keys
      // 16kk..16kk+15 of rows row0/row1 are sc[8kk .. 8kk+7]
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
      const uint32_t v_addr = smem_u32(vs + s * C::KV_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        Mma<HD>::rs(acc, pa[kk],
                    make_desc(v_addr + kk * 16 * C::SWB, BK * C::SWB,
                              8 * C::SWB, C::LAYOUT));
      wgmma_commit_and_wait();
      fence_regs(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);   // stage s may be refilled
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  __nv_bfloat16* o0 = o + ((size_t)b * Sq + row0) * H * HD + (size_t)h * HD;
  __nv_bfloat16* o1 = o0 + (size_t)8 * H * HD;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    if (row0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * j + cq) =
          __floats2bfloat162_rn(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
    if (row1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(o1 + 8 * j + cq) =
          __floats2bfloat162_rn(acc[4 * j + 2] * inv1,
                                acc[4 * j + 3] * inv1);
  }
}

// cuTensorMapEncodeTiled lives in libcuda, not in the runtime: its address
// comes from the runtime's entry-point query, so the library needs no
// -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (rc == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor (B, S, heads, hd) as the 4-D map (hd, heads, S, B), read in
// boxes of (ch, 1, rows, 1); elements outside it read as zeros.
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int B,
              int S, int heads, int hd, int ch, int rows,
              CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)S * heads * hd * 2};
  const cuuint32_t box[4] = {(cuuint32_t)ch, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int H, int KV, int causal, int window,
           cudaStream_t stream) {
  using C = Cfg<HD>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -2;
  CUtensorMap mq, mk, mv;
  if (!make_map(encode, &mq, q, B, Sq, H, HD, C::CH, BLOCK_Q, C::SWIZZLE) ||
      !make_map(encode, &mk, k, B, Sk, KV, HD, C::CH, C::BK, C::SWIZZLE) ||
      !make_map(encode, &mv, v, B, Sk, KV, HD, C::CH, C::BK, C::SWIZZLE))
    return -3;
  cudaError_t rc = cudaFuncSetAttribute(
      flash_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (rc != cudaSuccess) return (int)rc;
  const dim3 grid(H, B, (Sq + BLOCK_Q - 1) / BLOCK_Q);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)HD);
  flash_tc_kernel<HD><<<grid, THREADS, C::SMEM, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), Sq, Sk, H, KV, scale_log2,
      causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns 0 on success, -1 for a head dim this kernel does not take, -2 if
// libcuda has no cuTensorMapEncodeTiled, -3 if a tensor map was
// refused, else the cudaError_t of the launch.
extern "C" int repro_flash_attention_tc_fwd(const void* q, const void* k,
                                            const void* v, void* o, int B,
                                            int Sq, int Sk, int H, int KV,
                                            int hd, int causal, int window,
                                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Sk == 0)   // no key at all: every row gives 0
    return (int)cudaMemsetAsync(o, 0, (size_t)B * Sq * H * hd * 2, s);
  switch (hd) {
    case 16: return launch<16>(q, k, v, o, B, Sq, Sk, H, KV, causal, window, s);
    case 32: return launch<32>(q, k, v, o, B, Sq, Sk, H, KV, causal, window, s);
    case 64: return launch<64>(q, k, v, o, B, Sq, Sk, H, KV, causal, window, s);
    case 80: return launch<80>(q, k, v, o, B, Sq, Sk, H, KV, causal, window, s);
    case 128:
      return launch<128>(q, k, v, o, B, Sq, Sk, H, KV, causal, window, s);
    default:
      return -1;
  }
}
