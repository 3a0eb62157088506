// Hopper (sm_90a) tensor-core building blocks for the train kernels:
// warpgroup matrix multiply (wgmma) on operands in 128-byte-swizzled shared
// memory, staged by cp.async, and the 128 x 128 block GEMMs built on them:
// bf16 (gemm) and f32 as split-TF32 (gemm_tf32, at the end of this file).
//
// Shared-memory layout. An operand tile is a stack of 128-byte lines (64
// bf16 values); 16-byte chunk c of line r sits at chunk c ^ (r % 8), the
// layout TMA's 128-byte swizzle produces. A tile starts 1024-byte aligned.
//  * K-major (the reduction index runs along the line): line r is row r of
//    the operand (M or N index), 64 reduction values wide. Descriptor: SBO =
//    1024 (eight lines), LBO unused; step k16 advances the start by 32 B.
//  * MN-major (the M or N index runs along the line): line r is reduction
//    row r; a tile wider than 64 in M or N is a row of 64-wide atoms, each
//    BK lines deep, LBO bytes apart. Descriptor: SBO = 1024, LBO = atom
//    stride; step k16 advances the start by 16 lines (2048 B).
// The accumulator of m64nNk16 in a warpgroup: thread t (warp w = t / 32,
// lane l = t % 32) holds d[j] at row 16 w + l / 4 + 8 ((j % 4) / 2) and
// column 8 (j / 4) + 2 (l % 4) + j % 2.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace wg {

constexpr int LINE = 128;  // bytes of one swizzled line

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c (0..7) of line r inside a swizzled tile.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * LINE + ((c ^ (r & 7)) << 4));
}

// Shared-memory matrix descriptor, 128-byte swizzle.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo & 0x3FFFF) >> 4) << 16;
  d |= (uint64_t)((sbo & 0x3FFFF) >> 4) << 32;
  d |= 1ull << 62;
  return d;
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Make this thread's generic-proxy shared-memory writes visible to wgmma.
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d[64] (+)= A[64 x 16] B[16 x 128], bf16 in, f32 accumulate. TA / TB: 0 for
// a K-major operand, 1 for an MN-major one. scale_d = 0 overwrites d.
template <int TA, int TB>
__device__ __forceinline__ void mma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                               int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// 16-byte asynchronous copy global -> shared; src_bytes < 16 zero-fills the
// rest (0: nothing is read, src only has to be a valid address).
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void st16(uint32_t dst, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ------------------------------------------------------------ block GEMM

// A block of 256 threads (two warpgroups) forms a 128 x 128 f32 tile over
// a reduction cut into 64-deep stages: warpgroup w owns rows 64 w .. 64 w +
// 63. Each stage holds an A tile and a B tile of 16 KB each; a ring of
// three stages (97 KB with the alignment slack) keeps two stages' copies in
// flight while the tensor cores work on a third, and lets two blocks share
// an SM, so one block's loads and barriers hide behind the other's wgmma.
constexpr int BM = 128, BN = 128, BK = 64;
constexpr int NTH = 256;
constexpr int STAGES = 3;
constexpr int TILE = 16384;            // bytes of one operand tile
constexpr int STAGE = 2 * TILE;
constexpr int SMEM = STAGES * STAGE + 1024;  // + slack to align the ring to 1024 B
constexpr int BLOCKS_PER_SM = 2;

// Chunk u (0..3) of this thread in a 1024-chunk operand tile: idx.
__device__ __forceinline__ int chunk(int u) { return threadIdx.x + NTH * u; }

// 8 bf16 values of row `row` from column k (len columns in the row) into
// the 16-byte shared chunk at dst: one cp.async when the row is 16-byte
// aligned (vec), else element loads; zeros past len or for a null row.
__device__ __forceinline__ void stage8(uint32_t dst, const __nv_bfloat16* row, int k, int len,
                                       bool vec) {
  if (row == nullptr || k >= len) {
    st16(dst, make_uint4(0u, 0u, 0u, 0u));
  } else if (vec) {
    const int n = len - k < 8 ? len - k : 8;
    cp16(dst, row + k, 2 * n);
  } else {
    const unsigned short* p = reinterpret_cast<const unsigned short*>(row) + k;
    uint32_t w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t lo = k + 2 * q < len ? p[2 * q] : 0u;
      const uint32_t hi = k + 2 * q + 1 < len ? p[2 * q + 1] : 0u;
      w[q] = lo | (hi << 16);
    }
    st16(dst, make_uint4(w[0], w[1], w[2], w[3]));
  }
}

// The same from an f32 row, rounded to bf16 (round to nearest even).
__device__ __forceinline__ void stage8(uint32_t dst, const float* row, int k, int len,
                                       bool vec) {
  float v[8];
  if (row != nullptr && vec && k + 8 <= len) {
    const float4 x = *reinterpret_cast<const float4*>(row + k);
    const float4 y = *reinterpret_cast<const float4*>(row + k + 4);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    v[4] = y.x; v[5] = y.y; v[6] = y.z; v[7] = y.w;
  } else {
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = (row != nullptr && k + q < len) ? row[k + q] : 0.0f;
  }
  st16(dst, make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
                       pack2(v[6], v[7])));
}

// Keep the compiler from moving accumulator registers across wgmma's
// asynchronous window (a move there would serialize the wgmma chain).
__device__ __forceinline__ void fence_acc(float (&acc)[64]) {
#pragma unroll
  for (int j = 0; j < 64; ++j) asm volatile("" : "+f"(acc[j])::"memory");
}

// acc = sum over the nk stages of A B for this warpgroup's 64 rows. `load(dst,
// kt)` stages stage kt's A tile at dst and its B tile at dst + TILE (with
// cp.async and/or plain shared stores), called for kt = 0, 1, 2, ... in
// order. MN: both operands MN-major (each tile two 64-wide atoms, 8 KB
// apart) rather than K-major. `ring` is the 1024-aligned shared address of
// the STAGES-stage ring. Stage kt + 2's copies are issued while stage kt's
// products run.
template <bool MN, typename Load>
__device__ __forceinline__ void gemm(float (&acc)[64], uint32_t ring, int nk, Load&& load) {
  constexpr uint32_t KSTEP = MN ? 16 * LINE : 32;  // bytes per k16 step
  constexpr uint32_t LBO = MN ? 8 * 1024 : 16;
  const uint32_t a_off = (threadIdx.x / 128) * 8192;  // this warpgroup's 64 rows
#pragma unroll
  for (int j = 0; j < 64; ++j) acc[j] = 0.0f;
  fence_acc(acc);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(ring + s * STAGE, s);
    cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<STAGES - 2>();
    proxy_fence();
    __syncthreads();  // stage kt is in; stage kt - 1 is no longer read
    const uint32_t sa = ring + (kt % STAGES) * STAGE, sb = sa + TILE;
    fence_acc(acc);
    fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      mma_m64n128k16<MN, MN>(acc, desc(sa + a_off + kk * KSTEP, LBO, 1024),
                             desc(sb + kk * KSTEP, LBO, 1024), 1);
    commit();
    fence_acc(acc);
    const int nxt = kt + STAGES - 1;
    if (nxt < nk) load(ring + (nxt % STAGES) * STAGE, nxt);
    cp_commit();
    wait<0>();
    fence_acc(acc);
  }
}

// Row and column inside the block tile of accumulator element j.
__device__ __forceinline__ int acc_row(int j) {
  const int t = threadIdx.x;
  return (t / 128) * 64 + ((t / 32) % 4) * 16 + (t % 32) / 4 + 8 * ((j % 4) / 2);
}
__device__ __forceinline__ int acc_col(int j) {
  return 8 * (j / 4) + 2 * (threadIdx.x % 4) + j % 2;
}

// Epilogues that walk the f32 tile row by row (so that their loads and
// stores of residuals coalesce) stage it in the ring first, EPI_PITCH floats
// a row: the float2 stores below are then free of bank conflicts.
constexpr int EPI_PITCH = BN + 8;
static_assert(BM * EPI_PITCH * 4 <= STAGES * STAGE, "staged tile exceeds the ring");

// After gemm(): wait until both warpgroups are done with the ring, write
// the accumulator to the ring as a [BM][EPI_PITCH] f32 tile and return it
// once every thread's part is in.
__device__ __forceinline__ const float* stage_tile(float (&acc)[64], unsigned char* smem_raw,
                                                   uint32_t ring) {
  __syncthreads();
  float* tile = reinterpret_cast<float*>(smem_raw + (ring - smem_u32(smem_raw)));
#pragma unroll
  for (int j = 0; j < 64; j += 2)
    *reinterpret_cast<float2*>(tile + acc_row(j) * EPI_PITCH + acc_col(j)) =
        make_float2(acc[j], acc[j + 1]);
  __syncthreads();
  return tile;
}

// ------------------------------------------------- split-TF32 block GEMM
//
// f32 products on the tensor cores. Each f32 operand x is split into
// hi = TF32(x) and lo = TF32(x - hi), both rounded to nearest (cvt.rna; hi +
// lo is within 2^-21 |x| of x), and a product a b is formed as hi_a hi_b +
// hi_a lo_b + lo_a hi_b: three m64n128k8 TF32 wgmmas a k8 step (a TF32
// product is exact in f32; the dropped lo lo is ~2^-22 of it). A stage is 32
// reduction values deep (one 128-byte line of f32) and holds four tiles: A
// hi, A lo, B hi, B lo, 16 KB each, both operands K-major (TF32 wgmma has
// no transpose). Three stages are 192 KB, so one block an SM. Each stage's
// product is formed afresh on the tensor cores (12 wgmmas, accumulating) and
// added to the running sum in f32 registers, so that the sum over a long
// reduction rounds as IEEE f32 does rather than as the tensor cores'
// accumulator does; one writer per element, a fixed order, so two runs are
// bitwise equal. The same scheme as the f32 sampler (fused_generate.cu).
// The choice for this card: 32-deep stages (one 128-byte line of f32, the
// 128-byte swizzle), three of them, one block of 256 threads an SM (the
// ring is 192 KB, and the stage product plus its f32 sum hold 128
// registers a thread: a second block would get neither). Measured with
// python -m mlx_vae_tpu_torch.bench_train_f32 on an H100 80GB HBM3 at 700 W
// (PERF.md, PR 17): a stage takes ~1.5 us where its products alone need
// ~0.84; a forward step launch at the default model takes 31 / 37 us by
// layer (12 / 16 stages) whenever the grid is one wave. Fetching A a stage
// ahead took a stage from ~3.9 us; one product instead of three, adding to
// the sum every second stage, dropping the weight's lo plane, fetching two
// stages ahead and rotating each row block's first stage each left it
// where it is. Programmatic dependent launch of the step launches saved
// 1-4% but lets consecutive step kernels overlap, which the profile's
// device time by kernel then counts twice; not used.
constexpr int TF_BK = 32;  // f32 reduction values a stage
constexpr int TF_STAGES = 3;
constexpr int TF_STAGE = 4 * TILE;  // A hi, A lo, B hi, B lo
constexpr int TF_SMEM = TF_STAGES * TF_STAGE + 1024;  // 197,632 B with the alignment slack
constexpr int TF_BLOCKS_PER_SM = 1;
static_assert(BM * EPI_PITCH * 4 <= TF_STAGES * TF_STAGE, "staged tile exceeds the ring");

// TF32 of x, rounded to nearest (ties away from zero): the low 13 bits zero.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// d[64] (+)= A[64 x 8] B[8 x 128], tf32 in, f32 accumulate, both K-major;
// scale_d = 0 overwrites d.
__device__ __forceinline__ void mma_m64n128k8_tf32(float (&d)[64], uint64_t da, uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ uint4 tf32_hi4(const float (&v)[4]) {
  return make_uint4(tf32_rna(v[0]), tf32_rna(v[1]), tf32_rna(v[2]), tf32_rna(v[3]));
}
__device__ __forceinline__ uint4 tf32_lo4(const float (&v)[4], uint4 hi) {
  return make_uint4(tf32_rna(v[0] - __uint_as_float(hi.x)), tf32_rna(v[1] - __uint_as_float(hi.y)),
                    tf32_rna(v[2] - __uint_as_float(hi.z)), tf32_rna(v[3] - __uint_as_float(hi.w)));
}

// 4 f32 values of row `row` from column k (len columns in the row): one
// float4 load where vec (the row 16-byte aligned at k), else element loads;
// zeros past len or for a null row.
__device__ __forceinline__ float4 load4(const float* row, int k, int len, bool vec) {
  if (row != nullptr && vec && k + 4 <= len) return *reinterpret_cast<const float4*>(row + k);
  float v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = (row != nullptr && k + q < len) ? row[k + q] : 0.0f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// Split 4 values into the 16-byte chunk at dst (hi) and at dst + TILE (lo).
__device__ __forceinline__ void put4_split(uint32_t dst, float4 x) {
  const float v[4] = {x.x, x.y, x.z, x.w};
  const uint4 hi = tf32_hi4(v);
  st16(dst, hi);
  st16(dst + TILE, tf32_lo4(v, hi));
}

// An MN-major 4 x 4 block: rows[u] (u = 0..3: reduction rows 4 mg + u of a
// stage) at columns col .. col + 3, into v[u][i] (load4 each).
__device__ __forceinline__ void load_t4(float4 (&v)[4], const float* const (&rows)[4], int col,
                                        int len, bool vec) {
#pragma unroll
  for (int u = 0; u < 4; ++u) v[u] = load4(rows[u], col, len, vec);
}

// ... transposed while it is split: column col + i goes to line line0 + i
// of the tile, chunk mg (hi at dst, lo at dst + TILE), so each line holds
// 32 reduction values (K-major, as TF32 wgmma reads). A quarter-warp (eight
// mg) writes one whole line: no bank conflict.
__device__ __forceinline__ void put_t4(uint32_t dst, const float4 (&v)[4], int line0, int mg) {
  put4_split(dst + swz(line0, mg), make_float4(v[0].x, v[1].x, v[2].x, v[3].x));
  put4_split(dst + swz(line0 + 1, mg), make_float4(v[0].y, v[1].y, v[2].y, v[3].y));
  put4_split(dst + swz(line0 + 2, mg), make_float4(v[0].z, v[1].z, v[2].z, v[3].z));
  put4_split(dst + swz(line0 + 3, mg), make_float4(v[0].w, v[1].w, v[2].w, v[3].w));
}

// sum = A B over the nk stages for this warpgroup's 64 rows, as
// split-TF32 (above). Each stage is loaded in two calls, in order of kt:
// `fetch(kt)` issues its global loads into registers the caller keeps (one
// stage's worth), and `put(dst, kt)` splits them and stores the stage at dst
// (A hi, A lo at dst + TILE, B hi at dst + 2 TILE, B lo at dst + 3 TILE).
// Stage kt + 2 is put
// while stage kt's products run, from registers fetched while stage kt - 1's
// ran: a global load has a whole stage to land before its values are
// needed. `ring` is the 1024-aligned shared address of the TF_STAGES-stage
// ring.
template <typename Fetch, typename Put>
__device__ __forceinline__ void gemm_tf32(float (&sum)[64], uint32_t ring, int nk, Fetch&& fetch,
                                          Put&& put) {
  const uint32_t a_off = (threadIdx.x / 128) * 8192;  // this warpgroup's 64 rows
  float acc[64];
#pragma unroll
  for (int j = 0; j < 64; ++j) {
    sum[j] = 0.0f;
    acc[j] = 0.0f;
  }
  fence_acc(acc);
#pragma unroll
  for (int s = 0; s < TF_STAGES - 1; ++s) {
    if (s < nk) {
      fetch(s);
      put(ring + s * TF_STAGE, s);
    }
    cp_commit();
  }
  if (TF_STAGES - 1 < nk) fetch(TF_STAGES - 1);
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<TF_STAGES - 2>();
    proxy_fence();
    __syncthreads();  // stage kt is in; stage kt - 1 is no longer read
    const uint32_t sa = ring + (kt % TF_STAGES) * TF_STAGE + a_off, sb = ring +
        (kt % TF_STAGES) * TF_STAGE + 2 * TILE;
    fence_acc(acc);
    fence();
#pragma unroll
    for (int kk = 0; kk < TF_BK / 8; ++kk) {
      const uint64_t ahi = desc(sa + kk * 32, 16, 1024), alo = desc(sa + TILE + kk * 32, 16, 1024);
      const uint64_t bhi = desc(sb + kk * 32, 16, 1024), blo = desc(sb + TILE + kk * 32, 16, 1024);
      mma_m64n128k8_tf32(acc, ahi, bhi, kk > 0);
      mma_m64n128k8_tf32(acc, ahi, blo, 1);
      mma_m64n128k8_tf32(acc, alo, bhi, 1);
    }
    commit();
    fence_acc(acc);
    const int nxt = kt + TF_STAGES - 1;
    if (nxt < nk) put(ring + (nxt % TF_STAGES) * TF_STAGE, nxt);
    if (nxt + 1 < nk) fetch(nxt + 1);
    cp_commit();
    wait<0>();
    fence_acc(acc);
#pragma unroll
    for (int j = 0; j < 64; ++j) sum[j] += acc[j];
  }
}

}  // namespace wg
