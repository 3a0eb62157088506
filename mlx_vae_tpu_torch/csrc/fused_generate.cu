// Fused autoregressive sampler for the AR-CVAE decoder, for Hopper (sm_90a).
//
// Replaces the TPU kernel mlx_vae_tpu/ops/pallas_decoder.py:_kernel (reached
// through pallas_generate). One launch runs the whole sampling loop of L
// steps: token embedding (a row read), the n stacked LSTM cells, the vocab
// projection, temperature scaling, optional top-k / nucleus truncation by
// bisection, Gumbel-max sampling and EOS -> pad masking. The plain PyTorch
// version of the same function is fused_generate_reference in
// mlx_vae_tpu_torch/ops/fused_decoder.py (fused_generate_split_reference is
// the tensor-core kernel's layout twin); that module also builds this file
// with nvcc and binds it through ctypes (plain C interface below).
//
// Two kernels, routed by config before any launch
// (fused_decoder.py:fused_generate_tc_supported), never by batch size:
//
// gen_tc_kernel (tensor cores; the default model in f32 and bf16):
//  * A cluster of S CTAs owns a 64-row tile (one wgmma M) for all L steps;
//    tiles are independent. CTA r of the cluster owns Uc = H / S hidden units
//    of every layer, with all four gates of each: 4 Uc gate columns, 64 per
//    warpgroup (16 units), in the gate-interleaved K-major weight copy that
//    prepare_weights builds (column 64 (u / 16) + 32 ((u % 16) / 8) + 8 q +
//    u % 8 holds gate q of unit u), so one m64n64 accumulator fragment holds
//    i, f, g and o of 8 (row, unit) pairs per thread and the cell runs in the
//    epilogue. Only N is split: every gate column sums the same wgmma
//    instructions (always m64n64) over the same K order whatever S, B or the
//    tile, so a row's tokens do not depend on them.
//  * Per (step, layer) one GEMM [x | h] W over K stages of one 128-byte line
//    a row (64 bf16 or 32 f32 reduction values): a 3-stage ring holds the A
//    line and this CTA's B tiles in 128-byte-swizzled layout (csrc/wgmma.cuh);
//    B (the weights) streams from L2 by TMA (cp.async.bulk.tensor, one thread,
//    completing on an mbarrier a slot; the tensor maps come from
//    cuTensorMapEncodeTiled, fetched through cudaGetDriverEntryPoint, so the
//    library needs no -lcuda); A is staged by the threads from the step's
//    sources: the token's embedding row and the conditions (global), and h,
//    which each CTA keeps only for its own units (double-buffered by step
//    parity) and the others read through DSMEM (ld.shared::cluster), their
//    loads issued two stages ahead and left in flight. After each layer's
//    epilogue, and after the sampling, the cluster barrier
//    (barrier.cluster arrive.release / wait.acquire) opens the next phase; a
//    phase issues its first B copies before it waits.
//  * Each stage's product is formed afresh on the tensor cores and added to
//    the running sum in f32 registers: the tensor cores' accumulation rounds
//    otherwise than IEEE f32, and accumulating whole phases there made bf16's
//    truncated sampling drift from the plain version (PERF.md, row 1).
//  * f32 runs split-TF32: every product is hi*hi + hi*lo + lo*hi (three
//    m64n64k8 TF32 wgmmas per k8 step, f32 accumulation; the dropped lo*lo is
//    ~2^-22 of each product), with hi = TF32(x) and lo = TF32(x - hi), both
//    rounded to nearest (cvt.rna). The weights are split once in
//    prepare_weights, A in the staging. bf16 runs m64n64k16. h and c stay
//    f32 between steps (bf16: h is kept as its bf16 operand copy, the only
//    form the sums read).
//  * The head: every CTA of the cluster forms the tile's logits [64, V] on
//    wgmma from the top h, warpgroup w the 64-column tile w (a CTA has
//    max(Uc / 16, ceil(V / 64)) warpgroups, rounded up to 1, 2 or 4;
//    warpgroups past its gate tiles repeat one in the layer phases and drop
//    it), then samples 64 / S of the rows (one warp a row, the arithmetic of
//    the CUDA-core kernel: sampling.cuh:sample_row) and writes their tokens into
//    every CTA's token array.
//  * Budget per CTA (default model, V=80, E=128, C=1, H=256, n=2): the ring
//    3 x (A line + W B tiles) = 3 x 8 KB x (1 + W) in bf16, twice that in f32
//    (hi and lo planes), W the warpgroups; own h 2 x n x 64 x Uc (bf16 2 B,
//    f32 4 B), c n x 64 x Uc x 4 B, the bias slice; the logits 64 x (V + 4) x
//    4 B reuse the ring. f32 at S = 8 (W = 2): 144 + 32 + 16 + 1 KB = 194.5 KB
//    of the 227 KB; so f32 takes S = 8 and 16, bf16 S = 4, 8 and 16 (W = 1, 2
//    or 4: 255, 255 or 128 registers a thread). The weights are not resident:
//    at S = 16 the bf16 slice (118 KB) would fit, f32's hi/lo pair would not.
//  * What bounds it: 1.878 MFLOP a row-step at the default model. bf16: the
//    operations over 989 TFLOP/s (B=8192 L=64: 0.996 ms); f32: three TF32
//    products over 495 TFLOP/s (5.967 ms). Each CTA streams its weight slice
//    once a step, so a step reads every tile's weights from L2. Measured on
//    an H100 (PERF.md, row 1; python -m mlx_vae_tpu_torch.bench_sampler_stages),
//    neither binds yet: a stage's products run at about the tensor cores'
//    peak, but the same warps then stage the next A lines and issue the next
//    TMA boxes, one after the other, and the 2n + 1 cluster barriers, the
//    cell and the sampling of a step come on top. A producer warpgroup of its
//    own would overlap the staging with the products.
//
// fused_generate_kernel (CUDA cores; every other config the gate takes):
//  * One thread block (NT = 256 threads) owns a tile of R rows for the whole
//    time loop. Shared memory holds the step's input rows xin [R][E+C], the
//    hidden state of every layer double-buffered h [2][n][R][H], and the cell
//    state c [n][R][H]; the host sizes R so that this fits
//    (fused_decoder.py:_smem_bytes).
//  * Threads are TR row groups x TJ hidden units; a thread owns unit j (and
//    j + TJ, ...) for RPT rows and computes all four gate dots of its (row,
//    j) pairs, each weight it loads (scalar loads from L2) serving RPT rows.
//    Matmul inputs are rounded to the compute dtype, products accumulate in
//    f32. One warp per row does the vocab projection and the sampling.
//  * What bounds it: each block's serial weight stream from L2 (the tile
//    sweep, chip_smoke.py --sweep, found a block's step time barely growing
//    from 1 to 8 rows per thread), with FMA on CUDA cores (67 TFLOP/s).
//
// Both: random numbers r24 = hash(block_seed, row_in_block, t, v) >> 8, a
// counter-based 32-bit multiply-xorshift hash (lowbias32) implemented
// identically in torch integer ops, so a seed block's tokens depend only on
// its own seed and temperature, wherever it sits in the batch (the serving
// layer's contract). Vocab lanes >= V never win the argmax and never count
// toward k or the nucleus mass; argmax ties go to the lowest index.
// Optionally (logits0 != null) the first step's scaled logits, before
// truncation and noise, are written out so that a test can hold them
// against the plain version as numbers.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>
#include <cuda.h>

#include "sampling.cuh"
#include "wgmma.cuh"

namespace {

using namespace samp;

constexpr int NT = 256;       // threads per block
constexpr int NW = NT / 32;   // warps per block

__device__ __forceinline__ float load_w(const float* p) { return *p; }
__device__ __forceinline__ float load_w(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Round a float32 operand to the compute dtype (round to nearest even, as
// torch's .to(bfloat16)).
template <typename WT> __device__ __forceinline__ float to_compute(float x);
template <> __device__ __forceinline__ float to_compute<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_compute<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / (1.0f + expf(-x)); }

struct Args {
  const void* emb;     // [V, E] compute dtype
  const void* wcat;    // per layer [(K_l + H), 4H] compute dtype, layers back to back
  const float* bias;   // [n, 4H]
  const void* wout;    // [H, V] compute dtype
  const float* bout;   // [V]
  const float* h0;     // [B, H]
  const float* cond;   // [B, C]
  const int* seeds;    // [nb]
  const float* temps;  // [nb]
  int* out;            // [B, L]
  float* logits0;      // [B, V] or null: step 0's scaled logits
  int B, L, V, E, C, H, n, block_rows;
  int greedy, top_k;
  float top_p;
  int R, TJ, TR;
  int start_token, end_token, pad_token;
};

template <typename WT, int RPT, int VPL>
__global__ void __launch_bounds__(NT)
fused_generate_kernel(const Args a) {
  extern __shared__ float smem[];
  const int H = a.H, K0 = a.E + a.C, n = a.n, R = a.R, V = a.V, L = a.L;
  const int G = 4 * H;
  float* xin = smem;                        // [R][K0]
  float* hbuf = xin + R * K0;               // [2][n][R][H]
  float* cbuf = hbuf + 2 * n * R * H;       // [n][R][H]
  int* tok = reinterpret_cast<int*>(cbuf + n * R * H);  // [R]
  int* ended = tok + R;                     // [R]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * R;
  const WT* emb = static_cast<const WT*>(a.emb);
  const WT* wcat = static_cast<const WT*>(a.wcat);
  const WT* wout = static_cast<const WT*>(a.wout);

  // h of every layer starts at h0, c at 0, the token at start_token.
  for (int idx = tid; idx < R * H; idx += NT) {
    int r = idx / H, j = idx % H, g = row0 + r;
    float v = g < a.B ? a.h0[(size_t)g * H + j] : 0.0f;
    for (int l = 0; l < n; ++l) {
      hbuf[(size_t)l * R * H + idx] = v;
      cbuf[(size_t)l * R * H + idx] = 0.0f;
    }
  }
  for (int r = tid; r < R; r += NT) { tok[r] = a.start_token; ended[r] = 0; }
  __syncthreads();

  const int tj = tid % a.TJ, tr = tid / a.TJ;
  const bool cell_thread = tr < a.TR;
  int p = 0;  // hbuf[p] holds the previous step's h

  for (int t = 0; t < L; ++t) {
    // ---- step input: embedding row of the token, then the conditions ----
    for (int idx = tid; idx < R * K0; idx += NT) {
      int r = idx / K0, k = idx % K0, g = row0 + r;
      float v = 0.0f;
      if (g < a.B)
        v = k < a.E ? load_w(emb + (size_t)tok[r] * a.E + k)
                    : a.cond[(size_t)g * a.C + (k - a.E)];
      xin[idx] = v;
    }
    __syncthreads();

    // ---- the n stacked LSTM cells ----
    size_t woff = 0;
    for (int l = 0; l < n; ++l) {
      const int Kin = l == 0 ? K0 : H;
      const WT* W = wcat + woff;
      const float* xs = l == 0 ? xin : hbuf + ((size_t)(p ^ 1) * n + (l - 1)) * R * H;
      const float* hs = hbuf + ((size_t)p * n + l) * R * H;
      float* hnew = hbuf + ((size_t)(p ^ 1) * n + l) * R * H;
      float* cs = cbuf + (size_t)l * R * H;
      const float* b = a.bias + (size_t)l * G;
      if (cell_thread) {
        for (int j = tj; j < H; j += a.TJ) {
          float acc[4][RPT];
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int i = 0; i < RPT; ++i) acc[q][i] = 0.0f;
#pragma unroll 4
          for (int k = 0; k < Kin; ++k) {
            const WT* wk = W + (size_t)k * G + j;
            float w0 = load_w(wk), w1 = load_w(wk + H), w2 = load_w(wk + 2 * H),
                  w3 = load_w(wk + 3 * H);
#pragma unroll
            for (int i = 0; i < RPT; ++i) {
              float xv = to_compute<WT>(xs[(tr + a.TR * i) * Kin + k]);
              acc[0][i] = fmaf(xv, w0, acc[0][i]);
              acc[1][i] = fmaf(xv, w1, acc[1][i]);
              acc[2][i] = fmaf(xv, w2, acc[2][i]);
              acc[3][i] = fmaf(xv, w3, acc[3][i]);
            }
          }
#pragma unroll 4
          for (int k = 0; k < H; ++k) {
            const WT* wk = W + (size_t)(Kin + k) * G + j;
            float w0 = load_w(wk), w1 = load_w(wk + H), w2 = load_w(wk + 2 * H),
                  w3 = load_w(wk + 3 * H);
#pragma unroll
            for (int i = 0; i < RPT; ++i) {
              float hv = to_compute<WT>(hs[(tr + a.TR * i) * H + k]);
              acc[0][i] = fmaf(hv, w0, acc[0][i]);
              acc[1][i] = fmaf(hv, w1, acc[1][i]);
              acc[2][i] = fmaf(hv, w2, acc[2][i]);
              acc[3][i] = fmaf(hv, w3, acc[3][i]);
            }
          }
          const float bi = b[j], bf = b[H + j], bg = b[2 * H + j], bo = b[3 * H + j];
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const int r = tr + a.TR * i;
            float ig = sigmoidf(acc[0][i] + bi);
            float fg = sigmoidf(acc[1][i] + bf);
            float gg = tanhf(acc[2][i] + bg);
            float og = sigmoidf(acc[3][i] + bo);
            float cn = fg * cs[r * H + j] + ig * gg;
            cs[r * H + j] = cn;
            hnew[r * H + j] = og * tanhf(cn);
          }
        }
      }
      woff += (size_t)(Kin + H) * G;
      __syncthreads();
    }

    // ---- vocab projection, truncation, sampling: one warp per row ----
    const float* htop = hbuf + ((size_t)(p ^ 1) * n + (n - 1)) * R * H;
    for (int r = warp; r < R; r += NW) {
      const int g = row0 + r;
      const int gc = g < a.B ? g : a.B - 1;  // rows past B compute, never store
      const int blk = gc / a.block_rows, rib = gc % a.block_rows;
      const float temp = fmaxf(a.temps[blk], 1e-6f);
      float s[VPL];
      bool valid[VPL];
#pragma unroll
      for (int u = 0; u < VPL; ++u) {
        const int v = lane + 32 * u;
        valid[u] = v < V;
        float acc = 0.0f;
        if (valid[u]) {
          for (int k = 0; k < H; ++k)
            acc = fmaf(to_compute<WT>(htop[r * H + k]), load_w(wout + (size_t)k * V + v), acc);
          s[u] = (acc + a.bout[v]) / temp;
          if (t == 0 && a.logits0 != nullptr && g < a.B) a.logits0[(size_t)g * V + v] = s[u];
        } else {
          s[u] = -BIG;
        }
      }
      const int besti = sample_row<VPL>(s, valid, V, a.greedy, a.top_k, a.top_p,
                                        (uint32_t)a.seeds[blk], (uint32_t)rib, t);
      if (lane == 0) {
        const int tk = ended[r] ? a.pad_token : besti;
        if (tk == a.end_token) ended[r] = 1;
        tok[r] = tk;
        if (g < a.B) a.out[(size_t)g * L + t] = tk;
      }
    }
    __syncthreads();
    p ^= 1;
  }
}

template <typename WT, int RPT, int VPL>
cudaError_t launch(const Args& a, size_t smem, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(fused_generate_kernel<WT, RPT, VPL>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  fused_generate_kernel<WT, RPT, VPL><<<(a.B + a.R - 1) / a.R, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

// Two vocab widths keep the number of instantiations (and the build) small.
template <typename WT, int RPT>
cudaError_t launch_vpl(const Args& a, size_t smem, cudaStream_t stream) {
  if (a.V <= 128) return launch<WT, RPT, 4>(a, smem, stream);
  return launch<WT, RPT, MAX_VPL>(a, smem, stream);
}

template <typename WT>
cudaError_t launch_rpt(const Args& a, int rpt, size_t smem, cudaStream_t stream) {
  switch (rpt) {
    case 1: return launch_vpl<WT, 1>(a, smem, stream);
    case 2: return launch_vpl<WT, 2>(a, smem, stream);
    case 4: return launch_vpl<WT, 4>(a, smem, stream);
    case 8: return launch_vpl<WT, 8>(a, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------- the tensor-core sampler

namespace tc {

constexpr int ROWS = 64;            // rows of a tile: one wgmma M
constexpr int UNITS_WG = 16;        // hidden units of one warpgroup: 64 gate columns
constexpr int STAGES = 3;           // depth of the operand ring
static_assert(STAGES >= 3, "stage kt + 2's A line goes into a slot no product reads");
constexpr int PLANE = ROWS * wg::LINE;  // 8 KB: 64 swizzled lines, one operand plane
constexpr int PAD = 8;              // elements past Uc in a row of own h and c: the cell's
                                    // stores and loads of 8 rows hit distinct banks

// A CTA's shared memory. What other CTAs of the cluster address (own h, the
// tokens) sits at fixed offsets from the start of the dynamic window, the
// same in every CTA (mapa maps an address to the same offset in the target);
// the ring follows, aligned to 1024 bytes, at an offset that may differ from
// CTA to CTA and is only ever used locally. ops/fused_decoder.py:
// _tc_smem_bytes computes the same total.
struct Plan {
  int Uc, UP, NWG, NB, VP, slot, ring_bytes, coff, boff, toff, bars, fixed, lbytes, bytes;
};

__host__ __device__ inline Plan plan(int H, int n, int V, int S, int head_tiles, int es) {
  Plan p;
  p.Uc = H / S;
  p.UP = p.Uc + PAD;  // row pitch of own h and c
  p.NWG = p.Uc / UNITS_WG;
  p.NB = p.NWG > head_tiles ? p.NWG : head_tiles;          // warpgroups, B tiles a stage
  p.VP = (V + 3) / 4 * 4 + 4;                              // logits row pitch (floats)
  p.slot = PLANE * (es == 4 ? 2 : 1) * (1 + p.NB);         // A line + B tiles, all planes
  p.ring_bytes = STAGES * p.slot;
  // own h [2][n][64][UP] at 0, own c [n][64][UP] f32, own bias [n][4][Uc]
  // f32, tokens [64] and ended [64], a full barrier a slot
  p.coff = 2 * n * ROWS * p.UP * es;
  p.boff = p.coff + n * ROWS * p.UP * 4;
  p.toff = p.boff + n * 4 * p.Uc * 4;
  p.bars = p.toff + 2 * ROWS * 4;
  p.fixed = p.bars + 8 * STAGES;
  // logits [64][VP] f32: in the ring where they fit (the head's products
  // are done with it by then, and the next phase's copies wait for the
  // sampling), else after it
  p.lbytes = ROWS * p.VP * 4;
  p.bytes = p.fixed + 1024 + p.ring_bytes + (p.lbytes <= p.ring_bytes ? 0 : p.lbytes);
  return p;
  return p;
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// This CTA's shared address `addr` as seen in CTA `rank` of the cluster.
__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ uint4 ld_cluster16(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_cluster(uint32_t addr, int v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
// TF32 of x, rounded to nearest (ties away from zero): the low 13 bits zero.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// mbarrier and TMA (cp.async.bulk.tensor) for the weight stream.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "TC_MBAR_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra TC_MBAR_WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// One 2-D box of the tensor map at (x = reduction element, y = row) into
// this CTA's shared memory at dst, completing on bar.
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map, int x, int y,
                                       uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void st_t(float* p, float v) { *p = v; }
__device__ __forceinline__ void st_t(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ void fence_acc(float (&acc)[32]) {
#pragma unroll
  for (int j = 0; j < 32; ++j) asm volatile("" : "+f"(acc[j])::"memory");
}

__device__ __forceinline__ uint64_t kdesc(uint32_t addr) { return wg::desc(addr, 16, 1024); }

// d[32] += A[64 x 16] B[16 x 64], bf16 in, f32 accumulate, both K-major.
__device__ __forceinline__ void mma_bf16(float (&d)[32], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[32] += A[64 x 8] B[8 x 64], tf32 in, f32 accumulate, both K-major.
__device__ __forceinline__ void mma_tf32(float (&d)[32], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// One 32-byte reduction step (k16 bf16, k8 tf32) of the A line against the B
// tile at descriptors da, db; scale_d = 0 starts acc afresh. f32: hi*hi +
// hi*lo + lo*hi, in that order; each lo plane sits one PLANE (PLANE / 16 in
// the descriptors' start field) after its hi plane.
__device__ __forceinline__ void mma_step(__nv_bfloat16*, float (&acc)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  mma_bf16(acc, da, db, scale_d);
}
__device__ __forceinline__ void mma_step(float*, float (&acc)[32], uint64_t da, uint64_t db,
                                         int scale_d) {
  mma_tf32(acc, da, db, scale_d);
  mma_tf32(acc, da, db + PLANE / 16, 1);
  mma_tf32(acc, da + PLANE / 16, db, 1);
}

struct TcArgs {
  const void* emb;      // [V, E] compute dtype
  const float* cond;    // [B, C]
  const float* h0;      // [B, H]
  const void* w;        // per layer [4H, Kp_l] (gate-interleaved rows, K-major), layers back
                        // to back: bf16, or the TF32 hi plane
  const void* wlo;      // the same, TF32 lo plane (f32), or null (bf16)
  const void* wout;     // [>= 64 head_tiles, Hp] K-major head weight, rows >= V zero
  const void* wout_lo;  // its lo plane, or null
  const float* bias;    // [n, 4H] gate-major
  const float* bout;    // [V]
  const int* seeds;     // [nb]
  const float* temps;   // [nb]
  int* out;             // [B, L]
  float* logits0;       // [B, V] or null
  int B, L, V, E, C, H, n, block_rows;
  int greedy, top_k;
  float top_p;
  int S, Xp, Hp;        // Xp, Hp: E + C and H padded to a stage's depth
  int head_tiles;       // the CTA's warpgroups (1, 2 or 4), a 64-column head tile each
  int start_token, end_token, pad_token;
  // TMA maps of the weight planes: layer l's at 2 l (hi or bf16) and 2 l + 1
  // (lo), the head's at 2 n and 2 n + 1; boxes of 64 rows x 128 bytes,
  // 128-byte swizzle
  CUtensorMap maps[2 * 8 + 2];
};

// What a phase's A staging reads: reduction columns k < kb come from the
// step input x (x0) or from the own-h slices at element h0off of every CTA's
// hbuf, columns kb and up from those at h1off.
struct ASrc {
  int kb, x0, h0off, h1off;
};

struct Ctx {
  const TcArgs* a;
  const int* tok;      // this CTA's copy of the tile's tokens
  uint32_t hbuf_s;     // shared address of own h
  int Uc, UP, ushift, row0, tid, nth, rank;  // Uc = 1 << ushift units, rows UP apart
};

// A stage's A line in flight: this thread's CH chunks of the 64 x 128-byte
// line (512 chunks over the CTA's threads): bf16 values, or f32 values
// before their split.
template <int CH>
struct ALine {
  uint4 v[CH];
};

// Fetch stage kt's A line into registers. The h columns are DSMEM loads
// that stay in flight until store_a uses them; the x columns (layer 0's
// first stages) are formed here from the token's embedding row and the
// conditions (bf16: rounded to nearest even, as torch's .to()).
template <typename T, int CH>
__device__ __forceinline__ void fetch_a(ALine<CH>& out, int kt, const ASrc& s, const Ctx& cx) {
  constexpr int es = sizeof(T), EPC = 16 / es, KC = 8 * EPC;
  const TcArgs& a = *cx.a;
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int idx = cx.tid + i * cx.nth;
    if (idx >= ROWS * 8) break;
    const int r = idx >> 3, c = idx & 7, k = kt * KC + c * EPC;
    if (k < s.kb && s.x0) {
      const int g = cx.row0 + r;
      float f[EPC];
#pragma unroll
      for (int e = 0; e < EPC; ++e) f[e] = 0.0f;
      if (g < a.B) {
        const T* er = static_cast<const T*>(a.emb) + (size_t)cx.tok[r] * a.E;
#pragma unroll
        for (int e = 0; e < EPC; ++e) {
          const int kk = k + e;
          f[e] = kk < a.E ? load_w(er + kk)
                          : (kk < a.E + a.C ? a.cond[(size_t)g * a.C + (kk - a.E)] : 0.0f);
        }
      }
      if constexpr (es == 2)
        out.v[i] = make_uint4(wg::pack2(f[0], f[1]), wg::pack2(f[2], f[3]),
                              wg::pack2(f[4], f[5]), wg::pack2(f[6], f[7]));
      else
        out.v[i] = make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                              __float_as_uint(f[2]), __float_as_uint(f[3]));
    } else {
      const int hk = k < s.kb ? k : k - s.kb;
      const int off = k < s.kb ? s.h0off : s.h1off;
      out.v[i] = make_uint4(0u, 0u, 0u, 0u);
      if (hk < a.H) {
        const int o = hk >> cx.ushift, jj = hk & (cx.Uc - 1);
        out.v[i] = ld_cluster16(mapa(cx.hbuf_s + (uint32_t)((off + r * cx.UP + jj) * es), o));
      }
    }
  }
}

// Store a fetched A line into a stage's slot (swizzled; f32: the TF32 hi
// plane, then the lo plane one PLANE on).
template <typename T, int CH>
__device__ __forceinline__ void store_a(uint32_t slot, const ALine<CH>& in, const Ctx& cx) {
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int idx = cx.tid + i * cx.nth;
    if (idx >= ROWS * 8) break;
    const uint32_t dst = slot + wg::swz(idx >> 3, idx & 7);
    if constexpr (sizeof(T) == 2) {
      wg::st16(dst, in.v[i]);
    } else {
      const uint32_t f[4] = {in.v[i].x, in.v[i].y, in.v[i].z, in.v[i].w};
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        hi[e] = tf32_rna(__uint_as_float(f[e]));
        lo[e] = tf32_rna(__uint_as_float(f[e]) - __uint_as_float(hi[e]));
      }
      wg::st16(dst, make_uint4(hi[0], hi[1], hi[2], hi[3]));
      wg::st16(dst + PLANE, make_uint4(lo[0], lo[1], lo[2], lo[3]));
    }
  }
}

// Stage kt's B tiles: rows row0 + 64 i (i < ntiles) of the weight planes
// at maps[m] (and maps[m + 1], the lo plane of f32), 128 bytes of reduction
// each, into tile i of the slot, by TMA, completing on bar. Called by every
// thread: lane 0 of warp w issues box w (tile w / P, plane w % P), so that no
// one warp waits for all the issues, and warp 0 also posts the byte count
// (a box may land before it: the phase cannot complete before warp 0's
// arrival). At most 4 boxes, and a CTA has at least 4 warps.
template <typename T>
__device__ __forceinline__ void load_b(uint32_t slot, uint32_t bar, int kt, const CUtensorMap* map,
                                       int row0, int ntiles) {
  constexpr int P = sizeof(T) == 4 ? 2 : 1;
  constexpr int KC = wg::LINE / sizeof(T);
  const int w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) != 0 || w >= ntiles * P) return;
  if (w == 0) mbar_expect(bar, ntiles * P * PLANE);
  const int i = w / P, q = w % P;
  tma_2d(slot + PLANE * P * (1 + i) + PLANE * q, map + q, kt * KC, row0 + 64 * i, bar);
}

// acc = sum over the nk stages of A line x B tile wgi % ntiles of the stage
// for this warpgroup (warpgroups past the phase's ntiles tiles repeat one,
// and their products go unused): each stage's product is formed afresh on
// the tensor cores and added to acc in f32 (round to nearest), so the tensor
// cores' own accumulation spans one 128-byte line of the reduction and the
// running sum rounds as IEEE f32 does. Slot s's B copies complete on the
// mbarrier at bars + 8 s, whose phase parity this thread tracks in `parity`
// (bit s) across phases. The first STAGES - 1 stages' B copies go out before
// the cluster barrier's wait (the weights depend on no other CTA); the A
// fetches, which read the other CTAs' h, come after it. Between stage kt's
// k steps, stage kt + STAGES - 1's B copies go out, stage kt + 2's A line
// (fetched two stages before, its loads in flight since) is stored, and
// stage kt + 4's A line is fetched. Ends with the ring free.
template <typename T, int CH, typename LB>
__device__ __forceinline__ void phase(float (&acc)[32], uint32_t ring, int slot, int nk,
                                      int ntiles, const ASrc& src, const Ctx& cx, uint32_t bars,
                                      uint32_t& parity, LB&& lb) {
  constexpr int P = sizeof(T) == 4 ? 2 : 1;
  const uint32_t btile = PLANE * P * (1 + (threadIdx.x >> 7) % ntiles);
  float part[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) acc[j] = part[j] = 0.0f;
  wg::proxy_fence();  // the ring's generic accesses (the logits) come before the copies
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s)
    if (s < nk) lb(ring + s * slot, bars + 8 * s, s);
  cluster_wait();
  ALine<CH> la, lb2;  // the A lines of the next two stages to store
  fetch_a<T>(la, 0, src, cx);
  if (nk > 1) fetch_a<T>(lb2, 1, src, cx);
  store_a<T>(ring, la, cx);
  if (nk > 1) store_a<T>(ring + slot, lb2, cx);
  wg::proxy_fence();
  if (nk > 2) fetch_a<T>(la, 2, src, cx);
  if (nk > 3) fetch_a<T>(lb2, 3, src, cx);
  auto step = [&](int kt, ALine<CH>& line) {
    const int cur = kt % STAGES;
    mbar_wait(bars + 8 * cur, (parity >> cur) & 1u);  // stage kt's B is in
    parity ^= 1u << cur;
    __syncthreads();  // stage kt's A is in; stage kt - 1's slot is no longer read
    const uint32_t sa = ring + cur * slot;
    fence_acc(part);
    const uint64_t da = kdesc(sa), db = kdesc(sa + btile);  // a 32-byte k step adds 2
    const uint64_t da1 = da + 2, db1 = db + 2, da2 = da + 4, db2 = db + 4, da3 = da + 6,
                   db3 = db + 6;
    const int nb = kt + STAGES - 1, na = kt + 2;  // the next B copies and A line
    // A wgmma's issue waits for the tensor cores, so the staging of later
    // stages goes between this stage's k steps
    wg::fence();
    mma_step(static_cast<T*>(nullptr), part, da, db, 0);
    if (nb < nk) lb(ring + (nb % STAGES) * slot, bars + 8 * (nb % STAGES), nb);
    mma_step(static_cast<T*>(nullptr), part, da1, db1, 1);
    if (na < nk) {
      store_a<T>(ring + (na % STAGES) * slot, line, cx);  // line holds stage na
      wg::proxy_fence();
    }
    mma_step(static_cast<T*>(nullptr), part, da2, db2, 1);
    if (na + 2 < nk) fetch_a<T>(line, na + 2, src, cx);
    mma_step(static_cast<T*>(nullptr), part, da3, db3, 1);
    wg::commit();
    fence_acc(part);
    wg::wait<0>();
    fence_acc(part);
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] += part[j];
  };
  int kt = 0;
  for (; kt + 1 < nk; kt += 2) {
    step(kt, la);
    step(kt + 1, lb2);
  }
  if (kt < nk) step(kt, la);
  __syncthreads();
}

// The head's products and the sampling of one step: the logits of the
// tile's 64 rows (warpgroup w its 64-column tile w), then 64 / S rows sampled
// here, their tokens written into every CTA of the cluster.
template <typename T, int VPL, int CH>
__device__ __forceinline__ void head_step(int t, uint32_t ring, const Plan& pl, float* logits,
                                          int* ended, uint32_t tok_s, uint32_t bars,
                                          uint32_t& parity, const ASrc& src, const Ctx& cx) {
  const TcArgs& a = *cx.a;
  float acc[32];
  const CUtensorMap* map = &a.maps[2 * a.n];
  phase<T, CH>(acc, ring, pl.slot, a.Hp * (int)sizeof(T) / wg::LINE, pl.NB, src, cx, bars,
               parity, [&](uint32_t slot, uint32_t bar, int kt) {
                 load_b<T>(slot, bar, kt, map, 0, pl.NB);
               });
  const int tid = cx.tid, lane = tid & 31, wq = (tid & 127) >> 5, ti = tid >> 7;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int v = 64 * ti + 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
    const int r = 16 * wq + (lane >> 2) + 8 * ((j & 3) >> 1);
    if (v < a.V) logits[r * pl.VP + v] = acc[j];
  }
  __syncthreads();
  const int RS = ROWS / a.S;
  for (int rl = tid >> 5; rl < RS; rl += cx.nth >> 5) {
    const int r = cx.rank * RS + rl, g = cx.row0 + r;
    const int gc = g < a.B ? g : a.B - 1;  // rows past B compute, never store
    const int blk = gc / a.block_rows, rib = gc % a.block_rows;
    const float temp = fmaxf(a.temps[blk], 1e-6f);
    float s[VPL];
    bool valid[VPL];
#pragma unroll
    for (int u = 0; u < VPL; ++u) {
      const int v = lane + 32 * u;
      valid[u] = v < a.V;
      if (valid[u]) {
        s[u] = (logits[r * pl.VP + v] + a.bout[v]) / temp;
        if (t == 0 && a.logits0 != nullptr && g < a.B) a.logits0[(size_t)g * a.V + v] = s[u];
      } else {
        s[u] = -BIG;
      }
    }
    const int besti = sample_row<VPL>(s, valid, a.V, a.greedy, a.top_k, a.top_p,
                                      (uint32_t)a.seeds[blk], (uint32_t)rib, t);
    if (lane == 0) {
      const int tk = ended[r] ? a.pad_token : besti;
      if (tk == a.end_token) ended[r] = 1;
      for (int o = 0; o < a.S; ++o) st_cluster(mapa(tok_s + 4u * r, o), tk);
      if (g < a.B) a.out[(size_t)g * a.L + t] = tk;
    }
  }
  __syncthreads();  // the logits are read: the ring is free for the next copies
}

template <typename T, int VPL, int MAXT>
__global__ void __launch_bounds__(MAXT, 1) gen_tc_kernel(const __grid_constant__ TcArgs a) {
  constexpr int CH = 512 / MAXT;  // A chunks a thread: the 512 of a line over MAXT threads
  extern __shared__ unsigned char smem_raw[];
  constexpr int es = sizeof(T);
  const int H = a.H, n = a.n, S = a.S, G = 4 * H;
  const Plan pl = plan(H, n, a.V, S, a.head_tiles, es);
  const uint32_t sbase = wg::smem_u32(smem_raw);
  const uint32_t ring = (sbase + pl.fixed + 1023u) & ~1023u;
  T* hbuf = reinterpret_cast<T*>(smem_raw);                    // [2][n][64][Uc]
  float* cbuf = reinterpret_cast<float*>(smem_raw + pl.coff);  // [n][64][Uc]
  float* logits = reinterpret_cast<float*>(
      smem_raw + (ring - sbase) + (pl.lbytes <= pl.ring_bytes ? 0 : pl.ring_bytes));
  int* tok = reinterpret_cast<int*>(smem_raw + pl.toff);
  int* ended = tok + ROWS;
  const int Uc = pl.Uc, nwg = pl.NWG, tid = threadIdx.x;
  Ctx cx;
  cx.a = &a;
  cx.tok = tok;
  cx.hbuf_s = sbase;
  cx.Uc = Uc;
  cx.UP = pl.UP;
  cx.ushift = __ffs(Uc) - 1;
  cx.row0 = (blockIdx.x / S) * ROWS;
  cx.tid = tid;
  cx.nth = 128 * pl.NB;
  cx.rank = (int)cluster_rank();
  const int lane = tid & 31, wq = (tid & 127) >> 5, wgi = tid >> 7;
  const int UP = pl.UP, slice = ROWS * UP;  // elements of one own-h or c slice
  auto hoff = [&](int buf, int l) { return (buf * n + l) * slice; };

  // h of every layer starts at h0 (buffer 1 holds "step -1"), c at 0, the
  // tokens at start_token.
  for (int idx = tid; idx < ROWS * Uc; idx += cx.nth) {
    const int r = idx / Uc, j = idx % Uc, g = cx.row0 + r;
    const float v = g < a.B ? a.h0[(size_t)g * H + cx.rank * Uc + j] : 0.0f;
    for (int l = 0; l < n; ++l) {
      st_t(hbuf + hoff(1, l) + r * UP + j, v);
      cbuf[l * slice + r * UP + j] = 0.0f;
    }
  }
  for (int r = tid; r < ROWS; r += cx.nth) {
    tok[r] = a.start_token;
    ended[r] = 0;
  }
  float* bsm = reinterpret_cast<float*>(smem_raw + pl.boff);  // [n][4][Uc]: this CTA's bias
  for (int idx = tid; idx < n * 4 * Uc; idx += cx.nth) {
    const int l = idx / (4 * Uc), q = (idx / Uc) % 4, j = idx % Uc;
    bsm[idx] = a.bias[(size_t)l * G + q * H + cx.rank * Uc + j];
  }
  const uint32_t bars = sbase + pl.bars;  // a full barrier a slot
  if (tid < 2 * n + 2 && (sizeof(T) == 4 || tid % 2 == 0))  // the maps in use, into cache
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&a.maps[tid]))
                 : "memory");
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  uint32_t parity = 0;
  cluster_arrive();

  for (int t = 0; t < a.L; ++t) {
    const int cur = t & 1, prv = cur ^ 1;
    for (int l = 0; l < n; ++l) {
      const int kb = l == 0 ? a.Xp : a.Hp, Kp = kb + a.Hp;
      const ASrc src = {kb, l == 0, l == 0 ? 0 : hoff(cur, l - 1), hoff(prv, l)};
      const CUtensorMap* map = &a.maps[2 * l];
      float acc[32];
      phase<T, CH>(acc, ring, pl.slot, Kp * es / wg::LINE, nwg, src, cx, bars, parity,
                  [&](uint32_t slot, uint32_t bar, int kt) {
                    load_b<T>(slot, bar, kt, map, cx.rank * 4 * Uc, nwg);
                  });
      // The cell: this thread holds gate q of its (row, unit) pairs at
      // acc[16 T2 + 4 q + 2 hh + e] (warpgroups past the nwg tiles have none).
      const float* b = bsm + l * 4 * Uc;
      T* h_out = hbuf + hoff(cur, l);
      float* cs = cbuf + l * slice;
      if (wgi < nwg) {
#pragma unroll
        for (int T2 = 0; T2 < 2; ++T2)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int r = 16 * wq + (lane >> 2) + 8 * hh;
              const int jl = UNITS_WG * wgi + 8 * T2 + 2 * (lane & 3) + e;
              const int j0 = 16 * T2 + 2 * hh + e;
              const float ig = sigmoidf(acc[j0] + b[jl]);
              const float fg = sigmoidf(acc[j0 + 4] + b[Uc + jl]);
              const float gg = tanhf(acc[j0 + 8] + b[2 * Uc + jl]);
              const float og = sigmoidf(acc[j0 + 12] + b[3 * Uc + jl]);
              const float cn = fg * cs[r * UP + jl] + ig * gg;
              cs[r * UP + jl] = cn;
              st_t(h_out + r * UP + jl, og * tanhf(cn));
            }
      }
      cluster_arrive();
    }
    const ASrc hsrc = {a.Hp, 0, hoff(cur, n - 1), 0};
    head_step<T, VPL, CH>(t, ring, pl, logits, ended, sbase + pl.toff, bars, parity, hsrc, cx);
    cluster_arrive();
  }
  cluster_wait();  // no CTA leaves while another may still read its h
}

// The launch configuration of one call: tiles x S CTAs in clusters of S.
template <typename T, int VPL, int MAXT>
cudaError_t tc_config(const TcArgs& a, cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                      cudaStream_t st) {
  const Plan pl = plan(a.H, a.n, a.V, a.S, a.head_tiles, (int)sizeof(T));
  cudaError_t e = cudaFuncSetAttribute(gen_tc_kernel<T, VPL, MAXT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, pl.bytes);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(gen_tc_kernel<T, VPL, MAXT>,
                           cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)((a.B + ROWS - 1) / ROWS * a.S));
  cfg->blockDim = dim3((unsigned)(128 * pl.NB));
  cfg->dynamicSmemBytes = (size_t)pl.bytes;
  cfg->stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)a.S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <typename T, int VPL, int MAXT>
cudaError_t tc_run(const TcArgs& a, cudaStream_t st) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e = tc_config<T, VPL, MAXT>(a, &cfg, attr, st);
  if (e != cudaSuccess) return e;
  e = cudaLaunchKernelEx(&cfg, gen_tc_kernel<T, VPL, MAXT>, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Instances: the vocab layout (4 or 16 entries a lane) and the warpgroups
// (1, 2 or 4: 255, 255 and 128 registers a thread).
template <typename T, int VPL>
cudaError_t tc_run_wg(const TcArgs& a, cudaStream_t st) {
  if (a.head_tiles == 1) return tc_run<T, VPL, 128>(a, st);
  if (a.head_tiles == 2) return tc_run<T, VPL, 256>(a, st);
  return tc_run<T, VPL, 512>(a, st);
}

template <typename T>
cudaError_t tc_run_vpl(const TcArgs& a, cudaStream_t st) {
  if (a.V <= 128) return tc_run_wg<T, 4>(a, st);
  return tc_run_wg<T, MAX_VPL>(a, st);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, fetched once through cudaGetDriverEntryPoint (so
// the library needs no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of a K-major [rows, kp] weight plane: boxes of 64 rows x 128 bytes,
// 128-byte swizzle (the layout wgmma.cuh's descriptors read).
bool weight_map(CUtensorMap* m, const void* base, int rows, int kp, int bf16) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const int es = bf16 ? 2 : 4;
  const cuuint64_t dims[2] = {(cuuint64_t)kp, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)kp * es};
  const cuuint32_t box[2] = {(cuuint32_t)(wg::LINE / es), (cuuint32_t)ROWS};
  const cuuint32_t estr[2] = {1, 1};
  return enc(m, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
             const_cast<void*>(base), dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tc

}  // namespace

extern "C" {

// Returns a cudaError_t as int: 0 when the launch was accepted.
int fused_generate_launch(const void* emb, const void* wcat, const void* bias,
                          const void* wout, const void* bout, const void* h0,
                          const void* cond, const void* seeds, const void* temps,
                          void* out, void* logits0, int B, int L, int V, int E, int C,
                          int H, int n, int block_rows, int greedy, int top_k, float top_p, int bf16,
                          int R, int TJ, int TR, int start_token, int end_token,
                          int pad_token, void* stream) {
  Args a;
  a.emb = emb;
  a.wcat = wcat;
  a.bias = static_cast<const float*>(bias);
  a.wout = wout;
  a.bout = static_cast<const float*>(bout);
  a.h0 = static_cast<const float*>(h0);
  a.cond = static_cast<const float*>(cond);
  a.seeds = static_cast<const int*>(seeds);
  a.temps = static_cast<const float*>(temps);
  a.out = static_cast<int*>(out);
  a.logits0 = static_cast<float*>(logits0);
  a.B = B; a.L = L; a.V = V; a.E = E; a.C = C; a.H = H; a.n = n;
  a.block_rows = block_rows;
  a.greedy = greedy; a.top_k = top_k; a.top_p = top_p;
  a.R = R; a.TJ = TJ; a.TR = TR;
  a.start_token = start_token; a.end_token = end_token; a.pad_token = pad_token;
  if (B < 1 || L < 1 || V < 1 || V > 32 * MAX_VPL || TR < 1 || R % TR != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)R * (E + C) + (size_t)3 * n * R * H) +
                      sizeof(int) * 2 * (size_t)R;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rpt = R / TR;
  cudaError_t e = bf16 ? launch_rpt<__nv_bfloat16>(a, rpt, smem, s)
                       : launch_rpt<float>(a, rpt, smem, s);
  return (int)e;
}

// The tensor-core sampler (tc::gen_tc_kernel): w / wout hold bf16, or with
// wlo / wout_lo the TF32 hi and lo planes of f32, K-major (TcArgs). Returns
// a cudaError_t as int: 0 when the launch was accepted.
int fused_generate_tc_launch(const void* emb, const void* cond, const void* h0, const void* w,
                             const void* wlo, const void* wout, const void* wout_lo,
                             const void* bias, const void* bout, const void* seeds,
                             const void* temps, void* out, void* logits0, int B, int L, int V,
                             int E, int C, int H, int n, int block_rows, int greedy, int top_k,
                             float top_p, int bf16, int S, int Xp, int Hp, int head_tiles,
                             int start_token, int end_token, int pad_token, void* stream) {
  tc::TcArgs a = {};
  a.emb = emb;
  a.cond = static_cast<const float*>(cond);
  a.h0 = static_cast<const float*>(h0);
  a.w = w;
  a.wlo = wlo;
  a.wout = wout;
  a.wout_lo = wout_lo;
  a.bias = static_cast<const float*>(bias);
  a.bout = static_cast<const float*>(bout);
  a.seeds = static_cast<const int*>(seeds);
  a.temps = static_cast<const float*>(temps);
  a.out = static_cast<int*>(out);
  a.logits0 = static_cast<float*>(logits0);
  a.B = B; a.L = L; a.V = V; a.E = E; a.C = C; a.H = H; a.n = n;
  a.block_rows = block_rows;
  a.greedy = greedy; a.top_k = top_k; a.top_p = top_p;
  a.S = S; a.Xp = Xp; a.Hp = Hp; a.head_tiles = head_tiles;
  a.start_token = start_token; a.end_token = end_token; a.pad_token = pad_token;
  const int line = tc::PLANE / tc::ROWS / (bf16 ? 2 : 4);  // a stage's reduction depth
  const int nwg = S >= 1 && H % S == 0 ? H / S / tc::UNITS_WG : 0;  // gate tiles a CTA
  const bool shape_ok = S >= 1 && S <= 16 && tc::ROWS % S == 0 && H % S == 0 &&
                        (H / S) % tc::UNITS_WG == 0 && ((H / S) & (H / S - 1)) == 0;
  if (B < 1 || L < 1 || V < 1 || V > 32 * MAX_VPL || n < 1 || n > 8 || !shape_ok ||
      Xp % line != 0 || Hp % line != 0 || Xp < E + C || Hp < H || head_tiles * 64 < V ||
      (head_tiles != 1 && head_tiles != 2 && head_tiles != 4) || head_tiles < nwg ||
      (bf16 == 0) != (wlo != nullptr && wout_lo != nullptr))
    return (int)cudaErrorInvalidValue;
  const int es = bf16 ? 2 : 4;
  size_t off = 0;
  for (int l = 0; l < n; ++l) {
    const int kp = (l == 0 ? Xp : Hp) + Hp;
    for (int q = 0; q < (bf16 ? 1 : 2); ++q)
      if (!tc::weight_map(&a.maps[2 * l + q], static_cast<const char*>(q ? wlo : w) + off * es,
                          4 * H, kp, bf16))
        return (int)cudaErrorInvalidValue;
    off += (size_t)4 * H * kp;
  }
  for (int q = 0; q < (bf16 ? 1 : 2); ++q)
    if (!tc::weight_map(&a.maps[2 * n + q], q ? wout_lo : wout, 64 * head_tiles, Hp, bf16))
      return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = bf16 ? tc::tc_run_vpl<__nv_bfloat16>(a, s) : tc::tc_run_vpl<float>(a, s);
  return (int)e;
}

// Shared memory of one CTA of the tensor-core sampler (bytes).
int fused_generate_tc_smem(int H, int n, int V, int S, int head_tiles, int bf16) {
  return tc::plan(H, n, V, S, head_tiles, bf16 ? 2 : 4).bytes;
}

const char* fused_generate_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
