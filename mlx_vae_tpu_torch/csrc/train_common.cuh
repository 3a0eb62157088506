// Device code shared by the train-step kernels (fused_encoder.cu,
// fused_train_decoder.cu and fused_seq_lstm.cu; fused_lstm_gates.cu takes
// its activations), for Hopper (sm_90a): operand loads and rounding, the
// forward LSTM cell over a row tile, the reverse cell step, and the
// weight-gradient passes that the backwards end with.
//
// Conventions of both kernel pairs (the TPU kernels' residual contract):
//  * Matmul operands are rounded to the compute dtype T (float or bf16) and
//    products are accumulated in float32; h and c stay float32 inside a
//    kernel. Biases are float32.
//  * The forwards store, per (t, layer, row), h and c and the ACTIVATED
//    gates (i, f, g, o) in T: [L, n, B, H] and [L, n, B, 4H].
//  * The reverse step recomputes nothing but tanh(c): dgates come from the
//    stored activations, so a gate that saturated to exactly 1.0 in bf16
//    has a zero a*(1-a) term, as on the TPU.
//  * Layer l's combined weight is [K_l + H, 4H] (input rows, then recurrent
//    rows); the CUDA-core reverse step (the f32 training decoder's) reads
//    its transpose [4H, K_l + H] so that a thread owning one input column
//    reads neighbouring addresses.
//
// Cross-row sums. On the TPU a backward kernel adds every batch block's
// weight gradient into one VMEM accumulator, because its grid runs in order
// (the dW/db accumulators of mlx_vae_tpu/ops/pallas_seq_lstm.py:_bwd_kernel,
// pallas_encoder.py:_bwd_kernel and pallas_train_decoder.py:_bwd_kernel).
// Blocks on the card run in parallel and in no order, so the reverse kernels
// here write the per-(t, layer, row) gate cotangents dgates [L, n, B, 4H]
// (in T, rounded as the TPU rounds them before its dW product) and the
// layer-0 input cotangent, and the passes below form
//   dW_l = sum_{t,b} inp_l(t,b)^T dgates_l(t,b),   db_l = sum_{t,b} dgates_l,
//   d(embedding)[v] = sum_{t,b : token(t,b) = v} dx0(t,b)
// as split reductions: each block sums one output tile over one slice of
// the t*B rows into its own partial, and reduce_kernel adds the partials in
// a fixed order. No atomics, so the sums are the same from run to run.
//
// What bounds the weight-gradient pass: at I = H = 1024, B = 2048, L = 64 it
// is 2.2 TFLOP against ~1.3 GB of operands, so the operations (the tensor
// cores' bf16 rate) bound it. In bf16 it runs on wgmma (wgrad_wgmma_kernel:
// 128 x 128 tiles, a 3-stage cp.async ring, two blocks an SM, both operands
// MN-major as they lie in memory, f32 accumulation); db is a separate
// column sum (colsum_kernel). In f32 it runs split-TF32 (wgrad_tf32_kernel,
// wgmma.cuh:gemm_tf32: three TF32 products for each f32 product, so 3 x the
// operations at 495 TFLOP/s bound it), each operand transposed to K-major
// while it is split, since TF32 wgmma has no transposed operand.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

#include <algorithm>

#include "wgmma.cuh"

namespace train {

constexpr int NT = 256;      // threads per block of the recurrent kernels
constexpr int NW = NT / 32;  // warps per block

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// Round a float32 value to T (round to nearest even, as torch's .to()).
template <typename T> __device__ __forceinline__ float rnd(float x);
template <> __device__ __forceinline__ float rnd<float>(float x) { return x; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float sigm(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---------------------------------------------------------------- forward

// One LSTM layer at one step for a tile of R = RPT * TR rows. Threads are
// TR row groups x TJ hidden units; a thread owns unit j (and j + TJ, ...)
// for RPT rows and computes its four gate dots, so each weight it loads
// serves RPT rows. xs [R][Kin] and hold [R][H] are read, hnew [R][H] and
// cs [R][H] written (c of a (row, j) pair is touched only by its owner).
// The residuals of rows < B go to hs/cs [B, H] and gs [B, 4H] slabs.
template <typename T, int RPT>
__device__ __forceinline__ void cell_fwd(const T* W, const float* b, int Kin, int H,
                                         const float* xs, const float* hold, float* hnew,
                                         float* cs, int TJ, int TR, int row0, int B,
                                         T* hs_out, T* cs_out, T* gs_out) {
  const int tj = threadIdx.x % TJ, tr = threadIdx.x / TJ;
  if (tr >= TR) return;
  const int G = 4 * H;
  for (int j = tj; j < H; j += TJ) {
    float acc[4][RPT];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int i = 0; i < RPT; ++i) acc[q][i] = 0.0f;
#pragma unroll 4
    for (int k = 0; k < Kin; ++k) {
      const T* wk = W + (size_t)k * G + j;
      const float w0 = ld(wk), w1 = ld(wk + H), w2 = ld(wk + 2 * H), w3 = ld(wk + 3 * H);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float xv = rnd<T>(xs[(tr + TR * i) * Kin + k]);
        acc[0][i] = fmaf(xv, w0, acc[0][i]);
        acc[1][i] = fmaf(xv, w1, acc[1][i]);
        acc[2][i] = fmaf(xv, w2, acc[2][i]);
        acc[3][i] = fmaf(xv, w3, acc[3][i]);
      }
    }
#pragma unroll 4
    for (int k = 0; k < H; ++k) {
      const T* wk = W + (size_t)(Kin + k) * G + j;
      const float w0 = ld(wk), w1 = ld(wk + H), w2 = ld(wk + 2 * H), w3 = ld(wk + 3 * H);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float hv = rnd<T>(hold[(tr + TR * i) * H + k]);
        acc[0][i] = fmaf(hv, w0, acc[0][i]);
        acc[1][i] = fmaf(hv, w1, acc[1][i]);
        acc[2][i] = fmaf(hv, w2, acc[2][i]);
        acc[3][i] = fmaf(hv, w3, acc[3][i]);
      }
    }
    const float bi = b[j], bf = b[H + j], bg = b[2 * H + j], bo = b[3 * H + j];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = tr + TR * i;
      const float ig = sigm(acc[0][i] + bi);
      const float fg = sigm(acc[1][i] + bf);
      const float gg = tanhf(acc[2][i] + bg);
      const float og = sigm(acc[3][i] + bo);
      const float cn = fg * cs[r * H + j] + ig * gg;
      const float hn = og * tanhf(cn);
      cs[r * H + j] = cn;
      hnew[r * H + j] = hn;
      const int g = row0 + r;
      if (g < B) {
        st(hs_out + (size_t)g * H + j, hn);
        st(cs_out + (size_t)g * H + j, cn);
        T* gp = gs_out + (size_t)g * G + j;
        st(gp, ig);
        st(gp + H, fg);
        st(gp + 2 * H, gg);
        st(gp + 3 * H, og);
      }
    }
  }
}

// ---------------------------------------------------------------- reverse

// The reverse cell step at one (row, unit): from the activated gates a =
// (i, f, g, o), c and c_prev, the total h cotangent dht and the running dc,
// the four gate cotangents d4, rounded to T (the TPU casts dgates to the
// weight dtype before its products); returns the new dc.
template <typename T>
__device__ __forceinline__ float gate_cot(const float (&a)[4], float c, float cp, float dht,
                                          float dc, float (&d4)[4]) {
  const float ig = a[0], fg = a[1], gg = a[2], og = a[3];
  const float tc = tanhf(c);
  const float dct = dc + dht * og * (1.0f - tc * tc);
  d4[0] = rnd<T>(dct * gg * ig * (1.0f - ig));
  d4[1] = rnd<T>(dct * cp * fg * (1.0f - fg));
  d4[2] = rnd<T>(dct * ig * (1.0f - gg * gg));
  d4[3] = rnd<T>(dht * tc * og * (1.0f - og));
  return dct * fg;
}

// Phase A of the reverse step of one layer at step t, for a tile of R rows:
// from the stored activations and c, and the running (dh, dc), form the
// four gate cotangents, rounded to T (the TPU casts dgates to the weight
// dtype before its products). They go to dg [R][4H] in shared memory and
// to the dgates slab [B, 4H]; dc becomes dc_tot * f.
//   gs/cs_t/cs_prev: this layer's residual slabs at t (cs_prev at t-1, or
//   null at t = 0, where c_prev is c0 [B, H] f32, or 0 if c0 is null too);
//   dh, dc, fa: [R][H] (fa is the cotangent arriving from above: the layer
//   above's input cotangent, the vocab projection's for the decoder's top
//   layer, or the per-step output cotangent of a single layer).
template <typename T>
__device__ __forceinline__ void cell_bwd_gates(const T* gs, const T* cs_t, const T* cs_prev,
                                               const float* dh, float* dc, const float* fa,
                                               float* dg, T* dg_out, int R, int H, int row0,
                                               int B, const float* c0 = nullptr) {
  const int G = 4 * H;
  for (int idx = threadIdx.x; idx < R * H; idx += NT) {
    const int r = idx / H, j = idx % H, g = row0 + r;
    float a[4] = {0.f, 0.f, 0.f, 0.f}, c = 0.f, cp = 0.f;
    if (g < B) {
      const T* gp = gs + (size_t)g * G + j;
#pragma unroll
      for (int q = 0; q < 4; ++q) a[q] = ld(gp + q * H);
      c = ld(cs_t + (size_t)g * H + j);
      cp = cs_prev != nullptr ? ld(cs_prev + (size_t)g * H + j)
                              : (c0 != nullptr ? c0[(size_t)g * H + j] : 0.0f);
    }
    float d4[4];
    dc[idx] = gate_cot<T>(a, c, cp, dh[idx] + fa[idx], dc[idx], d4);
    float* d = dg + (size_t)r * G + j;
#pragma unroll
    for (int q = 0; q < 4; ++q) d[q * H] = d4[q];
    if (g < B) {
      T* o = dg_out + (size_t)g * G + j;
#pragma unroll
      for (int q = 0; q < 4; ++q) st(o + q * H, d4[q]);
    }
  }
}

// Phase B: the input cotangent dinp [R][Kl + H] = dg [R][4H] @ W^T, read
// from WT [4H][Kl + H]. Each column k is owned by one thread for all R rows
// and handed to sink(r, k, value).
template <typename T, int R, typename Sink>
__device__ __forceinline__ void cell_bwd_dinp(const T* WT, const float* dg, int K, int G,
                                              Sink sink) {
  for (int k = threadIdx.x; k < K; k += NT) {
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.0f;
#pragma unroll 4
    for (int q = 0; q < G; ++q) {
      const float w = ld(WT + (size_t)q * K + k);
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = fmaf(dg[r * G + q], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) sink(r, k, acc[r]);
  }
}

// The reverse step of one layer at one step s, element by element: the
// epilogue of the tensor-core reverse products (dinp_tile and dinp_tile_tf32
// below) and the first launch of their chains (gate_kernel). T: the
// residuals' and dgates' type (bf16, or f32 on the encoder's split-TF32
// chain).
template <typename T>
struct GateArgsT {
  const T* gs;         // [B, 4H] activated gates at s
  const T* cs;         // [B, H] c at s
  const T* cprev;      // [B, H] c at s - 1, or null: c0 (zeros if null too)
  const float* c0;     // [B, H], or null
  const float* dhs;    // [B, H] output cotangent at s, or null: none
  const float* dc_in;  // [B, H] running dc
  float* dc;           // [B, H] running dc out (may be dc_in)
  T* dg;               // [B, 4H] dgates at s, rounded to T
  int H;
};
using GateArgs = GateArgsT<__nv_bfloat16>;

// Row b, unit j, with dh the h cotangent from the layers and steps after s
// (the output cotangent dhs, where there is one, is added here).
template <typename T>
__device__ __forceinline__ void gate_step(const GateArgsT<T>& a, int b, int j, float dh) {
  const int H = a.H;
  const size_t G = 4 * (size_t)H, bj = (size_t)b * H + j;
  const T* gp = a.gs + b * G + j;
  float g4[4], d4[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) g4[q] = ld(gp + q * H);
  const float cp = a.cprev != nullptr ? ld(a.cprev + bj) : (a.c0 != nullptr ? a.c0[bj] : 0.0f);
  const float dht = a.dhs != nullptr ? dh + a.dhs[bj] : dh;
  a.dc[bj] = gate_cot<T>(g4, ld(a.cs + bj), cp, dht, a.dc_in[bj], d4);
  T* o = a.dg + b * G + j;
#pragma unroll
  for (int q = 0; q < 4; ++q) st(o + q * H, d4[q]);
}

// The first launch of a reverse chain: the gate step of its last step from
// the cotangent dh [B, H] (count = B * H elements).
template <typename T>
__global__ void __launch_bounds__(256) gate_kernel(const GateArgsT<T> a, const float* dh,
                                                   int count) {
  const int idx = blockIdx.x * 256 + threadIdx.x;
  if (idx < count) gate_step(a, idx / a.H, idx % a.H, dh[idx]);
}

// The product of every bf16 reverse-chain launch (fused_seq_lstm.cu's
// seq_step_kernel, fused_encoder.cu's enc_step_kernel, fused_train_decoder.cu's
// dec_step_kernel): this block's 128 x 128 tile (rows blockIdx.y, columns
// blockIdx.x) of dinp [B, N] = dg [B, G] w^T on wgmma. Both operands are
// K-major as they lie: the reduction over G = 4H runs along the rows of
// dgates and of the layer's combined weight w [N, G] (row k of w is column k
// of dinp). Rows >= B and columns >= N read zeros; vec: every row 16-byte
// aligned. Returns the f32 tile staged in shared memory ([BM][EPI_PITCH]),
// so that the epilogue walks it row by row and its loads and stores of the
// residuals coalesce.
__device__ __forceinline__ const float* dinp_tile(unsigned char* smem_raw,
                                                  const __nv_bfloat16* dg,
                                                  const __nv_bfloat16* w, int B, int N, int G,
                                                  bool vec) {
  const uint32_t ring = (wg::smem_u32(smem_raw) + 1023u) & ~1023u;
  const int n0 = blockIdx.x * wg::BN, m0 = blockIdx.y * wg::BM;
  float acc[64];
  wg::gemm<false>(acc, ring, (G + wg::BK - 1) / wg::BK, [&](uint32_t dst, int kt) {
    const int q = kt * wg::BK;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int idx = wg::chunk(u), r = idx >> 3, c = idx & 7;
      const uint32_t off = wg::swz(r, c);
      wg::stage8(dst + off, m0 + r < B ? dg + (size_t)(m0 + r) * G : nullptr, q + 8 * c, G, vec);
      wg::stage8(dst + wg::TILE + off, n0 + r < N ? w + (size_t)(n0 + r) * G : nullptr,
                 q + 8 * c, G, vec);
    }
  });
  return wg::stage_tile(acc, smem_raw, ring);
}

// The f32 counterpart (fused_encoder.cu's enc_step_tf32_kernel and
// fused_seq_lstm.cu's seq_step_tf32_kernel): the same tile as split-TF32
// (wgmma.cuh:gemm_tf32), both operands split while they are staged (dg's
// rows, and w's rows read as they lie). Rows and columns outside read
// zeros; vec: every row of dg and w 16-byte aligned (float4 loads; else
// element loads).
__device__ __forceinline__ const float* dinp_tile_tf32(unsigned char* smem_raw, const float* dg,
                                                       const float* w, int B, int N, int G,
                                                       bool vec) {
  const uint32_t ring = (wg::smem_u32(smem_raw) + 1023u) & ~1023u;
  const int n0 = blockIdx.x * wg::BN, m0 = blockIdx.y * wg::BM;
  // This thread stages 16-byte chunk c of tile rows r0 + 32 u of both operands.
  const int c = threadIdx.x & 7, r0 = threadIdx.x >> 3;
  float4 av[4], bv[4];
  float sum[64];
  wg::gemm_tf32(
      sum, ring, (G + wg::TF_BK - 1) / wg::TF_BK,
      [&](int kt) {
        const int q = kt * wg::TF_BK + 4 * c;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int r = r0 + 32 * u;
          av[u] = wg::load4(m0 + r < B ? dg + (size_t)(m0 + r) * G : nullptr, q, G, vec);
          bv[u] = wg::load4(n0 + r < N ? w + (size_t)(n0 + r) * G : nullptr, q, G, vec);
        }
      },
      [&](uint32_t dst, int) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const uint32_t off = wg::swz(r0 + 32 * u, c);
          wg::put4_split(dst + off, av[u]);
          wg::put4_split(dst + 2 * wg::TILE + off, bv[u]);
        }
      });
  return wg::stage_tile(sum, smem_raw, ring);
}

// ------------------------------------------------------- gradient sums

// A(m, k) for m = t * B + b, one of three row sources:
enum { A_DENSE = 0, A_SHIFT = 1, A_GATHER = 2 };

struct WgradArgs {
  const void* a;    // T elements
  long a_st, a_sb;  // strides of t and b, in elements
  int a_mode;       // A_DENSE: a[t*a_st + b*a_sb + k]
                    // A_SHIFT: step t reads step t - 1 (the previous h);
                    //          t = 0 reads a0[b*K + k], or 0 if a0 is null
                    // A_GATHER: row tok(t, b) of the table a [V, K]; a
                    //          token outside [0, V) reads 0
  const void* a0;
  const int* tok;
  long tok_st, tok_sb;
  int V;
  const void* d;    // D(m, n) = d[t*d_st + b*d_sb + n], TD elements
  long d_st, d_sb;
  int K, N, B, M, chunk;
  float* part;      // [S][K][N] (the output itself when S = 1)
  int a_vec, d_vec; // every row of A / D starts 16-byte aligned (set by wgrad)
};

// Row (t, b) of A (its element 0), or null where the row reads as zeros.
template <typename T>
__device__ __forceinline__ const T* a_row(const WgradArgs& g, int t, int b) {
  const T* a = static_cast<const T*>(g.a);
  if (g.a_mode == A_DENSE) return a + t * g.a_st + b * g.a_sb;
  if (g.a_mode == A_SHIFT) {
    if (t > 0) return a + (t - 1) * g.a_st + b * g.a_sb;
    return g.a0 != nullptr ? static_cast<const T*>(g.a0) + (size_t)b * g.K : nullptr;
  }
  const int v = g.tok[t * g.tok_st + b * g.tok_sb];
  return (v >= 0 && v < g.V) ? a + (size_t)v * g.K : nullptr;
}

template <typename TD>
__device__ __forceinline__ const TD* d_row(const WgradArgs& g, int t, int b) {
  return static_cast<const TD*>(g.d) + t * g.d_st + b * g.d_sb;
}

// f32: part[s] = sum over rows [s*chunk, (s+1)*chunk) of A^T D for one
// 128 x 128 tile (128 rows k, 128 columns n) as split-TF32
// (wgmma.cuh:gemm_tf32), 32 rows m a stage. Both operands lie MN-major
// (a row m holds k or n contiguously) and TF32 wgmma reads only K-major, so
// each is transposed while it is split: this thread loads rows 4 mg .. 4 mg
// + 3 of the stage at columns 4 kg .. 4 kg + 3 of A and of D (float4 where
// every row is 16-byte aligned) and writes them as chunk mg of lines 4 kg ..
// 4 kg + 3 (wgmma.cuh:load_t4 / put_t4). Rows past the slice and columns
// past K or N are zeros.
__global__ void __launch_bounds__(wg::NTH, wg::TF_BLOCKS_PER_SM) wgrad_tf32_kernel(
    const WgradArgs g) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (wg::smem_u32(smem_raw) + 1023u) & ~1023u;
  const int n0 = blockIdx.x * wg::BN, k0 = blockIdx.y * wg::BM, s = blockIdx.z;
  const int m_begin = s * g.chunk;
  const int m_end = min(m_begin + g.chunk, g.M);
  const int nk = (m_end - m_begin + wg::TF_BK - 1) / wg::TF_BK;
  const int mg = threadIdx.x & 7, kg = threadIdx.x >> 3;
  int t[4], b[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int m = m_begin + 4 * mg + u;
    t[u] = m / g.B;
    b[u] = m % g.B;
  }
  float4 va[4], vd[4];
  float sum[64];
  wg::gemm_tf32(
      sum, ring, nk,
      [&](int kt) {
        const int m0 = m_begin + kt * wg::TF_BK;
        const float* ar[4];
        const float* dr[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const bool in = m0 + 4 * mg + u < m_end;
          ar[u] = in ? a_row<float>(g, t[u], b[u]) : nullptr;
          dr[u] = in ? d_row<float>(g, t[u], b[u]) : nullptr;
          for (b[u] += wg::TF_BK; b[u] >= g.B; b[u] -= g.B) ++t[u];
        }
        wg::load_t4(va, ar, k0 + 4 * kg, g.K, g.a_vec);
        wg::load_t4(vd, dr, n0 + 4 * kg, g.N, g.d_vec);
      },
      [&](uint32_t dst, int) {
        wg::put_t4(dst, va, 4 * kg, mg);
        wg::put_t4(dst + 2 * wg::TILE, vd, 4 * kg, mg);
      });
  float* out = g.part + (size_t)s * g.K * g.N;
#pragma unroll
  for (int j = 0; j < 64; ++j) {
    const int k = k0 + wg::acc_row(j), n = n0 + wg::acc_col(j);
    if (k < g.K && n < g.N) out[(size_t)k * g.N + n] = sum[j];
  }
}

// bf16: the same sums on the tensor cores. A block forms one 128 x 128 tile
// of dW (128 rows k, 128 columns n) over its slice of rows m, 64 rows a
// stage: A's stage is 64 rows m of 128 k-values and D's 64 rows m of 128
// n-values, each row a contiguous run in device memory, so both operands
// are MN-major and are copied as they are (cp.async where a row is 16-byte
// aligned). D in f32 (TD = float) is rounded to bf16 while it is staged.
// Rows past the slice and columns past K or N are zeros.
template <typename TD>
__global__ void __launch_bounds__(wg::NTH, wg::BLOCKS_PER_SM) wgrad_wgmma_kernel(
    const WgradArgs g) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (wg::smem_u32(smem_raw) + 1023u) & ~1023u;
  const int n0 = blockIdx.x * wg::BN, k0 = blockIdx.y * wg::BM, s = blockIdx.z;
  const int m_begin = s * g.chunk;
  const int m_end = min(m_begin + g.chunk, g.M);
  const int nk = (m_end - m_begin + wg::BK - 1) / wg::BK;
  // This thread stages rows mm = tid / 16 + 16 u (u = 0..3) of every stage,
  // 16-byte chunk c = tid % 16 of each (atom c / 8); (t, b) of each row
  // advance by BK rows a stage.
  const int c = threadIdx.x & 15, mm0 = threadIdx.x >> 4;
  int t[4], b[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int m = m_begin + mm0 + 16 * u;
    t[u] = m / g.B;
    b[u] = m % g.B;
  }
  float acc[64];
  wg::gemm<true>(acc, ring, nk, [&](uint32_t dst, int kt) {
    const int m0 = m_begin + kt * wg::BK;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int mm = mm0 + 16 * u;
      const uint32_t off = (c >> 3) * 8192 + wg::swz(mm, c & 7);
      const bool in = m0 + mm < m_end;
      wg::stage8(dst + off, in ? a_row<__nv_bfloat16>(g, t[u], b[u]) : nullptr, k0 + 8 * c,
                 g.K, g.a_vec);
      wg::stage8(dst + wg::TILE + off, in ? d_row<TD>(g, t[u], b[u]) : nullptr, n0 + 8 * c,
                 g.N, g.d_vec);
      for (b[u] += wg::BK; b[u] >= g.B; b[u] -= g.B) ++t[u];
    }
  });
  float* out = g.part + (size_t)s * g.K * g.N;
#pragma unroll
  for (int j = 0; j < 64; ++j) {
    const int k = k0 + wg::acc_row(j), n = n0 + wg::acc_col(j);
    if (k < g.K && n < g.N) out[(size_t)k * g.N + n] = acc[j];
  }
}

// part[s][n] = sum over rows [s*chunk, (s+1)*chunk) of D(m, n), as stored
// (f32 dlogits unrounded, bf16 gate cotangents as rounded).
template <typename TD>
__global__ void __launch_bounds__(256) colsum_kernel(const WgradArgs g, float* part) {
  const int n = blockIdx.x * 256 + threadIdx.x, s = blockIdx.y;
  if (n >= g.N) return;
  const int m_end = min((s + 1) * g.chunk, g.M);
  int m = s * g.chunk, t = m / g.B, b = m % g.B;
  float acc = 0.0f;
#pragma unroll 4
  for (; m < m_end; ++m) {
    acc += ld(d_row<TD>(g, t, b) + n);
    if (++b == g.B) { b = 0; ++t; }
  }
  part[(size_t)s * g.N + n] = acc;
}

// out[i] = sum_s part[s * count + i], s in order.
__global__ void __launch_bounds__(256) reduce_kernel(const float* part, int S, long count,
                                                     float* out) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float acc = 0.0f;
  for (int s = 0; s < S; ++s) acc += part[(size_t)s * count + i];
  out[i] = acc;
}

constexpr int DE_COLS = 64;  // embedding columns per block of demb_kernel

// part[s][v][e] = sum over rows m in slice s with token(m) = v of dx(m, e).
// A thread owns one column e and its V sums in shared memory, so no two
// threads touch one address.
template <typename T>
__global__ void __launch_bounds__(DE_COLS) demb_kernel(const T* dx, const int* tok, long tok_st,
                                                       long tok_sb, int B, int M, int V, int E,
                                                       int chunk, float* part) {
  extern __shared__ float smem[];
  const int e = blockIdx.x * DE_COLS + threadIdx.x, s = blockIdx.y;
  for (int v = 0; v < V; ++v) smem[v * DE_COLS + threadIdx.x] = 0.0f;
  const int m_end = min((s + 1) * chunk, M);
  if (e < E) {
    for (int m = s * chunk; m < m_end; ++m) {
      const int t = m / B, b = m % B;
      const int v = tok[t * tok_st + b * tok_sb];
      if (v >= 0 && v < V) smem[v * DE_COLS + threadIdx.x] += ld(dx + (size_t)m * E + e);
    }
    for (int v = 0; v < V; ++v)
      part[((size_t)s * V + v) * E + e] = smem[v * DE_COLS + threadIdx.x];
  }
}

// ------------------------------------------------ host-side orchestration

inline int cdiv(long a, long b) { return (int)((a + b - 1) / b); }

// blocks of the tensor-core passes resident at once on an H100 SXM (132 SMs):
// bf16 and split-TF32
constexpr int SLOTS = 132 * wg::BLOCKS_PER_SM;
constexpr int TF_SLOTS = 132 * wg::TF_BLOCKS_PER_SM;

inline cudaError_t reduce(const float* part, int S, long count, float* out, cudaStream_t st) {
  reduce_kernel<<<cdiv(count, 256), 256, 0, st>>>(part, S, count, out);
  return cudaGetLastError();
}

// Splits of the M rows for `tiles` output tiles: the fewest that fill one or
// more whole waves of `slots` blocks to within 10%, at most 32, at least
// `rows_min` rows each, and at most `cap`.
inline int split_count(int tiles, long M, int rows_min, long cap, int slots = SLOTS) {
  int best = 1;
  double best_eff = (double)tiles / ((double)cdiv(tiles, slots) * slots);
  for (int S = 2; S <= 32 && best_eff < 0.9; ++S) {
    const double eff = (double)tiles * S / ((double)cdiv((long)tiles * S, slots) * slots);
    if (eff > best_eff + 0.05) { best = S; best_eff = eff; }
  }
  if ((long)best * rows_min > M) best = cdiv(M, rows_min);
  if (best > cap) best = (int)cap;
  return best < 1 ? 1 : best;
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// dW rows [out, out + K) (+ db when db != null) from one A source: on the
// tensor cores in both dtypes, a dispatch on dtype (bf16 wgmma for T = bf16,
// split-TF32 for T = float: 128 x 128 tiles, 32 rows a stage, one block an
// SM). Partials are added in a fixed order by reduce_kernel, so the sums are
// the same from run to run.
template <typename T, typename TD>
cudaError_t wgrad(WgradArgs g, float* out, float* db, float* scratch, long scratch_elems,
                  cudaStream_t st) {
  constexpr bool BF = sizeof(T) == 2;
  const int bk = BF ? wg::BK : wg::TF_BK;
  const int tiles = cdiv(g.K, wg::BM) * cdiv(g.N, wg::BN);
  const long per = (long)g.K * g.N;
  int S = split_count(tiles, g.M, 8 * bk, scratch_elems / per, BF ? SLOTS : TF_SLOTS);
  g.chunk = cdiv(cdiv(g.M, S), bk) * bk;
  S = cdiv(g.M, g.chunk);
  if (S > 1 && (long)S * per > scratch_elems) return cudaErrorInvalidValue;
  g.part = S > 1 ? scratch : out;
  dim3 grid(cdiv(g.N, wg::BN), cdiv(g.K, wg::BM), S);
  cudaError_t e;
  if constexpr (BF) {
    constexpr int E = 8;  // bf16 per 16 bytes
    const bool shift_ok = g.a_mode != A_SHIFT || g.a0 == nullptr || aligned16(g.a0);
    g.a_vec = aligned16(g.a) && shift_ok && g.K % E == 0 &&
              (g.a_mode == A_GATHER || (g.a_st % E == 0 && g.a_sb % E == 0));
    constexpr int ED = 16 / sizeof(TD);
    g.d_vec = aligned16(g.d) && g.d_st % ED == 0 && g.d_sb % ED == 0;
    e = cudaFuncSetAttribute(wgrad_wgmma_kernel<TD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             wg::SMEM);
    if (e != cudaSuccess) return e;
    wgrad_wgmma_kernel<TD><<<grid, wg::NTH, wg::SMEM, st>>>(g);
  } else {
    static_assert(sizeof(TD) == 4, "the split-TF32 pass reads f32 cotangents");
    constexpr int E = 4;  // f32 per 16 bytes
    const bool shift_ok = g.a_mode != A_SHIFT || g.a0 == nullptr || aligned16(g.a0);
    g.a_vec = aligned16(g.a) && shift_ok && g.K % E == 0 &&
              (g.a_mode == A_GATHER || (g.a_st % E == 0 && g.a_sb % E == 0));
    g.d_vec = aligned16(g.d) && g.N % E == 0 && g.d_st % E == 0 && g.d_sb % E == 0;
    e = cudaFuncSetAttribute(wgrad_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             wg::TF_SMEM);
    if (e != cudaSuccess) return e;
    wgrad_tf32_kernel<<<grid, wg::NTH, wg::TF_SMEM, st>>>(g);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (S > 1) {
    e = reduce(scratch, S, per, out, st);
    if (e != cudaSuccess) return e;
  }
  if (db == nullptr) return cudaSuccess;
  // db: column sums of D, split over the rows, partials added in order
  int Sd = cdiv(2 * SLOTS, cdiv(g.N, 256));
  Sd = Sd < cdiv(g.M, 256) ? Sd : cdiv(g.M, 256);
  if ((long)Sd * g.N > scratch_elems) Sd = (int)(scratch_elems / g.N);
  if (Sd < 1) return cudaErrorInvalidValue;
  g.chunk = cdiv(g.M, Sd);
  Sd = cdiv(g.M, g.chunk);
  colsum_kernel<TD><<<dim3(cdiv(g.N, 256), Sd), 256, 0, st>>>(g, scratch);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return reduce(scratch, Sd, g.N, db, st);
}

template <typename T>
cudaError_t demb(const T* dx, const int* tok, long tok_st, long tok_sb, int B, int M, int V,
                 int E, float* out, float* scratch, long scratch_elems, cudaStream_t st) {
  const int ct = cdiv(E, DE_COLS);
  int S = cdiv(1024, ct);
  S = S < cdiv(M, 256) ? S : cdiv(M, 256);
  const long per = (long)V * E;
  if (per > scratch_elems) return cudaErrorInvalidValue;
  if ((long)S * per > scratch_elems) S = (int)(scratch_elems / per);
  const int chunk = cdiv(M, S);
  S = cdiv(M, chunk);
  const size_t smem = sizeof(float) * V * DE_COLS;
  cudaError_t e = cudaFuncSetAttribute(demb_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  demb_kernel<T><<<dim3(ct, S), DE_COLS, smem, st>>>(dx, tok, tok_st, tok_sb, B, M, V, E, chunk,
                                                     scratch);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return reduce(scratch, S, per, out, st);
}

// ------------------------------------------ bf16 forward on the tensor cores

// The bf16 forward of one LSTM layer over L steps (the sequence forward of
// fused_seq_lstm.cu, and layer by layer the whole-stack encoder forward of
// fused_encoder.cu): L launches of seq_fwd_step_kernel, the kernel boundary
// being the grid-wide barrier the recurrence needs. Step t is one
// card-wide GEMM  gates_t [B, 4H] = A_t [B, Kp] W' [Kp, Np]  on wgmma
// (wg::gemm: 128 x 128 tiles, 3-stage ring, two blocks an SM) with the cell
// in its epilogue.
//  * A_t's reduction columns come from up to three sources: k < I from the
//    step's input row (a dense row, or the embedding row of the row's token,
//    zeros for a token outside [0, V), as train_common.py:embed_rows);
//    optionally Ix + k for k < C from the row's f32 conditions rounded to
//    nearest even (the decoder's layer 0: Ix = I rounded up to BK); Ixp + j
//    from h_{t-1}: the bf16 h the previous launch stored (the TPU kernel's
//    h_scr.astype(x.dtype)), at t = 0 the f32 h0 rounded to nearest even
//    (zeros where h0 is null). Ixp = Ix + C rounded up to BK, so that every
//    64-deep stage reads from one source; the columns between are zeros.
//  * W' is the wrapper's gate-interleaved, K-major copy of the layer's
//    weight (ops/train_common.py:interleave_weight): row n = 128 T + 32 q + j
//    holds the weight column of gate q of unit u = 32 T + j over Kp = Ixp +
//    Hp reduction rows (Hp = H rounded up to BK); pad rows and the rows of
//    units >= H are zeros. So one 128-wide output tile holds all four gates
//    of 32 units, and its epilogue runs the whole cell.
//  * Epilogue: the f32 tile goes through shared memory (wg::stage_tile).
//    Each (row, unit) of the tile belongs to one thread, which adds the bias,
//    applies the activations, reads c_{t-1} from the f32 running buffer (c0 at
//    t = 0, zeros where null), writes c_t back and stores h, c and the
//    activated gates of step t in bf16 (gate-major [i | f | g | o]: a warp
//    writes four 64-byte runs of a row), and the f32 h at the last step. One
//    writer per element and no atomics, so two runs are bitwise equal.
// What bounds it: at I = H = 1024, B = 2048, L = 64 the products are 2.2
// TFLOP against ~2.7 GB of operand and residual traffic, so the operations
// bound it (2.2 ms at the tensor cores' bf16 rate).

inline int round_up(int a, int b) { return (a + b - 1) / b * b; }
// where the h columns start: after the input's and the conditions' columns
inline int fwd_ixp(int I, int C = 0) { return round_up(I, wg::BK) + round_up(C, wg::BK); }
inline int fwd_kp(int I, int H, int C = 0) { return fwd_ixp(I, C) + round_up(H, wg::BK); }
inline int fwd_np(int H) { return cdiv(H, 32) * wg::BN; }

struct FwdStepArgs {
  const __nv_bfloat16* x;  // [B, I] the step's input rows, or with tok the table [V, I]
  const int* tok;          // the token of row b at tok[b * tok_sb], or null (dense)
  long tok_sb;
  int V;
  const float* cond;       // [B, C] f32 conditions, columns Ixp - Cxp + k (Cxp = 0: none)
  int C, Cxp, vec_c;
  const void* hprev;       // [B, H] h_{t-1}: bf16, or f32 where h_f32 (h0); null: zeros
  const float* c_in;       // [B, H] c_{t-1}, or null: zeros
  float* c_out;            // [B, H] c_t (may be c_in)
  const __nv_bfloat16* w;  // [Np, Kp] interleave_weight
  const float* bias;       // [4H]
  __nv_bfloat16* hs;       // [B, H] step t's h
  __nv_bfloat16* cs;       // [B, H] step t's c
  __nv_bfloat16* gs;       // [B, 4H] step t's activated gates
  float* hf;               // [B, H] f32 h, or null
  int B, I, Ixp, H, Kp, h_f32, vec_x, vec_h;
};

__global__ void __launch_bounds__(wg::NTH, wg::BLOCKS_PER_SM)
    seq_fwd_step_kernel(const FwdStepArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (wg::smem_u32(smem_raw) + 1023u) & ~1023u;
  const int n0 = blockIdx.x * wg::BN, m0 = blockIdx.y * wg::BM;
  const int B = a.B, I = a.I, H = a.H, Ixp = a.Ixp, Kp = a.Kp;
  // This thread stages 16-byte chunk c of tile rows r0 + 32 u (u = 0..3) of
  // both operands: the chunks wg::chunk(u) of a 1024-chunk tile.
  const int c = threadIdx.x & 7, r0 = threadIdx.x >> 3;
  const __nv_bfloat16* xr[4];
  const void* hr[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int row = m0 + r0 + 32 * u;
    xr[u] = nullptr;
    hr[u] = nullptr;
    if (row < B) {
      if (a.tok == nullptr) {
        xr[u] = a.x + (size_t)row * I;
      } else {
        const int v = a.tok[row * a.tok_sb];
        if (v >= 0 && v < a.V) xr[u] = a.x + (size_t)v * I;
      }
      if (a.hprev != nullptr)
        hr[u] = a.h_f32 ? static_cast<const void*>(static_cast<const float*>(a.hprev) +
                                                   (size_t)row * H)
                        : static_cast<const void*>(static_cast<const __nv_bfloat16*>(a.hprev) +
                                                   (size_t)row * H);
    }
  }
  const int Ix = Ixp - a.Cxp;  // where the conditions' columns start
  float acc[64];
  wg::gemm<false>(acc, ring, Kp / wg::BK, [&](uint32_t dst, int kt) {
    const int k0 = kt * wg::BK;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = r0 + 32 * u;
      const uint32_t off = wg::swz(r, c);
      if (k0 < Ix)
        wg::stage8(dst + off, xr[u], k0 + 8 * c, I, a.vec_x);
      else if (k0 < Ixp)  // one or a few stages: the row pointer is formed here
        wg::stage8(dst + off, m0 + r < B ? a.cond + (size_t)(m0 + r) * a.C : nullptr,
                   k0 - Ix + 8 * c, a.C, a.vec_c);
      else if (a.h_f32)
        wg::stage8(dst + off, static_cast<const float*>(hr[u]), k0 - Ixp + 8 * c, H, a.vec_h);
      else
        wg::stage8(dst + off, static_cast<const __nv_bfloat16*>(hr[u]), k0 - Ixp + 8 * c, H,
                   a.vec_h);
      wg::stage8(dst + wg::TILE + off, a.w + (size_t)(n0 + r) * Kp, k0 + 8 * c, Kp, true);
    }
  });
  const float* tile = wg::stage_tile(acc, smem_raw, ring);
  const int u0 = blockIdx.x * 32;
  const size_t G = 4 * (size_t)H;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < wg::BM * 32; idx += wg::NTH) {
    const int r = idx >> 5, j = idx & 31, row = m0 + r, u = u0 + j;
    if (row >= B || u >= H) continue;
    const float* g = tile + r * wg::EPI_PITCH + j;  // gate q at g[32 q]
    const float ig = sigm(g[0] + a.bias[u]);
    const float fg = sigm(g[32] + a.bias[H + u]);
    const float gg = tanhf(g[64] + a.bias[2 * H + u]);
    const float og = sigm(g[96] + a.bias[3 * H + u]);
    const size_t bu = (size_t)row * H + u;
    const float cn = fg * (a.c_in != nullptr ? a.c_in[bu] : 0.0f) + ig * gg;
    const float hn = og * tanhf(cn);
    a.c_out[bu] = cn;
    st(a.hs + bu, hn);
    st(a.cs + bu, cn);
    __nv_bfloat16* gp = a.gs + row * G + u;
    st(gp, ig);
    st(gp + H, fg);
    st(gp + 2 * H, gg);
    st(gp + 3 * H, og);
    if (a.hf != nullptr) a.hf[bu] = hn;
  }
}

// One layer over L steps. Step t's input rows are xs + t * x_st ([B, I]);
// with tok, row b reads table row tok[t * tok_st + b * tok_sb] of xs [V, I].
// Residual row t at hs/cs + t * h_st, gs + t * g_st (elements).
struct SeqFwdArgs {
  const __nv_bfloat16* xs;
  long x_st;
  const int* tok;
  long tok_st, tok_sb;
  int V;
  const float* h0;          // [B, H], or null: zeros
  const float* c0;          // [B, H], or null: zeros
  const __nv_bfloat16* w;   // [fwd_np(H), fwd_kp(I, H)] interleave_weight
  const float* bias;        // [4H]
  __nv_bfloat16* hs;
  __nv_bfloat16* cs;
  __nv_bfloat16* gs;
  long h_st, g_st;
  float* c;                 // [B, H] the running c; c_{L-1} at the end
  float* hf;                // [B, H] h_{L-1} in f32, or null
  int B, L, I, H;
};

inline cudaError_t seq_fwd_wgmma(const SeqFwdArgs& s, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(seq_fwd_step_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, wg::SMEM);
  if (e != cudaSuccess) return e;
  const int H = s.H, I = s.I;
  FwdStepArgs a = {};
  a.tok_sb = s.tok_sb;
  a.V = s.V;
  a.c_out = s.c;
  a.w = s.w;
  a.bias = s.bias;
  a.B = s.B; a.I = I; a.H = H;
  a.Ixp = fwd_ixp(I);
  a.Kp = fwd_kp(I, H);
  a.vec_x = I % 8 == 0 && aligned16(s.xs) && (s.tok != nullptr || s.x_st % 8 == 0);
  const dim3 grid(fwd_np(H) / wg::BN, cdiv(s.B, wg::BM));
  for (int t = 0; t < s.L; ++t) {
    a.x = s.tok != nullptr ? s.xs : s.xs + t * s.x_st;
    a.tok = s.tok != nullptr ? s.tok + t * s.tok_st : nullptr;
    a.h_f32 = t == 0;
    if (t == 0) {
      a.hprev = s.h0;
      a.vec_h = H % 4 == 0 && aligned16(s.h0);
      a.c_in = s.c0;
    } else {
      a.hprev = s.hs + (t - 1) * s.h_st;
      a.vec_h = H % 8 == 0 && aligned16(s.hs) && s.h_st % 8 == 0;
      a.c_in = s.c;
    }
    a.hs = s.hs + t * s.h_st;
    a.cs = s.cs + t * s.h_st;
    a.gs = s.gs + t * s.g_st;
    a.hf = t == s.L - 1 ? s.hf : nullptr;
    seq_fwd_step_kernel<<<grid, wg::NTH, wg::SMEM, st>>>(a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// ------------------------------------------ f32 forward as split-TF32

// The f32 counterpart of seq_fwd_step_kernel (the whole-stack encoder's
// forward, fused_encoder.cu, and the sequence forward, fused_seq_lstm.cu):
// step t of one layer is one card-wide GEMM
// gates_t [B, 4H] = A_t [B, Kp] W' [Kp, Np] on wgmma as split-TF32
// (wgmma.cuh:gemm_tf32: 128 x 128 tiles, 32-deep stages, 3-stage ring, one
// block an SM), with the cell in its epilogue. A_t's columns k < I are the
// step's input row (a dense f32 row, or the embedding row of the row's
// token, zeros for a token outside [0, V)); columns Ixp + j hold h_{t-1}
// (the f32 h the previous launch stored, hprev at t = 0, zeros where null).
// W' is interleave_weight's copy of the layer's f32 weight. Both operands
// are split into TF32 hi and lo while they are staged (reading precomputed
// hi and lo planes of W' instead measured the same and cost two copies a
// call; PERF.md, PR 17). The epilogue is seq_fwd_step_kernel's,
// storing h, c and the activated gates in f32. One writer per element and
// no atomics, so two runs are bitwise equal.
// Shared memory: the ring, 3 x 64 KB (A and W', each hi and lo), and the
// staged 128 x 136 f32 tile inside it: 197,632 B with the alignment slack,
// one block an SM (wgmma.cuh gives the choice and its measured times).
struct FwdStepTf32Args {
  const float* x;       // [B, I] the step's input rows, or with tok the table [V, I]
  const int* tok;       // the token of row b at tok[b * tok_sb], or null (dense)
  long tok_sb;
  int V;
  const float* hprev;   // [B, H] h_{t-1}, or null: zeros
  const float* c_in;    // [B, H] c_{t-1}, or null: zeros
  float* c_out;         // [B, H] c_t (may be c_in)
  const float* w;       // [Np, Kp] interleave_weight (f32)
  const float* bias;    // [4H]
  float* hs;            // [B, H] step t's h
  float* cs;            // [B, H] step t's c
  float* gs;            // [B, 4H] step t's activated gates
  float* hf;            // [B, H] a copy of h, or null
  int B, I, Ixp, H, Kp, vec_x, vec_h;
};

__global__ void __launch_bounds__(wg::NTH, wg::TF_BLOCKS_PER_SM)
    seq_fwd_tf32_kernel(const FwdStepTf32Args a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (wg::smem_u32(smem_raw) + 1023u) & ~1023u;
  const int n0 = blockIdx.x * wg::BN, m0 = blockIdx.y * wg::BM;
  const int B = a.B, I = a.I, H = a.H, Ixp = a.Ixp, Kp = a.Kp;
  // This thread stages 16-byte chunk c (4 f32) of tile rows r0 + 32 u.
  const int c = threadIdx.x & 7, r0 = threadIdx.x >> 3;
  const float* xr[4];
  const float* hr[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int row = m0 + r0 + 32 * u;
    xr[u] = nullptr;
    hr[u] = nullptr;
    if (row < B) {
      if (a.tok == nullptr) {
        xr[u] = a.x + (size_t)row * I;
      } else {
        const int v = a.tok[row * a.tok_sb];
        if (v >= 0 && v < a.V) xr[u] = a.x + (size_t)v * I;
      }
      if (a.hprev != nullptr) hr[u] = a.hprev + (size_t)row * H;
    }
  }
  float4 av[4], bv[4];
  float sum[64];
  wg::gemm_tf32(
      sum, ring, Kp / wg::TF_BK,
      [&](int kt) {
        const int k0 = kt * wg::TF_BK;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          av[u] = k0 < Ixp ? wg::load4(xr[u], k0 + 4 * c, I, a.vec_x)
                           : wg::load4(hr[u], k0 - Ixp + 4 * c, H, a.vec_h);
          bv[u] = wg::load4(a.w + (size_t)(n0 + r0 + 32 * u) * Kp, k0 + 4 * c, Kp, true);
        }
      },
      [&](uint32_t dst, int) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const uint32_t off = wg::swz(r0 + 32 * u, c);
          wg::put4_split(dst + off, av[u]);
          wg::put4_split(dst + 2 * wg::TILE + off, bv[u]);
        }
      });
  const float* tile = wg::stage_tile(sum, smem_raw, ring);
  const int u0 = blockIdx.x * 32;
  const size_t G = 4 * (size_t)H;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < wg::BM * 32; idx += wg::NTH) {
    const int r = idx >> 5, j = idx & 31, row = m0 + r, u = u0 + j;
    if (row >= B || u >= H) continue;
    const float* g = tile + r * wg::EPI_PITCH + j;  // gate q at g[32 q]
    const float ig = sigm(g[0] + a.bias[u]);
    const float fg = sigm(g[32] + a.bias[H + u]);
    const float gg = tanhf(g[64] + a.bias[2 * H + u]);
    const float og = sigm(g[96] + a.bias[3 * H + u]);
    const size_t bu = (size_t)row * H + u;
    const float cn = fg * (a.c_in != nullptr ? a.c_in[bu] : 0.0f) + ig * gg;
    const float hn = og * tanhf(cn);
    a.c_out[bu] = cn;
    a.hs[bu] = hn;
    a.cs[bu] = cn;
    float* gp = a.gs + row * G + u;
    gp[0] = ig;
    gp[H] = fg;
    gp[2 * H] = gg;
    gp[3 * H] = og;
    if (a.hf != nullptr) a.hf[bu] = hn;
  }
}

// One f32 layer over L steps (SeqFwdArgs' layout in f32): L launches of
// seq_fwd_tf32_kernel, the kernel boundary being the grid-wide barrier the
// recurrence needs. Step t's input rows are xs + t * x_st ([B, I]); with
// tok, row b reads table row tok[t * tok_st + b * tok_sb] of xs [V, I].
// Residual row t at hs/cs + t * h_st, gs + t * g_st (elements).
struct SeqFwdTf32Args {
  const float* xs;
  long x_st;
  const int* tok;
  long tok_st, tok_sb;
  int V;
  const float* h0;   // [B, H], or null: zeros
  const float* c0;   // [B, H], or null: zeros
  const float* w;    // [fwd_np(H), fwd_kp(I, H)] interleave_weight (f32)
  const float* bias; // [4H]
  float* hs;
  float* cs;
  float* gs;
  long h_st, g_st;
  float* c;          // [B, H] the running c; c_{L-1} at the end
  float* hf;         // [B, H] h_{L-1}, or null
  int B, L, I, H;
};

inline cudaError_t seq_fwd_tf32(const SeqFwdTf32Args& s, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(seq_fwd_tf32_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, wg::TF_SMEM);
  if (e != cudaSuccess) return e;
  const int H = s.H, I = s.I;
  FwdStepTf32Args a = {};
  a.tok_sb = s.tok_sb;
  a.V = s.V;
  a.c_out = s.c;
  a.w = s.w;
  a.bias = s.bias;
  a.B = s.B; a.I = I; a.H = H;
  a.Ixp = fwd_ixp(I);
  a.Kp = fwd_kp(I, H);
  a.vec_x = I % 4 == 0 && aligned16(s.xs) && (s.tok != nullptr || s.x_st % 4 == 0);
  const dim3 grid(fwd_np(H) / wg::BN, cdiv(s.B, wg::BM));
  for (int t = 0; t < s.L; ++t) {
    a.x = s.tok != nullptr ? s.xs : s.xs + t * s.x_st;
    a.tok = s.tok != nullptr ? s.tok + t * s.tok_st : nullptr;
    if (t == 0) {
      a.hprev = s.h0;
      a.vec_h = H % 4 == 0 && aligned16(s.h0);
      a.c_in = s.c0;
    } else {
      a.hprev = s.hs + (t - 1) * s.h_st;
      a.vec_h = H % 4 == 0 && aligned16(s.hs) && s.h_st % 4 == 0;
      a.c_in = s.c;
    }
    a.hs = s.hs + t * s.h_st;
    a.cs = s.cs + t * s.h_st;
    a.gs = s.gs + t * s.g_st;
    a.hf = t == s.L - 1 ? s.hf : nullptr;
    seq_fwd_tf32_kernel<<<grid, wg::NTH, wg::TF_SMEM, st>>>(a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace train
