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
//    rows); the CUDA-core reverse steps read its transpose [4H, K_l + H] so
//    that a thread owning one input column reads neighbouring addresses.
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
// column sum (colsum_kernel). The f32 pass stays CUDA-core FMA (wgrad_f32_kernel):
// tensor cores in f32 would mean TF32, about three decimal digits, and the
// f32 contract holds gradients to 1e-4.

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
// 64 x 64 tile, CUDA-core FMA in full f32 (tensor cores would mean TF32).
constexpr int GB_M = 16;  // rows of t*B per shared-memory stage
constexpr int GB_K = 64;  // output tile: rows of dW
constexpr int GB_N = 64;  // output tile: columns of dW

__global__ void __launch_bounds__(256) wgrad_f32_kernel(const WgradArgs g) {
  __shared__ float As[GB_M][GB_K];
  __shared__ float Ds[GB_M][GB_N];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * GB_N, k0 = blockIdx.y * GB_K, s = blockIdx.z;
  const int m_begin = s * g.chunk;
  const int m_end = min(m_begin + g.chunk, g.M);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  for (int m0 = m_begin; m0 < m_end; m0 += GB_M) {
    for (int idx = tid; idx < GB_M * GB_K; idx += 256) {
      const int mm = idx / GB_K, kk = idx % GB_K, m = m0 + mm, k = k0 + kk;
      const float* row = (m < m_end && k < g.K) ? a_row<float>(g, m / g.B, m % g.B) : nullptr;
      As[mm][kk] = row != nullptr ? row[k] : 0.0f;
    }
    for (int idx = tid; idx < GB_M * GB_N; idx += 256) {
      const int mm = idx / GB_N, nn = idx % GB_N, m = m0 + mm, n = n0 + nn;
      Ds[mm][nn] = (m < m_end && n < g.N) ? d_row<float>(g, m / g.B, m % g.B)[n] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int mm = 0; mm < GB_M; ++mm) {
      float av[4], dv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[mm][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) dv[j] = Ds[mm][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], dv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = g.part + (size_t)s * g.K * g.N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty * 4 + i;
    if (k >= g.K) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < g.N) out[(size_t)k * g.N + n] = acc[i][j];
    }
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

// blocks of the tensor-core passes resident at once on an H100 SXM (132 SMs)
constexpr int SLOTS = 132 * wg::BLOCKS_PER_SM;

inline cudaError_t reduce(const float* part, int S, long count, float* out, cudaStream_t st) {
  reduce_kernel<<<cdiv(count, 256), 256, 0, st>>>(part, S, count, out);
  return cudaGetLastError();
}

// Splits of the M rows for `tiles` output tiles: the fewest that fill one or
// more whole waves of SLOTS blocks to within 10%, at most 32, at least
// `rows_min` rows each, and at most `cap`.
inline int split_count(int tiles, long M, int rows_min, long cap) {
  int best = 1;
  double best_eff = (double)tiles / ((double)cdiv(tiles, SLOTS) * SLOTS);
  for (int S = 2; S <= 32 && best_eff < 0.9; ++S) {
    const double eff = (double)tiles * S / ((double)cdiv((long)tiles * S, SLOTS) * SLOTS);
    if (eff > best_eff + 0.05) { best = S; best_eff = eff; }
  }
  if ((long)best * rows_min > M) best = cdiv(M, rows_min);
  if (best > cap) best = (int)cap;
  return best < 1 ? 1 : best;
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// dW rows [out, out + K) (+ db when db != null) from one A source: the f32
// kernel for T = float, the tensor-core kernel for bf16 (a dispatch on
// dtype: f32 on the tensor cores would be TF32). Partials are added in a
// fixed order by reduce_kernel, so the sums are the same from run to run.
template <typename T, typename TD>
cudaError_t wgrad(WgradArgs g, float* out, float* db, float* scratch, long scratch_elems,
                  cudaStream_t st) {
  constexpr bool TC = sizeof(T) == 2;
  const int bm = TC ? wg::BM : GB_K, bn = TC ? wg::BN : GB_N, bk = TC ? wg::BK : GB_M;
  const int tiles = cdiv(g.K, bm) * cdiv(g.N, bn);
  const long per = (long)g.K * g.N;
  // f32: ~1024 blocks of 256 threads, several resident per SM
  int S = TC ? split_count(tiles, g.M, 8 * bk, scratch_elems / per)
             : std::max(1L, std::min({(long)cdiv(1024, tiles), (long)cdiv(g.M, bk),
                                      scratch_elems / per}));
  g.chunk = cdiv(cdiv(g.M, S), bk) * bk;
  S = cdiv(g.M, g.chunk);
  if (S > 1 && (long)S * per > scratch_elems) return cudaErrorInvalidValue;
  g.part = S > 1 ? scratch : out;
  dim3 grid(cdiv(g.N, bn), cdiv(g.K, bm), S);
  cudaError_t e;
  if constexpr (TC) {
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
    wgrad_f32_kernel<<<grid, 256, 0, st>>>(g);
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

}  // namespace train
