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
//    rows); the reverse step reads its transpose [4H, K_l + H] so that a
//    thread owning one input column reads neighbouring addresses.
//
// Cross-row sums. On the TPU a backward kernel adds every batch block's
// weight gradient into one VMEM accumulator, because its grid runs in
// order. Blocks on the card run in parallel and in no order, so the reverse
// kernels here write the per-(t, layer, row) gate cotangents dgates [L, n,
// B, 4H] (in T, rounded as the TPU rounds them before its dW product) and
// the layer-0 input cotangent, and wgrad_kernel / demb_kernel form
//   dW_l = sum_{t,b} inp_l(t,b)^T dgates_l(t,b),   db_l = sum_{t,b} dgates_l,
//   d(embedding)[v] = sum_{t,b : token(t,b) = v} dx0(t,b)
// as split reductions: each block sums one output tile over one slice of
// the t*B rows into its own partial, and reduce_kernel adds the partials in
// a fixed order. No atomics, so the sums are the same from run to run.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

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
    float ig = 0.f, fg = 0.f, gg = 0.f, og = 0.f, c = 0.f, cp = 0.f;
    if (g < B) {
      const T* gp = gs + (size_t)g * G + j;
      ig = ld(gp);
      fg = ld(gp + H);
      gg = ld(gp + 2 * H);
      og = ld(gp + 3 * H);
      c = ld(cs_t + (size_t)g * H + j);
      cp = cs_prev != nullptr ? ld(cs_prev + (size_t)g * H + j)
                              : (c0 != nullptr ? c0[(size_t)g * H + j] : 0.0f);
    }
    const float tc = tanhf(c);
    const float dht = dh[idx] + fa[idx];
    const float dct = dc[idx] + dht * og * (1.0f - tc * tc);
    const float di = rnd<T>(dct * gg * ig * (1.0f - ig));
    const float df = rnd<T>(dct * cp * fg * (1.0f - fg));
    const float dgg = rnd<T>(dct * ig * (1.0f - gg * gg));
    const float dout = rnd<T>(dht * tc * og * (1.0f - og));
    float* d = dg + (size_t)r * G + j;
    d[0] = di;
    d[H] = df;
    d[2 * H] = dgg;
    d[3 * H] = dout;
    dc[idx] = dct * fg;
    if (g < B) {
      T* o = dg_out + (size_t)g * G + j;
      st(o, di);
      st(o + H, df);
      st(o + 2 * H, dgg);
      st(o + 3 * H, dout);
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

constexpr int GB_M = 16;  // rows of t*B per shared-memory stage
constexpr int GB_K = 64;  // output tile: rows of dW
constexpr int GB_N = 64;  // output tile: columns of dW

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
  float* part;      // [S][K][N]
  float* part_db;   // [S][N], or null: no bias sum
};

template <typename T>
__device__ __forceinline__ float load_a(const WgradArgs& g, int m, int k) {
  const int t = m / g.B, b = m % g.B;
  const T* a = static_cast<const T*>(g.a);
  if (g.a_mode == A_DENSE) return ld(a + t * g.a_st + b * g.a_sb + k);
  if (g.a_mode == A_SHIFT) {
    if (t > 0) return ld(a + (t - 1) * g.a_st + b * g.a_sb + k);
    return g.a0 != nullptr ? ld(static_cast<const T*>(g.a0) + (size_t)b * g.K + k) : 0.0f;
  }
  const int v = g.tok[t * g.tok_st + b * g.tok_sb];
  return (v >= 0 && v < g.V) ? ld(a + (size_t)v * g.K + k) : 0.0f;
}

// part[s] = sum over rows [s*chunk, (s+1)*chunk) of A^T D for one 64 x 64
// tile; with part_db, the blocks of the first k tile also sum D's columns.
// D is read as stored for the bias sum and rounded to T for the product (the
// TPU sums f32 dlogits into d(bias) but rounds them for d(fc_out)).
template <typename T, typename TD>
__global__ void __launch_bounds__(256) wgrad_kernel(const WgradArgs g) {
  __shared__ float As[GB_M][GB_K];
  __shared__ float Ds[GB_M][GB_N];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * GB_N, k0 = blockIdx.y * GB_K, s = blockIdx.z;
  const int m_begin = s * g.chunk;
  const int m_end = min(m_begin + g.chunk, g.M);
  const TD* d = static_cast<const TD*>(g.d);
  const bool do_db = g.part_db != nullptr && blockIdx.y == 0;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  float dbacc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int m0 = m_begin; m0 < m_end; m0 += GB_M) {
    for (int idx = tid; idx < GB_M * GB_K; idx += 256) {
      const int mm = idx / GB_K, kk = idx % GB_K, m = m0 + mm, k = k0 + kk;
      As[mm][kk] = (m < m_end && k < g.K) ? load_a<T>(g, m, k) : 0.0f;
    }
    for (int idx = tid; idx < GB_M * GB_N; idx += 256) {
      const int mm = idx / GB_N, nn = idx % GB_N, m = m0 + mm, n = n0 + nn;
      float v = 0.0f;
      if (m < m_end && n < g.N) {
        const int t = m / g.B, b = m % g.B;
        v = ld(d + t * g.d_st + b * g.d_sb + n);
      }
      Ds[mm][nn] = v;
    }
    __syncthreads();
#pragma unroll
    for (int mm = 0; mm < GB_M; ++mm) {
      float av[4], dv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[mm][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float raw = Ds[mm][tx * 4 + j];
        dv[j] = rnd<T>(raw);
        if (ty == 0) dbacc[j] += raw;
      }
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
  if (do_db && ty == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < g.N) g.part_db[(size_t)s * g.N + n] = dbacc[j];
    }
  }
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

inline cudaError_t reduce(const float* part, int S, long count, float* out, cudaStream_t st) {
  reduce_kernel<<<cdiv(count, 256), 256, 0, st>>>(part, S, count, out);
  return cudaGetLastError();
}

// dW rows [out, out + K) (+ db when db != null) from one A source. The split
// count S targets ~1024 blocks and is capped by the scratch capacity.
template <typename T, typename TD>
cudaError_t wgrad(WgradArgs g, float* out, float* db, float* scratch, long scratch_elems,
                  cudaStream_t st) {
  const int tiles = cdiv(g.K, GB_K) * cdiv(g.N, GB_N);
  int S = cdiv(1024, tiles);
  S = S < cdiv(g.M, GB_M) ? S : cdiv(g.M, GB_M);
  const long per = (long)g.K * g.N + g.N;
  if (per > scratch_elems) return cudaErrorInvalidValue;
  if ((long)S * per > scratch_elems) S = (int)(scratch_elems / per);
  g.chunk = cdiv(cdiv(g.M, S), GB_M) * GB_M;
  S = cdiv(g.M, g.chunk);
  g.part = scratch;
  g.part_db = db != nullptr ? scratch + (size_t)S * g.K * g.N : nullptr;
  dim3 grid(cdiv(g.N, GB_N), cdiv(g.K, GB_K), S);
  wgrad_kernel<T, TD><<<grid, 256, 0, st>>>(g);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = reduce(g.part, S, (long)g.K * g.N, out, st);
  if (e != cudaSuccess || db == nullptr) return e;
  return reduce(g.part_db, S, g.N, db, st);
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
