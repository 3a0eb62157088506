// One LSTM layer over a whole sequence for the AR-CVAE train step, for
// Hopper (sm_90a): forward and backward.
//
// Replaces the TPU kernels of mlx_vae_tpu/ops/pallas_seq_lstm.py:
//   seq_fwd_launch  <- _fwd_kernel / _fwd_kernel_blk (reached through _fwd,
//                      from lstm_sequence_pallas)
//   seq_bwd_launch  <- _bwd_kernel / _bwd_kernel_blk (reached through
//                      lstm_seq_bwd_pallas_tm, from the lstm_sequence_pallas
//                      VJP and from the decoder's per-layer backward)
// The gate blocking of the TPU versions only worked around a per-buffer
// VMEM limit of the TPU compiler; it has no counterpart here.
//
// Forward: xs [L, B, I] (compute dtype T) and h0, c0 [B, H] f32 -> hs and
// cs [L, B, H] and the ACTIVATED gates [L, B, 4H] in T, and the final h, c
// [B, H] f32. Backward: the reverse (dh, dc) chain with the per-step output
// cotangent dhs [L, B, H] added at each step, starting from (dhf, dcf) and
// from c0 at t = 0; it returns dxs [L, B, I], dW [I + H, 4H], db [4H], dh0
// and dc0, all f32. The residuals (and xs) may be rows of layer-stacked
// arrays: row t of this layer is row t * stride + offset of a
// [L * stride, B, .] array (the decoder's forward stores [L, n, B, .]).
// The plain PyTorch version of both is in
// mlx_vae_tpu_torch/ops/fused_seq_lstm.py, which also builds this file with
// nvcc and binds it through ctypes (plain C interface below).
//
// What bounds it: at I = H = 1024, B = 2048, L = 64 each direction is ~2.2
// TFLOP of matrix work per product (the forward's cell products; the
// backward's reverse dgates @ W^T and its weight gradient) against ~1.5-2.7
// GB of residual traffic, so the operations bound it: 2.2 ms for the
// forward and 4.5 ms for the backward at the tensor cores' bf16 rate.
//
// Forward in bf16 (the tensor cores): train_common.cuh's seq_fwd_wgmma, L
// launches of seq_fwd_step_kernel, each one card-wide wgmma GEMM of the step
// ([x_t, h_{t-1}] against a gate-interleaved copy of the weight) with the
// cell in its epilogue. A kernel tiled over rows only (the CUDA-core forward
// below, once bf16 too) streamed the layer's whole weight (16.8 MB at I = H =
// 1024) from L2 at every step to serve a few rows.
//
// Forward in f32: CUDA-core FMA in full f32 (tensor cores in f32 mean TF32,
// about three decimal digits; the f32 contract is 1e-4). seq_fwd_kernel: one
// block (256 threads) owns a tile of R rows for all L steps, with the step
// input [R][I], h double-buffered and c in shared memory; the cell is
// train_common.cuh's forward tile, reading the weight from L2 at every step.
//
// Backward in bf16 (the tensor cores). A kernel tiled over rows only had to
// stream the whole weight from L2 at every step to serve a handful of rows
// (~275 GB of L2 reads a call) on CUDA-core FMA. Here each step is one
// card-wide GEMM, launched from the host: L + 1 launches, the kernel
// boundary being the grid-wide barrier the recurrence needs.
//  * train_common.cuh's gate_kernel: the gate step of t = L - 1 from dhf,
//    dcf and dhs[L-1].
//  * seq_step_kernel at t = L-1 .. 0: dinp_t = dgates_t [B, 4H] W^T on wgmma
//    in 128 x 128 output tiles over [B, I + H] (wgmma.cuh), reading wcat
//    [I + H, 4H] as it lies (K-major already: no transposed copy). The
//    epilogue writes columns k < I to dxs[t]; column I + j is the cotangent
//    of h_{t-1} at unit j, and the thread holding it runs the gate step of
//    t - 1 there (the stored activations at t - 1, c at t - 1 and t - 2 or
//    c0, dhs[t-1], and the running dc in the f32 [B, H] dc0 buffer), writing
//    dgates[t-1] rounded to bf16 (the next launch's operand); at t = 0 it
//    writes dh0, and dc0 holds the last dc. One writer per element, no
//    atomics, so the result is the same from run to run.
//  * The weight gradient: dW's input rows from xs, its recurrent rows from
//    the previous h (h0 at t = 0), and db, train_common.cuh's split
//    reductions over the L*B rows (wgmma for dW, a column sum for db),
//    partials added in a fixed order. Where the TPU kernel added each batch
//    block into one VMEM accumulator across its sequential grid, blocks here
//    run in parallel and in no order.
//
// Backward in f32: the same contract on CUDA cores.
// seq_bwd_kernel: a block owns R rows and walks t = L-1 .. 0 with dh, dc,
// the step's output cotangent and its dgates [R][4H] in shared memory
// (train_common.cuh's reverse step), reading the transpose [4H, I + H];
// then the f32 split reductions.

#include "train_common.cuh"

namespace {

using train::NT;
using bf16_t = __nv_bfloat16;

// f32: row t of xs at xs + t * x_st, of hs/cs at + t * h_st, of gs at
// + t * g_st (elements).
struct FwdArgs {
  const float* xs;      // [B, I] rows
  const float* h0;      // [B, H]
  const float* c0;      // [B, H]
  const float* wcat;    // [I + H, 4H]
  const float* bias;    // [4H]
  float* hs;            // [B, H] rows
  float* cs;            // [B, H] rows
  float* gs;            // [B, 4H] rows
  long x_st, h_st, g_st;
  float* hf;            // [B, H]
  float* cf;            // [B, H]
  int B, L, I, H, R, TJ, TR;
};

template <int RPT>
__global__ void __launch_bounds__(NT) seq_fwd_kernel(const FwdArgs a) {
  extern __shared__ float smem[];
  const int H = a.H, I = a.I, R = a.R, B = a.B;
  float* xin = smem;               // [R][I]
  float* hbuf = xin + R * I;       // [2][R][H]
  float* cbuf = hbuf + 2 * R * H;  // [R][H]
  const int row0 = blockIdx.x * R;

  for (int idx = threadIdx.x; idx < R * H; idx += NT) {
    const int g = row0 + idx / H;
    const size_t src = (size_t)g * H + idx % H;
    hbuf[idx] = g < B ? a.h0[src] : 0.0f;
    cbuf[idx] = g < B ? a.c0[src] : 0.0f;
  }
  int p = 0;  // hbuf[p] holds the previous step's h
  for (int t = 0; t < a.L; ++t) {
    const float* xt = a.xs + t * a.x_st;
    for (int idx = threadIdx.x; idx < R * I; idx += NT) {
      const int g = row0 + idx / I;
      xin[idx] = g < B ? xt[(size_t)g * I + idx % I] : 0.0f;
    }
    __syncthreads();
    train::cell_fwd<float, RPT>(a.wcat, a.bias, I, H, xin, hbuf + (size_t)p * R * H,
                                hbuf + (size_t)(p ^ 1) * R * H, cbuf, a.TJ, a.TR, row0, B,
                                a.hs + t * a.h_st, a.cs + t * a.h_st, a.gs + t * a.g_st);
    __syncthreads();
    p ^= 1;
  }
  for (int idx = threadIdx.x; idx < R * H; idx += NT) {
    const int g = row0 + idx / H;
    if (g >= B) continue;
    const size_t dst = (size_t)g * H + idx % H;
    a.hf[dst] = hbuf[(size_t)p * R * H + idx];
    a.cf[dst] = cbuf[idx];
  }
}

struct BwdArgs {
  const void* gs;       // row t at gs + t * g_st: [B, 4H] T (activated gates)
  const void* cs;       // row t at cs + t * h_st: [B, H] T
  long g_st, h_st;
  const float* c0;      // [B, H]
  const void* wcat;     // [I + H, 4H] T (bf16 path)
  const void* wT;       // [4H, I + H] T (f32 path)
  const float* dhs;     // [L, B, H]
  const float* dhf;     // [B, H]
  const float* dcf;     // [B, H]
  void* dgates;         // [L, B, 4H] T
  float* dxs;           // [L, B, I]
  float* dh0;           // [B, H]
  float* dc0;           // [B, H]
  int B, L, I, H;
};

// f32: one block owns R rows for all L steps (CUDA-core FMA, full f32).
template <int R>
__global__ void __launch_bounds__(NT) seq_bwd_kernel(const BwdArgs a) {
  extern __shared__ float smem[];
  const int H = a.H, I = a.I, B = a.B, G = 4 * H, K = I + H;
  float* dh = smem;         // [R][H]
  float* dc = dh + R * H;   // [R][H]
  float* fa = dc + R * H;   // [R][H] this step's output cotangent
  float* dg = fa + R * H;   // [R][4H]
  const int row0 = blockIdx.x * R;
  const float* gs = static_cast<const float*>(a.gs);
  const float* cs = static_cast<const float*>(a.cs);
  const float* wT = static_cast<const float*>(a.wT);
  float* dgates = static_cast<float*>(a.dgates);

  for (int idx = threadIdx.x; idx < R * H; idx += NT) {
    const int g = row0 + idx / H;
    const size_t src = (size_t)g * H + idx % H;
    dh[idx] = g < B ? a.dhf[src] : 0.0f;
    dc[idx] = g < B ? a.dcf[src] : 0.0f;
  }
  for (int t = a.L - 1; t >= 0; --t) {
    const float* dht = a.dhs + (size_t)t * B * H;
    for (int idx = threadIdx.x; idx < R * H; idx += NT) {
      const int g = row0 + idx / H;
      fa[idx] = g < B ? dht[(size_t)g * H + idx % H] : 0.0f;
    }
    __syncthreads();
    train::cell_bwd_gates<float>(gs + t * a.g_st, cs + t * a.h_st,
                                 t > 0 ? cs + (t - 1) * a.h_st : nullptr, dh, dc, fa, dg,
                                 dgates + (size_t)t * B * G, R, H, row0, B, a.c0);
    __syncthreads();
    float* dxt = a.dxs + (size_t)t * B * I;
    train::cell_bwd_dinp<float, R>(wT, dg, K, G, [&](int r, int k, float v) {
      if (k < I) {
        if (row0 + r < B) dxt[(size_t)(row0 + r) * I + k] = v;
      } else {
        dh[r * H + (k - I)] = v;
      }
    });
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < R * H; idx += NT) {
    const int g = row0 + idx / H;
    if (g >= B) continue;
    const size_t dst = (size_t)g * H + idx % H;
    a.dh0[dst] = dh[idx];
    a.dc0[dst] = dc[idx];
  }
}

template <int RPT>
cudaError_t launch_fwd(const FwdArgs& a, cudaStream_t st) {
  const size_t smem = sizeof(float) * ((size_t)a.R * a.I + (size_t)3 * a.R * a.H);
  cudaError_t e = cudaFuncSetAttribute(seq_fwd_kernel<RPT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  seq_fwd_kernel<RPT><<<(a.B + a.R - 1) / a.R, NT, smem, st>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_fwd_f32(const FwdArgs& a, cudaStream_t st) {
  switch (a.R / a.TR) {
    case 1: return launch_fwd<1>(a, st);
    case 2: return launch_fwd<2>(a, st);
    case 4: return launch_fwd<4>(a, st);
    case 8: return launch_fwd<8>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

template <int R>
cudaError_t launch_bwd_kernel(const BwdArgs& a, cudaStream_t st) {
  const size_t smem = sizeof(float) * (size_t)7 * R * a.H;
  cudaError_t e = cudaFuncSetAttribute(seq_bwd_kernel<R>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  seq_bwd_kernel<R><<<(a.B + R - 1) / R, NT, smem, st>>>(a);
  return cudaGetLastError();
}

// bf16: the reverse chain as L + 1 launches (the kernel boundary is the
// grid-wide barrier between steps): train_common.cuh's gate_kernel for the
// gate step of t = L - 1 from dhf and dcf, then seq_step_kernel per step.

using train::GateArgs;
using train::gate_step;

struct StepArgs {
  const bf16_t* dg;     // [B, 4H] dgates at t: the A operand
  const bf16_t* w;      // [I + H, 4H] wcat: row n is column n of the product
  float* dx;            // [B, I] dxs at t
  float* dh0;           // [B, H] (t = 0)
  int B, I, K, G, t, vec;
  GateArgs gate;        // the gate step of t - 1 (t > 0)
};

// dinp_t [B, I + H] = dgates_t [B, 4H] W^T, one 128 x 128 tile a block, on
// wgmma (train_common.cuh's dinp_tile: wcat read as it lies), staged in
// shared memory for the epilogue: columns k < I go to dxs[t], and each
// column I + j (the cotangent of h_{t-1}) to the gate step of t - 1 at
// (row, j), or to dh0 at t = 0. One thread per element, no atomics.
__global__ void __launch_bounds__(wg::NTH, wg::BLOCKS_PER_SM)
    seq_step_kernel(const StepArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const int n0 = blockIdx.x * wg::BN, m0 = blockIdx.y * wg::BM;
  const int B = a.B, K = a.K;
  const float* tile = train::dinp_tile(smem_raw, a.dg, a.w, B, K, a.G, a.vec);
  const int I = a.I, H = K - I;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < wg::BM * wg::BN; idx += wg::NTH) {
    const int r = idx / wg::BN, cc = idx % wg::BN, row = m0 + r, col = n0 + cc;
    if (row >= B || col >= K) continue;
    const float v = tile[r * wg::EPI_PITCH + cc];
    if (col < I) a.dx[(size_t)row * I + col] = v;
    else if (a.t == 0) a.dh0[(size_t)row * H + (col - I)] = v;
    else gate_step(a.gate, row, col - I, v);
  }
}

struct GradArgs {
  const void* xs;       // row t at xs + t * x_st: [B, I] T
  long x_st;
  const void* hs;       // row t at hs + t * h_st: [B, H] T
  const void* h0;       // [B, H] T
  float* dW;            // [I + H, 4H]
  float* db;            // [4H]
  float* scratch;
  long scratch_elems;
};

// dW's input rows from xs, its recurrent rows from the previous h (h0 at
// t = 0), and db: train_common.cuh's split reductions over the L*B rows.
template <typename T>
cudaError_t weight_grads(const BwdArgs& a, const GradArgs& o, cudaStream_t st) {
  const int B = a.B, H = a.H, I = a.I, G = 4 * H;
  train::WgradArgs g = {};
  g.d = a.dgates;
  g.d_st = (long)B * G;
  g.d_sb = G;
  g.N = G;
  g.B = B;
  g.M = B * a.L;
  train::WgradArgs gx = g;
  gx.K = I;
  gx.a = o.xs;
  gx.a_mode = train::A_DENSE;
  gx.a_st = o.x_st;
  gx.a_sb = I;
  cudaError_t e = train::wgrad<T, T>(gx, o.dW, nullptr, o.scratch, o.scratch_elems, st);
  if (e != cudaSuccess) return e;
  train::WgradArgs gh = g;
  gh.K = H;
  gh.a = o.hs;
  gh.a_mode = train::A_SHIFT;
  gh.a_st = a.h_st;
  gh.a_sb = H;
  gh.a0 = o.h0;
  return train::wgrad<T, T>(gh, o.dW + (size_t)I * G, o.db, o.scratch, o.scratch_elems, st);
}

cudaError_t launch_bwd_f32(const BwdArgs& a, int R, const GradArgs& o, cudaStream_t st) {
  cudaError_t e;
  switch (R) {
    case 1: e = launch_bwd_kernel<1>(a, st); break;
    case 2: e = launch_bwd_kernel<2>(a, st); break;
    case 4: e = launch_bwd_kernel<4>(a, st); break;
    case 8: e = launch_bwd_kernel<8>(a, st); break;
    default: return cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return e;
  return weight_grads<float>(a, o, st);
}

cudaError_t launch_bwd_bf16(const BwdArgs& a, const GradArgs& o, cudaStream_t st) {
  const int B = a.B, H = a.H, I = a.I, G = 4 * H, K = I + H, L = a.L;
  const bf16_t* gs = static_cast<const bf16_t*>(a.gs);
  const bf16_t* cs = static_cast<const bf16_t*>(a.cs);
  bf16_t* dgates = static_cast<bf16_t*>(a.dgates);
  auto gate_at = [&](int s) {
    GateArgs x;
    x.gs = gs + s * a.g_st;
    x.cs = cs + s * a.h_st;
    x.cprev = s > 0 ? cs + (s - 1) * a.h_st : nullptr;
    x.c0 = a.c0;
    x.dhs = a.dhs + (size_t)s * B * H;
    x.dc_in = a.dc0;
    x.dc = a.dc0;
    x.dg = dgates + (size_t)s * B * G;
    x.H = H;
    return x;
  };
  GateArgs first = gate_at(L - 1);
  first.dc_in = a.dcf;
  train::gate_kernel<<<train::cdiv((long)B * H, 256), 256, 0, st>>>(first, a.dhf, B * H);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(seq_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           wg::SMEM);
  if (e != cudaSuccess) return e;
  StepArgs s = {};
  s.w = static_cast<const bf16_t*>(a.wcat);
  s.dh0 = a.dh0;
  s.B = B; s.I = I; s.K = K; s.G = G;
  s.vec = G % 8 == 0 && train::aligned16(a.wcat) && train::aligned16(a.dgates);
  const dim3 grid(train::cdiv(K, wg::BN), train::cdiv(B, wg::BM));
  for (int t = L - 1; t >= 0; --t) {
    s.t = t;
    s.dg = dgates + (size_t)t * B * G;
    s.dx = a.dxs + (size_t)t * B * I;
    if (t > 0) s.gate = gate_at(t - 1);
    seq_step_kernel<<<grid, wg::NTH, wg::SMEM, st>>>(s);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return weight_grads<bf16_t>(a, o, st);
}

}  // namespace

extern "C" {

// Each returns a cudaError_t as int: 0 when every launch was accepted.

// xs: base of the [L * xs_stride, B, I] input array, hs/cs/gs of the
// [L * res_stride, B, .] residual arrays; row t of this layer is row
// t * stride + offset. bf16 reads wt, the interleaved copy of the weight
// (ops/train_common.py:interleave_weight), and uses cf as its running c;
// f32 reads wcat [I + H, 4H] (R, TJ, TR: its tile plan).
int seq_fwd_launch(const void* xs, int xs_stride, int xs_offset, const void* h0,
                   const void* c0, const void* wcat, const void* wt, const void* bias, void* hs,
                   void* cs, void* gs, int res_stride, int res_offset, void* hf, void* cf, int B,
                   int L, int I, int H, int bf16, int R, int TJ, int TR, void* stream) {
  if (B < 1 || L < 1 || I < 1 || H < 1 || res_stride < 1 || xs_stride < 1 ||
      res_offset < 0 || res_offset >= res_stride || xs_offset < 0 || xs_offset >= xs_stride)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long G = 4L * H, x_st = (long)xs_stride * B * I;
  const long h_st = (long)res_stride * B * H, g_st = (long)res_stride * B * G;
  const size_t x0 = (size_t)xs_offset * B * I, h0r = (size_t)res_offset * B * H;
  const size_t g0 = (size_t)res_offset * B * G;
  if (bf16) {
    train::SeqFwdArgs a = {};
    a.xs = static_cast<const bf16_t*>(xs) + x0;
    a.x_st = x_st;
    a.h0 = static_cast<const float*>(h0);
    a.c0 = static_cast<const float*>(c0);
    a.w = static_cast<const bf16_t*>(wt);
    a.bias = static_cast<const float*>(bias);
    a.hs = static_cast<bf16_t*>(hs) + h0r;
    a.cs = static_cast<bf16_t*>(cs) + h0r;
    a.gs = static_cast<bf16_t*>(gs) + g0;
    a.h_st = h_st;
    a.g_st = g_st;
    a.c = static_cast<float*>(cf);
    a.hf = static_cast<float*>(hf);
    a.B = B; a.L = L; a.I = I; a.H = H;
    return (int)train::seq_fwd_wgmma(a, s);
  }
  if (TR < 1 || R % TR != 0) return (int)cudaErrorInvalidValue;
  FwdArgs a;
  a.xs = static_cast<const float*>(xs) + x0;
  a.h0 = static_cast<const float*>(h0);
  a.c0 = static_cast<const float*>(c0);
  a.wcat = static_cast<const float*>(wcat);
  a.bias = static_cast<const float*>(bias);
  a.hs = static_cast<float*>(hs) + h0r;
  a.cs = static_cast<float*>(cs) + h0r;
  a.gs = static_cast<float*>(gs) + g0;
  a.x_st = x_st;
  a.h_st = h_st;
  a.g_st = g_st;
  a.hf = static_cast<float*>(hf);
  a.cf = static_cast<float*>(cf);
  a.B = B; a.L = L; a.I = I; a.H = H; a.R = R; a.TJ = TJ; a.TR = TR;
  return (int)launch_fwd_f32(a, s);
}

// gs, cs, hs: base of the [L * res_stride, B, .] residual arrays; xs: base
// of the [L * xs_stride, B, I] input array. Row t of this layer is row
// t * stride + offset. wcat [I + H, 4H] is read in bf16, its transpose wT
// [4H, I + H] in f32 (R: the f32 reverse kernel's rows per block).
int seq_bwd_launch(const void* gs, const void* cs, const void* hs, int res_stride,
                   int res_offset, const void* xs, int xs_stride, int xs_offset,
                   const void* h0, const void* c0, const void* wcat, const void* wT,
                   const void* dhs, const void* dhf, const void* dcf, void* dgates, void* dxs,
                   void* dW, void* db, void* dh0, void* dc0, void* scratch, long scratch_elems,
                   int B, int L, int I, int H, int bf16, int R, void* stream) {
  if (B < 1 || L < 1 || I < 1 || H < 1 || res_stride < 1 || xs_stride < 1 ||
      res_offset < 0 || res_offset >= res_stride || xs_offset < 0 || xs_offset >= xs_stride)
    return (int)cudaErrorInvalidValue;
  const size_t es = bf16 ? 2 : 4;
  const long G = 4L * H;
  BwdArgs a;
  a.gs = static_cast<const char*>(gs) + (size_t)res_offset * B * G * es;
  a.cs = static_cast<const char*>(cs) + (size_t)res_offset * B * H * es;
  a.g_st = (long)res_stride * B * G;
  a.h_st = (long)res_stride * B * H;
  a.c0 = static_cast<const float*>(c0);
  a.wcat = wcat;
  a.wT = wT;
  a.dhs = static_cast<const float*>(dhs);
  a.dhf = static_cast<const float*>(dhf);
  a.dcf = static_cast<const float*>(dcf);
  a.dgates = dgates;
  a.dxs = static_cast<float*>(dxs);
  a.dh0 = static_cast<float*>(dh0);
  a.dc0 = static_cast<float*>(dc0);
  a.B = B; a.L = L; a.I = I; a.H = H;
  GradArgs o;
  o.xs = static_cast<const char*>(xs) + (size_t)xs_offset * B * I * es;
  o.x_st = (long)xs_stride * B * I;
  o.hs = static_cast<const char*>(hs) + (size_t)res_offset * B * H * es;
  o.h0 = h0;
  o.dW = static_cast<float*>(dW);
  o.db = static_cast<float*>(db);
  o.scratch = static_cast<float*>(scratch);
  o.scratch_elems = scratch_elems;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? launch_bwd_bf16(a, o, s) : launch_bwd_f32(a, R, o, s));
}

const char* seq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
