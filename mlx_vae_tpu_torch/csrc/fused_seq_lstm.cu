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
// Design: both dtypes run one frame on the tensor cores, routed by dtype
// inside seq_fwd_launch / seq_bwd_launch before any launch. bf16 runs wgmma
// on bf16 operands (wgmma.cuh:gemm); f32 runs split-TF32 (wgmma.cuh:
// gemm_tf32: every f32 product as three TF32 products, hi*hi + hi*lo +
// lo*hi, of operands split while they are staged, each 32-deep stage's
// product added to an f32 register sum), which keeps the f32 contract
// (1e-4; one TF32 pass keeps about three decimal digits).
//
// What bounds it: at I = H = 1024, B = 2048, L = 64 each direction is ~2.2
// TFLOP of matrix work per product (the forward's cell products; the
// backward's reverse dgates @ W^T and its weight gradient) against ~1.5-2.7
// GB of residual traffic in bf16 (twice that in f32), so the operations
// bound it: 2.2 ms for the forward and 4.5 ms for the backward at the
// tensor cores' bf16 rate; 13.3 and 26.7 ms as split-TF32 (3 x the
// operations at 495 TFLOP/s). Kernels tiled over rows only (the CUDA-core
// kernels this replaced, last in f32) streamed the layer's whole weight
// (33.5 MB in f32 at I = H = 1024) from L2 at every step to serve a few
// rows.
//
// Forward: train_common.cuh's seq_fwd_wgmma (bf16) / seq_fwd_tf32 (f32), L
// launches of seq_fwd_step_kernel / seq_fwd_tf32_kernel, each one card-wide
// GEMM of the step ([x_t, h_{t-1}] against a gate-interleaved copy of the
// weight that the wrapper builds per call) with the cell in its epilogue;
// the kernel boundary is the grid-wide barrier the recurrence needs.
//
// Backward: each step is one card-wide GEMM, launched from the host: L + 1
// launches, the kernel boundary being the grid-wide barrier the recurrence
// needs.
//  * train_common.cuh's gate_kernel<T>: the gate step of t = L - 1 from dhf,
//    dcf and dhs[L-1].
//  * seq_step_kernel (bf16, dinp_tile) / seq_step_tf32_kernel (f32,
//    dinp_tile_tf32) at t = L-1 .. 0: dinp_t = dgates_t [B, 4H] W^T in 128 x
//    128 output tiles over [B, I + H], reading wcat [I + H, 4H] as it lies
//    (K-major already: no transposed copy). The epilogue writes columns k <
//    I to dxs[t]; column I + j is the cotangent of h_{t-1} at unit j, and
//    the thread holding it runs the gate step of t - 1 there (the stored
//    activations at t - 1, c at t - 1 and t - 2 or c0, dhs[t-1], and the
//    running dc in the f32 [B, H] dc0 buffer), writing dgates[t-1] in T
//    (the next launch's operand); at t = 0 it writes dh0, and dc0 holds the
//    last dc. One writer per element, no atomics, so the result is the same
//    from run to run.
//  * The weight gradient: dW's input rows from xs, its recurrent rows from
//    the previous h (h0 at t = 0), and db, train_common.cuh's split
//    reductions over the L*B rows (wgmma in bf16, split-TF32 in f32, for
//    dW; a column sum for db), partials added in a fixed order. Where the
//    TPU kernel added each batch block into one VMEM accumulator across its
//    sequential grid, blocks here run in parallel and in no order.

#include <type_traits>

#include "train_common.cuh"

namespace {

using bf16_t = __nv_bfloat16;

// L step launches of the forward (train_common.cuh). Row t of the input at
// xs + t * x_st, of hs/cs at + t * h_st, of gs at + t * g_st (elements,
// from the layer's first rows).
template <typename T>
cudaError_t launch_fwd(const T* xs, long x_st, const float* h0, const float* c0, const T* wt,
                       const float* bias, T* hs, T* cs, T* gs, long h_st, long g_st, float* hf,
                       float* cf, int B, int L, int I, int H, cudaStream_t st) {
  constexpr bool BF = sizeof(T) == 2;
  std::conditional_t<BF, train::SeqFwdArgs, train::SeqFwdTf32Args> a = {};
  a.xs = xs;
  a.x_st = x_st;
  a.h0 = h0;
  a.c0 = c0;
  a.w = wt;
  a.bias = bias;
  a.hs = hs;
  a.cs = cs;
  a.gs = gs;
  a.h_st = h_st;
  a.g_st = g_st;
  a.c = cf;
  a.hf = hf;
  a.B = B; a.L = L; a.I = I; a.H = H;
  if constexpr (BF) return train::seq_fwd_wgmma(a, st);
  else return train::seq_fwd_tf32(a, st);
}

struct BwdArgs {
  const void* gs;       // row t at gs + t * g_st: [B, 4H] T (activated gates)
  const void* cs;       // row t at cs + t * h_st: [B, H] T
  long g_st, h_st;
  const float* c0;      // [B, H]
  const void* wcat;     // [I + H, 4H] T
  const float* dhs;     // [L, B, H]
  const float* dhf;     // [B, H]
  const float* dcf;     // [B, H]
  void* dgates;         // [L, B, 4H] T
  float* dxs;           // [L, B, I]
  float* dh0;           // [B, H]
  float* dc0;           // [B, H]
  int B, L, I, H;
};

template <typename T>
struct StepArgs {
  const T* dg;          // [B, 4H] dgates at t: the A operand
  const T* w;           // [I + H, 4H] wcat: row n is column n of the product
  float* dx;            // [B, I] dxs at t
  float* dh0;           // [B, H] (t = 0)
  int B, I, K, G, t;
  int vec;              // every row of dg and w 16-byte aligned
  train::GateArgsT<T> gate;  // the gate step of t - 1 (t > 0)
};

// The epilogue of a reverse launch: dinp_t [B, I + H] = dgates_t [B, 4H]
// W^T, one 128 x 128 tile a block, staged in shared memory as f32: columns
// k < I go to dxs[t], and each column I + j (the cotangent of h_{t-1}) to
// the gate step of t - 1 at (row, j), or to dh0 at t = 0. One thread per
// element, no atomics.
template <typename T>
__device__ __forceinline__ void step_epilogue(const float* tile, const StepArgs<T>& a) {
  const int n0 = blockIdx.x * wg::BN, m0 = blockIdx.y * wg::BM;
  const int B = a.B, K = a.K, I = a.I, H = K - I;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < wg::BM * wg::BN; idx += wg::NTH) {
    const int r = idx / wg::BN, cc = idx % wg::BN, row = m0 + r, col = n0 + cc;
    if (row >= B || col >= K) continue;
    const float v = tile[r * wg::EPI_PITCH + cc];
    if (col < I) a.dx[(size_t)row * I + col] = v;
    else if (a.t == 0) a.dh0[(size_t)row * H + (col - I)] = v;
    else train::gate_step(a.gate, row, col - I, v);
  }
}

// bf16: the product on wgmma (train_common.cuh's dinp_tile).
__global__ void __launch_bounds__(wg::NTH, wg::BLOCKS_PER_SM)
    seq_step_kernel(const StepArgs<bf16_t> a) {
  extern __shared__ unsigned char smem_raw[];
  step_epilogue(train::dinp_tile(smem_raw, a.dg, a.w, a.B, a.K, a.G, a.vec), a);
}

// f32: the product as split-TF32 (train_common.cuh's dinp_tile_tf32).
__global__ void __launch_bounds__(wg::NTH, wg::TF_BLOCKS_PER_SM)
    seq_step_tf32_kernel(const StepArgs<float> a) {
  extern __shared__ unsigned char smem_raw[];
  step_epilogue(train::dinp_tile_tf32(smem_raw, a.dg, a.w, a.B, a.K, a.G, a.vec), a);
}

// The reverse chain as L + 1 launches on one stream (the kernel boundary is
// the grid-wide barrier between steps): gate_kernel<T> for the gate step of
// t = L - 1 from dhf and dcf, then one step launch per t.
template <typename T>
cudaError_t reverse_chain(const BwdArgs& a, cudaStream_t st) {
  constexpr bool BF = sizeof(T) == 2;
  const int B = a.B, H = a.H, I = a.I, G = 4 * H, K = I + H, L = a.L;
  const T* gs = static_cast<const T*>(a.gs);
  const T* cs = static_cast<const T*>(a.cs);
  T* dgates = static_cast<T*>(a.dgates);
  auto gate_at = [&](int s) {
    train::GateArgsT<T> x = {};
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
  train::GateArgsT<T> first = gate_at(L - 1);
  first.dc_in = a.dcf;
  train::gate_kernel<<<train::cdiv((long)B * H, 256), 256, 0, st>>>(first, a.dhf, B * H);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int smem = BF ? wg::SMEM : wg::TF_SMEM;
  if constexpr (BF)
    e = cudaFuncSetAttribute(seq_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  else
    e = cudaFuncSetAttribute(seq_step_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (e != cudaSuccess) return e;
  StepArgs<T> s = {};
  s.w = static_cast<const T*>(a.wcat);
  s.dh0 = a.dh0;
  s.B = B; s.I = I; s.K = K; s.G = G;
  // a row of G = 4H elements is a whole number of 16-byte chunks in f32,
  // and in bf16 where G % 8 == 0: then every row is aligned where both
  // bases are
  s.vec = G % (16 / (int)sizeof(T)) == 0 && train::aligned16(a.wcat) &&
          train::aligned16(a.dgates);
  const dim3 grid(train::cdiv(K, wg::BN), train::cdiv(B, wg::BM));
  for (int t = L - 1; t >= 0; --t) {
    s.t = t;
    s.dg = dgates + (size_t)t * B * G;
    s.dx = a.dxs + (size_t)t * B * I;
    if (t > 0) s.gate = gate_at(t - 1);
    if constexpr (BF)
      seq_step_kernel<<<grid, wg::NTH, smem, st>>>(s);
    else
      seq_step_tf32_kernel<<<grid, wg::NTH, smem, st>>>(s);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
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

template <typename T>
cudaError_t launch_bwd(const BwdArgs& a, const GradArgs& o, cudaStream_t st) {
  cudaError_t e = reverse_chain<T>(a, st);
  if (e != cudaSuccess) return e;
  return weight_grads<T>(a, o, st);
}

}  // namespace

extern "C" {

// Each returns a cudaError_t as int: 0 when every launch was accepted.

// xs: base of the [L * xs_stride, B, I] input array, hs/cs/gs of the
// [L * res_stride, B, .] residual arrays; row t of this layer is row
// t * stride + offset. wt: the interleaved copy of the weight
// (ops/train_common.py:interleave_weight) in the compute dtype; cf is the
// running c.
int seq_fwd_launch(const void* xs, int xs_stride, int xs_offset, const void* h0,
                   const void* c0, const void* wt, const void* bias, void* hs, void* cs,
                   void* gs, int res_stride, int res_offset, void* hf, void* cf, int B, int L,
                   int I, int H, int bf16, void* stream) {
  if (B < 1 || L < 1 || I < 1 || H < 1 || res_stride < 1 || xs_stride < 1 ||
      res_offset < 0 || res_offset >= res_stride || xs_offset < 0 || xs_offset >= xs_stride)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long G = 4L * H, x_st = (long)xs_stride * B * I;
  const long h_st = (long)res_stride * B * H, g_st = (long)res_stride * B * G;
  const size_t x0 = (size_t)xs_offset * B * I, h0r = (size_t)res_offset * B * H;
  const size_t g0 = (size_t)res_offset * B * G;
  const float* h = static_cast<const float*>(h0);
  const float* c = static_cast<const float*>(c0);
  const float* b = static_cast<const float*>(bias);
  float* fh = static_cast<float*>(hf);
  float* fc = static_cast<float*>(cf);
  if (bf16)
    return (int)launch_fwd(static_cast<const bf16_t*>(xs) + x0, x_st, h, c,
                           static_cast<const bf16_t*>(wt), b, static_cast<bf16_t*>(hs) + h0r,
                           static_cast<bf16_t*>(cs) + h0r, static_cast<bf16_t*>(gs) + g0, h_st,
                           g_st, fh, fc, B, L, I, H, s);
  return (int)launch_fwd(static_cast<const float*>(xs) + x0, x_st, h, c,
                         static_cast<const float*>(wt), b, static_cast<float*>(hs) + h0r,
                         static_cast<float*>(cs) + h0r, static_cast<float*>(gs) + g0, h_st,
                         g_st, fh, fc, B, L, I, H, s);
}

// gs, cs, hs: base of the [L * res_stride, B, .] residual arrays; xs: base
// of the [L * xs_stride, B, I] input array. Row t of this layer is row
// t * stride + offset. wcat [I + H, 4H] in the compute dtype is read as it
// lies by the reverse chain.
int seq_bwd_launch(const void* gs, const void* cs, const void* hs, int res_stride,
                   int res_offset, const void* xs, int xs_stride, int xs_offset,
                   const void* h0, const void* c0, const void* wcat, const void* dhs,
                   const void* dhf, const void* dcf, void* dgates, void* dxs, void* dW,
                   void* db, void* dh0, void* dc0, void* scratch, long scratch_elems, int B,
                   int L, int I, int H, int bf16, void* stream) {
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
  return (int)(bf16 ? launch_bwd<bf16_t>(a, o, s) : launch_bwd<float>(a, o, s));
}

const char* seq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
