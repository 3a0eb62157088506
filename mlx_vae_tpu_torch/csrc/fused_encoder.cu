// Fused encoder stack for the AR-CVAE train step, for Hopper (sm_90a):
// forward and backward.
//
// Replaces the TPU kernels of mlx_vae_tpu/ops/pallas_encoder.py:
//   enc_fwd_launch  <- _fwd_kernel (reached through _enc_fwd / encoder_stack_pallas)
//   enc_bwd_launch  <- _bwd_kernel (reached through _enc_bwd_rule)
// The forward embeds each token (a row read of the table: the one-hot
// matmul of the TPU gives the same values), runs the n stacked LSTM layers
// over L steps from zero state and returns the top layer's h at the last
// step [B, H] f32, storing h, c and activated gates of every (t, layer) in
// the compute dtype. The backward takes the one cotangent of that pooled
// feature, injected into the top layer at t = L-1, runs the reverse (dh, dc)
// chains, and forms every layer's dW and db and the embedding gradient, all
// in f32. The plain PyTorch version of both is in
// mlx_vae_tpu_torch/ops/fused_encoder.py, which also builds this file with
// nvcc and binds it through ctypes (plain C interface below).
//
// Design: both dtypes run the same frame on the tensor cores, routed by
// dtype inside enc_fwd_launch / enc_bwd_launch before any launch. bf16 runs
// wgmma on bf16 operands (wgmma.cuh:gemm); f32 runs split-TF32 (wgmma.cuh:
// gemm_tf32: every f32 product as three TF32 products, hi*hi + hi*lo +
// lo*hi, each stage's product added to an f32 register sum).
//  * Forward: the stack layer by layer, each layer L step launches
//    (train_common.cuh: seq_fwd_wgmma / seq_fwd_step_kernel in bf16,
//    seq_fwd_tf32 / seq_fwd_tf32_kernel in f32), so n * L launches, each one
//    card-wide GEMM [x_t, h_{t-1}] W'_l of one (step, layer) with the cell
//    in its epilogue. W'_l is the wrapper's gate-interleaved K-major copy of
//    the layer's weight, so one 128-wide
//    output tile holds i, f, g and o of 32 units. Layer 0's input rows are
//    the tokens' embedding rows (gathered by the kernel's loader); layer
//    l > 0 reads the layer below's stored h (rows t * n + l - 1 of hs); each
//    layer's state starts at zero and runs in one f32 [B, H] c buffer.
//    Layer-major order gives the same values as the TPU's step-major
//    wavefront: every cell sees the same operands.
//  * Backward, the reverse chain: it writes dgates [L, n, B, 4H] and the
//    embedding-input cotangent dx0 [L, B, E], both in the compute dtype (the
//    TPU rounds them before its products). 1 + n * L launches on one
//    stream, the kernel boundary being the grid-wide barrier the recurrence
//    needs: train_common.cuh's gate_kernel runs the gate step of (L-1, n-1)
//    from dh_last; then for t = L-1 .. 0 and l = n-1 .. 0 one card-wide GEMM
//    dinp = dgates(t, l) W_l^T (enc_step_kernel on train_common.cuh's
//    dinp_tile in bf16, enc_step_tf32_kernel on dinp_tile_tf32 in f32:
//    128 x 128 tiles, wcat read as it lies, K-major) whose epilogue runs the
//    gate step that the product unblocks:
//    (t, l-1) from the input columns, or at the top layer (t-1, n-1) from
//    the h columns. Each layer's running dc is an f32 [B, H] buffer and the
//    h cotangent a layer hands to its next step another; launching top down
//    within a step makes both cotangents of every gate step ready in one
//    product's epilogue.
//  * Backward, sums over rows (train_common.cuh): dW and db of each layer
//    and d(embedding) are split reductions over the t*B rows with partials
//    added in a fixed order, where the TPU kernel added into one VMEM
//    accumulator across its sequential grid. dW runs on wgmma in bf16 and
//    as split-TF32 in f32 (wgrad_tf32_kernel).
//
// What bounds it: at the default model (E=128, H=256, n=2) and B=4096, L=64
// the forward and the reverse chain are ~0.48 TFLOP of products each (the
// weight gradient as much again), and the residual streams (h, c, gates)
// ~0.8 GB in bf16, 1.6 GB in f32: the operations bound all of it, 0.49 ms
// for the forward at the tensor cores' bf16 rate and 2.92 ms as split-TF32
// (3 x the operations at 495 TFLOP/s). The f32 kernels this replaced, one
// block owning R rows for the whole loop on CUDA-core FMA, streamed every
// weight from L2 at every step to serve a few rows (PERF.md, PR 17). A
// reverse launch here has 96 (layer 0) or 128 (layer 1) tiles at B = 4096,
// against 264 resident blocks in bf16 (two an SM) and 132 in f32 (one an
// SM: the split-TF32 ring is 192 KB).

#include <type_traits>

#include "train_common.cuh"

namespace {

struct FwdArgs {
  const int* tokens;   // [B, L]
  const void* emb;     // [V, E] T
  const void* wt;      // every layer's interleaved weight back to back, [fwd_np(H),
                       // fwd_kp(K_l, H)] each (ops/train_common.py:interleave_weight), T
  const float* bias;   // [n, 4H]
  float* h_last;       // [B, H]
  void* hs;            // [L, n, B, H] T
  void* cs;            // [L, n, B, H] T
  void* gs;            // [L, n, B, 4H] T
  float* cbuf;         // [B, H] the running c
  int B, L, V, E, H, n;
};

// Layer by layer, L step launches each (train_common.cuh).
template <typename T>
cudaError_t launch_fwd(const FwdArgs& a, cudaStream_t st) {
  constexpr bool BF = sizeof(T) == 2;
  using Args = std::conditional_t<BF, train::SeqFwdArgs, train::SeqFwdTf32Args>;
  const int B = a.B, L = a.L, H = a.H, n = a.n;
  const long hst = (long)n * B * H, gst = 4 * hst;
  T* hs = static_cast<T*>(a.hs);
  T* cs = static_cast<T*>(a.cs);
  T* gs = static_cast<T*>(a.gs);
  const T* wt = static_cast<const T*>(a.wt);
  size_t woff = 0;
  for (int l = 0; l < n; ++l) {
    Args s = {};
    s.I = l == 0 ? a.E : H;
    if (l == 0) {  // row b at step t: the embedding row of tokens[b, t]
      s.xs = static_cast<const T*>(a.emb);
      s.tok = a.tokens;
      s.tok_st = 1;
      s.tok_sb = L;
      s.V = a.V;
    } else {  // the layer below's h: rows t * n + l - 1
      s.xs = hs + (size_t)(l - 1) * B * H;
      s.x_st = hst;
    }
    s.w = wt + woff;
    s.bias = a.bias + (size_t)l * 4 * H;
    s.hs = hs + (size_t)l * B * H;
    s.cs = cs + (size_t)l * B * H;
    s.gs = gs + (size_t)l * B * 4 * H;
    s.h_st = hst;
    s.g_st = gst;
    s.c = a.cbuf;
    s.hf = l == n - 1 ? a.h_last : nullptr;
    s.B = B; s.L = L; s.H = H;
    cudaError_t e;
    if constexpr (BF) e = train::seq_fwd_wgmma(s, st);
    else e = train::seq_fwd_tf32(s, st);
    if (e != cudaSuccess) return e;
    woff += (size_t)train::fwd_np(H) * train::fwd_kp(s.I, H);
  }
  return cudaSuccess;
}

struct BwdArgs {
  const float* dh_last;  // [B, H]
  const void* hs;        // [L, n, B, H] T (the weight-gradient pass reads it)
  const void* cs;
  const void* gs;        // [L, n, B, 4H] T
  const void* wcat;      // per layer [(K_l + H), 4H] T, back to back
  float* dh;             // [n, B, H] zeros: the h cotangent handed down a step
  float* dc;             // [n, B, H] zeros: each layer's running dc
  void* dgates;          // [L, n, B, 4H] T
  void* dx0;             // [L, B, E] T
  int B, L, E, H, n;
};

// One launch per (t, l), in the order (L-1, n-1), (L-1, n-2), ..., (0, 0).
template <typename T>
struct StepArgs {
  const T* dg;              // [B, 4H] dgates at (t, l): the A operand
  const T* w;               // [K_l + H, 4H] layer l's wcat: row k is column k of the product
  T* dx;                    // [B, E] dx0 at t (l = 0)
  const float* dh_in;       // [B, H] dh of layer l - 1 from (t + 1, l - 1) (l > 0)
  float* dh_out;            // [B, H] dh of layer l for (t - 1, l) (l < n - 1)
  int B, Kx, N, G, H, vec;
  int below;                // l > 0: input columns run the gate step of (t, l - 1)
  int top;                  // l = n - 1: h columns run the gate step of (t - 1, l)
  train::GateArgsT<T> gx;   // the gate step of (t, l - 1)
  train::GateArgsT<T> gh;   // the gate step of (t - 1, n - 1)
};

// The epilogue of a reverse launch: dinp [B, K_l + H] = dgates(t, l) [B, 4H]
// W_l^T, one 128 x 128 tile a block over the first N columns (N = K_l at t
// = 0, whose h columns nothing reads), staged in shared memory as f32. It
// walks the tile row by row, deciding per column (a tile may straddle K_l):
//  * k < K_l, l > 0: the cotangent of layer l - 1's h at t; its thread runs
//    the gate step of (t, l - 1) at unit k with dh_in + value;
//  * k < K_l, l = 0: dx0 at t, in T;
//  * k = K_l + j, l = n - 1: the cotangent of the top layer's h at t - 1;
//    nothing comes from above there, so its thread runs the gate step of
//    (t - 1, n - 1) at unit j;
//  * k = K_l + j, l < n - 1: stored to dh_out for the launch of (t - 1, l + 1).
// One writer per element, no atomics.
template <typename T>
__device__ __forceinline__ void step_epilogue(const float* tile, const StepArgs<T>& a) {
  const int n0 = blockIdx.x * wg::BN, m0 = blockIdx.y * wg::BM;
  const int B = a.B, N = a.N, Kx = a.Kx, H = a.H;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < wg::BM * wg::BN; idx += wg::NTH) {
    const int r = idx / wg::BN, cc = idx % wg::BN, row = m0 + r, col = n0 + cc;
    if (row >= B || col >= N) continue;
    const float v = tile[r * wg::EPI_PITCH + cc];
    if (col < Kx) {
      if (a.below) train::gate_step(a.gx, row, col, a.dh_in[(size_t)row * H + col] + v);
      else train::st(a.dx + (size_t)row * Kx + col, v);
    } else if (a.top) {
      train::gate_step(a.gh, row, col - Kx, v);
    } else {
      a.dh_out[(size_t)row * H + (col - Kx)] = v;
    }
  }
}

// bf16: the product on wgmma (train_common.cuh's dinp_tile).
__global__ void __launch_bounds__(wg::NTH, wg::BLOCKS_PER_SM)
    enc_step_kernel(const StepArgs<__nv_bfloat16> a) {
  extern __shared__ unsigned char smem_raw[];
  step_epilogue(train::dinp_tile(smem_raw, a.dg, a.w, a.B, a.N, a.G, a.vec), a);
}

// f32: the product as split-TF32 (train_common.cuh's dinp_tile_tf32).
__global__ void __launch_bounds__(wg::NTH, wg::TF_BLOCKS_PER_SM)
    enc_step_tf32_kernel(const StepArgs<float> a) {
  extern __shared__ unsigned char smem_raw[];
  step_epilogue(train::dinp_tile_tf32(smem_raw, a.dg, a.w, a.B, a.N, a.G, a.vec), a);
}

// The reverse chain: 1 + n * L launches on one stream (the kernel boundary
// is the grid-wide barrier). Launch (t, l) reads dh[l - 1], which launch
// (t + 1, l - 1) wrote and launch (t, l - 1) overwrites after it.
template <typename T>
cudaError_t reverse_chain(const BwdArgs& a, cudaStream_t st) {
  constexpr bool BF = sizeof(T) == 2;
  const int B = a.B, L = a.L, H = a.H, E = a.E, n = a.n, G = 4 * H;
  const T* gs = static_cast<const T*>(a.gs);
  const T* cs = static_cast<const T*>(a.cs);
  const T* wcat = static_cast<const T*>(a.wcat);
  T* dgates = static_cast<T*>(a.dgates);
  const size_t BH = (size_t)B * H;
  // the gate step of (s, l): zero state before s = 0, no output cotangent
  auto gate_at = [&](int s, int l) {
    const size_t slab = ((size_t)s * n + l) * B;
    train::GateArgsT<T> x = {};
    x.gs = gs + slab * G;
    x.cs = cs + slab * H;
    x.cprev = s > 0 ? cs + (slab - (size_t)n * B) * H : nullptr;
    x.dc_in = a.dc + l * BH;
    x.dc = a.dc + l * BH;
    x.dg = dgates + slab * G;
    x.H = H;
    return x;
  };
  train::gate_kernel<<<train::cdiv((long)B * H, 256), 256, 0, st>>>(gate_at(L - 1, n - 1),
                                                                  a.dh_last, B * H);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int smem = BF ? wg::SMEM : wg::TF_SMEM;
  if constexpr (BF)
    e = cudaFuncSetAttribute(enc_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  else
    e = cudaFuncSetAttribute(enc_step_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (e != cudaSuccess) return e;
  size_t wend = 0;
  for (int l = 0; l < n; ++l) wend += (size_t)((l == 0 ? E : H) + H) * G;
  StepArgs<T> s = {};
  s.B = B; s.G = G; s.H = H;
  s.vec = G % (16 / (int)sizeof(T)) == 0 && train::aligned16(a.wcat) &&
          train::aligned16(a.dgates);
  for (int t = L - 1; t >= 0; --t) {
    size_t woff = wend;
    for (int l = n - 1; l >= 0; --l) {
      s.Kx = l == 0 ? E : H;
      woff -= (size_t)(s.Kx + H) * G;
      s.N = t > 0 ? s.Kx + H : s.Kx;
      s.w = wcat + woff;
      s.dg = dgates + ((size_t)t * n + l) * B * G;
      s.dx = static_cast<T*>(a.dx0) + (size_t)t * B * E;
      s.below = l > 0;
      s.top = l == n - 1;
      s.dh_in = l > 0 ? a.dh + (l - 1) * BH : nullptr;
      s.dh_out = a.dh + l * BH;
      if (l > 0) s.gx = gate_at(t, l - 1);
      if (l == n - 1 && t > 0) s.gh = gate_at(t - 1, n - 1);
      const dim3 grid(train::cdiv(s.N, wg::BN), train::cdiv(B, wg::BM));
      if constexpr (BF)
        enc_step_kernel<<<grid, wg::NTH, smem, st>>>(s);
      else
        enc_step_tf32_kernel<<<grid, wg::NTH, smem, st>>>(s);
      e = cudaGetLastError();
      if (e != cudaSuccess) return e;
    }
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_bwd(const BwdArgs& a, const int* tokens, const void* emb, float* dW,
                       float* db, float* demb, int V, float* scratch, long scratch_elems,
                       cudaStream_t st) {
  cudaError_t e = reverse_chain<T>(a, st);
  if (e != cudaSuccess) return e;
  const int B = a.B, L = a.L, H = a.H, E = a.E, n = a.n, G = 4 * H, M = B * L;
  const T* hs = static_cast<const T*>(a.hs);
  const T* dgates = static_cast<const T*>(a.dgates);
  size_t woff = 0;
  for (int l = 0; l < n; ++l) {
    const int Kx = l == 0 ? E : H;
    train::WgradArgs g = {};
    g.d = dgates + (size_t)l * B * G;
    g.d_st = (long)n * B * G;
    g.d_sb = G;
    g.N = G;
    g.B = B;
    g.M = M;
    // input rows: the embedded token (layer 0) or the layer below's h
    g.K = Kx;
    if (l == 0) {
      g.a = emb;
      g.a_mode = train::A_GATHER;
      g.tok = tokens;
      g.tok_st = 1;
      g.tok_sb = L;
      g.V = V;
    } else {
      g.a = hs + (size_t)(l - 1) * B * H;
      g.a_mode = train::A_DENSE;
      g.a_st = (long)n * B * H;
      g.a_sb = H;
    }
    e = train::wgrad<T, T>(g, dW + woff, nullptr, scratch, scratch_elems, st);
    if (e != cudaSuccess) return e;
    // recurrent rows: this layer's h at the previous step (0 at t = 0)
    train::WgradArgs gh = g;
    gh.K = H;
    gh.a = hs + (size_t)l * B * H;
    gh.a_mode = train::A_SHIFT;
    gh.a_st = (long)n * B * H;
    gh.a_sb = H;
    gh.a0 = nullptr;
    e = train::wgrad<T, T>(gh, dW + woff + (size_t)Kx * G, db + (size_t)l * G, scratch,
                           scratch_elems, st);
    if (e != cudaSuccess) return e;
    woff += (size_t)(Kx + H) * G;
  }
  return train::demb<T>(static_cast<const T*>(a.dx0), tokens, 1, L, B, M, V, E, demb, scratch,
                        scratch_elems, st);
}

}  // namespace

extern "C" {

// Each returns a cudaError_t as int: 0 when every launch was accepted.
// wt: every layer's interleaved weight back to back, [fwd_np(H), fwd_kp(K_l,
// H)] each (ops/train_common.py:interleave_weight), in the compute dtype;
// cbuf [B, H] f32 the running c.
int enc_fwd_launch(const void* tokens, const void* emb, const void* wt, const void* bias,
                   void* h_last, void* hs, void* cs, void* gs, void* cbuf, int B, int L, int V,
                   int E, int H, int n, int bf16, void* stream) {
  FwdArgs a;
  a.tokens = static_cast<const int*>(tokens);
  a.emb = emb;
  a.wt = wt;
  a.bias = static_cast<const float*>(bias);
  a.h_last = static_cast<float*>(h_last);
  a.hs = hs;
  a.cs = cs;
  a.gs = gs;
  a.cbuf = static_cast<float*>(cbuf);
  a.B = B; a.L = L; a.V = V; a.E = E; a.H = H; a.n = n;
  if (B < 1 || L < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? launch_fwd<__nv_bfloat16>(a, s) : launch_fwd<float>(a, s));
}

// wcat: every layer's [K_l + H, 4H] weight back to back, read by the reverse
// chain; dh and dc its [n, B, H] f32 buffers (zeros on entry).
int enc_bwd_launch(const void* tokens, const void* emb, const void* wcat, const void* dh_last,
                   const void* hs, const void* cs, const void* gs, void* dh, void* dc,
                   void* dgates, void* dx0, void* dW, void* db, void* demb, void* scratch,
                   long scratch_elems, int B, int L, int V, int E, int H, int n, int bf16,
                   void* stream) {
  BwdArgs a;
  a.dh_last = static_cast<const float*>(dh_last);
  a.hs = hs;
  a.cs = cs;
  a.gs = gs;
  a.wcat = wcat;
  a.dh = static_cast<float*>(dh);
  a.dc = static_cast<float*>(dc);
  a.dgates = dgates;
  a.dx0 = dx0;
  a.B = B; a.L = L; a.E = E; a.H = H; a.n = n;
  if (B < 1 || L < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tok = static_cast<const int*>(tokens);
  float* w = static_cast<float*>(dW);
  float* b = static_cast<float*>(db);
  float* de = static_cast<float*>(demb);
  float* sc = static_cast<float*>(scratch);
  return (int)(bf16 ? launch_bwd<__nv_bfloat16>(a, tok, emb, w, b, de, V, sc, scratch_elems, s)
                    : launch_bwd<float>(a, tok, emb, w, b, de, V, sc, scratch_elems, s));
}

const char* enc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
