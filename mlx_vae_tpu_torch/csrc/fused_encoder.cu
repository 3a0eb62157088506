// Fused encoder stack for the AR-CVAE train step, for Hopper (sm_90a):
// forward and backward.
//
// Replaces the TPU kernels of mlx_vae_tpu/ops/pallas_encoder.py:
//   enc_fwd_kernel  <- _fwd_kernel (reached through _enc_fwd / encoder_stack_pallas)
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
// Design:
//  * Forward in bf16 (the tensor cores): the stack layer by layer, each layer
//    train_common.cuh's seq_fwd_wgmma over the L steps, so n * L launches of
//    seq_fwd_step_kernel, each one card-wide wgmma GEMM of one (step, layer)
//    with the cell in its epilogue. Layer 0's input rows are the tokens'
//    embedding rows (gathered by the kernel's loader); layer l > 0 reads the
//    layer below's stored h (rows t * n + l - 1 of hs); each layer's state
//    starts at zero and runs in one f32 [B, H] c buffer. Layer-major order
//    gives the same values as the TPU's step-major wavefront: every cell sees
//    the same operands.
//  * Forward in f32 (CUDA-core FMA; tensor cores in f32 mean TF32): one
//    thread block (256 threads) owns a tile of R rows for the whole time
//    loop, as in fused_generate.cu. Shared memory holds the step's embedded
//    input [R][E], h of every layer double-buffered and c.
//  * Backward, the reverse chain: it writes dgates [L, n, B, 4H] and the
//    embedding-input cotangent dx0 [L, B, E], both rounded to the compute
//    dtype as the TPU rounds them before its products.
//    - bf16 (the tensor cores): 1 + n * L launches on one stream, the kernel
//      boundary being the grid-wide barrier the recurrence needs.
//      train_common.cuh's gate_kernel runs the gate step of (L-1, n-1) from
//      dh_last; then for t = L-1 .. 0 and l = n-1 .. 0, enc_step_kernel is
//      one card-wide wgmma GEMM dinp = dgates(t, l) W_l^T (train_common.cuh's
//      dinp_tile: 128 x 128 tiles, wcat read as it lies) whose epilogue runs
//      the gate step that the product unblocks: (t, l-1) from the input
//      columns, or at the top layer (t-1, n-1) from the h columns. Each layer's running
//      dc is an f32 [B, H] buffer and the h cotangent a layer hands to its
//      next step another; launching top down within a step makes both
//      cotangents of every gate step ready in one product's epilogue.
//    - f32 (enc_bwd_kernel, CUDA-core FMA; tensor cores in f32 mean TF32):
//      a block owns R rows and walks t = L-1 .. 0 and the layers top down.
//      Shared memory holds dh and dc of every layer, the cotangent from the
//      layer above and the step's dgates [R][4H]; the transposed weight
//      streams from L2 at every step.
//  * Backward, sums over rows (train_common.cuh): dW and db of each layer
//    and d(embedding) are split reductions over the t*B rows with partials
//    added in a fixed order, where the TPU kernel added into one VMEM
//    accumulator across its sequential grid. In bf16 dW runs on the tensor
//    cores (wgmma); in f32 on CUDA cores.
//
// What bounds it: at the default model (E=128, H=256, n=2) and B=4096, L=64,
// bf16, the forward and the reverse chain are ~0.48 TFLOP of products
// each, and the residual streams (h, c, gates) ~0.8 GB in bf16: the
// operations bound both (0.49 ms at the tensor cores' bf16 rate). A
// row-tiled CUDA-core kernel streams every weight from L2 at every step to
// serve a few rows: on an H100 80GB HBM3 (700 W) torch.profiler put such a
// forward at 28.2 ms and such a reverse kernel at 49.9 ms. A reverse launch
// here has 96 (layer 0) or 128 (layer 1) tiles at B = 4096, against 264
// resident blocks: half the card.

#include "train_common.cuh"

namespace {

using train::NT;

struct FwdArgs {
  const int* tokens;   // [B, L]
  const void* emb;     // [V, E] T
  const void* wcat;    // per layer [(K_l + H), 4H] T, back to back (K_0 = E)
  const float* bias;   // [n, 4H]
  float* h_last;       // [B, H]
  void* hs;            // [L, n, B, H] T
  void* cs;            // [L, n, B, H] T
  void* gs;            // [L, n, B, 4H] T
  int B, L, V, E, H, n, R, TJ, TR;
};

template <typename T, int RPT>
__global__ void __launch_bounds__(NT) enc_fwd_kernel(const FwdArgs a) {
  extern __shared__ float smem[];
  const int H = a.H, E = a.E, n = a.n, R = a.R, L = a.L, B = a.B, G = 4 * H;
  float* xin = smem;                   // [R][E]
  float* hbuf = xin + R * E;           // [2][n][R][H]
  float* cbuf = hbuf + 2 * n * R * H;  // [n][R][H]
  const int row0 = blockIdx.x * R;
  const T* emb = static_cast<const T*>(a.emb);
  const T* wcat = static_cast<const T*>(a.wcat);
  T* hs = static_cast<T*>(a.hs);
  T* cs = static_cast<T*>(a.cs);
  T* gs = static_cast<T*>(a.gs);

  for (int idx = threadIdx.x; idx < 2 * n * R * H; idx += NT) hbuf[idx] = 0.0f;
  for (int idx = threadIdx.x; idx < n * R * H; idx += NT) cbuf[idx] = 0.0f;
  int p = 0;  // hbuf[p] holds the previous step's h
  for (int t = 0; t < L; ++t) {
    for (int idx = threadIdx.x; idx < R * E; idx += NT) {
      const int r = idx / E, k = idx % E, g = row0 + r;
      float v = 0.0f;
      if (g < B) {
        const int tok = a.tokens[(size_t)g * L + t];
        if (tok >= 0 && tok < a.V) v = train::ld(emb + (size_t)tok * E + k);
      }
      xin[idx] = v;
    }
    __syncthreads();
    size_t woff = 0;
    for (int l = 0; l < n; ++l) {
      const int Kin = l == 0 ? E : H;
      const float* xs = l == 0 ? xin : hbuf + ((size_t)(p ^ 1) * n + (l - 1)) * R * H;
      const size_t slab = ((size_t)t * n + l) * B;
      train::cell_fwd<T, RPT>(wcat + woff, a.bias + (size_t)l * G, Kin, H, xs,
                              hbuf + ((size_t)p * n + l) * R * H,
                              hbuf + ((size_t)(p ^ 1) * n + l) * R * H, cbuf + (size_t)l * R * H,
                              a.TJ, a.TR, row0, B, hs + slab * H, cs + slab * H, gs + slab * G);
      woff += (size_t)(Kin + H) * G;
      __syncthreads();
    }
    p ^= 1;
  }
  const float* htop = hbuf + ((size_t)p * n + (n - 1)) * R * H;
  for (int idx = threadIdx.x; idx < R * H; idx += NT) {
    const int g = row0 + idx / H;
    if (g < B) a.h_last[(size_t)g * H + idx % H] = htop[idx];
  }
}

struct BwdArgs {
  const float* dh_last;  // [B, H]
  const void* hs;        // [L, n, B, H] T (the weight-gradient pass reads it)
  const void* cs;
  const void* gs;        // [L, n, B, 4H] T
  const void* wcat;      // per layer [(K_l + H), 4H] T, back to back (bf16 reads it)
  const void* wT;        // per layer [4H, (K_l + H)] T, back to back (f32 reads it)
  float* dh;             // [n, B, H] zeros: the h cotangent handed down a step (bf16)
  float* dc;             // [n, B, H] zeros: each layer's running dc (bf16)
  void* dgates;          // [L, n, B, 4H] T
  void* dx0;             // [L, B, E] T
  int B, L, E, H, n;
};

template <typename T, int R>
__global__ void __launch_bounds__(NT) enc_bwd_kernel(const BwdArgs a) {
  extern __shared__ float smem[];
  const int H = a.H, E = a.E, n = a.n, L = a.L, B = a.B, G = 4 * H;
  float* dh = smem;              // [n][R][H]
  float* dc = dh + n * R * H;    // [n][R][H]
  float* fa = dc + n * R * H;    // [R][H] cotangent from the layer above
  float* dg = fa + R * H;        // [R][4H]
  const int row0 = blockIdx.x * R;
  const T* cs = static_cast<const T*>(a.cs);
  const T* gs = static_cast<const T*>(a.gs);
  const T* wT = static_cast<const T*>(a.wT);
  T* dgates = static_cast<T*>(a.dgates);
  T* dx0 = static_cast<T*>(a.dx0);

  for (int idx = threadIdx.x; idx < n * R * H; idx += NT) {
    const int l = idx / (R * H), rj = idx % (R * H), g = row0 + rj / H;
    dh[idx] = (l == n - 1 && g < B) ? a.dh_last[(size_t)g * H + rj % H] : 0.0f;
    dc[idx] = 0.0f;
  }
  __syncthreads();
  for (int t = L - 1; t >= 0; --t) {
    // no per-step cotangent reaches the top layer: only the pooled h at L-1
    for (int idx = threadIdx.x; idx < R * H; idx += NT) fa[idx] = 0.0f;
    __syncthreads();
    size_t woff = 0;
    for (int l = 0; l < n; ++l) woff += (size_t)((l == 0 ? E : H) + H) * G;
    for (int l = n - 1; l >= 0; --l) {
      const int Kx = l == 0 ? E : H, K = Kx + H;
      woff -= (size_t)K * G;
      const size_t slab = ((size_t)t * n + l) * B;
      const size_t prev = ((size_t)(t - 1) * n + l) * B;
      float* dhl = dh + (size_t)l * R * H;
      train::cell_bwd_gates<T>(gs + slab * G, cs + slab * H, t > 0 ? cs + prev * H : nullptr,
                               dhl, dc + (size_t)l * R * H, fa, dg, dgates + slab * G, R, H,
                               row0, B);
      __syncthreads();
      if (l > 0) {
        train::cell_bwd_dinp<T, R>(wT + woff, dg, K, G, [&](int r, int k, float v) {
          if (k < Kx) fa[r * H + k] = v;
          else dhl[r * H + (k - Kx)] = v;
        });
      } else {
        T* dxt = dx0 + (size_t)t * B * E;
        train::cell_bwd_dinp<T, R>(wT + woff, dg, K, G, [&](int r, int k, float v) {
          const int g = row0 + r;
          if (k < Kx) {
            if (g < B) train::st(dxt + (size_t)g * E + k, v);
          } else {
            dhl[r * H + (k - Kx)] = v;
          }
        });
      }
      __syncthreads();
    }
  }
}

// bf16: one launch per (t, l), in the order (L-1, n-1), (L-1, n-2), ..., (0, 0).
struct StepArgs {
  const __nv_bfloat16* dg;  // [B, 4H] dgates at (t, l): the A operand
  const __nv_bfloat16* w;   // [K_l + H, 4H] layer l's wcat: row k is column k of the product
  __nv_bfloat16* dx;        // [B, E] dx0 at t (l = 0)
  const float* dh_in;       // [B, H] dh of layer l - 1 from (t + 1, l - 1) (l > 0)
  float* dh_out;            // [B, H] dh of layer l for (t - 1, l) (l < n - 1)
  int B, Kx, N, G, H, vec;
  int below;                // l > 0: input columns run the gate step of (t, l - 1)
  int top;                  // l = n - 1: h columns run the gate step of (t - 1, l)
  train::GateArgs gx;       // the gate step of (t, l - 1)
  train::GateArgs gh;       // the gate step of (t - 1, n - 1)
};

// dinp [B, K_l + H] = dgates(t, l) [B, 4H] W_l^T on wgmma (train_common.cuh's
// dinp_tile: wcat read as it lies), one 128 x 128 tile a block over the
// first N columns (N = K_l at t = 0, whose h columns nothing reads). The
// epilogue walks the staged f32 tile row by row, deciding per column (a tile
// may straddle K_l):
//  * k < K_l, l > 0: the cotangent of layer l - 1's h at t; its thread runs
//    the gate step of (t, l - 1) at unit k with dh_in + value;
//  * k < K_l, l = 0: dx0 at t, rounded to bf16;
//  * k = K_l + j, l = n - 1: the cotangent of the top layer's h at t - 1;
//    nothing comes from above there, so its thread runs the gate step of
//    (t - 1, n - 1) at unit j;
//  * k = K_l + j, l < n - 1: stored to dh_out for the launch of (t - 1, l + 1).
// One writer per element, no atomics.
__global__ void __launch_bounds__(wg::NTH, wg::BLOCKS_PER_SM)
    enc_step_kernel(const StepArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const int n0 = blockIdx.x * wg::BN, m0 = blockIdx.y * wg::BM;
  const int B = a.B, N = a.N;
  const float* tile = train::dinp_tile(smem_raw, a.dg, a.w, B, N, a.G, a.vec);
  const int Kx = a.Kx, H = a.H;
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

// The bf16 reverse chain: 1 + n * L launches on one stream (the kernel
// boundary is the grid-wide barrier). Launch (t, l) reads dh[l - 1], which
// launch (t + 1, l - 1) wrote and launch (t, l - 1) overwrites after it.
cudaError_t reverse_bf16(const BwdArgs& a, cudaStream_t st) {
  using bf16_t = __nv_bfloat16;
  const int B = a.B, L = a.L, H = a.H, E = a.E, n = a.n, G = 4 * H;
  const bf16_t* gs = static_cast<const bf16_t*>(a.gs);
  const bf16_t* cs = static_cast<const bf16_t*>(a.cs);
  const bf16_t* wcat = static_cast<const bf16_t*>(a.wcat);
  bf16_t* dgates = static_cast<bf16_t*>(a.dgates);
  const size_t BH = (size_t)B * H;
  // the gate step of (s, l): zero state before s = 0, no output cotangent
  auto gate_at = [&](int s, int l) {
    const size_t slab = ((size_t)s * n + l) * B;
    train::GateArgs x = {};
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
  e = cudaFuncSetAttribute(enc_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           wg::SMEM);
  if (e != cudaSuccess) return e;
  size_t wend = 0;
  for (int l = 0; l < n; ++l) wend += (size_t)((l == 0 ? E : H) + H) * G;
  StepArgs s = {};
  s.B = B; s.G = G; s.H = H;
  s.vec = G % 8 == 0 && train::aligned16(a.wcat) && train::aligned16(a.dgates);
  for (int t = L - 1; t >= 0; --t) {
    size_t woff = wend;
    for (int l = n - 1; l >= 0; --l) {
      s.Kx = l == 0 ? E : H;
      woff -= (size_t)(s.Kx + H) * G;
      s.N = t > 0 ? s.Kx + H : s.Kx;
      s.w = wcat + woff;
      s.dg = dgates + ((size_t)t * n + l) * B * G;
      s.dx = static_cast<bf16_t*>(a.dx0) + (size_t)t * B * E;
      s.below = l > 0;
      s.top = l == n - 1;
      s.dh_in = l > 0 ? a.dh + (l - 1) * BH : nullptr;
      s.dh_out = a.dh + l * BH;
      if (l > 0) s.gx = gate_at(t, l - 1);
      if (l == n - 1 && t > 0) s.gh = gate_at(t - 1, n - 1);
      const dim3 grid(train::cdiv(s.N, wg::BN), train::cdiv(B, wg::BM));
      enc_step_kernel<<<grid, wg::NTH, wg::SMEM, st>>>(s);
      e = cudaGetLastError();
      if (e != cudaSuccess) return e;
    }
  }
  return cudaSuccess;
}

template <typename T, int RPT>
cudaError_t launch_fwd(const FwdArgs& a, cudaStream_t st) {
  const size_t smem = sizeof(float) * ((size_t)a.R * a.E + (size_t)3 * a.n * a.R * a.H);
  cudaError_t e = cudaFuncSetAttribute(enc_fwd_kernel<T, RPT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  enc_fwd_kernel<T, RPT><<<(a.B + a.R - 1) / a.R, NT, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fwd_rpt(const FwdArgs& a, cudaStream_t st) {
  switch (a.R / a.TR) {
    case 1: return launch_fwd<T, 1>(a, st);
    case 2: return launch_fwd<T, 2>(a, st);
    case 4: return launch_fwd<T, 4>(a, st);
    case 8: return launch_fwd<T, 8>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

// bf16: layer by layer, L step launches each (train_common.cuh).
cudaError_t launch_fwd_bf16(const FwdArgs& a, const __nv_bfloat16* wt, float* cbuf,
                            cudaStream_t st) {
  using bf16_t = __nv_bfloat16;
  const int B = a.B, L = a.L, H = a.H, n = a.n;
  const long hst = (long)n * B * H, gst = 4 * hst;
  bf16_t* hs = static_cast<bf16_t*>(a.hs);
  bf16_t* cs = static_cast<bf16_t*>(a.cs);
  bf16_t* gs = static_cast<bf16_t*>(a.gs);
  size_t woff = 0;
  for (int l = 0; l < n; ++l) {
    train::SeqFwdArgs s = {};
    s.I = l == 0 ? a.E : H;
    if (l == 0) {  // row b at step t: the embedding row of tokens[b, t]
      s.xs = static_cast<const bf16_t*>(a.emb);
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
    s.c = cbuf;
    s.hf = l == n - 1 ? a.h_last : nullptr;
    s.B = B; s.L = L; s.H = H;
    const cudaError_t e = train::seq_fwd_wgmma(s, st);
    if (e != cudaSuccess) return e;
    woff += (size_t)train::fwd_np(H) * train::fwd_kp(s.I, H);
  }
  return cudaSuccess;
}

template <typename T, int R>
cudaError_t launch_bwd_kernel(const BwdArgs& a, cudaStream_t st) {
  const size_t smem = sizeof(float) * ((size_t)2 * a.n * R * a.H + (size_t)R * a.H +
                                       (size_t)R * 4 * a.H);
  cudaError_t e = cudaFuncSetAttribute(enc_bwd_kernel<T, R>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  enc_bwd_kernel<T, R><<<(a.B + R - 1) / R, NT, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const BwdArgs& a, int R, const int* tokens, const void* emb,
                       float* dW, float* db, float* demb, int V, float* scratch,
                       long scratch_elems, cudaStream_t st) {
  cudaError_t e;
  if constexpr (sizeof(T) == 2) {
    e = reverse_bf16(a, st);
  } else {
    switch (R) {
      case 1: e = launch_bwd_kernel<T, 1>(a, st); break;
      case 2: e = launch_bwd_kernel<T, 2>(a, st); break;
      case 4: e = launch_bwd_kernel<T, 4>(a, st); break;
      case 8: e = launch_bwd_kernel<T, 8>(a, st); break;
      default: return cudaErrorInvalidValue;
    }
  }
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
// wcat: every layer's [K_l + H, 4H] weight back to back (f32); wt: every
// layer's interleaved copy back to back, [fwd_np(H), fwd_kp(K_l, H)] each
// (bf16, ops/train_common.py:interleave_weight), with cbuf [B, H] f32 its
// running c.
int enc_fwd_launch(const void* tokens, const void* emb, const void* wcat, const void* wt,
                   const void* bias, void* h_last, void* hs, void* cs, void* gs, void* cbuf,
                   int B, int L, int V, int E, int H, int n, int bf16, int R, int TJ, int TR,
                   void* stream) {
  FwdArgs a;
  a.tokens = static_cast<const int*>(tokens);
  a.emb = emb;
  a.wcat = wcat;
  a.bias = static_cast<const float*>(bias);
  a.h_last = static_cast<float*>(h_last);
  a.hs = hs;
  a.cs = cs;
  a.gs = gs;
  a.B = B; a.L = L; a.V = V; a.E = E; a.H = H; a.n = n; a.R = R; a.TJ = TJ; a.TR = TR;
  if (B < 1 || L < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)launch_fwd_bf16(a, static_cast<const __nv_bfloat16*>(wt),
                                static_cast<float*>(cbuf), s);
  if (TR < 1 || R % TR != 0) return (int)cudaErrorInvalidValue;
  return (int)launch_fwd_rpt<float>(a, s);
}

// wcat: every layer's [K_l + H, 4H] weight back to back, read by the bf16
// reverse chain, with dh and dc its [n, B, H] f32 buffers (zeros on entry);
// wT: every layer's transpose back to back, read by the f32 reverse kernel
// (R: its rows per block).
int enc_bwd_launch(const void* tokens, const void* emb, const void* wcat, const void* wT,
                   const void* dh_last, const void* hs, const void* cs, const void* gs,
                   void* dh, void* dc, void* dgates, void* dx0, void* dW, void* db, void* demb,
                   void* scratch, long scratch_elems, int B, int L, int V, int E, int H, int n,
                   int bf16, int R, void* stream) {
  BwdArgs a;
  a.dh_last = static_cast<const float*>(dh_last);
  a.hs = hs;
  a.cs = cs;
  a.gs = gs;
  a.wcat = wcat;
  a.wT = wT;
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
  return (int)(bf16 ? launch_bwd<__nv_bfloat16>(a, R, tok, emb, w, b, de, V, sc, scratch_elems, s)
                    : launch_bwd<float>(a, R, tok, emb, w, b, de, V, sc, scratch_elems, s));
}

const char* enc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
