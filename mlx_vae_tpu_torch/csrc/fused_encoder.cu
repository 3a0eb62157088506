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
// Design (simple and right first; the recurrent kernels are CUDA-core FMA):
//  * Forward: one thread block (256 threads) owns a tile of R rows for the
//    whole time loop, as in fused_generate.cu. Shared memory holds the
//    step's embedded input [R][E], h of every layer double-buffered and c.
//  * Backward, reverse kernel (enc_bwd_kernel): a block owns R rows and
//    walks t = L-1 .. 0 and the layers top down. Shared memory holds dh and
//    dc of every layer, the cotangent from the layer above and the step's
//    dgates [R][4H]. It writes dgates [L, n, B, 4H] and the embedding-input
//    cotangent [L, B, E], both rounded to the compute dtype as the TPU
//    rounds them before its products.
//  * Backward, sums over rows (train_common.cuh): dW and db of each layer
//    and d(embedding) are split reductions over the t*B rows with partials
//    added in a fixed order, where the TPU kernel added into one VMEM
//    accumulator across its sequential grid. In bf16 dW runs on the tensor
//    cores (wgmma); in f32 on CUDA cores.
//
// What bounds it: at the default model (E=128, H=256, n=2) and B=4096, L=64,
// bf16, torch.profiler on an H100 80GB HBM3 (700 W) put the forward at
// 28.3 ms, the reverse kernel at 49.6 ms and the encoder's weight-gradient
// passes, then on CUDA cores, at ~51 ms (~9.4 TFLOP/s). The forward and the
// reverse kernel are CUDA-core FMA (~0.48 TFLOP each) and stream every
// weight from L2 at every step (as in fused_generate.cu, whose block step
// time was found set by its serial weight stream); the reverse kernel reads
// its dgates operand from shared memory for every FMA. Tensor cores for
// those two are the next step; the residual streams (h, c, gates: ~0.8 GB
// in bf16) are read once by the backward.

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
  const void* wT;        // per layer [4H, (K_l + H)] T, back to back
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
  switch (R) {
    case 1: e = launch_bwd_kernel<T, 1>(a, st); break;
    case 2: e = launch_bwd_kernel<T, 2>(a, st); break;
    case 4: e = launch_bwd_kernel<T, 4>(a, st); break;
    case 8: e = launch_bwd_kernel<T, 8>(a, st); break;
    default: return cudaErrorInvalidValue;
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
int enc_fwd_launch(const void* tokens, const void* emb, const void* wcat, const void* bias,
                   void* h_last, void* hs, void* cs, void* gs, int B, int L, int V, int E, int H,
                   int n, int bf16, int R, int TJ, int TR, void* stream) {
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
  if (B < 1 || L < 1 || TR < 1 || R % TR != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? launch_fwd_rpt<__nv_bfloat16>(a, s) : launch_fwd_rpt<float>(a, s));
}

int enc_bwd_launch(const void* tokens, const void* emb, const void* wT, const void* dh_last,
                   const void* hs, const void* cs, const void* gs, void* dgates, void* dx0,
                   void* dW, void* db, void* demb, void* scratch, long scratch_elems, int B,
                   int L, int V, int E, int H, int n, int bf16, int R, void* stream) {
  BwdArgs a;
  a.dh_last = static_cast<const float*>(dh_last);
  a.hs = hs;
  a.cs = cs;
  a.gs = gs;
  a.wT = wT;
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
