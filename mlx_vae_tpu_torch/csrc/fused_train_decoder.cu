// Fused teacher-forced training decoder for the AR-CVAE train step, for
// Hopper (sm_90a): forward and backward, each with or without the fused
// cross-entropy.
//
// Replaces the TPU kernels of mlx_vae_tpu/ops/pallas_train_decoder.py:
//   dec_fwd_kernel  <- _fwd_kernel (reached through _run_fwd, from
//                      decoder_train_ce_pallas and decoder_train_pallas)
//                      and, in its logits specialization, _fwd_kernel_blk
//                      (reached through decoder_fwd_blk, the forward of
//                      ops/decoder_cv.py:decoder_train_cvp; its gate
//                      blocking only worked around a TPU compiler limit)
//   dec_bwd_launch  <- _bwd_kernel (reached through _run_bwd)
// Forward, per step: embed the fed token (a row read of the table) and
// append the conditions; run the n cells from h_init with c = 0; project to
// the vocab; then either add this step's CE (logsumexp minus the target
// logit) to the row's sum (with_ce: logits never reach device memory) or
// write the logits [B, L, V]. The next token is the target where tf[t],
// else the argmax (ties to the lowest index). The fed tokens [L, B] and h,
// c and activated gates of every (t, layer) are stored for the backward.
// Backward: per step, recompute the softmax from the stored top h and form
// dlogits = (softmax - onehot(target)) * dce (with_ce), or read dlogits;
// project it back through fc_out; run the n reverse chains down to the
// input. Out: dW and db of every layer, d(fc_out), d(embedding), all f32,
// d(h_init) [B, H] (the sum over layers at t = 0) and d(conditions) [B, C]
// through the per-step input. The plain PyTorch version of both is in
// mlx_vae_tpu_torch/ops/fused_train_decoder.py, which also builds this
// file with nvcc and binds it through ctypes (plain C interface below).
//
// Design (simple and right first; the recurrent kernels are CUDA-core FMA):
//  * Forward: one block (256 threads) owns R rows for all L steps, as in
//    fused_generate.cu: step input [R][E+C], h of every layer
//    double-buffered, c, the token and the CE sum in shared memory; one warp
//    per row does the vocab projection, the CE and the argmax over the V
//    real lanes (the TPU pads V to 128 with a -1e9 bias instead).
//  * Backward, reverse kernel (dec_bwd_kernel): a block owns R rows and
//    walks t = L-1 .. 0: dlogits per row by one warp, its projection
//    through fc_out, then the layers top down (train_common.cuh). It writes
//    dgates [L, n, B, 4H] and the embedding-input cotangent [L, B, E] in the
//    compute dtype and dlogits [L, B, V] in f32; d(h_init) and d(cond) are
//    per-row sums and stay in the block.
//  * Backward, sums over rows: dW and db of each layer, d(fc_out),
//    d(fc_out bias) and d(embedding) are split reductions over the t*B rows
//    with partials added in a fixed order (train_common.cuh), where the TPU
//    kernel added into one VMEM accumulator across its sequential grid. In
//    bf16 the dW products run on the tensor cores (wgmma; fc_out's f32
//    dlogits are rounded to bf16 for its product and summed unrounded into
//    d(fc_out bias)); in f32 on CUDA cores.
//
// What bounds it: at the default model (E=128, C=1, H=256, n=2, V=80) and
// B=4096, L=64, bf16, torch.profiler on an H100 80GB HBM3 (700 W) put the
// forward at 31.1 ms, the reverse kernel at 57.6 ms and the decoder's
// weight-gradient passes, then on CUDA cores, at ~51 ms (~9.4 TFLOP/s). The
// forward and the reverse kernel are CUDA-core FMA (~0.49 TFLOP each) and
// stream every weight from L2 at every step. Tensor cores for those two are
// the next step.

#include "train_common.cuh"

namespace {

using train::NT;
using train::NW;

struct FwdArgs {
  const int* targets;  // [B, L]
  const int* tf;       // [L] 0/1
  const float* cond;   // [B, C]
  const float* h_init; // [B, H]
  const void* emb;     // [V, E] T
  const void* wcat;    // per layer [(K_l + H), 4H] T, back to back (K_0 = E + C)
  const float* bias;   // [n, 4H]
  const void* wout;    // [H, V] T
  const float* bout;   // [V]
  float* out;          // with_ce: ce [B]; else logits [B, L, V]
  int* toks;           // [L, B] fed tokens
  void* hs;            // [L, n, B, H] T
  void* cs;
  void* gs;            // [L, n, B, 4H] T
  int B, L, V, E, C, H, n, R, TJ, TR, with_ce, start_token;
};

template <typename T, int RPT, int VPL>
__global__ void __launch_bounds__(NT) dec_fwd_kernel(const FwdArgs a) {
  extern __shared__ float smem[];
  const int H = a.H, E = a.E, C = a.C, K0 = E + C, n = a.n, R = a.R, L = a.L, B = a.B,
            V = a.V, G = 4 * H;
  float* xin = smem;                          // [R][K0]
  float* hbuf = xin + R * K0;                 // [2][n][R][H]
  float* cbuf = hbuf + 2 * n * R * H;         // [n][R][H]
  float* ce = cbuf + n * R * H;               // [R]
  int* tok = reinterpret_cast<int*>(ce + R);  // [R]
  const int row0 = blockIdx.x * R;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* emb = static_cast<const T*>(a.emb);
  const T* wcat = static_cast<const T*>(a.wcat);
  const T* wout = static_cast<const T*>(a.wout);
  T* hs = static_cast<T*>(a.hs);
  T* cs = static_cast<T*>(a.cs);
  T* gs = static_cast<T*>(a.gs);

  for (int idx = threadIdx.x; idx < R * H; idx += NT) {
    const int g = row0 + idx / H;
    const float v = g < B ? a.h_init[(size_t)g * H + idx % H] : 0.0f;
    for (int l = 0; l < n; ++l) {
      hbuf[(size_t)l * R * H + idx] = v;
      cbuf[(size_t)l * R * H + idx] = 0.0f;
    }
  }
  for (int r = threadIdx.x; r < R; r += NT) {
    tok[r] = a.start_token;
    ce[r] = 0.0f;
  }
  __syncthreads();

  int p = 0;  // hbuf[p] holds the previous step's h
  for (int t = 0; t < L; ++t) {
    for (int idx = threadIdx.x; idx < R * K0; idx += NT) {
      const int r = idx / K0, k = idx % K0, g = row0 + r;
      float v = 0.0f;
      if (g < B) {
        if (k < E) {
          const int tk = tok[r];
          if (tk >= 0 && tk < V) v = train::ld(emb + (size_t)tk * E + k);
        } else {
          v = a.cond[(size_t)g * C + (k - E)];
        }
      }
      xin[idx] = v;
    }
    for (int r = threadIdx.x; r < R; r += NT)
      if (row0 + r < B) a.toks[(size_t)t * B + row0 + r] = tok[r];
    __syncthreads();

    size_t woff = 0;
    for (int l = 0; l < n; ++l) {
      const int Kin = l == 0 ? K0 : H;
      const float* xs = l == 0 ? xin : hbuf + ((size_t)(p ^ 1) * n + (l - 1)) * R * H;
      const size_t slab = ((size_t)t * n + l) * B;
      train::cell_fwd<T, RPT>(wcat + woff, a.bias + (size_t)l * G, Kin, H, xs,
                              hbuf + ((size_t)p * n + l) * R * H,
                              hbuf + ((size_t)(p ^ 1) * n + l) * R * H, cbuf + (size_t)l * R * H,
                              a.TJ, a.TR, row0, B, hs + slab * H, cs + slab * H, gs + slab * G);
      woff += (size_t)(Kin + H) * G;
      __syncthreads();
    }

    // ---- vocab projection, CE or logits, next token: one warp per row ----
    const float* htop = hbuf + ((size_t)(p ^ 1) * n + (n - 1)) * R * H;
    for (int r = warp; r < R; r += NW) {
      const int g = row0 + r;
      const int gc = g < B ? g : B - 1;  // rows past B compute, never store
      const int target = a.targets[(size_t)gc * L + t];
      float s[VPL];
#pragma unroll
      for (int u = 0; u < VPL; ++u) {
        const int v = lane + 32 * u;
        s[u] = -INFINITY;
        if (v < V) {
          float acc = 0.0f;
          for (int k = 0; k < H; ++k)
            acc = fmaf(train::rnd<T>(htop[r * H + k]), train::ld(wout + (size_t)k * V + v), acc);
          s[u] = acc + a.bout[v];
          if (!a.with_ce && g < B) a.out[((size_t)g * L + t) * V + v] = s[u];
        }
      }
      float best = -INFINITY;
      int besti = 0x7fffffff;
#pragma unroll
      for (int u = 0; u < VPL; ++u)
        if (lane + 32 * u < V && s[u] > best) { best = s[u]; besti = lane + 32 * u; }
      for (int o = 16; o > 0; o >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, o);
        const int oi = __shfl_xor_sync(0xffffffffu, besti, o);
        if (ob > best || (ob == best && oi < besti)) { best = ob; besti = oi; }
      }
      if (a.with_ce) {
        // best is the row max after the butterfly
        float e = 0.0f, tl = 0.0f;
#pragma unroll
        for (int u = 0; u < VPL; ++u) {
          const int v = lane + 32 * u;
          if (v < V) {
            e += expf(s[u] - best);
            if (v == target) tl = s[u];
          }
        }
        e = train::warp_sum(e);
        tl = train::warp_sum(tl);
        if (lane == 0) ce[r] += (best + logf(e)) - tl;
      }
      if (lane == 0) tok[r] = a.tf[t] ? target : besti;
    }
    __syncthreads();
    p ^= 1;
  }
  if (a.with_ce)
    for (int r = threadIdx.x; r < R; r += NT)
      if (row0 + r < B) a.out[row0 + r] = ce[r];
}

struct BwdArgs {
  const float* din;      // with_ce: dce [B]; else dlogits [B, L, V]
  const int* targets;    // [B, L]
  const void* hs;        // [L, n, B, H] T
  const void* cs;
  const void* gs;        // [L, n, B, 4H] T
  const void* wT;        // per layer [4H, (K_l + H)] T, back to back
  const void* wout;      // [H, V] T
  const void* woutT;     // [V, H] T
  const float* bout;     // [V]
  void* dgates;          // [L, n, B, 4H] T
  void* dx0;             // [L, B, E] T
  float* dlog;           // [L, B, V]
  float* dh_init;        // [B, H]
  float* dcond;          // [B, C]
  int B, L, V, E, C, H, n, with_ce;
};

template <typename T, int R, int VPL>
__global__ void __launch_bounds__(NT) dec_bwd_kernel(const BwdArgs a) {
  extern __shared__ float smem[];
  const int H = a.H, E = a.E, C = a.C, n = a.n, L = a.L, B = a.B, V = a.V, G = 4 * H;
  const int K0 = E + C;
  float* dh = smem;            // [n][R][H]
  float* dc = dh + n * R * H;  // [n][R][H]
  float* fa = dc + n * R * H;  // [R][H] cotangent from above
  float* dg = fa + R * H;      // [R][4H]
  float* dl = dg + R * G;      // [R][V] this step's dlogits
  float* dcs = dl + R * V;     // [R][C] d(cond) sums
  const int row0 = blockIdx.x * R;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* hs = static_cast<const T*>(a.hs);
  const T* cs = static_cast<const T*>(a.cs);
  const T* gs = static_cast<const T*>(a.gs);
  const T* wT = static_cast<const T*>(a.wT);
  const T* wout = static_cast<const T*>(a.wout);
  const T* woutT = static_cast<const T*>(a.woutT);
  T* dgates = static_cast<T*>(a.dgates);
  T* dx0 = static_cast<T*>(a.dx0);

  for (int idx = threadIdx.x; idx < n * R * H; idx += NT) {
    dh[idx] = 0.0f;
    dc[idx] = 0.0f;
  }
  for (int idx = threadIdx.x; idx < R * C; idx += NT) dcs[idx] = 0.0f;
  __syncthreads();
  size_t wend = 0;
  for (int l = 0; l < n; ++l) wend += (size_t)((l == 0 ? K0 : H) + H) * G;

  for (int t = L - 1; t >= 0; --t) {
    // ---- dlogits: one warp per row ----
    const T* htop = hs + ((size_t)t * n + (n - 1)) * B * H;
    for (int r = warp; r < R; r += NW) {
      const int g = row0 + r;
      float d[VPL];
      if (a.with_ce) {
        float s[VPL];
        float mx = -INFINITY;
#pragma unroll
        for (int u = 0; u < VPL; ++u) {
          const int v = lane + 32 * u;
          s[u] = -INFINITY;
          if (v < V && g < B) {
            float acc = 0.0f;
            for (int k = 0; k < H; ++k)
              acc = fmaf(train::ld(htop + (size_t)g * H + k), train::ld(wout + (size_t)k * V + v),
                         acc);
            s[u] = acc + a.bout[v];
            mx = fmaxf(mx, s[u]);
          }
        }
        mx = train::warp_max(mx);
        float e[VPL], tot = 0.0f;
#pragma unroll
        for (int u = 0; u < VPL; ++u) {
          e[u] = (lane + 32 * u < V && g < B) ? expf(s[u] - mx) : 0.0f;
          tot += e[u];
        }
        tot = train::warp_sum(tot);
        const int target = g < B ? a.targets[(size_t)g * L + t] : -1;
        const float dce = g < B ? a.din[g] : 0.0f;
#pragma unroll
        for (int u = 0; u < VPL; ++u) {
          const int v = lane + 32 * u;
          d[u] = g < B ? (e[u] / tot - (v == target ? 1.0f : 0.0f)) * dce : 0.0f;
        }
      } else {
#pragma unroll
        for (int u = 0; u < VPL; ++u) {
          const int v = lane + 32 * u;
          d[u] = (v < V && g < B) ? a.din[((size_t)g * L + t) * V + v] : 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < VPL; ++u) {
        const int v = lane + 32 * u;
        if (v < V) {
          dl[r * V + v] = d[u];
          if (g < B) a.dlog[((size_t)t * B + g) * V + v] = d[u];
        }
      }
    }
    __syncthreads();
    // ---- cotangent of the top h from the vocab projection ----
    for (int j = threadIdx.x; j < H; j += NT) {
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.0f;
      for (int v = 0; v < V; ++v) {
        const float w = train::ld(woutT + (size_t)v * H + j);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(train::rnd<T>(dl[r * V + v]), w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) fa[r * H + j] = acc[r];
    }
    __syncthreads();

    // ---- the LSTM stack, top layer down ----
    size_t woff = wend;
    for (int l = n - 1; l >= 0; --l) {
      const int Kx = l == 0 ? K0 : H, K = Kx + H;
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
          if (k < E) {
            if (g < B) train::st(dxt + (size_t)g * E + k, v);
          } else if (k < K0) {
            dcs[r * C + (k - E)] += v;
          } else {
            dhl[r * H + (k - K0)] = v;
          }
        });
      }
      __syncthreads();
    }
  }
  // every layer's h at t = 0 is the shared h_init
  for (int idx = threadIdx.x; idx < R * H; idx += NT) {
    const int g = row0 + idx / H;
    if (g >= B) continue;
    float s = 0.0f;
    for (int l = 0; l < n; ++l) s += dh[(size_t)l * R * H + idx];
    a.dh_init[(size_t)g * H + idx % H] = s;
  }
  for (int idx = threadIdx.x; idx < R * C; idx += NT) {
    const int g = row0 + idx / C;
    if (g < B) a.dcond[(size_t)g * C + idx % C] = dcs[idx];
  }
}

template <typename T, int RPT, int VPL>
cudaError_t launch_fwd(const FwdArgs& a, cudaStream_t st) {
  const size_t smem = sizeof(float) * ((size_t)a.R * (a.E + a.C) +
                                       (size_t)3 * a.n * a.R * a.H + 2 * (size_t)a.R);
  cudaError_t e = cudaFuncSetAttribute(dec_fwd_kernel<T, RPT, VPL>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dec_fwd_kernel<T, RPT, VPL><<<(a.B + a.R - 1) / a.R, NT, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T, int VPL>
cudaError_t launch_fwd_rpt(const FwdArgs& a, cudaStream_t st) {
  switch (a.R / a.TR) {
    case 1: return launch_fwd<T, 1, VPL>(a, st);
    case 2: return launch_fwd<T, 2, VPL>(a, st);
    case 4: return launch_fwd<T, 4, VPL>(a, st);
    case 8: return launch_fwd<T, 8, VPL>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

// Two vocab widths keep the number of instantiations (and the build) small.
template <typename T>
cudaError_t launch_fwd_vpl(const FwdArgs& a, cudaStream_t st) {
  return a.V <= 128 ? launch_fwd_rpt<T, 4>(a, st) : launch_fwd_rpt<T, 16>(a, st);
}

template <typename T, int R, int VPL>
cudaError_t launch_bwd_kernel(const BwdArgs& a, cudaStream_t st) {
  const size_t smem = sizeof(float) * ((size_t)2 * a.n * R * a.H + (size_t)R * a.H +
                                       (size_t)R * 4 * a.H + (size_t)R * a.V + (size_t)R * a.C);
  cudaError_t e = cudaFuncSetAttribute(dec_bwd_kernel<T, R, VPL>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dec_bwd_kernel<T, R, VPL><<<(a.B + R - 1) / R, NT, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T, int VPL>
cudaError_t launch_bwd_r(const BwdArgs& a, int R, cudaStream_t st) {
  switch (R) {
    case 1: return launch_bwd_kernel<T, 1, VPL>(a, st);
    case 2: return launch_bwd_kernel<T, 2, VPL>(a, st);
    case 4: return launch_bwd_kernel<T, 4, VPL>(a, st);
    case 8: return launch_bwd_kernel<T, 8, VPL>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

struct GradOut {
  const int* toks;      // [L, B] fed tokens
  const void* emb;      // [V, E] T
  const void* h_init;   // [B, H] T (rounded as the TPU rounds it)
  const void* cond;     // [B, C] T
  float* dW;            // per layer [(K_l + H), 4H], back to back
  float* db;            // [n, 4H]
  float* dwout;         // [H, V]
  float* dbout;         // [V]
  float* demb;          // [V, E]
  float* scratch;
  long scratch_elems;
};

template <typename T>
cudaError_t launch_bwd(const BwdArgs& a, int R, const GradOut& o, cudaStream_t st) {
  cudaError_t e = a.V <= 128 ? launch_bwd_r<T, 4>(a, R, st) : launch_bwd_r<T, 16>(a, R, st);
  if (e != cudaSuccess) return e;
  const int B = a.B, L = a.L, H = a.H, E = a.E, C = a.C, n = a.n, V = a.V, G = 4 * H,
            M = B * L;
  const T* hs = static_cast<const T*>(a.hs);
  const T* dgates = static_cast<const T*>(a.dgates);
  size_t woff = 0;
  for (int l = 0; l < n; ++l) {
    const int Kx = l == 0 ? E + C : H;
    train::WgradArgs g = {};
    g.d = dgates + (size_t)l * B * G;
    g.d_st = (long)n * B * G;
    g.d_sb = G;
    g.N = G;
    g.B = B;
    g.M = M;
    if (l == 0) {
      // input rows: the embedded fed token, then the conditions
      train::WgradArgs ge = g;
      ge.K = E;
      ge.a = o.emb;
      ge.a_mode = train::A_GATHER;
      ge.tok = o.toks;
      ge.tok_st = B;
      ge.tok_sb = 1;
      ge.V = V;
      e = train::wgrad<T, T>(ge, o.dW + woff, nullptr, o.scratch, o.scratch_elems, st);
      if (e != cudaSuccess) return e;
      train::WgradArgs gc = g;
      gc.K = C;
      gc.a = o.cond;
      gc.a_mode = train::A_DENSE;
      gc.a_st = 0;
      gc.a_sb = C;
      e = train::wgrad<T, T>(gc, o.dW + woff + (size_t)E * G, nullptr, o.scratch,
                             o.scratch_elems, st);
    } else {
      train::WgradArgs gx = g;
      gx.K = H;
      gx.a = hs + (size_t)(l - 1) * B * H;
      gx.a_mode = train::A_DENSE;
      gx.a_st = (long)n * B * H;
      gx.a_sb = H;
      e = train::wgrad<T, T>(gx, o.dW + woff, nullptr, o.scratch, o.scratch_elems, st);
    }
    if (e != cudaSuccess) return e;
    // recurrent rows: this layer's h at the previous step, h_init at t = 0
    train::WgradArgs gh = g;
    gh.K = H;
    gh.a = hs + (size_t)l * B * H;
    gh.a_mode = train::A_SHIFT;
    gh.a_st = (long)n * B * H;
    gh.a_sb = H;
    gh.a0 = o.h_init;
    e = train::wgrad<T, T>(gh, o.dW + woff + (size_t)Kx * G, o.db + (size_t)l * G, o.scratch,
                           o.scratch_elems, st);
    if (e != cudaSuccess) return e;
    woff += (size_t)(Kx + H) * G;
  }
  // fc_out: the top layer's h against f32 dlogits (rounded for the product)
  train::WgradArgs go = {};
  go.a = hs + (size_t)(n - 1) * B * H;
  go.a_mode = train::A_DENSE;
  go.a_st = (long)n * B * H;
  go.a_sb = H;
  go.d = a.dlog;
  go.d_st = (long)B * V;
  go.d_sb = V;
  go.K = H;
  go.N = V;
  go.B = B;
  go.M = M;
  e = train::wgrad<T, float>(go, o.dwout, o.dbout, o.scratch, o.scratch_elems, st);
  if (e != cudaSuccess) return e;
  return train::demb<T>(static_cast<const T*>(a.dx0), o.toks, B, 1, B, M, V, E, o.demb,
                        o.scratch, o.scratch_elems, st);
}

}  // namespace

extern "C" {

// Each returns a cudaError_t as int: 0 when every launch was accepted.
int dec_fwd_launch(const void* targets, const void* tf, const void* cond, const void* h_init,
                   const void* emb, const void* wcat, const void* bias, const void* wout,
                   const void* bout, void* out, void* toks, void* hs, void* cs, void* gs, int B,
                   int L, int V, int E, int C, int H, int n, int bf16, int R, int TJ, int TR,
                   int with_ce, int start_token, void* stream) {
  FwdArgs a;
  a.targets = static_cast<const int*>(targets);
  a.tf = static_cast<const int*>(tf);
  a.cond = static_cast<const float*>(cond);
  a.h_init = static_cast<const float*>(h_init);
  a.emb = emb;
  a.wcat = wcat;
  a.bias = static_cast<const float*>(bias);
  a.wout = wout;
  a.bout = static_cast<const float*>(bout);
  a.out = static_cast<float*>(out);
  a.toks = static_cast<int*>(toks);
  a.hs = hs;
  a.cs = cs;
  a.gs = gs;
  a.B = B; a.L = L; a.V = V; a.E = E; a.C = C; a.H = H; a.n = n;
  a.R = R; a.TJ = TJ; a.TR = TR; a.with_ce = with_ce; a.start_token = start_token;
  if (B < 1 || L < 1 || V < 1 || V > 512 || TR < 1 || R % TR != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? launch_fwd_vpl<__nv_bfloat16>(a, s) : launch_fwd_vpl<float>(a, s));
}

int dec_bwd_launch(const void* din, const void* targets, const void* toks, const void* hs,
                   const void* cs, const void* gs, const void* emb, const void* wT,
                   const void* wout, const void* woutT, const void* bout, const void* h_init,
                   const void* cond, void* dgates, void* dx0, void* dlog, void* dh_init,
                   void* dcond, void* dW, void* db, void* dwout, void* dbout, void* demb,
                   void* scratch, long scratch_elems, int B, int L, int V, int E, int C, int H,
                   int n, int bf16, int R, int with_ce, void* stream) {
  BwdArgs a;
  a.din = static_cast<const float*>(din);
  a.targets = static_cast<const int*>(targets);
  a.hs = hs;
  a.cs = cs;
  a.gs = gs;
  a.wT = wT;
  a.wout = wout;
  a.woutT = woutT;
  a.bout = static_cast<const float*>(bout);
  a.dgates = dgates;
  a.dx0 = dx0;
  a.dlog = static_cast<float*>(dlog);
  a.dh_init = static_cast<float*>(dh_init);
  a.dcond = static_cast<float*>(dcond);
  a.B = B; a.L = L; a.V = V; a.E = E; a.C = C; a.H = H; a.n = n; a.with_ce = with_ce;
  GradOut o;
  o.toks = static_cast<const int*>(toks);
  o.emb = emb;
  o.h_init = h_init;
  o.cond = cond;
  o.dW = static_cast<float*>(dW);
  o.db = static_cast<float*>(db);
  o.dwout = static_cast<float*>(dwout);
  o.dbout = static_cast<float*>(dbout);
  o.demb = static_cast<float*>(demb);
  o.scratch = static_cast<float*>(scratch);
  o.scratch_elems = scratch_elems;
  if (B < 1 || L < 1 || V < 1 || V > 512) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? launch_bwd<__nv_bfloat16>(a, R, o, s) : launch_bwd<float>(a, R, o, s));
}

const char* dec_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
