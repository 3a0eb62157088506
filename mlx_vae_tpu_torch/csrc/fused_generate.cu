// Fused autoregressive sampler for the AR-CVAE decoder, for Hopper (sm_90a).
//
// Replaces the TPU kernel mlx_vae_tpu/ops/pallas_decoder.py:_kernel (reached
// through pallas_generate). One launch runs the whole sampling loop of L
// steps: token embedding (a row read), the n stacked LSTM cells, the vocab
// projection, temperature scaling, optional top-k / nucleus truncation by
// bisection, Gumbel-max sampling and EOS -> pad masking. The plain PyTorch
// version of the same function is fused_generate_reference in
// mlx_vae_tpu_torch/ops/fused_decoder.py; that module also builds this file
// with nvcc and binds it through ctypes (plain C interface below).
//
// Design (simple and right first; no wgmma or TMA yet):
//  * One thread block (NT = 256 threads) owns a tile of R rows for the whole
//    time loop: rows are independent and time is sequential. This replaces
//    the TPU's grid, which is sequential in time.
//  * Shared memory holds the step's input rows xin [R][E+C], the hidden
//    state of every layer double-buffered h [2][n][R][H], and the cell state
//    c [n][R][H]. The host sizes R so that this fits (see
//    fused_decoder.py:_smem_bytes).
//  * Threads are laid out as TR row groups x TJ hidden units. A thread owns
//    unit j (and j + TJ, ... when H > TJ) for RPT rows, and computes all four
//    gate dots of its (row, j) pairs, so each weight it loads from global
//    memory serves RPT rows. c of a (row, j) pair is only ever touched by its
//    owner thread.
//  * Matmul inputs are rounded to the compute dtype (float or bf16) and
//    products are accumulated in float32; h and c stay float32 between steps.
//  * One warp per row does the vocab projection (lanes over v), the argmax
//    (ties to the lowest index, as torch.argmax and jnp.argmax) and the
//    40-iteration bisection. Vocab lanes >= V are flagged invalid: they
//    never win the argmax and never count toward k or the nucleus mass.
//  * Random numbers: r24 = hash(block_seed, row_in_block, t, v) >> 8, a
//    counter-based 32-bit multiply-xorshift hash (lowbias32) implemented
//    identically in torch integer ops. A seed block's tokens therefore
//    depend only on its own seed and temperature, wherever it sits in the
//    batch (the serving layer's contract).
//
//  * Optionally (logits0 != null) the first step's scaled logits, before
//    truncation and noise, are written out so that a test can hold them
//    against the plain version as numbers, not only as tokens.
//
// What bounds it: at the default model (H=256, E=128, C=1, V=80, n=2) one
// row-step is ~1.9 MFLOP of FMA on CUDA cores, and each block re-reads all
// weights (3.7 MB in f32) from L2 every step, shared by its R rows. The tile
// sweep on an H100 (chip_smoke.py --sweep, PERF.md) found a block's time per
// step barely growing from 1 to 8 rows per thread, so the host takes 8 (R = 8
// at H=256). The hypothesis, not yet checked with a profiler, is that each
// block's serial weight stream is latency-bound, rather than FMA throughput
// or aggregate L2 bandwidth. A small batch gives few blocks (B=256: 32
// blocks), leaving most of the 132 SMs idle. Tensor cores (wgmma), more loads
// in flight per block, and weights kept resident across steps are work for
// later.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int NT = 256;       // threads per block
constexpr int NW = NT / 32;   // warps per block
constexpr int MAX_VPL = 16;   // vocab entries per lane: V <= 512
constexpr int BISECT_ITERS = 40;
constexpr float TRUNC_NEG = -1e30f;
constexpr float BIG = 3.4e38f;

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

__device__ __forceinline__ uint32_t lowbias32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Per-row bisection for the cutoff of a monotone predicate
// pred(t) := sum(w[s > t]) < thresh, over the entries flagged in `kept`.
template <int VPL>
__device__ float bisect_lo(const float (&s)[VPL], const float (&w)[VPL],
                           const bool (&kept)[VPL], float thresh) {
  float hi = -BIG, lo = BIG;
#pragma unroll
  for (int u = 0; u < VPL; ++u) {
    if (kept[u]) { hi = fmaxf(hi, s[u]); lo = fminf(lo, s[u]); }
  }
  hi = warp_max(hi);
  lo = warp_min(lo) - 1.0f;
  for (int it = 0; it < BISECT_ITERS; ++it) {
    float mid = 0.5f * (lo + hi);
    float m = 0.0f;
#pragma unroll
    for (int u = 0; u < VPL; ++u) m += (kept[u] && s[u] > mid) ? w[u] : 0.0f;
    m = warp_sum(m);
    bool ok = m < thresh;
    lo = ok ? lo : mid;
    hi = ok ? mid : hi;
  }
  return lo;
}

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
      if (!a.greedy) {
        const bool do_k = a.top_k > 0 && a.top_k < V;
        const bool do_p = a.top_p < 1.0f;
        if (do_k) {
          float ones[VPL];
#pragma unroll
          for (int u = 0; u < VPL; ++u) ones[u] = valid[u] ? 1.0f : 0.0f;
          float lo = bisect_lo<VPL>(s, ones, valid, (float)a.top_k);
#pragma unroll
          for (int u = 0; u < VPL; ++u)
            if (valid[u]) s[u] = s[u] > lo ? s[u] : TRUNC_NEG;
        }
        if (do_p) {
          bool kept[VPL];
          float mx = -BIG;
#pragma unroll
          for (int u = 0; u < VPL; ++u) {
            kept[u] = valid[u] && s[u] > 0.5f * TRUNC_NEG;
            if (kept[u]) mx = fmaxf(mx, s[u]);
          }
          mx = warp_max(mx);
          float e[VPL], tot = 0.0f;
#pragma unroll
          for (int u = 0; u < VPL; ++u) {
            e[u] = kept[u] ? expf(s[u] - mx) : 0.0f;
            tot += e[u];
          }
          tot = warp_sum(tot);
#pragma unroll
          for (int u = 0; u < VPL; ++u) e[u] = e[u] / tot;
          float lo = bisect_lo<VPL>(s, e, kept, a.top_p);
#pragma unroll
          for (int u = 0; u < VPL; ++u)
            if (valid[u]) s[u] = (kept[u] && s[u] > lo) ? s[u] : TRUNC_NEG;
        }
        const uint32_t key =
            lowbias32(lowbias32(lowbias32((uint32_t)a.seeds[blk]) ^ (uint32_t)rib) ^ (uint32_t)t);
#pragma unroll
        for (int u = 0; u < VPL; ++u) {
          if (valid[u]) {
            const uint32_t bits = lowbias32(lowbias32(key ^ (uint32_t)(lane + 32 * u)));
            const float un = (float)(bits >> 8) * (1.0f / 16777216.0f) + 1e-12f;
            s[u] = s[u] + (-logf(-logf(un)));
          }
        }
      }
      // argmax, ties to the lowest index
      float best = -INFINITY;
      int besti = 0x7fffffff;
#pragma unroll
      for (int u = 0; u < VPL; ++u)
        if (valid[u] && s[u] > best) { best = s[u]; besti = lane + 32 * u; }
      for (int o = 16; o > 0; o >>= 1) {
        float ob = __shfl_xor_sync(0xffffffffu, best, o);
        int oi = __shfl_xor_sync(0xffffffffu, besti, o);
        if (ob > best || (ob == best && oi < besti)) { best = ob; besti = oi; }
      }
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

const char* fused_generate_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
