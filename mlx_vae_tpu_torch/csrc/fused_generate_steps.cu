// Step-major fused sampler for the AR-CVAE decoder, for Hopper (sm_90a):
// the route of every config the tensor-core cluster kernel
// (fused_generate.cu: tc::gen_tc_kernel) does not take, the hidden-1024 /
// 4-layer model among them.
//
// Replaces the TPU kernel mlx_vae_tpu/ops/pallas_decoder.py:_kernel (reached
// through pallas_generate) for those configs, with the same function as
// fused_generate.cu: per step, the fed token's embedding row and the
// conditions, the n stacked LSTM cells, the vocab projection, temperature
// scaling, optional top-k / nucleus truncation by bisection, Gumbel-max
// sampling and EOS -> pad masking. The plain PyTorch version is
// fused_generate_reference in mlx_vae_tpu_torch/ops/fused_decoder.py
// (fused_generate_steps_reference is this frame's twin launch by launch);
// that module also builds this file with nvcc and binds it through ctypes
// (plain C interface below).
//
// Design: the frame of the training decoder's forward
// (fused_train_decoder.cu:launch_fwd), without its residuals.
//  * One call is 1 + n * L + L launches on one stream, the kernel boundary
//    being the grid-wide barrier the recurrence needs: gen_init_kernel
//    (the start tokens and the ended flags), then for t = 0 .. L-1 one
//    launch of train_common.cuh's forward step per layer (gen_step_kernel,
//    its bf16 seq_fwd_step on wgmma, or seq_fwd_tf32_kernel as split-TF32 in
//    f32: a card-wide GEMM [x, cond, h_{t-1}] W' with the cell in its
//    epilogue; layer 0 gathers the fed token's embedding row and reads the
//    f32 conditions as a third operand segment; h_{-1} = h0 for every layer
//    and c_{-1} = 0), then one sampling head (gen_head_kernel in bf16,
//    gen_head_tf32_kernel in f32).
//  * Every product sums its 64-deep (bf16) or 32-deep (split-TF32) stages in
//    f32 registers, each stage formed afresh on the tensor cores, as the
//    tensor-core cluster kernel does: the tensor cores' accumulator rounds
//    otherwise than IEEE f32, and a bf16 h that rounds the other way changes
//    the rest of a truncated row. The train forward's bf16 step
//    (seq_fwd_step_kernel) accumulates whole products on the tensor cores,
//    two blocks an SM; with it, truncated bf16 rows at H=768 agreed with the
//    plain version on 87.1% (PERF.md). gen_step_kernel is the same
//    step with the stage sums in registers (64 more), one block an SM.
//  * State: h of every layer in a two-slot buffer [2, n, B, H] in the
//    compute dtype (step t writes slot t % 2, reads slot (t - 1) % 2), c in
//    f32 [n, B, H] (read and written in place by its one owner). The step
//    kernels are told not to store c or the gates: at B = 8192 the scaled
//    model's gate residuals [L, n, B, 4H] alone would be 17.2 GB in bf16.
//  * The sampling head: one block owns 128 rows and loops over the vocab's
//    128-wide column tiles; each tile's logits h_top W_out come from the
//    tensor cores (bf16 wgmma on the operands dec_head_kernel stages; f32
//    as split-TF32 on train_common.cuh:abt_tile_tf32), and the epilogue adds
//    the bias and divides by the row's block temperature into an f32 [B, V]
//    buffer (and, at t = 0, logits_out). The row block's whole vocabulary
//    does not fit shared memory at V = 512 (128 x 512 x 4 B = 256 KB), so it
//    goes through that buffer, written and read back by the same block
//    (L2-resident: 2.6 MB at B = 8192, V = 80). Then one warp a row runs
//    sampling.cuh:sample_row, the arithmetic of both fused_generate.cu
//    kernels (truncation, Gumbel noise from the row's hash key, argmax with
//    ties to the lowest index), applies the ended flag and pad, and writes
//    the token into out [B, L], which the next step's layer 0 reads.
//  * A row's tokens depend only on its own h0, conditions, block seed and
//    temperature: every product tile sums the same wgmma instructions over
//    the same K order whatever B, and the sampling reads only its row. One
//    writer per element and no atomics, so two runs are bitwise equal.
// What bounds it: at the hidden-1024 / 4-layer model (E=128, C=1, V=80) a
// row-step is 29.97 M multiply-adds; B=8192, L=64 is 3.14e13 FLOP: 31.8 ms
// at the tensor cores' bf16 rate, 190 ms as split-TF32 (3 TF32 products at
// 495 TFLOP/s). Each step launch reads one layer's weights (at most 16.8 MB
// in bf16), which stay in L2 across its row tiles.

#include <stdint.h>
#include <type_traits>

#include "sampling.cuh"
#include "train_common.cuh"

namespace {

constexpr int HEAD_ROWS = wg::BM / train::NW;  // rows a warp samples in a block

struct HeadArgs {
  const void* h;        // [B, H] T: the top layer's h at step t
  const void* woutT;    // [V, H] T
  const float* bout;    // [V]
  const int* seeds;     // [nb] per seed block
  const float* temps;   // [nb]
  float* scaled;        // [B, V] step t's scaled logits (scratch)
  float* logits0;       // [B, V] step 0's scaled logits, or null
  int* out;             // [B, L] tokens; column t is written
  int* ended;           // [B] 0/1
  int B, L, V, H, t, block_rows, greedy, top_k, end_token, pad_token, vec;
  float top_p;
};

// Column tile n0's epilogue on the staged f32 tile of the block's logits:
// (logit + bias) / temperature of the row's block, to the scaled buffer.
__device__ __forceinline__ void head_scale(const HeadArgs& a, const float* tile, int m0,
                                           int n0) {
  for (int idx = threadIdx.x; idx < wg::BM * wg::BN; idx += wg::NTH) {
    const int r = idx / wg::BN, cc = idx % wg::BN, row = m0 + r, v = n0 + cc;
    if (row >= a.B || v >= a.V) continue;
    const float temp = fmaxf(a.temps[row / a.block_rows], 1e-6f);
    const float s = (tile[r * wg::EPI_PITCH + cc] + a.bout[v]) / temp;
    a.scaled[(size_t)row * a.V + v] = s;
    if (a.t == 0 && a.logits0 != nullptr) a.logits0[(size_t)row * a.V + v] = s;
  }
}

// After the last column tile: one warp a row samples from the block's
// scaled rows (written by this block before the barrier that precedes this).
template <int VPL>
__device__ __forceinline__ void head_sample(const HeadArgs& a, int m0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = 0; i < HEAD_ROWS; ++i) {
    const int row = m0 + warp * HEAD_ROWS + i;
    if (row >= a.B) break;
    const int blk = row / a.block_rows, rib = row % a.block_rows;
    float s[VPL];
    bool valid[VPL];
#pragma unroll
    for (int u = 0; u < VPL; ++u) {
      const int v = lane + 32 * u;
      valid[u] = v < a.V;
      s[u] = valid[u] ? a.scaled[(size_t)row * a.V + v] : -samp::BIG;
    }
    const int besti = samp::sample_row<VPL>(s, valid, a.V, a.greedy, a.top_k, a.top_p,
                                            (uint32_t)a.seeds[blk], (uint32_t)rib, a.t);
    if (lane == 0) {
      const int tk = a.ended[row] ? a.pad_token : besti;
      if (tk == a.end_token) a.ended[row] = 1;
      a.out[(size_t)row * a.L + a.t] = tk;
    }
  }
}

// bf16: train_common.cuh's forward step with its stages summed in f32
// registers (see the design note above).
__global__ void __launch_bounds__(wg::NTH, 1) gen_step_kernel(const train::FwdStepArgs a) {
  train::seq_fwd_step<true>(a);
}

template <int VPL>
__global__ void __launch_bounds__(wg::NTH, 1) gen_head_kernel(const HeadArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const int m0 = blockIdx.x * wg::BM, B = a.B, H = a.H, V = a.V;
  const uint32_t ring = (wg::smem_u32(smem_raw) + 1023u) & ~1023u;
  const __nv_bfloat16* h = static_cast<const __nv_bfloat16*>(a.h);
  const __nv_bfloat16* woutT = static_cast<const __nv_bfloat16*>(a.woutT);
  const int c = threadIdx.x & 7, r0 = threadIdx.x >> 3;
  for (int n0 = 0; n0 < V; n0 += wg::BN) {
    float acc[64];
    wg::gemm<false, true>(acc, ring, (H + wg::BK - 1) / wg::BK, [&](uint32_t dst, int kt) {
      const int k = kt * wg::BK + 8 * c;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = r0 + 32 * u;
        const uint32_t off = wg::swz(r, c);
        wg::stage8(dst + off, m0 + r < B ? h + (size_t)(m0 + r) * H : nullptr, k, H, a.vec);
        wg::stage8(dst + wg::TILE + off, n0 + r < V ? woutT + (size_t)(n0 + r) * H : nullptr, k,
                   H, a.vec);
      }
    });
    head_scale(a, wg::stage_tile(acc, smem_raw, ring), m0, n0);
    __syncthreads();  // the next column tile's copies reuse the ring; the rows are written
  }
  head_sample<VPL>(a, m0);
}

template <int VPL>
__global__ void __launch_bounds__(wg::NTH, 1) gen_head_tf32_kernel(const HeadArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const int m0 = blockIdx.x * wg::BM;
  const uint32_t ring = (wg::smem_u32(smem_raw) + 1023u) & ~1023u;
  const float* h = static_cast<const float*>(a.h);
  const float* woutT = static_cast<const float*>(a.woutT);
  for (int n0 = 0; n0 < a.V; n0 += wg::BN) {
    head_scale(a, train::abt_tile_tf32(smem_raw, ring, h, woutT, a.B, a.V, a.H, m0, n0, a.vec),
               m0, n0);
    __syncthreads();  // the next column tile's stages reuse the ring; the rows are written
  }
  head_sample<VPL>(a, m0);
}

__global__ void __launch_bounds__(256) gen_init_kernel(int* start, int* ended, int start_token,
                                                      int B) {
  const int b = blockIdx.x * 256 + threadIdx.x;
  if (b >= B) return;
  start[b] = start_token;
  ended[b] = 0;
}

// The head of type T at vocab lanes VPL, its shared memory allowed.
template <typename T, int VPL>
cudaError_t launch_head_vpl(const HeadArgs& h, cudaStream_t st) {
  constexpr bool BF = sizeof(T) == 2;
  const int smem = BF ? wg::SMEM : wg::TF_SMEM;
  const auto kernel = BF ? gen_head_kernel<VPL> : gen_head_tf32_kernel<VPL>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<train::cdiv(h.B, wg::BM), wg::NTH, smem, st>>>(h);
  return cudaGetLastError();
}

// Two vocab widths, as fused_generate.cu's kernels: V <= 128, else V <= 512.
template <typename T>
cudaError_t launch_head(HeadArgs h, const T* htop, int t, cudaStream_t st) {
  h.h = htop;
  h.t = t;
  h.vec = h.H % (16 / (int)sizeof(T)) == 0 && train::aligned16(htop) &&
          train::aligned16(h.woutT);
  return h.V <= 128 ? launch_head_vpl<T, 4>(h, st) : launch_head_vpl<T, samp::MAX_VPL>(h, st);
}

struct StepsArgs {
  const void* emb;      // [V, E] T
  const float* cond;    // [B, C]
  const float* h0;      // [B, H]
  const void* wt;       // every layer's interleave_weight copy, back to back
  const float* bias;    // [n, 4H]
  const void* woutT;    // [V, H] T
  const float* bout;    // [V]
  const int* seeds;     // [nb]
  const float* temps;   // [nb]
  int* out;             // [B, L]
  float* logits0;       // [B, V] or null
  void* hbuf;           // [2, n, B, H] T
  float* cbuf;          // [n, B, H]
  float* scaled;        // [B, V]
  int* start;           // [B]: the start tokens, step 0's fed tokens
  int* ended;           // [B]
  int B, L, V, E, C, H, n, block_rows, greedy, top_k, start_token, end_token, pad_token;
  float top_p;
};

template <typename T>
cudaError_t launch_steps(const StepsArgs& a, cudaStream_t st) {
  constexpr bool BF = sizeof(T) == 2;
  constexpr int EV = 16 / sizeof(T);  // elements in 16 bytes
  using Step = std::conditional_t<BF, train::FwdStepArgs, train::FwdStepTf32Args>;
  const int B = a.B, L = a.L, H = a.H, n = a.n, E = a.E, C = a.C;
  const size_t BH = (size_t)B * H;
  T* hbuf = static_cast<T*>(a.hbuf);
  gen_init_kernel<<<train::cdiv(B, 256), 256, 0, st>>>(a.start, a.ended, a.start_token, B);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if constexpr (BF)
    e = cudaFuncSetAttribute(gen_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             wg::SMEM);
  else
    e = cudaFuncSetAttribute(train::seq_fwd_tf32_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, wg::TF_SMEM);
  if (e != cudaSuccess) return e;
  Step ls[8];  // each layer's fixed arguments (fused_train_decoder.cu:launch_fwd's)
  train::dec_fwd_layers(ls, n, static_cast<const T*>(a.emb), a.cond, hbuf,
                        static_cast<const T*>(a.wt), a.bias, a.cbuf, B, a.V, E, C, H);
  HeadArgs head = {};
  head.woutT = a.woutT;
  head.bout = a.bout;
  head.seeds = a.seeds;
  head.temps = a.temps;
  head.scaled = a.scaled;
  head.logits0 = a.logits0;
  head.out = a.out;
  head.ended = a.ended;
  head.B = B; head.L = L; head.V = a.V; head.H = H; head.block_rows = a.block_rows;
  head.greedy = a.greedy; head.top_k = a.top_k; head.top_p = a.top_p;
  head.end_token = a.end_token; head.pad_token = a.pad_token;
  const dim3 grid(train::fwd_np(H) / wg::BN, train::cdiv(B, wg::BM));
  for (int t = 0; t < L; ++t) {
    T* cur = hbuf + (size_t)(t % 2) * n * BH;         // slot t % 2: step t's h
    T* prev = hbuf + (size_t)((t + 1) % 2) * n * BH;  // step t - 1's
    for (int l = 0; l < n; ++l) {
      Step& s = ls[l];
      if (l == 0) {  // step 0 feeds the start token, step t the token of t - 1
        s.tok = t == 0 ? a.start : a.out + (t - 1);
        s.tok_sb = t == 0 ? 1 : L;
      } else {
        s.x = cur + (size_t)(l - 1) * BH;
      }
      if (t == 0) {
        s.hprev = a.h0;
        s.vec_h = H % 4 == 0 && train::aligned16(a.h0);
        s.c_in = nullptr;
      } else {
        s.hprev = prev + (size_t)l * BH;
        s.vec_h = H % EV == 0 && train::aligned16(hbuf);
        s.c_in = a.cbuf + l * BH;
      }
      s.hs = cur + (size_t)l * BH;
      if constexpr (BF) {
        s.h_f32 = t == 0;
        gen_step_kernel<<<grid, wg::NTH, wg::SMEM, st>>>(s);
      } else {
        train::seq_fwd_tf32_kernel<<<grid, wg::NTH, wg::TF_SMEM, st>>>(s);
      }
      e = cudaGetLastError();
      if (e != cudaSuccess) return e;
    }
    e = launch_head(head, cur + (size_t)(n - 1) * BH, t, st);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Each returns a cudaError_t as int: 0 when every launch was accepted.
// One sampling call, bf16 (bf16 = 1) or f32: wt, every layer's interleaved
// copy back to back, [fwd_np(H), fwd_kp(K_l, H, C_l)] each (C_0 = C, else 0;
// ops/train_common.py:interleave_weight), woutT [V, H] and the embedding in
// the compute dtype; hbuf [2, n, B, H] in the compute dtype, cbuf [n, B, H]
// and scaled [B, V] f32, start and ended [B] int32 scratch.
int gen_steps_launch(const void* emb, const void* cond, const void* h0, const void* wt,
                     const void* bias, const void* woutT, const void* bout, const void* seeds,
                     const void* temps, void* out, void* logits0, void* hbuf, void* cbuf,
                     void* scaled, void* start, void* ended, int B, int L, int V, int E, int C,
                     int H, int n, int block_rows, int greedy, int top_k, float top_p, int bf16,
                     int start_token, int end_token, int pad_token, void* stream) {
  if (B < 1 || L < 1 || V < 1 || V > 32 * samp::MAX_VPL || n < 1 || n > 8 || H < 1 ||
      block_rows < 1)
    return (int)cudaErrorInvalidValue;
  StepsArgs a = {};
  a.emb = emb;
  a.cond = static_cast<const float*>(cond);
  a.h0 = static_cast<const float*>(h0);
  a.wt = wt;
  a.bias = static_cast<const float*>(bias);
  a.woutT = woutT;
  a.bout = static_cast<const float*>(bout);
  a.seeds = static_cast<const int*>(seeds);
  a.temps = static_cast<const float*>(temps);
  a.out = static_cast<int*>(out);
  a.logits0 = static_cast<float*>(logits0);
  a.hbuf = hbuf;
  a.cbuf = static_cast<float*>(cbuf);
  a.scaled = static_cast<float*>(scaled);
  a.start = static_cast<int*>(start);
  a.ended = static_cast<int*>(ended);
  a.B = B; a.L = L; a.V = V; a.E = E; a.C = C; a.H = H; a.n = n;
  a.block_rows = block_rows;
  a.greedy = greedy; a.top_k = top_k; a.top_p = top_p;
  a.start_token = start_token; a.end_token = end_token; a.pad_token = pad_token;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? launch_steps<__nv_bfloat16>(a, s) : launch_steps<float>(a, s));
}

// One sampling head alone, step t (gen_head_kernel where bf16, else
// gen_head_tf32_kernel): htop [B, H] the top layer's h at t in woutT's
// dtype; out, ended and scaled as a call holds them (a check of the kernel
// against its plain twin).
int gen_head_launch(const void* htop, const void* woutT, const void* bout, const void* seeds,
                    const void* temps, void* out, void* logits0, void* scaled, void* ended,
                    int B, int L, int V, int H, int t, int block_rows, int greedy, int top_k,
                    float top_p, int end_token, int pad_token, int bf16, void* stream) {
  if (B < 1 || L < 1 || V < 1 || V > 32 * samp::MAX_VPL || t < 0 || t >= L || block_rows < 1)
    return (int)cudaErrorInvalidValue;
  HeadArgs h = {};
  h.woutT = woutT;
  h.bout = static_cast<const float*>(bout);
  h.seeds = static_cast<const int*>(seeds);
  h.temps = static_cast<const float*>(temps);
  h.scaled = static_cast<float*>(scaled);
  h.logits0 = static_cast<float*>(logits0);
  h.out = static_cast<int*>(out);
  h.ended = static_cast<int*>(ended);
  h.B = B; h.L = L; h.V = V; h.H = H; h.block_rows = block_rows;
  h.greedy = greedy; h.top_k = top_k; h.top_p = top_p;
  h.end_token = end_token; h.pad_token = pad_token;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? launch_head(h, static_cast<const __nv_bfloat16*>(htop), t, s)
                    : launch_head(h, static_cast<const float*>(htop), t, s));
}

const char* gen_steps_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
