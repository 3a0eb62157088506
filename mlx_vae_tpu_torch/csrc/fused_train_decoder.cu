// Fused teacher-forced training decoder for the AR-CVAE train step, for
// Hopper (sm_90a): forward and backward, each with or without the fused
// cross-entropy.
//
// Replaces the TPU kernels of mlx_vae_tpu/ops/pallas_train_decoder.py:
//   dec_fwd_launch  <- _fwd_kernel (reached through _run_fwd, from
//                      decoder_train_ce_pallas and decoder_train_pallas)
//                      and, with logits out, _fwd_kernel_blk (reached
//                      through decoder_fwd_blk, the forward of
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
// dlogits = (softmax - onehot(target)) * dce (with_ce; a target outside
// [0, V) adds no one-hot), or read dlogits; project it back through fc_out;
// run the n reverse chains down to the input. Out: dW and db of every layer,
// d(fc_out), d(embedding), all f32, d(h_init) [B, H] (the sum over layers at
// t = 0) and d(conditions) [B, C] through the per-step input. The plain
// PyTorch version of both is in mlx_vae_tpu_torch/ops/fused_train_decoder.py,
// which also builds this file with nvcc and binds it through ctypes (plain C
// interface below).
//
// Design:
//  * Forward (the tensor cores; bf16 wgmma, f32 as split-TF32, one frame):
//    step-major, because step t + 1's layer-0 input is step t's argmax. Per
//    call, a set-up kernel writes the start token and zeroes the CE sums;
//    then for t = 0 .. L-1, one launch of train_common.cuh's forward step
//    kernel per layer (seq_fwd_step_kernel in bf16, seq_fwd_tf32_kernel in
//    f32: a card-wide GEMM [x, cond, h_{t-1}] W' with the cell in its
//    epilogue; layer 0 gathers its embedding rows by the fed token and
//    reads the f32 conditions as a third operand segment, layer l > 0 reads
//    the layer below's stored h; h_{-1} is the f32 h_init, each layer's c
//    runs in an f32 [n, B, H] buffer), then one vocab head (dec_head_kernel
//    in bf16, dec_head_tf32_kernel in f32): the vocab projection (a GEMM
//    over K = H, one 128-row tile a block looping over the vocab's 128-wide
//    column tiles), with the CE or the logits, the argmax and the next token
//    in its epilogue. 1 + n * L + L launches a call, the kernel boundary
//    being the grid-wide barrier the recurrence needs; one writer per
//    element and no atomics, so two runs are bitwise equal.
//  * Backward (the tensor cores; bf16 wgmma, f32 as split-TF32, one frame),
//    before the sums: the head's cotangent of step t needs only forward
//    residuals (the stored top h, the targets, dce), so it is formed for all
//    L * B rows m = t * B + b at once, ahead of the recurrence: the head pass
//    (dec_head_bwd_kernel in bf16, dec_head_bwd_tf32_kernel in f32)
//    recomputes the logits from the head's operands, 128 rows a block, and
//    writes dlog = (softmax - onehot) * dce [L, B, V] f32 (for V > 128 a
//    first pass over the column tiles finds each row's max and sum); then
//    dtop = dlog fc_out^T [L, B, H] f32 (dec_dtop_kernel: dlog rounded to
//    bf16, dec_dtop_tf32_kernel: unrounded, JAX's from_above: dlogits in the
//    compute dtype, f32 sums). Then the reverse chain of fused_encoder.cu's
//    frame: train_common.cuh's gate_kernel<T> runs the gate step of (L-1,
//    n-1) from dtop(L-1); for t = L-1 .. 0 and l = n-1 .. 0, one card-wide
//    GEMM dinp = dgates(t, l) W_l^T (dec_step_kernel on train_common.cuh's
//    dinp_tile, dec_step_tf32_kernel on dinp_tile_tf32; wcat read as it
//    lies) over all K_l + H columns, whose epilogue routes each column: the
//    input columns run the gate step of (t, l-1) (l > 0), or are dx0 at t
//    and the conditions' cotangent, added into d(cond) in the reference's t
//    order (l = 0); the top layer's h columns run the gate step of (t-1,
//    n-1) with dtop(t-1) added; the others hand dh[l] to the next launch of
//    layer l, at t = 0 the cotangents of h_init, which reduce_kernel sums
//    over layers (layer 0 first). 2 + 1 + n * L + 1 launches; one writer per
//    element, so two runs are bitwise equal. (A CUDA-core reverse in which
//    a block of R rows walks all L steps reads every layer's transposed
//    weight from L2 at each step to serve its rows: as such the f32 reverse
//    took 69.3 ms of the 133.5 ms default f32 step on an H100 80GB HBM3 at
//    700 W, PERF.md.)
//  * Backward, sums over rows: dW and db of each layer, d(fc_out),
//    d(fc_out bias) and d(embedding) are split reductions over the t*B rows
//    with partials added in a fixed order (train_common.cuh), where the TPU
//    kernel added into one VMEM accumulator across its sequential grid. The
//    dW products run on the tensor cores (bf16 wgmma, f32 split-TF32;
//    fc_out's f32 dlogits are rounded to bf16 for its bf16 product and summed
//    unrounded into d(fc_out bias)).
//
// What bounds it: at the default model (E=128, C=1, H=256, n=2, V=80) and
// B=4096, L=64, bf16, the forward is ~0.51 TFLOP of products against ~0.8
// GB of residual stores, so the operations bound it (0.5 ms at the tensor
// cores' bf16 rate); at hidden 1024 / 4 layers (B=2048) ~7.9 TFLOP. In f32
// the same products as split-TF32 are three TF32 products each, so 3 x the
// operations over 495 TFLOP/s: 3.0 ms default, 47.6 ms scaled. The
// backward is ~1 TFLOP (the chain's products, the recomputed logits,
// from_above and the weight gradients): 1.0 ms in bf16, 6.0 ms as
// split-TF32. A row-tiled CUDA-core
// kernel streams every weight from L2 (or, past 50 MB of weights, from
// device memory) at every step to serve a few rows: on an H100 80GB HBM3
// (700 W) the f32 forward as such a kernel took 1074 ms at the scaled model
// (PERF.md), its 119.5 MB of f32 weights read from device memory by each of
// 512 blocks at each step. Here each launch touches one layer's
// weights, once per 128 rows. The chain's layer-0 launches at the default
// model have N = E + C + H = 385 columns: a fourth 128-wide column tile that
// holds one column.

#include <climits>
#include <type_traits>

#include "train_common.cuh"

namespace {

using train::NW;

struct BwdArgs {
  const float* din;      // with_ce: dce [B]; else dlogits [B, L, V]
  const int* targets;    // [B, L]
  const void* hs;        // [L, n, B, H] T
  const void* cs;
  const void* gs;        // [L, n, B, 4H] T
  const void* wcat;      // per layer [(K_l + H), 4H] T, back to back
  const void* wout;      // [H, V] T
  const void* woutT;     // [V, H] T
  const float* bout;     // [V]
  float* dh;             // [n, B, H] zeros, the h cotangent handed down a step
  float* dc;             // [n, B, H] zeros, each layer's running dc
  float* dtop;           // [L, B, H] the head's cotangent of the top layer's h
  void* dgates;          // [L, n, B, 4H] T
  void* dx0;             // [L, B, E] T
  float* dlog;           // [L, B, V]
  float* dh_init;        // [B, H]
  float* dcond;          // [B, C] zeros on entry, added to
  int B, L, V, E, C, H, n, with_ce;
};

// ------------------------------------------------ forward on the tensor cores

// Step t's vocab head: logits = h_top(t) [B, H] (hs row t * n + n - 1) @
// wout + bout, B operand woutT [V, H] (K-major as it lies; rows >= V read
// zeros): on wgmma in bf16 (dec_head_kernel), as split-TF32 in f32
// (dec_head_tf32_kernel: both operands split while they are staged,
// train_common.cuh:abt_tile_tf32). A block owns 128 rows and loops over the
// vocab's 128-wide column tiles; a warp walks 16 rows of each staged f32
// tile, a lane 4 columns, and keeps each row's running max, sum of
// exponentials, argmax (ties to the lowest index) and target logit in
// shared memory, so that after the last tile it holds the whole vocabulary
// of its rows. The rows' targets are read into shared memory before the
// first product, so that no row of the epilogue waits on device memory.
struct HeadArgs {
  const void* h;       // [B, H] T
  const void* woutT;   // [V, H] T
  const float* bout;   // [V]
  const int* targets;  // [B, L]
  const int* tf;       // [L] 0/1
  float* out;          // with_ce: ce [B], added to; else logits [B, L, V]
  int* toks;           // [L, B]: row t + 1 is written where t + 1 < L
  int B, L, V, H, t, with_ce, vec;
};

constexpr int HEAD_ROWS = wg::BM / NW;              // rows a warp walks in a tile
constexpr int HEAD_STATE = 5 * wg::BM * 4;          // bytes of the per-row state
constexpr int HEAD_SMEM = HEAD_STATE + wg::SMEM;
constexpr int HEAD_TF_SMEM = HEAD_STATE + wg::TF_SMEM;  // 200,192 B: one block an SM

// A head block's per-row state, HEAD_STATE bytes at the start of its shared
// memory: the running max, sum and target logit (0 where none yet), the
// argmax, and the rows' targets.
struct HeadState {
  float* run_max;
  float* run_sum;
  float* run_tl;
  int* run_arg;
  int* target;
};

__device__ __forceinline__ HeadState head_state(unsigned char* smem_raw, const HeadArgs& a,
                                                int m0) {
  HeadState s;
  s.run_max = reinterpret_cast<float*>(smem_raw);  // [BM] each
  s.run_sum = s.run_max + wg::BM;
  s.run_tl = s.run_sum + wg::BM;
  s.run_arg = reinterpret_cast<int*>(s.run_tl + wg::BM);
  s.target = s.run_arg + wg::BM;
  if (threadIdx.x < wg::BM) {  // visible to the epilogue after the product's barriers
    const int row = m0 + threadIdx.x;
    s.target[threadIdx.x] = row < a.B ? a.targets[(size_t)row * a.L + a.t] : -1;
    s.run_tl[threadIdx.x] = 0.0f;
  }
  return s;
}

// Column tile n0's epilogue on the staged f32 tile of the block's logits.
__device__ __forceinline__ void head_epilogue(const HeadArgs& a, const HeadState& s,
                                              const float* tile, int m0, int n0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int B = a.B, V = a.V, L = a.L, t = a.t;
  float bias[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int v = n0 + lane + 32 * q;
    bias[q] = v < V ? a.bout[v] : 0.0f;
  }
  const bool last = n0 + wg::BN >= V, forced = a.tf[t] != 0;
  for (int i = 0; i < HEAD_ROWS; ++i) {
    const int r = warp * HEAD_ROWS + i, row = m0 + r;
    if (row >= B) break;
    float x[4], best = -INFINITY;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int v = n0 + lane + 32 * q;
      x[q] = v < V ? tile[r * wg::EPI_PITCH + lane + 32 * q] + bias[q] : -INFINITY;
      if (!a.with_ce && v < V) a.out[((size_t)row * L + t) * V + v] = x[q];
      best = fmaxf(best, x[q]);
      if (v < V && v == s.target[r]) s.run_tl[r] = x[q];
    }
    best = train::warp_max(best);
    // the lowest column holding the max: the first lane of the first q
    int besti = 0;
#pragma unroll
    for (int q = 3; q >= 0; --q) {
      const unsigned hit = __ballot_sync(0xffffffffu, x[q] == best);
      if (hit) besti = n0 + 32 * q + __ffs(hit) - 1;
    }
    float e = 0.0f;
#pragma unroll
    for (int q = 0; q < 4; ++q) e += x[q] > -INFINITY ? expf(x[q] - best) : 0.0f;
    e = train::warp_sum(e);
    __syncwarp();  // the target's lane wrote run_tl[r]
    if (lane == 0) {
      if (n0 == 0) {
        s.run_max[r] = best; s.run_sum[r] = e; s.run_arg[r] = besti;
      } else {
        const float m = s.run_max[r], nm = fmaxf(m, best);
        s.run_sum[r] = s.run_sum[r] * expf(m - nm) + e * expf(best - nm);
        if (best > m) s.run_arg[r] = besti;
        s.run_max[r] = nm;
      }
      if (last) {
        if (a.with_ce) a.out[row] += (s.run_max[r] + logf(s.run_sum[r])) - s.run_tl[r];
        if (t + 1 < L) a.toks[(size_t)(t + 1) * B + row] = forced ? s.target[r] : s.run_arg[r];
      }
    }
  }
}

__global__ void __launch_bounds__(wg::NTH, wg::BLOCKS_PER_SM) dec_head_kernel(const HeadArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const int m0 = blockIdx.x * wg::BM, B = a.B, H = a.H, V = a.V;
  const HeadState s = head_state(smem_raw, a, m0);
  const uint32_t ring = (wg::smem_u32(smem_raw + HEAD_STATE) + 1023u) & ~1023u;
  const __nv_bfloat16* h = static_cast<const __nv_bfloat16*>(a.h);
  const __nv_bfloat16* woutT = static_cast<const __nv_bfloat16*>(a.woutT);
  const int c = threadIdx.x & 7, r0 = threadIdx.x >> 3;
  for (int n0 = 0; n0 < V; n0 += wg::BN) {
    float acc[64];
    wg::gemm<false>(acc, ring, (H + wg::BK - 1) / wg::BK, [&](uint32_t dst, int kt) {
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
    head_epilogue(a, s, wg::stage_tile(acc, smem_raw, ring), m0, n0);
    __syncthreads();  // the next column tile's copies reuse the ring
  }
}

__global__ void __launch_bounds__(wg::NTH, wg::TF_BLOCKS_PER_SM)
    dec_head_tf32_kernel(const HeadArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const int m0 = blockIdx.x * wg::BM;
  const HeadState s = head_state(smem_raw, a, m0);
  const uint32_t ring = (wg::smem_u32(smem_raw + HEAD_STATE) + 1023u) & ~1023u;
  const float* h = static_cast<const float*>(a.h);
  const float* woutT = static_cast<const float*>(a.woutT);
  for (int n0 = 0; n0 < a.V; n0 += wg::BN) {
    head_epilogue(a, s, train::abt_tile_tf32(smem_raw, ring, h, woutT, a.B, a.V, a.H, m0, n0,
                                             a.vec), m0, n0);
    __syncthreads();  // the next column tile's stages reuse the ring
  }
}

// The set-up of a forward: the start token in row 0 of toks and, with CE,
// zero sums.
__global__ void __launch_bounds__(256) dec_init_kernel(int* toks, int start_token, float* ce,
                                                      int B) {
  const int b = blockIdx.x * 256 + threadIdx.x;
  if (b >= B) return;
  toks[b] = start_token;
  if (ce != nullptr) ce[b] = 0.0f;
}

HeadArgs head_args(const void* woutT, const float* bout, const int* targets, const int* tf,
                   float* out, int* toks, int B, int L, int V, int H, int with_ce) {
  HeadArgs h = {};
  h.woutT = woutT;
  h.bout = bout;
  h.targets = targets;
  h.tf = tf;
  h.out = out;
  h.toks = toks;
  h.B = B; h.L = L; h.V = V; h.H = H; h.with_ce = with_ce;
  return h;
}

// The head kernel of type T (bf16 or f32) with its shared memory allowed.
template <typename T>
cudaError_t head_smem() {
  if constexpr (sizeof(T) == 2)
    return cudaFuncSetAttribute(dec_head_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                HEAD_SMEM);
  else
    return cudaFuncSetAttribute(dec_head_tf32_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, HEAD_TF_SMEM);
}

template <typename T>
cudaError_t launch_head(HeadArgs h, const T* htop, int t, cudaStream_t st) {
  h.h = htop;
  h.t = t;
  h.vec = h.H % (16 / (int)sizeof(T)) == 0 && train::aligned16(htop) &&
          train::aligned16(h.woutT);
  if constexpr (sizeof(T) == 2)
    dec_head_kernel<<<train::cdiv(h.B, wg::BM), wg::NTH, HEAD_SMEM, st>>>(h);
  else
    dec_head_tf32_kernel<<<train::cdiv(h.B, wg::BM), wg::NTH, HEAD_TF_SMEM, st>>>(h);
  return cudaGetLastError();
}

struct FwdArgs {
  const int* targets;  // [B, L]
  const int* tf;       // [L] 0/1
  const float* cond;   // [B, C]
  const float* h_init; // [B, H]
  const void* emb;     // [V, E] T
  const float* bias;   // [n, 4H]
  const float* bout;   // [V]
  float* out;          // with_ce: ce [B]; else logits [B, L, V]
  int* toks;           // [L, B] fed tokens
  void* hs;            // [L, n, B, H] T
  void* cs;
  void* gs;            // [L, n, B, 4H] T
  int B, L, V, E, C, H, n, with_ce, start_token;
};

// n * L step launches and L head launches, step-major (t outer, l inner),
// after one set-up launch; T = bf16 (seq_fwd_step_kernel, dec_head_kernel)
// or float (seq_fwd_tf32_kernel, dec_head_tf32_kernel). wt: every layer's
// interleaved weight back to back (layer 0 with the conditions' segment),
// woutT: the head's [V, H], cbuf: [n, B, H] f32, each layer's running c
// (c_{-1} = 0 is read as a null c_in, so it needs no zeroing). A row is
// read 16 bytes at a time where its width and start allow it, else element
// by element.
template <typename T>
cudaError_t launch_fwd(const FwdArgs& a, const T* wt, const T* woutT, float* cbuf,
                       cudaStream_t st) {
  constexpr bool BF = sizeof(T) == 2;
  constexpr int EV = 16 / sizeof(T);  // elements in 16 bytes
  using Step = std::conditional_t<BF, train::FwdStepArgs, train::FwdStepTf32Args>;
  const int B = a.B, L = a.L, H = a.H, n = a.n, E = a.E, C = a.C;
  const size_t BH = (size_t)B * H;
  T* hs = static_cast<T*>(a.hs);
  T* cs = static_cast<T*>(a.cs);
  T* gs = static_cast<T*>(a.gs);
  dec_init_kernel<<<train::cdiv(B, 256), 256, 0, st>>>(a.toks, a.start_token,
                                                      a.with_ce ? a.out : nullptr, B);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if constexpr (BF)
    e = cudaFuncSetAttribute(train::seq_fwd_step_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, wg::SMEM);
  else
    e = cudaFuncSetAttribute(train::seq_fwd_tf32_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, wg::TF_SMEM);
  if (e != cudaSuccess) return e;
  e = head_smem<T>();
  if (e != cudaSuccess) return e;
  Step ls[8];  // each layer's fixed arguments
  train::dec_fwd_layers(ls, n, static_cast<const T*>(a.emb), a.cond, hs, wt, a.bias, cbuf, B,
                        a.V, E, C, H);
  const HeadArgs head = head_args(woutT, a.bout, a.targets, a.tf, a.out, a.toks, B, L, a.V, H,
                                  a.with_ce);
  const dim3 grid(train::fwd_np(H) / wg::BN, train::cdiv(B, wg::BM));
  for (int t = 0; t < L; ++t) {
    for (int l = 0; l < n; ++l) {
      Step& s = ls[l];
      const size_t slab = (size_t)t * n + l;  // residual row of (t, l)
      if (l == 0) s.tok = a.toks + (size_t)t * B;
      else s.x = hs + (slab - 1) * BH;
      if (t == 0) {
        s.hprev = a.h_init;
        s.vec_h = H % 4 == 0 && train::aligned16(a.h_init);
        s.c_in = nullptr;
      } else {
        s.hprev = hs + (slab - n) * BH;
        s.vec_h = H % EV == 0 && train::aligned16(hs);
        s.c_in = cbuf + l * BH;
      }
      s.hs = hs + slab * BH;
      s.cs = cs + slab * BH;
      s.gs = gs + slab * 4 * BH;
      if constexpr (BF) {
        s.h_f32 = t == 0;
        train::seq_fwd_step_kernel<<<grid, wg::NTH, wg::SMEM, st>>>(s);
      } else {
        train::seq_fwd_tf32_kernel<<<grid, wg::NTH, wg::TF_SMEM, st>>>(s);
      }
      e = cudaGetLastError();
      if (e != cudaSuccess) return e;
    }
    e = launch_head(head, hs + ((size_t)t * n + n - 1) * BH, t, st);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// ------------------------------------------------ backward on the tensor cores

// The head's backward for all L * B rows m = t * B + b at once, before the
// chain (its cotangent of step t needs only forward residuals).
//  * with_ce: the logits h_top(t) [B, H] @ wout + bout, B operand woutT [V,
//    H] (K-major as it lies), one 128-row tile a block over the vocab's
//    128-wide column tiles: on wgmma in bf16 (dec_head_bwd_kernel, operands
//    as dec_head_kernel stages them; a block owns rows m of the flat L * B),
//    as split-TF32 in f32 (dec_head_bwd_tf32_kernel on abt_tile_tf32; a
//    block owns rows b of one step t, its grid (row tiles of B) x L, since
//    the top h of row m lies at hs row t * n + n - 1, not densely in m).
//    dlog = (softmax - onehot(target)) * dce [L, B, V] f32, where a target
//    outside [0, V) adds no one-hot (decoder_reverse_reference). A warp
//    walks 16 rows of each staged tile, a lane 4 columns. For V > 128 a
//    first pass over the column tiles keeps each row's running max and sum
//    of exponentials in shared memory and a second one recomputes each tile
//    and writes dlog; at V <= 128 one tile holds the whole row.
//  * else: dlog is the given dlogits [B, L, V], transposed to [L, B, V].
struct HeadBwdArgs {
  const void* hs;       // [L, n, B, H] T: the top layer's h at rows t * n + n - 1
  const void* woutT;    // [V, H] T
  const float* bout;    // [V]
  const int* targets;   // [B, L]
  const float* din;     // with_ce: dce [B]; else dlogits [B, L, V]
  float* dlog;          // [L, B, V]
  int B, L, V, H, n, with_ce, vec;
};

// A head-pass block's per-row state at the start of its shared memory (at
// most HEAD_STATE bytes): the running max and sum, and the rows' dce and
// targets, read before the first product so that no row of the epilogue
// waits on device memory. The block's rows are m0 .. m0 + rows - 1.
struct HeadBwdState {
  float* run_max;
  float* run_sum;
  float* dce;
  int* target;
};

__device__ __forceinline__ HeadBwdState head_bwd_state(unsigned char* smem_raw,
                                                       const HeadBwdArgs& a, size_t m0,
                                                       int rows) {
  HeadBwdState s;
  s.run_max = reinterpret_cast<float*>(smem_raw);  // [BM] each
  s.run_sum = s.run_max + wg::BM;
  s.dce = s.run_sum + wg::BM;
  s.target = reinterpret_cast<int*>(s.dce + wg::BM);
  if (threadIdx.x < wg::BM) {  // visible to the epilogue after the product's barriers
    const size_t m = m0 + threadIdx.x;
    const bool in = (int)threadIdx.x < rows;
    s.target[threadIdx.x] = in ? a.targets[(m % a.B) * a.L + m / a.B] : -1;
    s.dce[threadIdx.x] = in ? a.din[m % a.B] : 0.0f;
  }
  return s;
}

// Without CE: the block's rows of the given dlogits, transposed.
__device__ __forceinline__ void head_bwd_copy(const HeadBwdArgs& a, size_t m0, int rows) {
  const int B = a.B, L = a.L, V = a.V;
  for (int idx = threadIdx.x; idx < wg::BM * V; idx += wg::NTH) {
    const int r = idx / V, v = idx % V;
    const size_t m = m0 + r;
    if (r < rows) a.dlog[m * V + v] = a.din[((m % B) * L + m / B) * V + v];
  }
}

// Column tile n0's epilogue on the staged f32 tile of the block's logits:
// a first pass (of two) updates each row's running max and sum; the final
// pass writes dlog.
__device__ __forceinline__ void head_bwd_epilogue(const HeadBwdArgs& a, const HeadBwdState& s,
                                                  const float* tile, size_t m0, int rows, int n0,
                                                  int passes, bool final_pass) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int V = a.V;
  float bias[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int v = n0 + lane + 32 * q;
    bias[q] = v < V ? a.bout[v] : 0.0f;
  }
  for (int i = 0; i < HEAD_ROWS; ++i) {
    const int r = warp * HEAD_ROWS + i;
    const size_t m = m0 + r;
    if (r >= rows) break;
    float x[4], mx = -INFINITY, sum = 0.0f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int v = n0 + lane + 32 * q;
      x[q] = v < V ? tile[r * wg::EPI_PITCH + lane + 32 * q] + bias[q] : -INFINITY;
      mx = fmaxf(mx, x[q]);
    }
    if (passes == 1 || !final_pass) {  // this tile's max and sum of exponentials
      mx = train::warp_max(mx);
#pragma unroll
      for (int q = 0; q < 4; ++q) sum += x[q] > -INFINITY ? expf(x[q] - mx) : 0.0f;
      sum = train::warp_sum(sum);
    }
    if (!final_pass) {
      if (lane == 0) {
        if (n0 == 0) {
          s.run_max[r] = mx; s.run_sum[r] = sum;
        } else {
          const float m_old = s.run_max[r], nm = fmaxf(m_old, mx);
          s.run_sum[r] = s.run_sum[r] * expf(m_old - nm) + sum * expf(mx - nm);
          s.run_max[r] = nm;
        }
      }
      continue;
    }
    if (passes > 1) {  // the whole row's, from the first pass
      mx = s.run_max[r];
      sum = s.run_sum[r];
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int v = n0 + lane + 32 * q;
      if (v < V)
        a.dlog[m * V + v] = (expf(x[q] - mx) / sum - (v == s.target[r] ? 1.0f : 0.0f)) * s.dce[r];
    }
  }
}

__global__ void __launch_bounds__(wg::NTH, wg::BLOCKS_PER_SM)
    dec_head_bwd_kernel(const HeadBwdArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const int B = a.B, V = a.V, H = a.H, n = a.n;
  const size_t M = (size_t)a.L * B, m0 = (size_t)blockIdx.x * wg::BM;
  const int rows = M - m0 < (size_t)wg::BM ? (int)(M - m0) : wg::BM;
  if (!a.with_ce) {
    head_bwd_copy(a, m0, rows);
    return;
  }
  const HeadBwdState s = head_bwd_state(smem_raw, a, m0, rows);
  const uint32_t ring = (wg::smem_u32(smem_raw + HEAD_STATE) + 1023u) & ~1023u;
  const __nv_bfloat16* hs = static_cast<const __nv_bfloat16*>(a.hs);
  const __nv_bfloat16* woutT = static_cast<const __nv_bfloat16*>(a.woutT);
  const int c = threadIdx.x & 7, r0 = threadIdx.x >> 3;
  const __nv_bfloat16* hr[4];  // the rows this thread stages
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const size_t m = m0 + r0 + 32 * u;
    hr[u] = m < M ? hs + (((m / B) * n + n - 1) * B + m % B) * H : nullptr;
  }
  const int passes = V > wg::BN ? 2 : 1;
  for (int pass = 0; pass < passes; ++pass) {
    for (int n0 = 0; n0 < V; n0 += wg::BN) {
      float acc[64];
      wg::gemm<false>(acc, ring, (H + wg::BK - 1) / wg::BK, [&](uint32_t dst, int kt) {
        const int k = kt * wg::BK + 8 * c;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int r = r0 + 32 * u;
          const uint32_t off = wg::swz(r, c);
          wg::stage8(dst + off, hr[u], k, H, a.vec);
          wg::stage8(dst + wg::TILE + off,
                     n0 + r < V ? woutT + (size_t)(n0 + r) * H : nullptr, k, H, a.vec);
        }
      });
      head_bwd_epilogue(a, s, wg::stage_tile(acc, smem_raw, ring), m0, rows, n0, passes,
                        pass == passes - 1);
      __syncthreads();  // the next column tile's copies reuse the ring
    }
  }
}

__global__ void __launch_bounds__(wg::NTH, wg::TF_BLOCKS_PER_SM)
    dec_head_bwd_tf32_kernel(const HeadBwdArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const int B = a.B, V = a.V, H = a.H, n = a.n, t = blockIdx.y, b0 = blockIdx.x * wg::BM;
  const size_t m0 = (size_t)t * B + b0;
  const int rows = min(wg::BM, B - b0);
  if (!a.with_ce) {
    head_bwd_copy(a, m0, rows);
    return;
  }
  const HeadBwdState s = head_bwd_state(smem_raw, a, m0, rows);
  const uint32_t ring = (wg::smem_u32(smem_raw + HEAD_STATE) + 1023u) & ~1023u;
  const float* htop = static_cast<const float*>(a.hs) + ((size_t)t * n + n - 1) * B * H;
  const float* woutT = static_cast<const float*>(a.woutT);
  const int passes = V > wg::BN ? 2 : 1;
  for (int pass = 0; pass < passes; ++pass) {
    for (int n0 = 0; n0 < V; n0 += wg::BN) {
      head_bwd_epilogue(a, s,
                        train::abt_tile_tf32(smem_raw, ring, htop, woutT, B, V, H, b0, n0, a.vec),
                        m0, rows, n0, passes, pass == passes - 1);
      __syncthreads();  // the next column tile's stages reuse the ring
    }
  }
}

// dtop [M, H] f32 = dlog [M, V] wout^T, M = L * B, B operand wout [H, V]
// (row j is column j of the product: K-major as it lies); one 128 x 128
// tile a block, staged in shared memory so that the rows are stored whole.
// bf16 (dec_dtop_kernel): the f32 dlog rows rounded to bf16 while staged,
// on wgmma. f32 (dec_dtop_tf32_kernel): dlog unrounded, as split-TF32.
struct DtopArgs {
  const float* dlog;  // [M, V]
  const void* wout;   // [H, V] T
  float* dtop;        // [M, H]
  size_t M;
  int V, H, vec_a, vec_b;
};

__device__ __forceinline__ void dtop_store(const float* tile, const DtopArgs& a, size_t m0,
                                           int n0) {
#pragma unroll 4
  for (int idx = threadIdx.x; idx < wg::BM * wg::BN; idx += wg::NTH) {
    const int r = idx / wg::BN, cc = idx % wg::BN;
    if (m0 + r < a.M && n0 + cc < a.H)
      a.dtop[(m0 + r) * a.H + n0 + cc] = tile[r * wg::EPI_PITCH + cc];
  }
}

__global__ void __launch_bounds__(wg::NTH, wg::BLOCKS_PER_SM) dec_dtop_kernel(const DtopArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (wg::smem_u32(smem_raw) + 1023u) & ~1023u;
  const int n0 = blockIdx.x * wg::BN, V = a.V, H = a.H;
  const size_t m0 = (size_t)blockIdx.y * wg::BM, M = a.M;
  const __nv_bfloat16* wout = static_cast<const __nv_bfloat16*>(a.wout);
  float acc[64];
  wg::gemm<false>(acc, ring, (V + wg::BK - 1) / wg::BK, [&](uint32_t dst, int kt) {
    const int k = kt * wg::BK;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int idx = wg::chunk(u), r = idx >> 3, c = idx & 7;
      const uint32_t off = wg::swz(r, c);
      wg::stage8(dst + off, m0 + r < M ? a.dlog + (m0 + r) * V : nullptr, k + 8 * c, V,
                 a.vec_a);
      wg::stage8(dst + wg::TILE + off, n0 + r < H ? wout + (size_t)(n0 + r) * V : nullptr,
                 k + 8 * c, V, a.vec_b);
    }
  });
  dtop_store(wg::stage_tile(acc, smem_raw, ring), a, m0, n0);
}

__global__ void __launch_bounds__(wg::NTH, wg::TF_BLOCKS_PER_SM)
    dec_dtop_tf32_kernel(const DtopArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (wg::smem_u32(smem_raw) + 1023u) & ~1023u;
  const int n0 = blockIdx.x * wg::BN, m0 = blockIdx.y * wg::BM;
  dtop_store(train::abt_tile_tf32(smem_raw, ring, a.dlog, static_cast<const float*>(a.wout),
                                  (int)a.M, a.H, a.V, m0, n0, a.vec_a && a.vec_b),
             a, m0, n0);
}

// The head's backward of type T: the head pass, then dtop. A row is read 16
// bytes at a time where its width and start allow it, else element by
// element.
template <typename T>
cudaError_t head_bwd(const BwdArgs& a, cudaStream_t st) {
  constexpr bool BF = sizeof(T) == 2;
  constexpr int EV = 16 / sizeof(T);  // elements in 16 bytes
  const size_t M = (size_t)a.L * a.B;
  if (!BF && M > (size_t)INT_MAX) return cudaErrorInvalidValue;  // abt_tile_tf32's int rows
  const int tiles = train::cdiv((long)M, wg::BM);
  HeadBwdArgs h = {};
  h.hs = a.hs;
  h.woutT = a.woutT;
  h.bout = a.bout;
  h.targets = a.targets;
  h.din = a.din;
  h.dlog = a.dlog;
  h.B = a.B; h.L = a.L; h.V = a.V; h.H = a.H; h.n = a.n; h.with_ce = a.with_ce;
  h.vec = a.H % EV == 0 && train::aligned16(a.hs) && train::aligned16(a.woutT);
  cudaError_t e;
  if constexpr (BF) {
    e = cudaFuncSetAttribute(dec_head_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             HEAD_SMEM);
    if (e != cudaSuccess) return e;
    dec_head_bwd_kernel<<<tiles, wg::NTH, HEAD_SMEM, st>>>(h);
  } else {
    e = cudaFuncSetAttribute(dec_head_bwd_tf32_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, HEAD_TF_SMEM);
    if (e != cudaSuccess) return e;
    dec_head_bwd_tf32_kernel<<<dim3(train::cdiv(a.B, wg::BM), a.L), wg::NTH, HEAD_TF_SMEM,
                               st>>>(h);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  DtopArgs d = {};
  d.dlog = a.dlog;
  d.wout = a.wout;
  d.dtop = a.dtop;
  d.M = M;
  d.V = a.V;
  d.H = a.H;
  d.vec_a = a.V % 4 == 0 && train::aligned16(a.dlog);
  d.vec_b = a.V % EV == 0 && train::aligned16(a.wout);
  const dim3 grid(train::cdiv(a.H, wg::BN), tiles);
  if constexpr (BF) {
    e = cudaFuncSetAttribute(dec_dtop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             wg::SMEM);
    if (e != cudaSuccess) return e;
    dec_dtop_kernel<<<grid, wg::NTH, wg::SMEM, st>>>(d);
  } else {
    e = cudaFuncSetAttribute(dec_dtop_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             wg::TF_SMEM);
    if (e != cudaSuccess) return e;
    dec_dtop_tf32_kernel<<<grid, wg::NTH, wg::TF_SMEM, st>>>(d);
  }
  return cudaGetLastError();
}

// One chain launch, (t, l), in the order (L-1, n-1), (L-1, n-2), ..., (0, 0).
template <typename T>
struct StepArgs {
  const T* dg;              // [B, 4H] dgates at (t, l): the A operand
  const T* w;               // [K_l + H, 4H] layer l's wcat: row k is column k of the product
  T* dx;                    // [B, E] dx0 at t (l = 0)
  float* dcond;             // [B, C] (l = 0), added to
  const float* dh_in;       // [B, H] dh of layer l - 1 from (t + 1, l - 1) (l > 0)
  float* dh_out;            // [B, H] dh of layer l for (t - 1, l), or of h_init at t = 0
  int B, Kx, N, G, H, E, C, vec;
  int below;                // l > 0: input columns run the gate step of (t, l - 1)
  int top;                  // l = n - 1, t > 0: h columns run the gate step of (t - 1, l)
  train::GateArgsT<T> gx;   // the gate step of (t, l - 1)
  train::GateArgsT<T> gh;   // the gate step of (t - 1, n - 1), dtop(t - 1) added
};

// The epilogue of a chain launch on the staged f32 tile of dinp [B, K_l +
// H] = dgates(t, l) W_l^T, per column (a tile may straddle E, K_l = E + C at
// l = 0, or K_l = H):
//  * k < K_l, l > 0: the cotangent of layer l - 1's h at t; its thread runs
//    the gate step of (t, l - 1) at unit k with dh_in + value;
//  * l = 0, k < E: dx0 at t, in T;
//  * l = 0, E <= k < E + C: added to d(cond) (one writer per element a
//    launch, launches in the reference's t-descending order);
//  * k = K_l + j, top: the top layer's h cotangent at t - 1 from the step
//    after; its thread runs the gate step of (t - 1, n - 1) at unit j, where
//    the gate step adds the head's dtop(t - 1);
//  * k = K_l + j, otherwise: stored to dh_out.
template <typename T>
__device__ __forceinline__ void dec_step_epilogue(const float* tile, const StepArgs<T>& a) {
  const int n0 = blockIdx.x * wg::BN, m0 = blockIdx.y * wg::BM;
  const int B = a.B, N = a.N, Kx = a.Kx, H = a.H, E = a.E;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < wg::BM * wg::BN; idx += wg::NTH) {
    const int r = idx / wg::BN, cc = idx % wg::BN, row = m0 + r, col = n0 + cc;
    if (row >= B || col >= N) continue;
    const float v = tile[r * wg::EPI_PITCH + cc];
    if (col < Kx) {
      if (a.below) train::gate_step(a.gx, row, col, a.dh_in[(size_t)row * H + col] + v);
      else if (col < E) train::st(a.dx + (size_t)row * E + col, v);
      else a.dcond[(size_t)row * a.C + (col - E)] += v;
    } else if (a.top) {
      train::gate_step(a.gh, row, col - Kx, v);
    } else {
      a.dh_out[(size_t)row * H + (col - Kx)] = v;
    }
  }
}

// bf16: the product on wgmma (train_common.cuh's dinp_tile).
__global__ void __launch_bounds__(wg::NTH, wg::BLOCKS_PER_SM)
    dec_step_kernel(const StepArgs<__nv_bfloat16> a) {
  extern __shared__ unsigned char smem_raw[];
  dec_step_epilogue(train::dinp_tile(smem_raw, a.dg, a.w, a.B, a.N, a.G, a.vec), a);
}

// f32: the product as split-TF32 (train_common.cuh's dinp_tile_tf32).
__global__ void __launch_bounds__(wg::NTH, wg::TF_BLOCKS_PER_SM)
    dec_step_tf32_kernel(const StepArgs<float> a) {
  extern __shared__ unsigned char smem_raw[];
  dec_step_epilogue(train::dinp_tile_tf32(smem_raw, a.dg, a.w, a.B, a.N, a.G, a.vec), a);
}

// The reverse of type T: the head's backward (2 launches), then the chain's
// 1 + n * L launches on one stream (the kernel boundary is the grid-wide
// barrier), then d(h_init) = sum over layers of dh (1 launch). Launch (t, l)
// reads dh[l - 1], which launch (t + 1, l - 1) wrote and launch (t, l - 1)
// overwrites after it; at t = 0 the h columns of every layer go to dh[l]
// after launch (0, l + 1) has read it. dh, dc and dcond are zeros on entry.
template <typename T>
cudaError_t reverse_chain(const BwdArgs& a, cudaStream_t st) {
  constexpr bool BF = sizeof(T) == 2;
  const int B = a.B, L = a.L, H = a.H, E = a.E, C = a.C, n = a.n, G = 4 * H;
  const T* gs = static_cast<const T*>(a.gs);
  const T* cs = static_cast<const T*>(a.cs);
  const T* wcat = static_cast<const T*>(a.wcat);
  T* dgates = static_cast<T*>(a.dgates);
  const size_t BH = (size_t)B * H;
  cudaError_t e = head_bwd<T>(a, st);
  if (e != cudaSuccess) return e;
  // the gate step of (s, l): zero state before s = 0; the top layer's h
  // also takes the head's cotangent dtop(s)
  auto gate_at = [&](int s, int l) {
    const size_t slab = ((size_t)s * n + l) * B;
    train::GateArgsT<T> x = {};
    x.gs = gs + slab * G;
    x.cs = cs + slab * H;
    x.cprev = s > 0 ? cs + (slab - (size_t)n * B) * H : nullptr;
    x.dhs = l == n - 1 ? a.dtop + s * BH : nullptr;
    x.dc_in = a.dc + l * BH;
    x.dc = a.dc + l * BH;
    x.dg = dgates + slab * G;
    x.H = H;
    return x;
  };
  // (L-1, n-1) from dh[n - 1] (zeros) + dtop(L - 1), as the reference adds them
  train::gate_kernel<<<train::cdiv((long)B * H, 256), 256, 0, st>>>(
      gate_at(L - 1, n - 1), a.dh + (n - 1) * BH, B * H);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int smem = BF ? wg::SMEM : wg::TF_SMEM;
  if constexpr (BF)
    e = cudaFuncSetAttribute(dec_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  else
    e = cudaFuncSetAttribute(dec_step_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (e != cudaSuccess) return e;
  size_t wend = 0;
  for (int l = 0; l < n; ++l) wend += (size_t)((l == 0 ? E + C : H) + H) * G;
  StepArgs<T> s = {};
  s.B = B; s.G = G; s.H = H; s.E = E; s.C = C;
  s.dcond = a.dcond;
  s.vec = G % (16 / (int)sizeof(T)) == 0 && train::aligned16(a.wcat) &&
          train::aligned16(a.dgates);
  for (int t = L - 1; t >= 0; --t) {
    size_t woff = wend;
    for (int l = n - 1; l >= 0; --l) {
      s.Kx = l == 0 ? E + C : H;
      woff -= (size_t)(s.Kx + H) * G;
      s.N = s.Kx + H;
      s.w = wcat + woff;
      s.dg = dgates + ((size_t)t * n + l) * B * G;
      s.dx = static_cast<T*>(a.dx0) + (size_t)t * B * E;
      s.below = l > 0;
      s.top = l == n - 1 && t > 0;
      s.dh_in = l > 0 ? a.dh + (l - 1) * BH : nullptr;
      s.dh_out = a.dh + l * BH;
      if (s.below) s.gx = gate_at(t, l - 1);
      if (s.top) s.gh = gate_at(t - 1, n - 1);
      const dim3 grid(train::cdiv(s.N, wg::BN), train::cdiv(B, wg::BM));
      if constexpr (BF)
        dec_step_kernel<<<grid, wg::NTH, smem, st>>>(s);
      else
        dec_step_tf32_kernel<<<grid, wg::NTH, smem, st>>>(s);
      e = cudaGetLastError();
      if (e != cudaSuccess) return e;
    }
  }
  // every layer's h at t = 0 is the shared h_init
  return train::reduce(a.dh, n, (long)BH, a.dh_init, st);
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
cudaError_t launch_bwd(const BwdArgs& a, const GradOut& o, cudaStream_t st) {
  cudaError_t e = reverse_chain<T>(a, st);
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
// The forward, bf16 (bf16 = 1) or f32: wt, every layer's interleaved copy
// back to back, [fwd_np(H), fwd_kp(K_l, H, C_l)] each (C_0 = C, else 0;
// ops/train_common.py:interleave_weight), woutT [V, H], the embedding and
// the residuals hs, cs, gs in the compute dtype, and cbuf [n, B, H] f32 the
// layers' running c.
int dec_fwd_launch(const void* targets, const void* tf, const void* cond, const void* h_init,
                   const void* emb, const void* wt, const void* bias, const void* woutT,
                   const void* bout, void* out, void* toks, void* hs, void* cs, void* gs,
                   void* cbuf, int B, int L, int V, int E, int C, int H, int n, int with_ce,
                   int start_token, int bf16, void* stream) {
  if (B < 1 || L < 1 || V < 1 || V > 512 || n < 1 || n > 8) return (int)cudaErrorInvalidValue;
  FwdArgs a = {};
  a.targets = static_cast<const int*>(targets);
  a.tf = static_cast<const int*>(tf);
  a.cond = static_cast<const float*>(cond);
  a.h_init = static_cast<const float*>(h_init);
  a.emb = emb;
  a.bias = static_cast<const float*>(bias);
  a.bout = static_cast<const float*>(bout);
  a.out = static_cast<float*>(out);
  a.toks = static_cast<int*>(toks);
  a.hs = hs;
  a.cs = cs;
  a.gs = gs;
  a.B = B; a.L = L; a.V = V; a.E = E; a.C = C; a.H = H; a.n = n;
  a.with_ce = with_ce; a.start_token = start_token;
  float* c = static_cast<float*>(cbuf);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)launch_fwd(a, static_cast<const __nv_bfloat16*>(wt),
                           static_cast<const __nv_bfloat16*>(woutT), c, s);
  return (int)launch_fwd(a, static_cast<const float*>(wt), static_cast<const float*>(woutT), c,
                         s);
}

// One vocab-head launch alone, step t of a forward (dec_head_kernel where
// bf16, else dec_head_tf32_kernel): htop [B, H] the top layer's h at t, in
// woutT's dtype (a check of the kernel against its plain twin).
int dec_head_launch(const void* htop, const void* woutT, const void* bout, const void* targets,
                    const void* tf, void* out, void* toks, int B, int L, int V, int H, int t,
                    int with_ce, int bf16, void* stream) {
  if (B < 1 || L < 1 || V < 1 || V > 512 || t < 0 || t >= L) return (int)cudaErrorInvalidValue;
  const HeadArgs h = head_args(woutT, static_cast<const float*>(bout),
                               static_cast<const int*>(targets), static_cast<const int*>(tf),
                               static_cast<float*>(out), static_cast<int*>(toks), B, L, V, H,
                               with_ce);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = bf16 ? head_smem<__nv_bfloat16>() : head_smem<float>();
  if (e != cudaSuccess) return (int)e;
  return (int)(bf16 ? launch_head(h, static_cast<const __nv_bfloat16*>(htop), t, s)
                    : launch_head(h, static_cast<const float*>(htop), t, s));
}

// The backward, bf16 (bf16 = 1) or f32: wcat (every layer's [K_l + H, 4H]
// weight back to back), wout [H, V] and woutT [V, H] in the compute dtype,
// with dh and dc its [n, B, H] f32 buffers and dcond zeros on entry, and
// dtop [L, B, H] f32 scratch.
int dec_bwd_launch(const void* din, const void* targets, const void* toks, const void* hs,
                   const void* cs, const void* gs, const void* emb, const void* wcat,
                   const void* wout, const void* woutT, const void* bout, const void* h_init,
                   const void* cond, void* dh, void* dc, void* dtop, void* dgates, void* dx0,
                   void* dlog, void* dh_init, void* dcond, void* dW, void* db, void* dwout,
                   void* dbout, void* demb, void* scratch, long scratch_elems, int B, int L,
                   int V, int E, int C, int H, int n, int bf16, int with_ce, void* stream) {
  BwdArgs a;
  a.din = static_cast<const float*>(din);
  a.targets = static_cast<const int*>(targets);
  a.hs = hs;
  a.cs = cs;
  a.gs = gs;
  a.wcat = wcat;
  a.wout = wout;
  a.woutT = woutT;
  a.bout = static_cast<const float*>(bout);
  a.dh = static_cast<float*>(dh);
  a.dc = static_cast<float*>(dc);
  a.dtop = static_cast<float*>(dtop);
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
  if (B < 1 || L < 1 || V < 1 || V > 512 || n < 1 || n > 8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? launch_bwd<__nv_bfloat16>(a, o, s) : launch_bwd<float>(a, o, s));
}

// The backward's head pass alone, bf16 (dec_head_bwd_kernel, dec_dtop_kernel)
// or f32 (dec_head_bwd_tf32_kernel, dec_dtop_tf32_kernel): dlog [L, B, V]
// and dtop [L, B, H] f32 from hs [L, n, B, H] in woutT's dtype (a check of
// the kernels against their plain twin).
int dec_head_bwd_launch(const void* hs, const void* woutT, const void* wout, const void* bout,
                        const void* targets, const void* din, void* dlog, void* dtop, int B,
                        int L, int V, int H, int n, int with_ce, int bf16, void* stream) {
  if (B < 1 || L < 1 || V < 1 || V > 512 || n < 1 || n > 8) return (int)cudaErrorInvalidValue;
  BwdArgs a = {};
  a.hs = hs;
  a.woutT = woutT;
  a.wout = wout;
  a.bout = static_cast<const float*>(bout);
  a.targets = static_cast<const int*>(targets);
  a.din = static_cast<const float*>(din);
  a.dlog = static_cast<float*>(dlog);
  a.dtop = static_cast<float*>(dtop);
  a.B = B; a.L = L; a.V = V; a.H = H; a.n = n; a.with_ce = with_ce;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? head_bwd<__nv_bfloat16>(a, s) : head_bwd<float>(a, s));
}

const char* dec_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
