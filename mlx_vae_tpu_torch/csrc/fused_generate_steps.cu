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
//    (the start tokens and the ended flags), then for t = 0 .. L-1 one step
//    launch per layer (bf16: gen_step_tma_kernel, below; f32:
//    train_common.cuh's seq_fwd_tf32_kernel as split-TF32: a card-wide GEMM
//    [x, cond, h_{t-1}] W' with the cell in its epilogue; layer 0 gathers
//    the fed token's embedding row and reads the conditions as a third
//    operand segment; h_{-1} = h0 for every layer and c_{-1} = 0), then one
//    sampling head (gen_head_kernel in bf16, gen_head_tf32_kernel in f32).
//  * Every product sums its 64-deep (bf16) or 32-deep (split-TF32) stages in
//    f32 registers, each stage formed afresh on the tensor cores, as the
//    tensor-core cluster kernel does: the tensor cores' accumulator rounds
//    otherwise than IEEE f32, and a bf16 h that rounds the other way changes
//    the rest of a truncated row. The train forward's bf16 step
//    (seq_fwd_step_kernel) accumulates whole products on the tensor cores;
//    with it, truncated bf16 rows at H=768 agreed with the plain version on
//    87.1% (PERF.md).
//  * The bf16 step, gen_step_tma_kernel<NC>: a tile of 64 NC rows (NC =
//    1 or 3 consumer warpgroups) by 128 gate columns (all four gates of
//    32 units), one m64n128k16 wgmma chain per 64 rows, the same
//    instructions on the same bf16 operands in the same order as
//    train_common.cuh's seq_fwd_step, so a row's outputs are those of the
//    kernel it replaced (train::seq_fwd_step with the stage sums in
//    registers), bit for bit, whatever NC. What held that kernel to ~1.5 us
//    a 64-deep stage (0.28 us of products): all 256 threads staged both
//    operands with cp.async, then waited, synchronised, ran the stage's
//    products and waited for them before adding them, so the tensor cores
//    idled through every barrier, wait and add, at one block an SM. What
//    bounds this one (PERF.md): the rate at which the SMs take in
//    their operands from L2, 47-53 GB/s an SM with all 132 at work (6.2-7.0
//    TB/s; 75-82 GB/s with a quarter or half of them), at ~55 GB/s a CTA in
//    the 128-row kernel's stages whether 64 or 132 SMs were at work. So a
//    tile's bytes a product decide: 32 KB a 64-deep stage of a 128-row
//    tile, 40 KB of a 192-row one for 1.5x the products. Here:
//    - a producer warpgroup keeps a ring of stages in flight (6; 4 of the
//      192-row tile's 40 KB): its thread 0 issues the weight tile and the
//      A rows by TMA (cp.async.bulk.tensor, 128-byte swizzle, zeros past B
//      and past a row's width), completing on a full mbarrier a slot; the
//      consumers free a slot through its empty mbarrier, and every
//      producer thread waits for each slot in turn. TMA cannot gather rows or
//      convert types, so layer 0's x segment (the fed tokens' embedding
//      rows) is staged by the producer's 128 threads themselves
//      (wg::stage8, then a proxy fence before the arrival), and h0 and the
//      conditions come in as bf16 copies made once a call (the rounding
//      stage8 applied to the f32 values: ops/fused_decoder.py:
//      steps_bf16_operands); so does any h whose rows TMA cannot address
//      (H not a multiple of 8);
//    - one consumer warpgroup issues stage k + 1's wgmmas into a second
//      register set before adding stage k's (wait_group 1), so the adds and
//      the barrier waits run under the next products (acc and two stage
//      products: 192 f32 registers a thread). Three have 152 a thread
//      (setmaxnreg: the producer gives up all but 40): one stage product
//      each, and the three take turns on the tensor cores. Two, a 128-row
//      tile, were slower than one or three at every batch (PERF.md;
//      with a producer warp alone ptxas held them to 168 registers and they
//      spilled). The warpgroup index is made warp-uniform and
//      the waits and slot releases carry no branch around the wgmmas, or
//      ptxas serializes them (C7518);
//    - the epilogue runs on the accumulator registers: a thread holds all
//      four gates of its (row, unit) pairs (gate q of unit j is gate-tile
//      column 32 q + j), so the cell (the arithmetic of train_common.cuh's
//      seq_fwd_step epilogue, its fma spelled out) needs no staging through
//      shared memory; c_{t-1} and the bias come from a shared buffer that
//      the producer fills while the tile's products run (two buffers, a
//      barrier each way);
//    - the grid is persistent: as many CTAs as the card holds at once,
//      each walking its tiles, so the producer loads the next tile's first
//      stages while the consumers run this tile's cell. The tiles past B
//      or past the units store nothing (TMA reads zeros there). NC is
//      chosen by config and B on the host (ops/fused_decoder.py:
//      steps_tile, from the sweep in PERF.md); the tokens do not depend on
//      it;
//    - no operand is shared over a thread-block cluster: multicasting the
//      weight tile over 2 row tiles, the A rows over 2 column tiles, or
//      both, moved a pass by 2% or less either way, and one launch alone
//      with the A rows multicast, in turns with one without, was not
//      faster in every round (PERF.md).
//    A wait that never completes traps after ~2^34 cycles: a launch
//    failure, never a hang.
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
// in bf16), which stay in L2 across its row tiles. The bf16 steps are held
// to the rate at which an SM takes in its operands (above): a 64-deep
// stage of a 192-row tile is 40 KB for 0.42 us of products at the tensor
// cores' rate, 0.74 us at ~55 GB/s.

#include <cuda.h>
#include <stdint.h>

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

// ------------------------------------------------------ the bf16 step kernel

// gen_step_tma_kernel<NC>: one step launch of one layer in bf16, the tile
// rows m0 .. m0 + 64 NC - 1 by the 128 gate columns n0 .. n0 + 127 (see the
// design note above). Warpgroup NC is the producer; warpgroups 0 .. NC - 1
// are the consumers, warpgroup w the tile's rows 64 w .. 64 w + 63.
namespace ws {

constexpr int BK = 64, BN = 128;
constexpr int B_BYTES = BN * wg::LINE;       // a stage's weight tile: 16 KB
constexpr long long TRAP_CYCLES = 1ll << 34;  // ~9 s: a wait this long is a deadlock

template <int NC>  // consumer warpgroups
struct Tile {
  static constexpr int BM = 64 * NC;             // rows a tile
  static constexpr int A_BYTES = BM * wg::LINE;  // a stage's A tile
  static constexpr int SLOT = A_BYTES + B_BYTES;
  static constexpr int RING = NC == 3 ? 4 : 6;   // stages in flight
  static constexpr int NTH = (NC + 1) * 128;     // the consumers and the producer
  // after the ring (1024-aligned): a full and an empty barrier a slot; two
  // buffers of the cell's inputs (c_{t-1} of the tile [BM, 32] and the
  // bias of its units [4, 32], f32), each with a barrier that says they
  // are in and one that says the epilogue is done with them
  static constexpr int BARS = RING * SLOT, CBARS = BARS + 2 * RING * 8;
  static constexpr int CTILE = CBARS + 4 * 8, CT_BYTES = BM * 128 + 512;
  static constexpr int SMEM = 1024 + CTILE + 2 * CT_BYTES;  // + the ring's alignment
  static_assert(SMEM <= 232448, "shared memory of a block");
};

// One launch's arguments: the step's FwdStepArgs (hprev: h_{t-1} in bf16;
// cond unused, the conditions come from cmap) and the tensor maps of the
// operands that TMA loads, each a bf16 [rows, cols] matrix with 64-column
// boxes, 128-byte swizzle (wgmma.cuh's layout), zeros outside the matrix.
struct StepArgs {
  CUtensorMap wmap;   // the layer's interleave_weight [Np, Kp], boxes of 128 rows
  CUtensorMap xmap;   // the x segment's rows [B, I] where x_tma, boxes of 64 NC / CN rows
  CUtensorMap cmap;   // the conditions [B, Cxp] where Cxp > 0
  CUtensorMap hmap;   // h_{t-1} [B, H] where h_tma
  train::FwdStepArgs a;
  int x_tma, h_tma;   // 0: the producer stages that segment itself
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// Wait for the phase of parity `parity` to complete; trap (a launch
// failure the host sees) rather than hang if it never does. The loop is in
// the PTX, so the compiler sees no divergent path around the wgmmas.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .u64 t0, t1;\n"
      "mov.u64 t0, %%clock64;\n"
      "WS_MBAR_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra WS_MBAR_DONE;\n"
      "mov.u64 t1, %%clock64;\n"
      "sub.u64 t1, t1, t0;\n"
      "setp.lt.u64 p, t1, %2;\n"
      "@p bra WS_MBAR_WAIT;\n"
      "trap;\n"
      "WS_MBAR_DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity), "l"(TRAP_CYCLES)
      : "memory");
}
// A consumer warp is done with a ring slot or a cell buffer: its lane 0
// arrives on the barrier at bar (a predicated arrival: no branch around
// the wgmmas).
__device__ __forceinline__ void release(uint32_t bar, uint32_t lane) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.eq.u32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n"
      "}\n" ::"r"(bar),
      "r"(lane)
      : "memory");
}
// One box of `map` at (column x, row y) into this CTA's shared memory at
// dst, completing on the barrier at bar.
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map, int x, int y,
                                        uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

// The producer's own staging of a stage's A tile (rows m0 .. m0 + BM - 1):
// seg 0 the x segment's rows (the embedding rows of the fed tokens, or
// dense rows), seg 2 h_{t-1}'s, with train_common's loads (wg::stage8);
// producer thread i writes chunks i, i + 128, ... (whole lines a warp: no
// bank conflict). Ends with this thread's copies landed and fenced for
// wgmma.
template <int BM>
__device__ __forceinline__ void stage_own(uint32_t sa, const train::FwdStepArgs& a, int seg,
                                          int k0, int m0, int ptid) {
  const __nv_bfloat16* h = static_cast<const __nv_bfloat16*>(a.hprev);
  for (int idx = ptid; idx < BM * 8; idx += 128) {
    const int r = idx >> 3, c = idx & 7, row = m0 + r;
    const uint32_t dst = sa + wg::swz(r, c);
    if (seg == 0) {
      const __nv_bfloat16* src = nullptr;
      if (row < a.B) {
        if (a.tok == nullptr) {
          src = a.x + (size_t)row * a.I;
        } else {
          const int v = a.tok[row * a.tok_sb];
          if (v >= 0 && v < a.V) src = a.x + (size_t)v * a.I;
        }
      }
      wg::stage8(dst, src, k0 + 8 * c, a.I, a.vec_x);
    } else {
      wg::stage8(dst, row < a.B && h != nullptr ? h + (size_t)row * a.H : nullptr,
                 k0 - a.Ixp + 8 * c, a.H, a.vec_h);
    }
  }
  wg::cp_commit();
  wg::cp_wait<0>();
  wg::proxy_fence();
}

// The producer's copies of a tile's cell inputs, issued before its first
// stage so that they land under its products: c_{t-1} of the tile's rows
// and 32 units into ct [BM, 32] (cp.async where 16-byte aligned, zeros
// where there is none or past B and H), the bias of the four gates of the
// 32 units into ct + BM * 128 [4, 32]. Ends with this thread's copies
// issued (not landed).
template <int BM>
__device__ __forceinline__ void stage_cell_inputs(uint32_t ct, const train::FwdStepArgs& a,
                                                  int m0, int u0, int ptid) {
  const float* cin = a.c_in;
  const int H = a.H;
  const bool vec = (H & 3) == 0 && (reinterpret_cast<uintptr_t>(cin) & 15u) == 0;
  for (int idx = ptid; idx < BM * 8; idx += 128) {
    const int r = idx >> 3, u = u0 + 4 * (idx & 7), row = m0 + r;
    const uint32_t dst = ct + idx * 16;
    if (cin == nullptr || row >= a.B || u >= H) {
      wg::st16(dst, make_uint4(0u, 0u, 0u, 0u));
    } else if (vec) {
      wg::cp16(dst, cin + (size_t)row * H + u, 4 * min(4, H - u));
    } else {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = u + e < H ? cin[(size_t)row * H + u + e] : 0.0f;
      wg::st16(dst, make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                               __float_as_uint(v[2]), __float_as_uint(v[3])));
    }
  }
  const int q = ptid >> 5, u = u0 + (ptid & 31);
  const float b = u < H ? a.bias[q * H + u] : 0.0f;
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(ct + BM * 128 + 4 * ptid), "f"(b) : "memory");
  wg::cp_commit();
}

// This CTA's tiles: CTA c of the grid takes tiles c, c + gridDim.x, ...;
// tile ct is (column ct % ncol, row ct / ncol), the columns fastest (the
// CTAs at work share row tiles, and so the A rows in L2).
struct TileWalk {
  int first, step, count, ncol;
};

template <int NC>
__global__ void __launch_bounds__(Tile<NC>::NTH, 1)
    gen_step_tma_kernel(const __grid_constant__ StepArgs p) {
  using T = Tile<NC>;
  constexpr int RING = T::RING;
  extern __shared__ unsigned char smem_raw[];
  const train::FwdStepArgs& a = p.a;
  const uint32_t ring = (wg::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = ring + T::BARS;  // full[s] at + 8 s, empty[s] at + 8 (RING + s)
  // cfull[b] at + 8 b, cfree[b] at + 8 (2 + b): the cell inputs' buffer b
  const uint32_t cbars = ring + T::CBARS;
  const int nk = a.Kp / BK, Ixp = a.Ixp, Ix = Ixp - a.Cxp;
  TileWalk tw;
  tw.ncol = (a.H + 31) / 32;  // 32 units a column tile
  tw.count = tw.ncol * ((a.B + T::BM - 1) / T::BM);
  tw.first = blockIdx.x;
  tw.step = gridDim.x;
  // the warpgroup, made warp-uniform for the compiler (no divergent path
  // around the wgmmas)
  const int wgi = __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 7), 0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < RING; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (RING + s), NC * 4);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(cbars + 8 * b, 128);
      mbar_init(cbars + 8 * (2 + b), NC * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // every barrier is initialised before a copy lands
  if (wgi == NC) {
    // ---- the producer warpgroup: the ring, in order of the stages of this
    // CTA's tiles; its thread 0 issues the copies (its warp following it),
    // all 128 stage what TMA cannot load and the cell inputs
    if constexpr (NC > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int ptid = threadIdx.x - NC * 128;
    uint32_t g = 0;  // stages issued so far
    int it = 0;
    for (int ct = tw.first; ct < tw.count; ct += tw.step, ++it) {
      const int n0 = (ct % tw.ncol) * BN, m0 = (ct / tw.ncol) * T::BM;
      const int cb = it & 1;
      if (it >= 2) mbar_wait(cbars + 8 * (2 + cb), ((it >> 1) - 1) & 1);
      stage_cell_inputs<T::BM>(ring + T::CTILE + cb * T::CT_BYTES, a, m0, n0 / 4, ptid);
      for (int kt = 0; kt < nk; ++kt, ++g) {
        const int s = g % RING;
        const uint32_t sa = ring + s * T::SLOT, full = bars + 8 * s;
        const int k0 = kt * BK;
        const int seg = k0 < Ix ? 0 : (k0 < Ixp ? 1 : 2);  // x, conditions, h
        const bool own = seg == 0 ? !p.x_tma : (seg == 2 && !p.h_tma);
        // every producer thread waits for each slot in turn: one that ran a
        // whole phase ahead would take the parity of the phase before as
        // its own
        if (g >= RING) mbar_wait(bars + 8 * (RING + s), ((g / RING) - 1) & 1);
        if (own) {
          stage_own<T::BM>(sa, a, seg, k0, m0, ptid);
          asm volatile("bar.sync 2, 128;\n" ::: "memory");  // the whole A tile is in
        }
        if (ptid < 32) {  // warp 0 issues (whole, so that it meets bar.sync 2 converged)
          if (ptid == 0) {
            mbar_expect(full, (own ? 0 : T::A_BYTES) + B_BYTES);
            tma_box(sa + T::A_BYTES, &p.wmap, k0, n0, full);
            if (!own) {
              const CUtensorMap* map = seg == 0 ? &p.xmap : (seg == 1 ? &p.cmap : &p.hmap);
              const int col = seg == 0 ? k0 : (seg == 1 ? k0 - Ix : k0 - Ixp);
              tma_box(sa, map, col, m0, full);
            }
          }
          __syncwarp();
        }
      }
      wg::cp_wait<0>();  // this thread's copies of the tile's cell inputs have landed
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(cbars + 8 * cb)
                   : "memory");
    }
  } else {
    // ---- the consumers: stage k + 1's products run while stage k's are
    // added; then the cell of each (row, unit) from the accumulator
    if constexpr (NC == 3) asm volatile("setmaxnreg.inc.sync.aligned.u32 152;\n");
    const uint32_t lane = threadIdx.x & 31;
    const uint32_t a_off = wgi * 8192;  // this warpgroup's 64 rows
    // three warpgroups have no room for a second stage product (152
    // registers a thread): theirs take turns on the tensor cores instead
    constexpr bool TWO = NC == 1;
    float acc[64], pa[64], pb[TWO ? 64 : 1];
#pragma unroll
    for (int j = 0; j < 64; ++j) pa[j] = 0.0f;
    // pinned here: a zero the compiler rematerialised at its use would be
    // an instruction defining a wgmma's accumulator inside another's
    // pipeline stage, which serializes them (C7515)
    wg::fence_acc(pa);
    if constexpr (TWO) {
#pragma unroll
      for (int j = 0; j < 64; ++j) pb[j] = 0.0f;
      wg::fence_acc(pb);
    }
    auto issue = [&](float (&d)[64], uint32_t g) {
      const int s = g % RING;
      mbar_wait(bars + 8 * s, (g / RING) & 1);
      const uint32_t sa = ring + s * T::SLOT, sb = sa + T::A_BYTES;
      wg::fence_acc(d);
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wg::mma_m64n128k16<0, 0>(d, wg::desc(sa + a_off + kk * 32, 16, 1024),
                                 wg::desc(sb + kk * 32, 16, 1024), kk > 0);
      wg::commit();
      wg::fence_acc(d);
    };
    auto retire = [&](float (&d)[64], uint32_t g) {  // stage g's products are done
      wg::fence_acc(d);
      release(bars + 8 * (RING + g % RING), lane);
#pragma unroll
      for (int j = 0; j < 64; ++j) acc[j] += d[j];
    };
    uint32_t g = 0;  // stages consumed so far
    int it = 0;
    for (int ct = tw.first; ct < tw.count; ct += tw.step, ++it) {
      const int n0 = (ct % tw.ncol) * BN, m0 = (ct / tw.ncol) * T::BM;
#pragma unroll
      for (int j = 0; j < 64; ++j) acc[j] = 0.0f;
      wg::fence_acc(acc);
      if constexpr (TWO) {
        // stage g + kt in flight in pa at the top of each pass and at its end
        issue(pa, g);
        int kt = 0;
        for (; kt + 2 < nk; kt += 2) {
          issue(pb, g + kt + 1);
          wg::wait<1>();
          retire(pa, g + kt);
          issue(pa, g + kt + 2);
          wg::wait<1>();
          retire(pb, g + kt + 1);
        }
        if (kt + 1 < nk) {
          issue(pb, g + kt + 1);
          wg::wait<1>();
          retire(pa, g + kt);
          wg::wait<0>();
          retire(pb, g + kt + 1);
        } else {
          wg::wait<0>();
          retire(pa, g + kt);
        }
      } else {
        for (int kt = 0; kt < nk; ++kt) {
          issue(pa, g + kt);
          wg::wait<0>();
          retire(pa, g + kt);
        }
      }
      g += nk;
      // the cell from the accumulator: this thread holds all four gates of
      // its (row, unit) pairs (gate q of unit j at column 32 q + j, four
      // fragment columns on), c_{t-1} and the bias from the cell buffer
      const int cb = it & 1;
      const float* c_tile = reinterpret_cast<const float*>(
          smem_raw + (ring + T::CTILE + cb * T::CT_BYTES - wg::smem_u32(smem_raw)));
      const float* b_tile = c_tile + T::BM * 32;
      mbar_wait(cbars + 8 * cb, (it >> 1) & 1);
      const int H = a.H, u0 = n0 / 4;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int r = wg::acc_row(j), uj = wg::acc_col(j), row = m0 + r, u = u0 + uj;
        const float ig = train::sigm(acc[j] + b_tile[uj]);
        const float fg = train::sigm(acc[j + 16] + b_tile[32 + uj]);
        const float gg = tanhf(acc[j + 32] + b_tile[64 + uj]);
        const float og = train::sigm(acc[j + 48] + b_tile[96 + uj]);
        // c_t = f c_{t-1} + i g rounded as train_common.cuh's epilogue
        // rounds it (fma(i, g, f c_{t-1}): the compiler fuses one of the two
        // products, which one following the code around it, so the fma is
        // spelled out; the other fusion parted from the replaced kernel's
        // tokens on 4 of 18 digests, PERF.md)
        const float cn = __fmaf_rn(ig, gg, __fmul_rn(fg, c_tile[r * 32 + uj]));
        const float hn = og * tanhf(cn);
        if (row < a.B && u < H) {
          const size_t bu = (size_t)row * H + u;
          a.c_out[bu] = cn;
          train::st(a.hs + bu, hn);
        }
      }
      // this warp is done with the buffer (every lane's reads are above)
      __syncwarp();
      release(cbars + 8 * (2 + cb), lane);
    }
  }
}

}  // namespace ws

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
  const void* h0b;      // bf16: h0 as bf16 [B, H]
  const void* condb;    // bf16: the conditions as bf16 [B, Cxp], zeros past C
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

// ---- host side of the bf16 step launches

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, fetched once through cudaGetDriverEntryPoint (so
// the library needs no -lcuda), as fused_generate.cu does.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of a bf16 [rows, cols] matrix at base: boxes of 64 columns by
// box_rows rows, 128-byte swizzle, zeros outside the matrix. False where
// TMA cannot read it (a start or a row stride off 16 bytes).
bool bf16_map(CUtensorMap* m, const void* base, int rows, int cols, int box_rows) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr || base == nullptr || !train::aligned16(base) || cols % 8 != 0) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)ws::BK, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box,
             estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A persistent grid: as many CTAs as the card holds at once (at most one a
// tile), each walking its tiles (ws::TileWalk). NC: the tile instance (64
// NC rows; ops/fused_decoder.py:steps_tile picks it).
template <int NC>
cudaError_t launch_tma(const ws::StepArgs& p, cudaStream_t st) {
  using T = ws::Tile<NC>;
  static int resident = 0;  // CTAs the card holds at once
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ws::gen_step_tma_kernel<NC>,
                                                        T::NTH, T::SMEM);
    if (e != cudaSuccess) return e;
    if (sms * per_sm < 1) return cudaErrorInvalidConfiguration;
    resident = sms * per_sm;
  }
  const int tiles = train::fwd_np(p.a.H) / ws::BN * train::cdiv(p.a.B, T::BM);
  ws::gen_step_tma_kernel<NC><<<tiles < resident ? tiles : resident, T::NTH, T::SMEM, st>>>(p);
  return cudaGetLastError();
}

template <int NC>
cudaError_t tma_smem() {
  return cudaFuncSetAttribute(ws::gen_step_tma_kernel<NC>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, ws::Tile<NC>::SMEM);
}

cudaError_t tma_prepare(int nc) { return nc == 1 ? tma_smem<1>() : tma_smem<3>(); }

cudaError_t launch_tma_step(const ws::StepArgs& p, int nc, cudaStream_t st) {
  return nc == 1 ? launch_tma<1>(p, st) : launch_tma<3>(p, st);
}

HeadArgs head_args(const StepsArgs& a) {
  HeadArgs head = {};
  head.woutT = a.woutT;
  head.bout = a.bout;
  head.seeds = a.seeds;
  head.temps = a.temps;
  head.scaled = a.scaled;
  head.logits0 = a.logits0;
  head.out = a.out;
  head.ended = a.ended;
  head.B = a.B; head.L = a.L; head.V = a.V; head.H = a.H; head.block_rows = a.block_rows;
  head.greedy = a.greedy; head.top_k = a.top_k; head.top_p = a.top_p;
  head.end_token = a.end_token; head.pad_token = a.pad_token;
  return head;
}

// The frame both dtypes share: the set-up launch, then for t = 0 .. L-1 the
// n step launches, step(l, t, cur, prev) with cur slot t % 2 of h's
// two-slot buffer (step t's h) and prev slot (t - 1) % 2, then the sampling
// head on the top layer's h.
template <typename T, typename Step>
cudaError_t run_steps(const StepsArgs& a, cudaStream_t st, Step&& step) {
  const size_t BH = (size_t)a.B * a.H;
  T* hbuf = static_cast<T*>(a.hbuf);
  gen_init_kernel<<<train::cdiv(a.B, 256), 256, 0, st>>>(a.start, a.ended, a.start_token, a.B);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const HeadArgs head = head_args(a);
  for (int t = 0; t < a.L; ++t) {
    T* cur = hbuf + (size_t)(t % 2) * a.n * BH;
    T* prev = hbuf + (size_t)((t + 1) % 2) * a.n * BH;
    for (int l = 0; l < a.n; ++l) {
      e = step(l, t, cur, prev);
      if (e != cudaSuccess) return e;
    }
    e = launch_head(head, cur + (size_t)(a.n - 1) * BH, t, st);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// bf16: per step n launches of gen_step_tma_kernel and one head. The tensor
// maps are encoded once a call: each layer's weight, every (slot, layer)
// of h's two-slot buffer, h0 and the conditions as bf16; a launch copies
// its own into its arguments.
cudaError_t launch_steps_bf16(const StepsArgs& a, int nc, cudaStream_t st) {
  using bf = __nv_bfloat16;
  const int B = a.B, L = a.L, H = a.H, n = a.n;
  const size_t BH = (size_t)B * H;
  bf* hbuf = static_cast<bf*>(a.hbuf);
  const bf* h0b = static_cast<const bf*>(a.h0b);
  cudaError_t e = tma_prepare(nc);
  if (e != cudaSuccess) return e;
  train::FwdStepArgs ls[8];
  train::dec_fwd_layers(ls, n, static_cast<const bf*>(a.emb), a.cond, hbuf,
                        static_cast<const bf*>(a.wt), a.bias, a.cbuf, B, a.V, a.E, a.C, H);
  ws::StepArgs p[8];
  CUtensorMap hmap[2][8], h0map;
  bool h_tma = true;  // h's buffer by TMA (H a multiple of 8), else staged by the producer
  for (int s = 0; s < 2; ++s)
    for (int l = 0; l < n; ++l)
      h_tma = bf16_map(&hmap[s][l], hbuf + (size_t)(s * n + l) * BH, B, H, 64 * nc) && h_tma;
  const bool h0_tma = bf16_map(&h0map, h0b, B, H, 64 * nc);
  for (int l = 0; l < n; ++l) {
    p[l] = {};
    p[l].a = ls[l];
    p[l].a.h_f32 = 0;
    if (!bf16_map(&p[l].wmap, ls[l].w, train::fwd_np(H), ls[l].Kp, ws::BN))
      return cudaErrorInvalidValue;
  }
  if (ls[0].Cxp > 0 && !bf16_map(&p[0].cmap, a.condb, B, ls[0].Cxp, 64 * nc))
    return cudaErrorInvalidValue;
  return run_steps<bf>(a, st, [&](int l, int t, bf* cur, bf* prev) {
    ws::StepArgs& s = p[l];
    if (l == 0) {  // step 0 feeds the start token, step t the token of t - 1
      s.a.tok = t == 0 ? a.start : a.out + (t - 1);
      s.a.tok_sb = t == 0 ? 1 : L;
      s.x_tma = 0;
    } else {
      s.a.x = cur + (size_t)(l - 1) * BH;
      s.xmap = hmap[t % 2][l - 1];
      s.x_tma = h_tma;
    }
    if (t == 0) {
      s.a.hprev = h0b;
      s.a.vec_h = H % 8 == 0 && train::aligned16(h0b);
      s.a.c_in = nullptr;
      s.hmap = h0map;
      s.h_tma = h0_tma;
    } else {
      s.a.hprev = prev + (size_t)l * BH;
      s.a.vec_h = H % 8 == 0 && train::aligned16(hbuf);
      s.a.c_in = a.cbuf + l * BH;
      s.hmap = hmap[(t + 1) % 2][l];
      s.h_tma = h_tma;
    }
    s.a.hs = cur + (size_t)l * BH;
    return launch_tma_step(s, nc, st);
  });
}

// f32: per step n launches of train_common.cuh's split-TF32 forward step
// and one head.
cudaError_t launch_steps_f32(const StepsArgs& a, cudaStream_t st) {
  const int B = a.B, L = a.L, H = a.H, n = a.n;
  const size_t BH = (size_t)B * H;
  float* hbuf = static_cast<float*>(a.hbuf);
  cudaError_t e = cudaFuncSetAttribute(train::seq_fwd_tf32_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, wg::TF_SMEM);
  if (e != cudaSuccess) return e;
  train::FwdStepTf32Args ls[8];  // each layer's fixed arguments (as launch_fwd's)
  train::dec_fwd_layers(ls, n, static_cast<const float*>(a.emb), a.cond, hbuf,
                        static_cast<const float*>(a.wt), a.bias, a.cbuf, B, a.V, a.E, a.C, H);
  const dim3 grid(train::fwd_np(H) / wg::BN, train::cdiv(B, wg::BM));
  return run_steps<float>(a, st, [&](int l, int t, float* cur, float* prev) {
    train::FwdStepTf32Args& s = ls[l];
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
      s.vec_h = H % 4 == 0 && train::aligned16(hbuf);
      s.c_in = a.cbuf + l * BH;
    }
    s.hs = cur + (size_t)l * BH;
    train::seq_fwd_tf32_kernel<<<grid, wg::NTH, wg::TF_SMEM, st>>>(s);
    return cudaGetLastError();
  });
}

}  // namespace

extern "C" {

// Each returns a cudaError_t as int: 0 when every launch was accepted.
// One sampling call, bf16 (bf16 = 1) or f32: wt, every layer's interleaved
// copy back to back, [fwd_np(H), fwd_kp(K_l, H, C_l)] each (C_0 = C, else 0;
// ops/train_common.py:interleave_weight), woutT [V, H] and the embedding in
// the compute dtype; hbuf [2, n, B, H] in the compute dtype, cbuf [n, B, H]
// and scaled [B, V] f32, start and ended [B] int32 scratch. bf16 also takes
// h0b [B, H] and condb [B, round_up(C, 64)] (h0 and the conditions rounded
// to bf16, zeros past C; ops/fused_decoder.py:steps_bf16_operands) and the
// tile instance nc (64 nc rows a tile, nc = 1 or 3); f32 ignores them.
int gen_steps_launch(const void* emb, const void* cond, const void* h0, const void* h0b,
                     const void* condb, const void* wt, const void* bias, const void* woutT,
                     const void* bout, const void* seeds, const void* temps, void* out,
                     void* logits0, void* hbuf, void* cbuf, void* scaled, void* start, void* ended,
                     int B, int L, int V, int E, int C, int H, int n, int block_rows, int greedy,
                     int top_k, float top_p, int bf16, int start_token, int end_token,
                     int pad_token, int nc, void* stream) {
  if (B < 1 || L < 1 || V < 1 || V > 32 * samp::MAX_VPL || n < 1 || n > 8 || H < 1 ||
      block_rows < 1 ||
      (bf16 && ((nc != 1 && nc != 3) || h0b == nullptr || (C > 0 && condb == nullptr))))
    return (int)cudaErrorInvalidValue;
  StepsArgs a = {};
  a.emb = emb;
  a.cond = static_cast<const float*>(cond);
  a.h0 = static_cast<const float*>(h0);
  a.h0b = h0b;
  a.condb = condb;
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
  return (int)(bf16 ? launch_steps_bf16(a, nc, s) : launch_steps_f32(a, s));
}

// One bf16 step launch alone (gen_step_tma_kernel; a check of the kernel
// against its plain step): x the step's input rows [B, I], or with tok
// (row b's token at tok[b * tok_sb]) the embedding table [V, I]; condb
// [B, round_up(C, 64)] bf16 where C > 0; hprev [B, H] bf16 (null: zeros);
// c_in [B, H] f32 (null: zeros), c_out [B, H] f32; w the layer's
// interleave_weight [fwd_np(H), fwd_kp(I, H, C)]; bias [4H] f32; hs [B, H]
// bf16 out. Inputs that TMA cannot read (a start or a row stride off 16
// bytes) the producer warpgroup stages itself.
int gen_step_launch(const void* x, const void* tok, long tok_sb, int V, const void* condb,
                    const void* hprev, const void* c_in, void* c_out, const void* w,
                    const void* bias, void* hs, int B, int I, int H, int C, int nc,
                    void* stream) {
  if ((nc != 1 && nc != 3) || B < 1 || I < 1 || H < 1 || C < 0 || (C > 0 && condb == nullptr) ||
      x == nullptr || w == nullptr || c_out == nullptr || hs == nullptr)
    return (int)cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  ws::StepArgs p = {};
  train::FwdStepArgs& s = p.a;
  s.x = static_cast<const bf*>(x);
  s.tok = static_cast<const int*>(tok);
  s.tok_sb = tok_sb;
  s.V = V;
  s.C = C;
  s.Cxp = train::round_up(C, wg::BK);
  s.hprev = hprev;
  s.c_in = static_cast<const float*>(c_in);
  s.c_out = static_cast<float*>(c_out);
  s.w = static_cast<const bf*>(w);
  s.bias = static_cast<const float*>(bias);
  s.hs = static_cast<bf*>(hs);
  s.B = B; s.I = I; s.H = H;
  s.Ixp = train::fwd_ixp(I, C);
  s.Kp = train::fwd_kp(I, H, C);
  s.vec_x = I % 8 == 0 && train::aligned16(x);
  s.vec_h = H % 8 == 0 && train::aligned16(hprev);
  if (!bf16_map(&p.wmap, w, train::fwd_np(H), s.Kp, ws::BN) ||
      (C > 0 && !bf16_map(&p.cmap, condb, B, s.Cxp, 64 * nc)))
    return (int)cudaErrorInvalidValue;
  p.x_tma = tok == nullptr && bf16_map(&p.xmap, x, B, I, 64 * nc);
  p.h_tma = bf16_map(&p.hmap, hprev, B, H, 64 * nc);
  cudaError_t e = tma_prepare(nc);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_tma_step(p, nc, static_cast<cudaStream_t>(stream));
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
