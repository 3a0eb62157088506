// The LSTM cell's elementwise tail, for Hopper (sm_90a): forward and
// backward.
//
// Replaces the TPU kernels of mlx_vae_tpu/ops/pallas_lstm.py (reached
// through _row_blocked_call, from fused_lstm_gates):
//   gates_fwd_kernel  <- _fwd_kernel
//   gates_bwd_kernel  <- _bwd_kernel
// Gate order (i, f, g, o). Forward: pre-activation gates [B, 4H] and c
// [B, H] (f32) -> c' = sig(f) c + sig(i) tanh(g), h' = sig(o) tanh(c').
// Backward, given (dh, dc) of (h', c'): the activations are recomputed from
// (gates, c), as on the TPU, and it returns dgates [B, 4H] and dc_prev
// [B, H]. The plain PyTorch version of both is in
// mlx_vae_tpu_torch/ops/fused_lstm.py, which also builds this file with
// nvcc and binds it through ctypes (plain C interface below).
//
// Design: one pass over the data, nothing kept between threads. What bounds
// both: bytes. The forward moves 28 bytes per unit for ~40 operations, the
// backward 48 bytes for ~70, far below the ~20 operations per byte at which
// the card's f32 rate would limit them. Both run on a 2-D grid of (row
// groups, unit chunks), one thread a chunk of U units of R rows, with no
// division per element. Where H % 4 == 0 and every pointer is 16-byte
// aligned, U = 4: one float4 load from each gate slice and from c (and dh,
// dc), one float4 store to each output (16 bytes a thread per access, a
// warp's accesses 512 contiguous bytes). Elsewhere a sibling instance has
// U = 1 with scalar accesses. Loads go through the read-only path and
// stores are streaming (__ldg, __stcs): no byte is read twice or read back.
//  * Forward (gates_fwd_kernel<U, R>): a thread issues all 5 R loads of its
//    R rows before it computes. The port launches R = 1: R = 2 and 4, which
//    keep more bytes in flight a thread, were slower at every measured
//    shape, B = 4096, 512 and 256 at H = 256 (python -m
//    mlx_vae_tpu_torch.bench_gates builds and times them beside it).
//  * Backward (gates_bwd_kernel<U>): one row a thread.

#include "train_common.cuh"

namespace {

using train::sigm;

// U consecutive floats at p (U = 4: one 16-byte access; p 16-byte aligned).
template <int U> struct Units;
template <> struct Units<4> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
};
template <> struct Units<1> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[1]) { v[0] = __ldg(p); }
  static __device__ __forceinline__ void store(float* p, const float (&v)[1]) { __stcs(p, v[0]); }
};

// Thread (x, y) of block (bx, by): units (by * blockDim.x + x) * U .. + U - 1
// of rows (bx * blockDim.y + y) * R .. + R - 1.
template <int U, int R>
__global__ void __launch_bounds__(256) gates_fwd_kernel(const float* __restrict__ gates,
                                                        const float* __restrict__ c,
                                                        float* __restrict__ h_out,
                                                        float* __restrict__ c_out, int B, int H) {
  const int j = (blockIdx.y * blockDim.x + threadIdx.x) * U;
  const int b0 = (blockIdx.x * blockDim.y + threadIdx.y) * R;
  if (j >= H || b0 >= B) return;
  using V = Units<U>;
  float gi[R][U], gf[R][U], gg[R][U], go[R][U], cp[R][U];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (b0 + r < B) {
      const size_t g0 = (size_t)(b0 + r) * 4 * H + j, u0 = (size_t)(b0 + r) * H + j;
      V::load(gates + g0, gi[r]);
      V::load(gates + g0 + H, gf[r]);
      V::load(gates + g0 + 2 * H, gg[r]);
      V::load(gates + g0 + 3 * H, go[r]);
      V::load(c + u0, cp[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (b0 + r < B) {
      float hn[U], cn[U];
#pragma unroll
      for (int k = 0; k < U; ++k) {
        cn[k] = sigm(gf[r][k]) * cp[r][k] + sigm(gi[r][k]) * tanhf(gg[r][k]);
        hn[k] = sigm(go[r][k]) * tanhf(cn[k]);
      }
      const size_t u0 = (size_t)(b0 + r) * H + j;
      V::store(c_out + u0, cn);
      V::store(h_out + u0, hn);
    }
  }
}

// Thread (x, y) of block (bx, by): units (by * blockDim.x + x) * U .. + U - 1
// of row bx * blockDim.y + y.
template <int U>
__global__ void __launch_bounds__(256) gates_bwd_kernel(const float* __restrict__ gates,
                                                        const float* __restrict__ c,
                                                        const float* __restrict__ dh,
                                                        const float* __restrict__ dc,
                                                        float* __restrict__ dgates,
                                                        float* __restrict__ dc_prev, int B,
                                                        int H) {
  const int j = (blockIdx.y * blockDim.x + threadIdx.x) * U;
  const int b = blockIdx.x * blockDim.y + threadIdx.y;
  if (j >= H || b >= B) return;
  const size_t g0 = (size_t)b * 4 * H + j, u0 = (size_t)b * H + j;
  float gi[U], gf[U], gg[U], go[U], cp[U], d[U], dcv[U];
  using V = Units<U>;
  V::load(gates + g0, gi);
  V::load(gates + g0 + H, gf);
  V::load(gates + g0 + 2 * H, gg);
  V::load(gates + g0 + 3 * H, go);
  V::load(c + u0, cp);
  V::load(dh + u0, d);
  V::load(dc + u0, dcv);
  float o0[U], o1[U], o2[U], o3[U], dcn[U];
#pragma unroll
  for (int k = 0; k < U; ++k) {
    const float ig = sigm(gi[k]), fg = sigm(gf[k]), g = tanhf(gg[k]), og = sigm(go[k]);
    const float tc = tanhf(fg * cp[k] + ig * g);
    const float dct = dcv[k] + d[k] * og * (1.0f - tc * tc);
    o0[k] = dct * g * ig * (1.0f - ig);
    o1[k] = dct * cp[k] * fg * (1.0f - fg);
    o2[k] = dct * ig * (1.0f - g * g);
    o3[k] = d[k] * tc * og * (1.0f - og);
    dcn[k] = dct * fg;
  }
  V::store(dgates + g0, o0);
  V::store(dgates + g0 + H, o1);
  V::store(dgates + g0 + 2 * H, o2);
  V::store(dgates + g0 + 3 * H, o3);
  V::store(dc_prev + u0, dcn);
}

// A block of 256 threads: a row's chunks along x (a multiple of 32), row
// groups (R rows each) along y; the grid's x walks the row groups, its y
// the chunk blocks. With every input read from device memory the backward
// on this grid ran as fast as the row-loop grids that python -m
// mlx_vae_tpu_torch.bench_gates times beside it.
template <int U>
void plan(int B, int H, int R, dim3* grid, dim3* block) {
  const int chunks = (H + U - 1) / U, groups = (B + R - 1) / R;
  const int tx = std::min(256, (chunks + 31) / 32 * 32), ty = 256 / tx;
  *grid = dim3((groups + ty - 1) / ty, (chunks + tx - 1) / tx);
  *block = dim3(tx, ty);
}

template <int U, int R>
cudaError_t launch_fwd(const float* gates, const float* c, float* h_out, float* c_out, int B,
                       int H, cudaStream_t st) {
  dim3 grid, block;
  plan<U>(B, H, R, &grid, &block);
  gates_fwd_kernel<U, R><<<grid, block, 0, st>>>(gates, c, h_out, c_out, B, H);
  return cudaGetLastError();
}

template <int U>
cudaError_t launch_bwd(const float* gates, const float* c, const float* dh, const float* dc,
                       float* dgates, float* dc_prev, int B, int H, cudaStream_t st) {
  dim3 grid, block;
  plan<U>(B, H, 1, &grid, &block);
  gates_bwd_kernel<U><<<grid, block, 0, st>>>(gates, c, dh, dc, dgates, dc_prev, B, H);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns a cudaError_t as int: 0 when the launch was accepted.
int gates_fwd_launch(const void* gates, const void* c, void* h_out, void* c_out, int B, int H,
                     void* stream) {
  if (B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const float* g = static_cast<const float*>(gates);
  const float* cc = static_cast<const float*>(c);
  float* h = static_cast<float*>(h_out);
  float* co = static_cast<float*>(c_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using train::aligned16;
  const bool vec = H % 4 == 0 && aligned16(g) && aligned16(cc) && aligned16(h) && aligned16(co);
  return (int)(vec ? launch_fwd<4, 1>(g, cc, h, co, B, H, s)
                   : launch_fwd<1, 1>(g, cc, h, co, B, H, s));
}

int gates_bwd_launch(const void* gates, const void* c, const void* dh, const void* dc,
                     void* dgates, void* dc_prev, int B, int H, void* stream) {
  if (B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const float* g = static_cast<const float*>(gates);
  const float* cc = static_cast<const float*>(c);
  const float* d = static_cast<const float*>(dh);
  const float* dcc = static_cast<const float*>(dc);
  float* dg = static_cast<float*>(dgates);
  float* dcp = static_cast<float*>(dc_prev);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using train::aligned16;
  const bool vec = H % 4 == 0 && aligned16(g) && aligned16(cc) && aligned16(d) &&
                   aligned16(dcc) && aligned16(dg) && aligned16(dcp);
  return (int)(vec ? launch_bwd<4>(g, cc, d, dcc, dg, dcp, B, H, s)
                   : launch_bwd<1>(g, cc, d, dcc, dg, dcp, B, H, s));
}

const char* gates_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
