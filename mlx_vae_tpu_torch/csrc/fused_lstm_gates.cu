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
// Design: one thread per (row, hidden unit) reads that unit's four gate
// pre-activations (neighbouring threads, neighbouring addresses, in each of
// the four gate slices) and c, and writes its outputs: one pass over the
// data, nothing kept between threads. What bounds it: bytes. The forward
// moves 28 bytes per unit for ~40 operations, the backward 48 bytes for
// ~60, far below the ~20 operations per byte at which the card's f32 rate
// would limit it.

#include "train_common.cuh"

namespace {

using train::sigm;

__global__ void __launch_bounds__(256) gates_fwd_kernel(const float* gates, const float* c,
                                                        float* h_out, float* c_out, long n,
                                                        int H) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const long b = idx / H;
  const int j = (int)(idx % H);
  const float* g = gates + b * 4 * H + j;
  const float ig = sigm(g[0]), fg = sigm(g[H]), gg = tanhf(g[2 * H]), og = sigm(g[3 * H]);
  const float cn = fg * c[idx] + ig * gg;
  c_out[idx] = cn;
  h_out[idx] = og * tanhf(cn);
}

__global__ void __launch_bounds__(256) gates_bwd_kernel(const float* gates, const float* c,
                                                        const float* dh, const float* dc,
                                                        float* dgates, float* dc_prev, long n,
                                                        int H) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const long b = idx / H;
  const int j = (int)(idx % H);
  const float* g = gates + b * 4 * H + j;
  const float ig = sigm(g[0]), fg = sigm(g[H]), gg = tanhf(g[2 * H]), og = sigm(g[3 * H]);
  const float cp = c[idx];
  const float tc = tanhf(fg * cp + ig * gg);
  const float d = dh[idx];
  const float dct = dc[idx] + d * og * (1.0f - tc * tc);
  float* o = dgates + b * 4 * H + j;
  o[0] = dct * gg * ig * (1.0f - ig);
  o[H] = dct * cp * fg * (1.0f - fg);
  o[2 * H] = dct * ig * (1.0f - gg * gg);
  o[3 * H] = d * tc * og * (1.0f - og);
  dc_prev[idx] = dct * fg;
}

inline unsigned blocks(long n) { return (unsigned)((n + 255) / 256); }

}  // namespace

extern "C" {

// Each returns a cudaError_t as int: 0 when the launch was accepted.
int gates_fwd_launch(const void* gates, const void* c, void* h_out, void* c_out, int B, int H,
                     void* stream) {
  if (B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const long n = (long)B * H;
  gates_fwd_kernel<<<blocks(n), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gates), static_cast<const float*>(c),
      static_cast<float*>(h_out), static_cast<float*>(c_out), n, H);
  return (int)cudaGetLastError();
}

int gates_bwd_launch(const void* gates, const void* c, const void* dh, const void* dc,
                     void* dgates, void* dc_prev, int B, int H, void* stream) {
  if (B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const long n = (long)B * H;
  gates_bwd_kernel<<<blocks(n), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gates), static_cast<const float*>(c),
      static_cast<const float*>(dh), static_cast<const float*>(dc),
      static_cast<float*>(dgates), static_cast<float*>(dc_prev), n, H);
  return (int)cudaGetLastError();
}

const char* gates_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
