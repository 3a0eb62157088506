// The sampling arithmetic of one row on one warp, shared by the fused
// sampler's kernels (fused_generate.cu: fused_generate_kernel and
// tc::gen_tc_kernel) and the step-major sampler's head
// (fused_generate_steps.cu: gen_head_kernel, gen_head_tf32_kernel): the
// random stream, top-k and nucleus truncation by bisection, Gumbel noise and
// the argmax. Its plain twin is ops/fused_decoder.py (gumbel_noise) and
// ops/sampling.py (truncate_logits_bisect).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>

namespace samp {

constexpr int MAX_VPL = 16;   // vocab entries per lane: V <= 512
constexpr int BISECT_ITERS = 40;
constexpr float TRUNC_NEG = -1e30f;
constexpr float BIG = 3.4e38f;

__device__ __forceinline__ uint32_t lowbias32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

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

// One row's sampling on one warp: s[u] holds the scaled logit of vocab
// index lane + 32 u where valid[u] (V valid entries in all). Top-k, then
// nucleus truncation by bisection, Gumbel noise from the row's hash key,
// then the argmax (ties to the lowest index); every lane returns the index.
template <int VPL>
__device__ int sample_row(float (&s)[VPL], const bool (&valid)[VPL], int V, int greedy,
                          int top_k, float top_p, uint32_t seed, uint32_t rib, int t) {
  const int lane = threadIdx.x & 31;
  if (!greedy) {
    const bool do_k = top_k > 0 && top_k < V;
    const bool do_p = top_p < 1.0f;
    if (do_k) {
      float ones[VPL];
#pragma unroll
      for (int u = 0; u < VPL; ++u) ones[u] = valid[u] ? 1.0f : 0.0f;
      float lo = bisect_lo<VPL>(s, ones, valid, (float)top_k);
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
      float lo = bisect_lo<VPL>(s, e, kept, top_p);
#pragma unroll
      for (int u = 0; u < VPL; ++u)
        if (valid[u]) s[u] = (kept[u] && s[u] > lo) ? s[u] : TRUNC_NEG;
    }
    const uint32_t key = lowbias32(lowbias32(lowbias32(seed) ^ rib) ^ (uint32_t)t);
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
  return besti;
}

}  // namespace samp
