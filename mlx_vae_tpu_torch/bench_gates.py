"""Launch shapes of the gate pair on one CUDA card; prints ONE JSON line.

    python -m mlx_vae_tpu_torch.bench_gates [--samples N]

Each call below is timed by the median device time of interleaved launches:

* the backward at the default model's main-path shape (B = 4096, H = 256,
  f32):
  * ``kernel``: ``csrc/fused_lstm_gates.cu:gates_bwd_kernel<4>`` as the
    port launches it (``ops/fused_lstm.py:gates_bwd``): a flat 2-D grid,
    one thread a float4 chunk of one row;
  * ``rows xN``: the same body inside a grid-stride loop over row groups,
    with the grid cut to N blocks an SM (built here from the source below);
  * ``aten``: ``aten::_thnn_fused_lstm_cell_backward_impl``, the library's
    kernel for the same function;
  * ``copy``: one ``copy_`` of 6 floats a unit, which moves the backward's
    48 bytes a unit (each read once, each written once);
* the forward at B = 4096 and at B = 256 (the curve-parity study's batch),
  H = 256:
  * ``kernel``: ``gates_fwd_kernel<4, 1>`` as the port launches it
    (``ops/fused_lstm.py:gates_fwd``), one row a thread;
  * ``rows R``: ``gates_fwd_kernel<4, R>``, R = 2 and 4 rows a thread (all
    their loads issued before any arithmetic), launched from this
    source, which includes the port's;
  * ``aten``: ``aten::_thnn_fused_lstm_cell``;
  * ``copy``: one ``copy_`` of 3.5 floats a unit: the forward's 28 bytes.

Each launch is queued behind a spin kernel, so the bracket of CUDA events
holds its device time and not the host's launch time. Two passes: ``cold``
writes 128 MB (over twice the L2) before each launch, so that every input
comes from device memory as the bound assumes (``chip_smoke.py`` phase 11
times so); ``interleaved`` does not, so a call may find inputs that the call
before it read still in L2. Every kernel is first held against its plain
version. The card's name and power limit go to stderr. Without CUDA the
script exits 2 and prints no result.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess
import sys

import torch

from mlx_vae_tpu_torch.ops import fused_lstm as fl
from mlx_vae_tpu_torch.ops.build import BUILD, CSRC, nvcc

B, H = 4096, 256
FWD_BATCHES = (4096, 256)  # the forward's timed batches, at H
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, HBM3
SPIN_CYCLES = 2_000_000  # ~1 ms of device spin ahead of each timed launch

ROWS_SRC = r"""
#include "fused_lstm_gates.cu"

// gates_bwd_kernel<4>'s body in a loop over row groups: thread (x, y) of
// block (bx, by) owns units (bx * blockDim.x + x) * 4 .. + 3 of rows
// by * blockDim.y + y + k * gridDim.y * blockDim.y.
__global__ void __launch_bounds__(256) gates_bwd_rows(
    const float* __restrict__ gates, const float* __restrict__ c, const float* __restrict__ dh,
    const float* __restrict__ dc, float* __restrict__ dgates, float* __restrict__ dc_prev,
    int B, int H) {
  using train::sigm;
  const int j = (blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (j >= H) return;
  for (int b = blockIdx.y * blockDim.y + threadIdx.y; b < B; b += gridDim.y * blockDim.y) {
    const size_t g0 = (size_t)b * 4 * H + j, u0 = (size_t)b * H + j;
    const float* src[7] = {gates + g0, gates + g0 + H, gates + g0 + 2 * H, gates + g0 + 3 * H,
                           c + u0, dh + u0, dc + u0};
    float x[7][4], o[5][4];
#pragma unroll
    for (int s = 0; s < 7; ++s)
      *reinterpret_cast<float4*>(x[s]) = __ldg(reinterpret_cast<const float4*>(src[s]));
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float ig = sigm(x[0][k]), fg = sigm(x[1][k]), g = tanhf(x[2][k]),
                  og = sigm(x[3][k]);
      const float tc = tanhf(fg * x[4][k] + ig * g);
      const float dct = x[6][k] + x[5][k] * og * (1.0f - tc * tc);
      o[0][k] = dct * g * ig * (1.0f - ig);
      o[1][k] = dct * x[4][k] * fg * (1.0f - fg);
      o[2][k] = dct * ig * (1.0f - g * g);
      o[3][k] = x[5][k] * tc * og * (1.0f - og);
      o[4][k] = dct * fg;
    }
    float* dst[5] = {dgates + g0, dgates + g0 + H, dgates + g0 + 2 * H, dgates + g0 + 3 * H,
                     dc_prev + u0};
#pragma unroll
    for (int s = 0; s < 5; ++s)
      __stcs(reinterpret_cast<float4*>(dst[s]), *reinterpret_cast<float4*>(o[s]));
  }
}

// gates_fwd_kernel<4, rows> of the port's source, on its own grid.
extern "C" int gates_fwd_rows_launch(const void* gates, const void* c, void* h_out, void* c_out,
                                     int B, int H, int rows, void* stream) {
  if (H % 4 != 0) return (int)cudaErrorInvalidValue;
  const float* g = static_cast<const float*>(gates);
  const float* cc = static_cast<const float*>(c);
  float* h = static_cast<float*>(h_out);
  float* co = static_cast<float*>(c_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 2: return (int)launch_fwd<4, 2>(g, cc, h, co, B, H, s);
    case 4: return (int)launch_fwd<4, 4>(g, cc, h, co, B, H, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// per_sm blocks an SM, each walking an equal share of the row groups.
extern "C" int gates_bwd_rows_launch(const void* gates, const void* c, const void* dh,
                                     const void* dc, void* dgates, void* dc_prev, int B, int H,
                                     int per_sm, void* stream) {
  if (H % 4 != 0) return (int)cudaErrorInvalidValue;
  const int chunks = H / 4;
  const int tx = std::min(256, (chunks + 31) / 32 * 32), ty = 256 / tx;
  const int gx = (chunks + tx - 1) / tx, groups = (B + ty - 1) / ty;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int slots = std::max(1, per_sm * sms / gx);
  const int iters = (groups + slots - 1) / slots;
  const dim3 grid(gx, std::min((groups + iters - 1) / iters, 65535));
  gates_bwd_rows<<<grid, dim3(tx, ty), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gates), static_cast<const float*>(c),
      static_cast<const float*>(dh), static_cast<const float*>(dc), static_cast<float*>(dgates),
      static_cast<float*>(dc_prev), B, H);
  return (int)cudaGetLastError();
}
"""


def l2_scrub() -> torch.Tensor:
    """128 MB on the card: writing it evicts the 50 MB L2."""
    return torch.empty((32 * 1024 * 1024,), device="cuda")


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def build_rows() -> ctypes.CDLL:
    """Build ``ROWS_SRC`` (``nvcc``, as ``ops/build.py`` builds ``csrc/``)."""
    digest = hashlib.sha256(ROWS_SRC.encode() + b"".join(
        (CSRC / n).read_bytes() for n in ("fused_lstm_gates.cu", "train_common.cuh",
                                          "wgmma.cuh")))
    so = BUILD / f"libbench_gates_rows_{digest.hexdigest()[:12]}.so"
    if not so.exists():
        BUILD.mkdir(parents=True, exist_ok=True)
        src = so.with_suffix(".cu")
        src.write_text(ROWS_SRC)
        subprocess.run([nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                        "-shared", "-Xcompiler", "-fPIC", "-I", str(CSRC), "-o", str(so),
                        str(src)], check=True)
    lib = ctypes.CDLL(str(so))
    lib.gates_bwd_rows_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    lib.gates_bwd_rows_launch.restype = ctypes.c_int
    lib.gates_fwd_rows_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    lib.gates_fwd_rows_launch.restype = ctypes.c_int
    return lib


def median_ms(fns: dict, samples: int, scrub=None) -> dict:
    """{name: median device ms of one call of fns[name]}, the calls taken in
    turns ``samples`` times, each bracketed by CUDA events and queued behind
    a write of ``scrub`` (if given: to evict the L2) and a spin kernel
    (``torch.cuda._sleep``), so that the device is still busy while the host
    enqueues the call and the bracket holds its device time alone."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    marks = {k: [] for k in fns}
    for _ in range(samples):
        for k, fn in fns.items():
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            if scrub is not None:
                scrub.zero_()
            torch.cuda._sleep(SPIN_CYCLES)
            start.record()
            fn()
            end.record()
            marks[k].append((start, end))
    torch.cuda.synchronize()
    return {k: statistics.median(s.elapsed_time(e) for s, e in v) for k, v in marks.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--samples", type=int, default=400)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        log("bench_gates: no CUDA device")
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(9)
    gates = torch.randn((B, 4 * H), generator=g, device="cuda")
    c, dh, dc = (torch.randn((B, H), generator=g, device="cuda") for _ in range(3))
    want = fl.gates_bwd_reference(gates, c, dh, dc)
    lib, st = build_rows(), torch.cuda.current_stream().cuda_stream
    dgates, dc_prev = torch.empty_like(gates), torch.empty_like(c)

    def rows(per_sm: int):
        def run():
            rc = lib.gates_bwd_rows_launch(gates.data_ptr(), c.data_ptr(), dh.data_ptr(),
                                           dc.data_ptr(), dgates.data_ptr(), dc_prev.data_ptr(),
                                           B, H, per_sm, st)
            if rc:
                raise RuntimeError(f"gates_bwd_rows_launch: cudaError {rc}")
            return dgates, dc_prev
        return run

    zero = torch.zeros_like(gates)
    _, cy, ws = torch.ops.aten._thnn_fused_lstm_cell(gates, zero, c)
    src, dst = torch.randn((B, 6 * H), generator=g, device="cuda"), torch.empty((B, 6 * H),
                                                                                device="cuda")
    fns = {"kernel": lambda: fl.gates_bwd(gates, c, dh, dc),
           **{f"rows x{n}": rows(n) for n in (1, 2, 4)},
           "aten": lambda: torch.ops.aten._thnn_fused_lstm_cell_backward_impl(
               dh, dc, c, cy, ws, False),
           "copy": lambda: dst.copy_(src)}
    err = {}
    for name in ("kernel", "rows x1", "rows x2", "rows x4"):
        got = fns[name]()
        torch.cuda.synchronize()
        err[name] = max((a - b).abs().max().item() / b.abs().max().item()
                        for a, b in zip(got, want))
        if not err[name] <= 1e-5:
            raise AssertionError(f"{name}: rel err {err[name]:.3e} > 1e-5")
    bound = 48.0 * B * H / HBM_BYTES_PER_S * 1e3
    scrub = l2_scrub()
    med = {}
    for mode, sc in (("cold", scrub), ("interleaved", None)):
        med[mode] = median_ms(fns, args.samples, sc)
        for name, ms in med[mode].items():
            log(f"  backward {mode:11s} {name:8s} median {ms:.5f} ms  "
                f"{48.0 * B * H / ms / 1e9:.3f} TB/s  {bound / ms:.1%} of the bound [{smi}]")
    fwd = {Bf: forward(lib, st, Bf, args.samples, scrub, smi) for Bf in FWD_BATCHES}
    print(json.dumps({"card": smi, "shape": [B, H], "samples": args.samples, "bound_ms": bound,
                      "median_ms": med, "max_rel_err": err,
                      "forward": {f"B={Bf} H={H}": v for Bf, v in fwd.items()}}))
    return 0


def forward(lib, st: int, Bf: int, samples: int, scrub, smi: str) -> dict:
    """The forward's calls (the module docstring) at [Bf, H]: {"bound_ms",
    "median_ms": {mode: {call: ms}}, "max_rel_err"}."""
    g = torch.Generator(device="cuda").manual_seed(Bf)
    gates = torch.randn((Bf, 4 * H), generator=g, device="cuda")
    c = torch.randn((Bf, H), generator=g, device="cuda")
    want = fl.gates_fwd_reference(gates, c)
    h_out, c_out = torch.empty_like(c), torch.empty_like(c)

    def rows(r: int):
        def run():
            rc = lib.gates_fwd_rows_launch(gates.data_ptr(), c.data_ptr(), h_out.data_ptr(),
                                           c_out.data_ptr(), Bf, H, r, st)
            if rc:
                raise RuntimeError(f"gates_fwd_rows_launch: cudaError {rc}")
            return h_out, c_out
        return run

    zero = torch.zeros_like(gates)
    src = torch.randn((Bf * H * 7 // 2,), generator=g, device="cuda")
    dst = torch.empty_like(src)
    fns = {"kernel": lambda: fl.gates_fwd(gates, c), "rows 2": rows(2), "rows 4": rows(4),
           "aten": lambda: torch.ops.aten._thnn_fused_lstm_cell(gates, zero, c),
           "copy": lambda: dst.copy_(src)}
    err = {}
    for name in ("kernel", "rows 2", "rows 4"):
        got = fns[name]()
        torch.cuda.synchronize()
        err[name] = max((a - b).abs().max().item() / b.abs().max().item()
                        for a, b in zip(got, want))
        if not err[name] <= 1e-5:
            raise AssertionError(f"forward {name} at B={Bf}: rel err {err[name]:.3e} > 1e-5")
    bound = 28.0 * Bf * H / HBM_BYTES_PER_S * 1e3
    med = {}
    for mode, sc in (("cold", scrub), ("interleaved", None)):
        med[mode] = median_ms(fns, samples, sc)
        for name, ms in med[mode].items():
            log(f"  forward [{Bf}, {H}] {mode:11s} {name:7s} median {ms:.5f} ms  "
                f"{28.0 * Bf * H / ms / 1e9:.3f} TB/s  {bound / ms:.1%} of the bound [{smi}]")
    return {"bound_ms": bound, "median_ms": med, "max_rel_err": err}

if __name__ == "__main__":
    sys.exit(main())
