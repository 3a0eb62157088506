"""Where a CTA of the tensor-core sampler spends its cycles, on the card.

    python -m mlx_vae_tpu_torch.bench_sampler_stages

Builds a copy of ``csrc/fused_generate.cu`` with ``clock64()`` counters
around the parts of ``tc::gen_tc_kernel`` (thread 0 of CTA 0 adds up each
part's cycles over one call; thread 0 also issues a weight box by TMA each
stage), runs the default model at L=64, T=0.8 in f32 (S=8) and bf16 (S=4)
at B=256 and 8192, and prints one JSON line: each part's cycles per step
and per pipeline stage, beside the call's ms with and without the counters
(CUDA events) and the card's name, power limit and SM clock. The counters
cost a few percent of the call. Nothing of the port uses the copy; the
numbers behind PERF.md's sampler breakdown come from here.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
import tempfile

import torch

# (anchor in csrc/fused_generate.cu, what to put before it, what after it)
_PROBES = [
    ("  cluster_wait();\n  ALine<CH> la, lb2;", "  TC_T(0);\n", "  TC_T(1);\n"),
    ("  auto step = [&](int kt, ALine<CH>& line) {", "  TC_T(2);\n", ""),
    ("    parity ^= 1u << cur;\n", "", "    TC_T(3);\n"),
    ("    const uint32_t sa = ring + cur * slot;\n", "    TC_T(4);\n", ""),
    ("    wg::wait<0>();\n", "    TC_T(5);\n", ""),
    ("    for (int j = 0; j < 32; ++j) acc[j] += part[j];\n",
     "", "    TC_T(6);\n    if (threadIdx.x == 0 && blockIdx.x == 0) tc_clk[15] += 1;\n"),
]
_PARTS = ["TMA prologue", "cluster wait", "phase prologue (A lines 0-1)", "wait for B",
          "__syncthreads", "products and staging", "wait for products, add"]
_HEADER = """
__device__ unsigned long long tc_clk[16];
#define TC_T(i) do { unsigned long long _n = clock64(); \\
  if (threadIdx.x == 0 && blockIdx.x == 0) tc_clk[i] += _n - _tc_t; _tc_t = _n; } while (0)
"""
_EXPORT = """
extern "C" int tc_clock(unsigned long long* host, int reset) {
  unsigned long long z[16] = {0};
  return reset ? (int)cudaMemcpyToSymbol(tc::tc_clk, z, sizeof(z))
               : (int)cudaMemcpyFromSymbol(host, tc::tc_clk, sizeof(z));
}
"""


def instrumented_library(tmp: str) -> ctypes.CDLL:
    """Compile the counted copy of fused_generate.cu and bind it like the
    port's own library."""
    from mlx_vae_tpu_torch.ops import fused_decoder as fd
    from mlx_vae_tpu_torch.ops.build import CSRC, nvcc

    shutil.copytree(CSRC, f"{tmp}/csrc")
    src = open(f"{tmp}/csrc/fused_generate.cu").read()
    src = src.replace("namespace tc {\n", "namespace tc {\n" + _HEADER, 1)
    src = src.replace("  constexpr int P = sizeof(T) == 4 ? 2 : 1;\n  const uint32_t btile",
                      "  unsigned long long _tc_t = clock64();\n  constexpr int P = sizeof(T) == 4 "
                      "? 2 : 1;\n  const uint32_t btile", 1)
    for anchor, before, after in _PROBES:
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once in fused_generate.cu: {anchor!r}")
        src = src.replace(anchor, before + anchor + after)
    open(f"{tmp}/csrc/fused_generate.cu", "w").write(src + _EXPORT)
    so = f"{tmp}/libfused_generate_clock.so"
    subprocess.run([nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-I", f"{tmp}/csrc", "-o", so,
                    f"{tmp}/csrc/fused_generate.cu"], check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    own = fd.build_library()
    for name in ("fused_generate_tc_launch", "fused_generate_error_string"):
        getattr(lib, name).argtypes = getattr(own, name).argtypes
        getattr(lib, name).restype = getattr(own, name).restype
    lib.tc_clock.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


def time_ms(fn, reps: int) -> float:
    """Mean ms of ``reps`` calls after one warm-up call (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_sampler_stages: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from mlx_vae_tpu_torch.config import ModelConfig
    from mlx_vae_tpu_torch.models.decoder import hidden_init_row, init_decoder_params
    from mlx_vae_tpu_torch.ops import fused_decoder as fd

    own = fd.build_library()
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        lib = instrumented_library(tmp)
        for dtype in ("float32", "bfloat16"):
            cfg = ModelConfig(compute_dtype=dtype)
            params = init_decoder_params(torch.Generator().manual_seed(1234), cfg)
            params = {k: {n: t.cuda() for n, t in v.items()} for k, v in params.items()}
            w = fd.prepare_weights(params, cfg, "cuda")
            for B in (256, 8192):
                g = torch.Generator(device="cuda").manual_seed(3)
                z = torch.randn((B, cfg.latent_dim), generator=g, device="cuda")
                cond = torch.randn((B, cfg.num_conditions), generator=g, device="cuda")
                nb = -(-B // fd.block_rows(B))
                seeds = torch.randint(0, 2**31 - 1, (nb,), generator=g, device="cuda",
                                      dtype=torch.int32)
                temps = torch.full((nb,), 0.8, device="cuda")
                h0 = hidden_init_row(params, cfg, z, cond).contiguous()
                run = lambda: fd.fused_generate(w, h0, cond, seeds, temps, 64)  # noqa: E731
                fd.build_library = lambda verbose=False: own  # noqa: E731
                ms = time_ms(run, 5)
                fd.build_library = lambda verbose=False: lib  # noqa: E731
                run()
                torch.cuda.synchronize()
                lib.tc_clock(None, 1)
                ms_counted = time_ms(run, 1)  # one warm-up call and one counted
                clk = (ctypes.c_ulonglong * 16)()
                lib.tc_clock(clk, 0)
                fd.build_library = lambda verbose=False: own  # noqa: E731
                calls, stages = 2, clk[15] / 2
                per_step = {p: clk[i] / calls / 64 for i, p in enumerate(_PARTS)}
                rows.append({"dtype": dtype, "B": B, "S": fd.tc_cluster_size(cfg), "ms": ms,
                             "ms_counted": ms_counted, "stages_per_step": stages / 64,
                             "cycles_per_step": per_step,
                             "cycles_per_stage": {p: per_step[p] * 64 / stages
                                                  for p in _PARTS[3:]}})
                print(f"{dtype} B={B}: {ms:.3f} ms; cycles a step: "
                      + ", ".join(f"{p} {v:.0f}" for p, v in per_step.items()), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "smi": smi("name,power.limit"), "sm_clock": smi("clocks.sm"),
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
