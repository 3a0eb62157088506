"""The step route's bf16 step launches, the library's LSTM step and the L2
read rate, on the card; prints ONE JSON line.

    python -m mlx_vae_tpu_torch.bench_step_launch [--batches 256,2048,8192]
        [--config 1024:4:80] [--tiles 64,192 [--rounds 6]] [--no_l2] [--no_library]

* **Per launch**: one step-route pass (``fused_generate(..., kernel="steps")``,
  L=64, T=0.8, bf16, random weights from seed 0) under ``torch.profiler``
  after a warm-up pass; the step kernels' device times in launch order (any
  kernel whose name starts with ``gen_step``), launch i being layer i % n:
  the median of layer 0's (Kp = E + C and H, each rounded up to 64) and of
  layers 1 to n-1's (Kp = 2H rounded up), beside the pass's time on CUDA
  events (the mean of 3 after the warm-up) and each launch's bound, its
  FLOP over 989 TFLOP/s.
* ``--tiles``: one layer-1..n-1 step launch alone (the C entry
  ``gen_step_launch``, random bf16 rows, h_{t-1} and weights from seed 0)
  at each tile instance (rows a tile, ``64 NC``), in turns: ``--rounds``
  rounds, each timing every
  instance over 20 launches on CUDA events after 3 warm-ups, the order
  reversed every other round; ms a launch, each round's and the median.
* **Library**: one ``torch.lstm_cell`` at I = H, bf16 (two cuBLAS products
  and a pointwise cell), the one PyTorch call that computes what a layer
  1..n-1 launch computes; the mean of 20 calls after 3 warm-ups, CUDA
  events. A yardstick only: the port never calls it.
* **L2**: the read rate a kernel gets from a 16 MB buffer that stays in
  the 50 MB L2 (the size of one scaled layer's weights): (a) every thread
  streams 16-byte ``ld.global.cg`` loads (L1 bypassed), 256 threads a
  block, 1-4 blocks an SM; (b) one thread a block streams 16 KB
  ``cp.async.bulk`` copies into a 4-slot shared ring through mbarriers (the
  copy engine TMA uses), 1-3 blocks an SM, and one block on a quarter, a
  half and all of the SMs (GB/s an SM: whether the rate is the SM's or
  L2's). Each reads the buffer 32 times after a warm-up; bytes over the
  time on CUDA events.
* Whether ``ncu`` is on the PATH.

Without ``--tiles`` the module runs in an older checkout too (copy it
there): it calls only ``fused_generate`` and what that tree's
``ops/fused_decoder.py`` has. The
card's name and power limit are in the line; without CUDA the script exits 2
and prints no result.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess
import sys
import tempfile

import torch

PEAK_BF16 = 989e12
L2_BYTES = 16 << 20
L2_READS = 32

L2_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void l2_ld_kernel(const uint4* buf, long n16, int reps, unsigned* out) {
  uint32_t acc = 0;
  const long stride = (long)gridDim.x * blockDim.x;
  for (int r = 0; r < reps; ++r)
    for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n16; i += stride) {
      uint32_t x, y, z, w;
      asm volatile("ld.global.cg.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(x), "=r"(y), "=r"(z), "=r"(w) : "l"(buf + i));
      acc ^= x ^ y ^ z ^ w;
    }
  if (acc == 0x9e3779b9u) out[0] = acc;  // keeps the loads
}

constexpr int CHUNK = 16384, SLOTS = 4;

__device__ __forceinline__ void wait_bar(uint32_t bar, uint32_t parity) {
  asm volatile("{\n.reg .pred p;\nL2_WAIT:\n"
               "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
               "@!p bra L2_WAIT;\n}\n" :: "r"(bar), "r"(parity) : "memory");
}

__global__ void l2_bulk_kernel(const char* buf, int nchunks, int reps) {
  extern __shared__ __align__(1024) unsigned char ring[];
  __shared__ __align__(8) uint64_t bars[SLOTS];
  if (threadIdx.x != 0) return;
  const uint32_t b0 = (uint32_t)__cvta_generic_to_shared(bars);
  const uint32_t r0 = (uint32_t)__cvta_generic_to_shared(ring);
  for (int s = 0; s < SLOTS; ++s)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(b0 + 8 * s) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  const int mine = (nchunks - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int total = mine * reps;
  for (int j = 0; j < total; ++j) {
    const int s = j % SLOTS;
    if (j >= SLOTS) wait_bar(b0 + 8 * s, ((j / SLOTS) - 1) & 1);
    const char* src = buf + (long)(blockIdx.x + (j % mine) * gridDim.x) * CHUNK;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(b0 + 8 * s), "r"(CHUNK) : "memory");
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
                 "[%0], [%1], %2, [%3];\n"
                 :: "r"(r0 + s * CHUNK), "l"(src), "r"(CHUNK), "r"(b0 + 8 * s) : "memory");
  }
  for (int j = total > SLOTS ? total - SLOTS : 0; j < total; ++j)
    wait_bar(b0 + 8 * (j % SLOTS), (j / SLOTS) & 1);
}

extern "C" int l2_ld(const void* buf, long n16, int reps, int blocks, void* out, void* st) {
  l2_ld_kernel<<<blocks, 256, 0, (cudaStream_t)st>>>((const uint4*)buf, n16, reps,
                                                      (unsigned*)out);
  return (int)cudaGetLastError();
}

extern "C" int l2_bulk(const void* buf, int nchunks, int reps, int blocks, void* st) {
  const int smem = SLOTS * CHUNK;
  cudaError_t e = cudaFuncSetAttribute(l2_bulk_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  l2_bulk_kernel<<<blocks, 32, smem, (cudaStream_t)st>>>((const char*)buf, nchunks, reps);
  return (int)cudaGetLastError();
}
"""


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def _events_ms(fn, reps: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _kernel(name: str) -> str:
    """A kernel's name without its namespaces and arguments."""
    return name.replace("(anonymous namespace)::", "").split("(")[0].split("::")[-1]


def step_kernel_ms(fn, n: int, tries: int = 3) -> dict:
    """The step kernels of one call of ``fn`` under the profiler, in launch
    order: ``{"names", "layer0_ms", "upper_ms", "launches", "step_kernels_ms"}``
    (medians over layer 0's and the other layers' launches; a session in
    which CUPTI recorded no step kernel is traced again, ``tries`` in all)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    steps = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            fn()
            torch.cuda.synchronize()
        steps = sorted((e.time_range.start, e.time_range.elapsed_us() / 1e3, _kernel(e.name))
                       for e in prof.events() if e.device_type == DeviceType.CUDA
                       and _kernel(e.name).startswith("gen_step"))
        if steps:
            break
    if not steps:
        return {"names": [], "layer0_ms": None, "upper_ms": None, "launches": 0}
    ms = [s[1] for s in steps]
    lay0 = sorted(ms[0::n])
    upper = sorted(m for i, m in enumerate(ms) if i % n)
    med = lambda v: v[len(v) // 2] if v else None  # noqa: E731
    return {"names": sorted({s[2] for s in steps}), "layer0_ms": med(lay0),
            "upper_ms": med(upper), "launches": len(ms), "step_kernels_ms": sum(ms)}


def launch_flops(cfg, B: int) -> tuple:
    """(layer 0's, a layer above's) FLOP of one step launch: the gate
    product over the columns that hold weights (E + C + H, or 2H, by 4H)."""
    E, C, H = cfg.embedding_dim, cfg.num_conditions, cfg.hidden_dim
    return 2.0 * B * (E + C + H) * 4 * H, 2.0 * B * 2 * H * 4 * H


def launches(spec: str, batches, smi: str) -> list:
    from mlx_vae_tpu_torch.bench_sampler_routes import inputs, model, parse_config
    from mlx_vae_tpu_torch.ops import fused_decoder as fd

    cfg = parse_config(spec, "bfloat16")
    params, w = model(cfg, 0, ["steps"])
    n, out = cfg.num_layers, []
    for B in batches:
        args = inputs(cfg, params, B, 0.8, B) + (64,)
        fn = lambda: fd.fused_generate(w, *args, kernel="steps")  # noqa: E731
        fn()
        torch.cuda.synchronize()
        pass_ms = _events_ms(fn, 3)
        rec = step_kernel_ms(fn, n)
        f0, fu = launch_flops(cfg, B)
        rec.update(config=spec, B=B, pass_ms=pass_ms,
                   layer0_bound_ms=f0 / PEAK_BF16 * 1e3, upper_bound_ms=fu / PEAK_BF16 * 1e3)
        out.append(rec)
        print(f"  {spec} bf16 B={B}: pass {pass_ms:.3f} ms; step launch layer 0 "
              f"{rec['layer0_ms']} ms, layers 1-{n - 1} {rec['upper_ms']} ms (bounds "
              f"{rec['layer0_bound_ms']:.4f} / {rec['upper_bound_ms']:.4f}); {rec['names']} "
              f"[{smi}]", flush=True)
    return out


def tile_ms(spec: str, batches, tiles, rounds: int, smi: str) -> list:
    """``--tiles`` (the docstring): ms a layer-1..n-1 launch by tile
    instance, in turns."""
    from mlx_vae_tpu_torch.bench_sampler_routes import parse_config
    from mlx_vae_tpu_torch.ops import fused_decoder as fd

    cfg = parse_config(spec, "bfloat16")
    H = cfg.hidden_dim
    _, kp, np_ = fd.fwd_step_plan(H, H, 0)
    lib = fd.build_steps_library()
    g = torch.Generator(device="cuda").manual_seed(0)
    rnd = lambda *s: torch.randn(s, generator=g, device="cuda")  # noqa: E731
    wt, bias = (0.03 * rnd(np_, kp)).bfloat16(), 0.1 * rnd(4 * H)
    st = torch.cuda.current_stream().cuda_stream
    out = []
    for B in batches:
        x, hprev, c_in = (0.5 * rnd(B, H)).bfloat16(), (0.5 * rnd(B, H)).bfloat16(), rnd(B, H)
        c_out, hs = torch.empty_like(c_in), torch.empty_like(hprev)

        def launch(tile):
            rc = lib.gen_step_launch(x.data_ptr(), None, 1, cfg.vocab_size, None,
                                     hprev.data_ptr(), c_in.data_ptr(), c_out.data_ptr(),
                                     wt.data_ptr(), bias.data_ptr(), hs.data_ptr(), B, H, H, 0,
                                     tile // 64, st)
            if rc != 0:
                raise RuntimeError(f"gen_step_launch {tile}: {lib.gen_steps_error_string(rc)}")

        by = {t: [] for t in tiles}
        for r in range(rounds):
            for t in (tiles if r % 2 == 0 else tiles[::-1]):
                for _ in range(3):
                    launch(t)
                by[t].append(_events_ms(lambda t=t: launch(t), 20))
        for t in tiles:
            rec = dict(config=spec, B=B, rows=t, ms=by[t], median_ms=statistics.median(by[t]))
            out.append(rec)
            print(f"  {spec} bf16 B={B} one layer-1..{cfg.num_layers - 1} launch, {t} rows a "
                  f"tile: median {rec['median_ms']:.4f} ms of {rounds} rounds in turns "
                  f"{[round(v, 4) for v in by[t]]} [{smi}]", flush=True)
    return out


def library_ms(H: int, batches, smi: str) -> dict:
    """``torch.lstm_cell`` bf16 at I = H, ms a call by batch."""
    out = {}
    for B in batches:
        g = torch.Generator(device="cuda").manual_seed(B)
        mk = lambda *s: (0.05 * torch.randn(s, generator=g, device="cuda")).bfloat16()  # noqa
        x, h, c = mk(B, H), mk(B, H), mk(B, H)
        w_ih, w_hh, b_ih, b_hh = mk(4 * H, H), mk(4 * H, H), mk(4 * H), mk(4 * H)
        fn = lambda: torch.lstm_cell(x, (h, c), w_ih, w_hh, b_ih, b_hh)  # noqa: E731
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        out[B] = _events_ms(fn, 20)
        print(f"  torch.lstm_cell bf16 I=H={H} B={B}: {out[B]:.4f} ms [{smi}]", flush=True)
    return out


def l2_rate(smi: str) -> dict:
    """(a) and (b) of the docstring: TB/s by blocks an SM."""
    from mlx_vae_tpu_torch.ops.build import nvcc

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    with tempfile.TemporaryDirectory() as tmp:
        src, lib = f"{tmp}/l2.cu", f"{tmp}/libl2.so"
        with open(src, "w") as f:
            f.write(L2_SRC)
        subprocess.run([nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                        "-shared", "-Xcompiler", "-fPIC", "-o", lib, src], check=True)
        so = ctypes.CDLL(lib)
        p, i, lg = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
        so.l2_ld.argtypes = [p, lg, i, i, p, p]
        so.l2_bulk.argtypes = [p, i, i, i, p]
        buf = torch.randint(0, 255, (L2_BYTES,), dtype=torch.uint8, device="cuda")
        sink = torch.zeros(1, dtype=torch.int32, device="cuda")
        st = torch.cuda.current_stream().cuda_stream
        out = {"ld_cg": {}, "bulk": {}, "bulk_per_sm_by_blocks": {}}
        for per_sm in (1, 2, 4):
            def ld(reps=L2_READS, blocks=per_sm * sms):
                rc = so.l2_ld(buf.data_ptr(), L2_BYTES // 16, reps, blocks, sink.data_ptr(), st)
                assert rc == 0, rc
            ld(1)
            ms = min(_events_ms(ld, 1) for _ in range(3))
            out["ld_cg"][per_sm] = L2_BYTES * L2_READS / ms / 1e9
        for per_sm in (1, 2, 3):
            def bulk(reps=L2_READS, blocks=per_sm * sms):
                rc = so.l2_bulk(buf.data_ptr(), L2_BYTES // 16384, reps, blocks, st)
                assert rc == 0, rc
            bulk(1)
            ms = min(_events_ms(bulk, 1) for _ in range(3))
            out["bulk"][per_sm] = L2_BYTES * L2_READS / ms / 1e9
        for blocks in (sms // 4, sms // 2, sms):  # one block an SM on a part of the SMs
            def part(reps=L2_READS, blocks=blocks):
                rc = so.l2_bulk(buf.data_ptr(), L2_BYTES // 16384, reps, blocks, st)
                assert rc == 0, rc
            part(1)
            ms = min(_events_ms(part, 1) for _ in range(3))
            out["bulk_per_sm_by_blocks"][blocks] = L2_BYTES * L2_READS / ms / 1e6 / blocks
        print(f"  L2 read rate from a 16 MB resident buffer, TB/s by blocks an SM: 16-byte "
              f"ld.global.cg {out['ld_cg']}, 16 KB cp.async.bulk {out['bulk']}; bulk GB/s an SM "
              f"with that many blocks at work: {out['bulk_per_sm_by_blocks']} [{smi}]",
              flush=True)
    return out


def parse_tiles(spec: str):
    return [int(t) for t in spec.split(",")] if spec else []


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="1024:4:80")
    ap.add_argument("--batches", default="256,2048,8192")
    ap.add_argument("--tiles", default="", help="rows a tile (64,192) timed in turns")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--no_l2", action="store_true")
    ap.add_argument("--no_library", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_step_launch: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = smi_line()
    batches = [int(b) for b in args.batches.split(",")]
    rec = {"smi": smi, "ncu": shutil.which("ncu"),
           "launches": launches(args.config, batches, smi)}
    if args.tiles:
        rec["tiles"] = tile_ms(args.config, batches, parse_tiles(args.tiles), args.rounds, smi)
    if not args.no_library:
        rec["library_ms"] = library_ms(int(args.config.split(":")[0]), batches, smi)
    if not args.no_l2:
        rec["l2_tb_s"] = l2_rate(smi)
    print(json.dumps({"step_launch": rec}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
