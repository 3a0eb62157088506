"""What every traffic kind shares: loading by name, spans, the lagged
metric readback, the profiled stretch and its reduction, and the guard
against JAX in the process."""

from __future__ import annotations

import collections
import importlib.util
import json
import os
import sys
import tempfile
import time
from pathlib import Path
from types import ModuleType

import torch

ROOT = Path(__file__).resolve().parent  # portbench/
CHECKOUT = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mlx_vae_tpu")  # whole top-level module names


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path) -> ModuleType:
    """The Python file ``path`` as a module of its own (a metric's name may
    hold dots, so files are loaded by path, not imported by name)."""
    name = "portbench._loaded." + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Top-level names of loaded modules that this benchmark must not load."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


class Spans:
    """Host seconds spent inside each named span, and (while ``tracing``)
    the same spans as profiler annotations, so device idle gaps can be
    labelled by the span the host was in."""

    def __init__(self):
        self.total = collections.defaultdict(float)
        self.count = collections.Counter()
        self.tracing = False

    def reset(self):
        self.total.clear()
        self.count.clear()

    def __call__(self, name: str):
        return _Span(self, name)


class _Span:
    def __init__(self, spans: Spans, name: str):
        self.spans, self.name, self.rf = spans, name, None

    def __enter__(self):
        if self.spans.tracing:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.spans.total[self.name] += time.perf_counter() - self.t0
        self.spans.count[self.name] += 1
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


class Readback:
    """A step's metrics on their way to the host, as the port's trainer
    reads them: stacked into one f32 tensor, copied to pinned memory
    without blocking, with an event to wait on (on the CPU the tensor
    itself)."""

    def __init__(self, metrics: dict, keys):
        self.keys = list(keys)
        vals = torch.stack([metrics[k].detach().float() for k in self.keys])
        self.event = None
        if vals.device.type == "cuda":
            self.host = torch.empty(vals.shape, dtype=vals.dtype, pin_memory=True)
            self.host.copy_(vals, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = vals

    def get(self) -> dict:
        if self.event is not None:
            self.event.synchronize()
        return {k: float(v) for k, v in zip(self.keys, self.host.tolist())}


class SetupSplit:
    """Logs, on standard error, the seconds each named phase of set-up took
    on the host clock, the device synchronised at each mark."""

    def __init__(self, t_start: float, device):
        self.device = device
        self.t = time.perf_counter()
        log(f"setup: {self.t - t_start:.3f} s to the traffic kind (imports, CUDA context)")

    def __call__(self, phase: str):
        sync(self.device)
        now = time.perf_counter()
        log(f"setup: {now - self.t:.3f} s {phase}")
        self.t = now


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "portbench_window"


def profile_stretch(fn, spans: Spans, device) -> dict:
    """Run ``fn()`` under ``torch.profiler`` and reduce its trace: device
    kernels counted, the union of device operations (``busy_s``) within the
    stretch's wall time (``window_s``), the operations that took the most
    device time, and the longest idle gaps, each labelled by the innermost
    span the host was in at the gap's middle (else ``"host"``)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    spans.tracing = True
    try:
        with profile(activities=acts) as prof:
            with record_function(WINDOW):
                fn()
                sync(device)
    finally:
        spans.tracing = False
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        events = load_json(Path(path)).get("traceEvents", [])
    return reduce_trace(events, set(spans.count))


def reduce_trace(events: list, span_names: set) -> dict:
    """The reduction of :func:`profile_stretch` over chrome-trace events."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in xs if e.get("name") == WINDOW]
    if not win:
        return {"kernels": 0, "busy_s": 0.0, "window_s": 0.0, "device_ops": [], "idle_gaps": []}
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS]
    by_name = collections.defaultdict(float)
    for e in dev:
        by_name[e["name"]] += float(e["dur"]) * 1e-6
    ivals = sorted((max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1))
                   for e in dev)
    merged = []
    for a, b in ivals:
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged) * 1e-6
    opened = [e for e in xs if e.get("name") in span_names and e.get("cat") == "user_annotation"]
    gaps, prev = [], w0
    for a, b in merged + [[w1, w1]]:
        if a > prev:
            mid = 0.5 * (a + prev)
            inside = [e for e in opened
                      if float(e["ts"]) <= mid <= float(e["ts"]) + float(e["dur"])]
            label = max(inside, key=lambda e: float(e["ts"]))["name"] if inside else "host"
            gaps.append([label, (a - prev) * 1e-6])
        prev = max(prev, b)
    gaps.sort(key=lambda g: -g[1])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"kernels": sum(1 for e in dev if e.get("cat") == "kernel"), "busy_s": busy,
            "window_s": (w1 - w0) * 1e-6, "device_ops": [[n, s] for n, s in ops],
            "idle_gaps": gaps[:10]}


def device_record(device, trace: dict = None) -> dict:
    """The result line's ``device``; the memory peak is read now."""
    d = torch.device(device)
    if d.type == "cuda":
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(d), "count": 1,
               "memory_peak_bytes": int(torch.cuda.max_memory_allocated(d))}
    else:
        out = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if trace is not None:
        out["busy_s"], out["window_s"] = trace["busy_s"], trace["window_s"]
    return out


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)
