"""Fused autoregressive sampler: the CUDA kernel, its wrapper and its plain
PyTorch version.

Counterpart of ``mlx_vae_tpu/ops/pallas_decoder.py:pallas_generate``. The
kernel (``csrc/fused_generate.cu``, CUDA C++ for ``sm_90a``) runs the whole
sampling loop in one launch; its design and what bounds it are noted at the
top of that file. ``fused_generate_reference`` below is the same function in
plain torch on the same prepared weights and the same hash-based Gumbel
noise: the CPU tests run it, and ``chip_smoke.py`` holds the kernel against
it on the card.

:func:`fused_generate` takes the plain version only for tensors that lie on
the CPU. On a CUDA tensor it launches the kernel or raises: shapes outside
:func:`fused_generate_supported` raise ``NotImplementedError``, a failed
build or launch raises ``RuntimeError``.

Random numbers are a pure function of (block seed, row in block, step,
vocab index) — ``r24 = mix(mix(key ^ v)) >> 8`` with
``key = mix(mix(mix(seed) ^ row) ^ t)`` and ``mix`` the lowbias32 hash —
so a seed block's tokens depend only on its own seed and temperature
(``block_rows(B) = min(256, B)`` rows share one), wherever it sits in the
batch. The stream is not the TPU's ``prng_random_bits``: JAX <-> port
stochastic comparisons are distributional.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import torch

from mlx_vae_tpu_torch.config import ModelConfig
from mlx_vae_tpu_torch.ops.build import load_library
from mlx_vae_tpu_torch.ops.lstm import combined_weight, lstm_gates
from mlx_vae_tpu_torch.ops.sampling import _check_truncation, truncate_logits_bisect
from mlx_vae_tpu_torch.ops.train_common import MAX_SMEM, MAX_V, NT, RPTS, check

_BB = 256  # rows per seed/temperature block (pallas_decoder._BB)


def block_rows(batch: int) -> int:
    """Rows per seed/temperature block for a given batch — the unit at
    which per-block seeds and temperatures apply."""
    return min(_BB, batch)


# ---- the weights, prepared once per loaded model ----

@dataclass(frozen=True)
class FusedWeights:
    """Decoder weights in the kernel's layout, all on one device.

    ``wcat`` holds every layer's ``[K_l + H, 4H]`` combined weight back to
    back (``K_0 = E + C``, ``K_l = H`` above); ``layers`` are views into it.
    Weight matrices are in the compute dtype, biases in float32.
    """

    cfg: ModelConfig
    emb: torch.Tensor      # [V, E]
    wcat: torch.Tensor     # flat
    layers: tuple          # n views [K_l + H, 4H]
    bias: torch.Tensor     # [n, 4H] f32
    wout: torch.Tensor     # [H, V]
    bout: torch.Tensor     # [V] f32


def prepare_weights(params: dict, cfg: ModelConfig, device) -> FusedWeights:
    """Transpose, cast and stack decoder ``params`` (the ``.npz`` tree, as
    tensors) for :func:`fused_generate`. Do this once per model: it copies
    every weight."""
    wdt = cfg.dtype
    mats = [combined_weight(params[f"lstm_layer_{i}"]).to(device, wdt)
            for i in range(cfg.num_layers)]
    wcat = torch.cat([m.reshape(-1) for m in mats]).contiguous()
    layers, off = [], 0
    for m in mats:
        layers.append(wcat[off:off + m.numel()].view(m.shape))
        off += m.numel()
    return FusedWeights(
        cfg=cfg,
        emb=params["embedding"]["weight"].to(device, wdt).contiguous(),
        wcat=wcat,
        layers=tuple(layers),
        bias=torch.stack([params[f"lstm_layer_{i}"]["bias"]
                          for i in range(cfg.num_layers)]).to(device, torch.float32).contiguous(),
        wout=params["fc_out"]["weight"].T.to(device, wdt).contiguous(),
        bout=params["fc_out"]["bias"].to(device, torch.float32).contiguous(),
    )


# ---- the random stream (identical in csrc/fused_generate.cu) ----

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for int64 ``x`` in [0, 2**32), split into 16-bit
    limbs so no intermediate reaches 2**63."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + (((hi * (c & 0xFFFF)) & 0xFFFF) << 16)) & _M32


def _mix(x: torch.Tensor) -> torch.Tensor:
    """lowbias32: a 32-bit multiply-xorshift bijection."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def gumbel_noise(seeds: torch.Tensor, rows: torch.Tensor, t: int,
                 vocab: int) -> torch.Tensor:
    """``[B, vocab]`` float32 Gumbel noise ``-log(-log(u))`` with
    ``u = r24 * 2**-24 + 1e-12`` for per-row block ``seeds`` and
    ``rows`` (row index within its seed block) at step ``t``."""
    key = _mix(_mix(_mix(seeds.long() & _M32) ^ rows.long()) ^ t)
    v = torch.arange(vocab, device=seeds.device, dtype=torch.int64)
    bits = _mix(_mix(key[:, None] ^ v[None, :]))
    u = (bits >> 8).to(torch.float32) * (1.0 / (1 << 24)) + 1e-12
    return -torch.log(-torch.log(u))


# ---- the plain version ----

@torch.no_grad()
def fused_generate_reference(w: FusedWeights, h0: torch.Tensor,
                             cond: torch.Tensor, seeds: torch.Tensor,
                             temps: torch.Tensor, max_length: int,
                             greedy: bool = False, top_k: int = 0,
                             top_p: float = 1.0,
                             logits_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain-torch twin of the kernel: ``[B, max_length]`` int32 tokens.

    ``h0 [B, H]`` and ``cond [B, C]`` float32, ``seeds [nb]`` int32 and
    ``temps [nb]`` float32 per seed block (``nb = ceil(B / block_rows(B))``).
    ``logits_out``, if given (``[B, V]`` float32), receives the first step's
    scaled logits, before truncation and noise.
    """
    cfg = w.cfg
    wdt = cfg.dtype
    B = h0.shape[0]
    rows = torch.arange(B, device=h0.device)
    blk, rib = rows // block_rows(B), rows % block_rows(B)
    temp = temps.float()[blk].clamp_min(1e-6)[:, None]
    seed = seeds[blk]
    emb = w.emb.float()
    mats = [m.float() for m in w.layers]
    wout = w.wout.float()
    cond = cond.float()
    h = [h0.float()] * cfg.num_layers
    c = [torch.zeros_like(h0, dtype=torch.float32)] * cfg.num_layers
    tok = torch.full((B,), cfg.start_token, dtype=torch.int64, device=h0.device)
    ended = torch.zeros(B, dtype=torch.bool, device=h0.device)
    out = []
    for t in range(max_length):
        x = torch.cat([emb[tok], cond], dim=1)
        for layer in range(cfg.num_layers):
            inp = torch.cat([x, h[layer]], dim=1).to(wdt).float()
            h[layer], c[layer] = lstm_gates(inp @ mats[layer] + w.bias[layer], c[layer])
            x = h[layer]
        scaled = (x.to(wdt).float() @ wout + w.bout) / temp
        if t == 0 and logits_out is not None:
            logits_out.copy_(scaled)
        if not greedy:
            scaled = truncate_logits_bisect(scaled, cfg.vocab_size,
                                            top_k=top_k, top_p=top_p)
            scaled = scaled + gumbel_noise(seed, rib, t, cfg.vocab_size)
        sampled = torch.argmax(scaled, dim=1)
        tok = torch.where(ended, cfg.pad_token, sampled)
        ended = ended | (tok == cfg.end_token)
        out.append(tok)
    return torch.stack(out, dim=1).to(torch.int32)


# ---- the kernel ----

def _cell_layout(H: int):
    """(TJ, TR): threads along hidden units x row groups (csrc: tj/tr)."""
    tj = min(H, NT)
    return tj, NT // tj


def _smem_bytes(cfg: ModelConfig, rows: int) -> int:
    """Shared memory for a tile of ``rows``: xin, double-buffered h, c,
    token and ended flags (csrc: the smem carve-up)."""
    H, n = cfg.hidden_dim, cfg.num_layers
    K0 = cfg.embedding_dim + cfg.num_conditions
    return 4 * (rows * K0 + 3 * n * rows * H) + 8 * rows


def _unsupported_reason(cfg: ModelConfig) -> Optional[str]:
    if not 1 <= cfg.num_layers <= 8:
        return f"num_layers={cfg.num_layers} (kernel takes 1..8)"
    if cfg.compute_dtype not in ("float32", "bfloat16"):
        return f"compute_dtype={cfg.compute_dtype}"
    if not 1 <= cfg.hidden_dim <= 1024:
        return f"hidden_dim={cfg.hidden_dim} (kernel takes 1..1024)"
    if not 1 <= cfg.vocab_size <= MAX_V:
        return f"vocab_size={cfg.vocab_size} (kernel takes 1..{MAX_V})"
    if cfg.reference_zero_state:
        return "reference_zero_state (plain scan sampler only)"
    _, tr = _cell_layout(cfg.hidden_dim)
    if _smem_bytes(cfg, tr) > MAX_SMEM:
        return (f"shared-memory plan: {_smem_bytes(cfg, tr)} B for a "
                f"{tr}-row tile > {MAX_SMEM} B (H={cfg.hidden_dim}, "
                f"E={cfg.embedding_dim}, C={cfg.num_conditions}, "
                f"n={cfg.num_layers})")
    return None


def fused_generate_supported(cfg: ModelConfig) -> bool:
    """Shapes the kernel takes: 1 <= n <= 8 layers, f32 or bf16 weights,
    H <= 1024, V <= 512, and a tile of one row group whose shared memory
    (inputs, double-buffered h and c of every layer) fits one block."""
    return _unsupported_reason(cfg) is None


def _tile_rows(cfg: ModelConfig, rows_per_thread: Optional[int] = None) -> int:
    """Rows per thread block: ``rows_per_thread`` (times the TR row groups)
    if given, else 8 rows per thread where shared memory allows, else the
    next smaller instance.

    The rule comes from ``python3 chip_smoke.py --sweep`` at the default
    model (PERF.md, tile sweep): 8 rows per thread beat 1, 2 and 4 at every
    batch from 256 to 8192, in f32 and bf16, so fewer, fuller blocks win even
    when they leave SMs idle."""
    _, tr = _cell_layout(cfg.hidden_dim)
    if rows_per_thread is not None:
        if rows_per_thread not in RPTS:
            raise ValueError(f"rows_per_thread={rows_per_thread}: the kernel is "
                             f"built for {RPTS}")
        if _smem_bytes(cfg, rows_per_thread * tr) > MAX_SMEM:
            raise ValueError(f"rows_per_thread={rows_per_thread}: "
                             f"{_smem_bytes(cfg, rows_per_thread * tr)} B of shared "
                             f"memory > {MAX_SMEM} B")
        return rows_per_thread * tr
    for rpt in RPTS:
        if _smem_bytes(cfg, rpt * tr) <= MAX_SMEM:
            return rpt * tr
    raise AssertionError("unreachable: the gate admits a one-row-group tile")


def build_library(verbose: bool = False) -> ctypes.CDLL:
    """Build ``csrc/fused_generate.cu`` for sm_90a (once per source content,
    ``ops/build.py``), load it and declare its C interface."""
    lib = load_library("fused_generate", verbose)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fused_generate_launch.argtypes = [p] * 11 + [i] * 10 + [f] + [i] * 7 + [p]
    lib.fused_generate_launch.restype = i
    lib.fused_generate_error_string.argtypes = [i]
    lib.fused_generate_error_string.restype = ctypes.c_char_p
    return lib


def fused_generate(w: FusedWeights, h0: torch.Tensor, cond: torch.Tensor,
                   seeds: torch.Tensor, temps: torch.Tensor, max_length: int,
                   greedy: bool = False, top_k: int = 0,
                   top_p: float = 1.0,
                   logits_out: Optional[torch.Tensor] = None,
                   rows_per_thread: Optional[int] = None) -> torch.Tensor:
    """Sample ``[B, max_length]`` int32 tokens (contract of
    :func:`fused_generate_reference`, ``logits_out`` included). CPU tensors
    run the plain version; CUDA tensors launch the kernel, counted in
    ``fused_generate.launches``. ``rows_per_thread`` overrides the kernel's
    tile rule (:func:`_tile_rows`); the tokens do not depend on it.
    """
    _check_truncation(top_k, top_p)
    if h0.device.type == "cpu":
        if w.cfg.reference_zero_state:
            raise NotImplementedError("reference_zero_state: use the plain "
                                      "scan sampler (models/sampling.py)")
        if rows_per_thread is not None:
            _tile_rows(w.cfg, rows_per_thread)  # same argument check as on CUDA
        return fused_generate_reference(w, h0, cond, seeds, temps, max_length,
                                        greedy=greedy, top_k=top_k, top_p=top_p,
                                        logits_out=logits_out)
    if h0.device.type != "cuda":
        raise ValueError(f"fused_generate: unsupported device {h0.device}")
    cfg = w.cfg
    reason = _unsupported_reason(cfg)
    if reason is not None:
        raise NotImplementedError(f"fused_generate kernel does not take {reason}")
    B, H, C = h0.shape[0], cfg.hidden_dim, cfg.num_conditions
    if B < 1 or max_length < 1:
        raise ValueError(f"fused_generate: need B >= 1 and max_length >= 1, "
                         f"got B={B}, max_length={max_length}")
    dev = h0.device
    nb = -(-B // block_rows(B))
    check(h0, "h0", (B, H), torch.float32, dev)
    check(cond, "cond", (B, C), torch.float32, dev)
    check(seeds, "seeds", (nb,), torch.int32, dev)
    check(temps, "temps", (nb,), torch.float32, dev)
    if logits_out is not None:
        check(logits_out, "logits_out", (B, cfg.vocab_size), torch.float32, dev)
    for name, dtype in (("emb", cfg.dtype), ("wcat", cfg.dtype), ("wout", cfg.dtype),
                        ("bias", torch.float32), ("bout", torch.float32)):
        t = getattr(w, name)
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"weights.{name} must be contiguous {dtype} on {dev} "
                             f"(prepare_weights makes them so)")
    lib = build_library()
    out = torch.empty((B, max_length), dtype=torch.int32, device=dev)
    rows = _tile_rows(cfg, rows_per_thread)
    tj, tr = _cell_layout(H)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fused_generate_launch(
            w.emb.data_ptr(), w.wcat.data_ptr(), w.bias.data_ptr(),
            w.wout.data_ptr(), w.bout.data_ptr(), h0.data_ptr(),
            cond.data_ptr(), seeds.data_ptr(), temps.data_ptr(),
            out.data_ptr(),
            logits_out.data_ptr() if logits_out is not None else None,
            B, max_length, cfg.vocab_size, cfg.embedding_dim, C, H,
            cfg.num_layers, block_rows(B), int(greedy), int(top_k),
            float(top_p), int(cfg.compute_dtype == "bfloat16"),
            rows, tj, tr, cfg.start_token, cfg.end_token, cfg.pad_token,
            stream)
    if rc != 0:
        raise RuntimeError(f"fused_generate launch failed: "
                           f"{lib.fused_generate_error_string(rc).decode()} ({rc})")
    fused_generate.launches += 1
    return out


fused_generate.launches = 0
