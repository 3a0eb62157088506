"""Fused autoregressive sampler: the CUDA kernels, their wrapper and their
plain PyTorch versions.

Counterpart of ``mlx_vae_tpu/ops/pallas_decoder.py:pallas_generate``. Two
kernels of ``csrc/fused_generate.cu`` (CUDA C++ for ``sm_90a``) run the whole
sampling loop in one launch each; their designs and what bounds them are
noted at the top of that file:

* ``gen_tc_kernel`` (the tensor-core route): a cluster of S CTAs a 64-row
  tile, gate columns split over the cluster, ``wgmma`` products (split-TF32
  in f32). It takes every config :func:`fused_generate_tc_supported` admits
  (the default model in f32 and bf16).
* ``fused_generate_kernel`` (the CUDA-core route): every other config that
  :func:`fused_generate_supported` admits.

The route depends on the config alone, never on the batch, and is decided
before any launch (:func:`fused_generate_route`).
``fused_generate_reference`` below is the function in plain torch on the
same prepared weights and the same hash-based Gumbel noise: the CPU tests
run it, and ``chip_smoke.py`` holds both kernels against it on the card.
``fused_generate_split_reference`` is the tensor-core kernel's layout twin:
its interleaved operands, its per-CTA column slices and its 3-term product.

:func:`fused_generate` takes the plain version only for tensors that lie on
the CPU. On a CUDA tensor it launches a kernel or raises: shapes outside
:func:`fused_generate_supported` (or, with the tensor-core kernel forced,
outside :func:`fused_generate_tc_supported`) raise ``NotImplementedError``,
a failed build or launch raises ``RuntimeError``.

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
import threading
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from mlx_vae_tpu_torch.config import ModelConfig
from mlx_vae_tpu_torch.ops.build import load_library
from mlx_vae_tpu_torch.ops.lstm import combined_weight, lstm_gates
from mlx_vae_tpu_torch.ops.sampling import _check_truncation, truncate_logits_bisect
from mlx_vae_tpu_torch.ops.train_common import (  # noqa: F401 (re-exported)
    MAX_SMEM, MAX_V, NT, RPTS, _tf32_rna, check, tf32_split)

KERNELS = ("tc", "cuda_core")  # the sampler's two routes

_BB = 256  # rows per seed/temperature block (pallas_decoder._BB)


def block_rows(batch: int) -> int:
    """Rows per seed/temperature block for a given batch — the unit at
    which per-block seeds and temperatures apply."""
    return min(_BB, batch)


# ---- the tensor-core kernel's plan (csrc/fused_generate.cu, namespace tc) ----

TC_ROWS = 64         # rows of a tile: one wgmma M (tc::ROWS)
TC_UNITS_WG = 16     # hidden units of one warpgroup: 64 gate columns (tc::UNITS_WG)
TC_STAGES = 3        # depth of the operand ring (tc::STAGES)
TC_PLANE = 64 * 128  # bytes of one operand plane: 64 swizzled 128-byte lines
TC_PAD = 8           # elements past a CTA's units in a row of its h and c (tc::PAD)
TC_CLUSTERS = (1, 2, 4, 8, 16)  # cluster sizes the launch takes (16: non-portable)


def _tc_depth(cfg: ModelConfig) -> int:
    """Reduction depth of one stage: one 128-byte line of bf16 or f32."""
    return 64 if cfg.compute_dtype == "bfloat16" else 32


def _tc_pads(cfg: ModelConfig) -> Tuple[int, int]:
    """(Xp, Hp): the step input's columns E + C and the hidden width H,
    each rounded up to a stage's depth (the segments of layer 0's reduction
    are [x | 0 | h | 0], of the others [h_below | 0 | h | 0])."""
    kc = _tc_depth(cfg)
    return (-(-(cfg.embedding_dim + cfg.num_conditions) // kc) * kc,
            -(-cfg.hidden_dim // kc) * kc)


def _tc_head_tiles(cfg: ModelConfig, S: int) -> int:
    """Warpgroups of a CTA at cluster size S, one 64-column head tile each:
    the larger of its gate tiles (16 units each) and ceil(V / 64), rounded up
    to 1, 2 or 4 (the kernel's instances)."""
    w = max(cfg.hidden_dim // S // TC_UNITS_WG, -(-cfg.vocab_size // 64))
    return 4 if w == 3 else w


def _tc_smem_bytes(cfg: ModelConfig, S: int) -> int:
    """Shared memory of one CTA at cluster size S (csrc: tc::plan)."""
    H, n, V = cfg.hidden_dim, cfg.num_layers, cfg.vocab_size
    es = 2 if cfg.compute_dtype == "bfloat16" else 4
    uc = H // S
    slot = TC_PLANE * (2 if es == 4 else 1) * (1 + _tc_head_tiles(cfg, S))
    ring = TC_STAGES * slot
    logits = TC_ROWS * (-(-V // 4) * 4 + 4) * 4  # in the ring where they fit
    up = uc + TC_PAD  # row pitch of own h and c
    return (ring + 2 * n * TC_ROWS * up * es + n * TC_ROWS * up * 4 + n * 4 * uc * 4
            + 2 * TC_ROWS * 4 + 8 * TC_STAGES + (logits if logits > ring else 0) + 1024)


def tc_clusters(cfg: ModelConfig) -> Tuple[int, ...]:
    """Cluster sizes S the tensor-core kernel takes for ``cfg``: each CTA
    owns H / S units, a power of two, 16 to a 64-column gate tile; its
    warpgroups (:func:`_tc_head_tiles`, at most 4, so V <= 256) cover its
    gate tiles and the head's; S divides the 64 rows (the sampling share);
    and the CTA's shared memory (:func:`_tc_smem_bytes`) fits."""
    H = cfg.hidden_dim
    out = []
    for S in TC_CLUSTERS:
        uc = H // S
        if H % (S * TC_UNITS_WG) or uc & (uc - 1) or TC_ROWS % S:
            continue
        if _tc_head_tiles(cfg, S) > 4 or _tc_smem_bytes(cfg, S) > MAX_SMEM:
            continue
        out.append(S)
    return tuple(out)


def _tc_unsupported_reason(cfg: ModelConfig) -> Optional[str]:
    reason = _unsupported_reason(cfg)
    if reason is not None:
        return reason
    if not tc_clusters(cfg):
        return (f"no cluster size fits the tensor-core sampler (H={cfg.hidden_dim} must be "
                f"S times a power of two >= 16 units, at most 4 warpgroups a CTA "
                f"(V={cfg.vocab_size} <= 256), and a CTA's shared memory within {MAX_SMEM} B; "
                f"compute_dtype={cfg.compute_dtype}, n={cfg.num_layers})")
    return None


def fused_generate_tc_supported(cfg: ModelConfig) -> bool:
    """Configs the tensor-core sampler takes: those of
    :func:`fused_generate_supported` for which some cluster size fits
    (:func:`tc_clusters`). It depends on the config alone, so every batch
    size takes the same route. The default model (H=256, V=80, n=2) takes
    S = 8 and 16 in f32, S = 4, 8 and 16 in bf16."""
    return _tc_unsupported_reason(cfg) is None


# ---- the weights, prepared once per loaded model ----

def tc_gate_rows(H: int, device=None) -> torch.Tensor:
    """``[4H]``: the row of the tensor-core kernel's weight copy that holds
    gate-major column ``q * H + u``: ``64 (u // 16) + 32 ((u % 16) // 8) + 8 q
    + u % 8``, so one m64n64 accumulator fragment holds i, f, g and o of the
    same (row, unit) pairs, and CTA r of a cluster of S owns rows ``[4 H r /
    S, 4 H (r + 1) / S)`` (units ``[H r / S, H (r + 1) / S)``)."""
    u = torch.arange(H, device=device)
    base = 64 * (u // 16) + 32 * ((u % 16) // 8) + u % 8
    return torch.cat([base + 8 * q for q in range(4)])


def tc_reduction_cols(k_in: int, H: int, xp: int, device=None) -> torch.Tensor:
    """The reduction columns of a layer's weight copy that hold its combined
    weight's rows ``[input (k_in), h (H)]``: the input from 0, h from ``xp``
    (the input segment padded to a stage's depth)."""
    return torch.cat([torch.arange(k_in, device=device), xp + torch.arange(H, device=device)])


@dataclass(frozen=True)
class TcWeights:
    """The tensor-core kernel's operands: per layer a K-major ``[4H, Kp_l]``
    copy of the combined weight, rows in :func:`tc_gate_rows` order,
    reduction columns ``[input | 0 | h | 0]`` (``Kp_0 = Xp + Hp``, ``Kp_l =
    2 Hp``); the head ``fc_out`` as a K-major ``[64 T, Hp]`` copy, rows >= V
    zero (T = ceil(V / 64) rounded up to 4 tiles). bf16: one plane; f32: the
    TF32 ``hi`` and ``lo`` planes (:func:`tf32_split`)."""

    xp: int
    hp: int
    w: torch.Tensor                  # flat: the layers back to back (bf16, or hi)
    wlo: Optional[torch.Tensor]      # f32: the lo plane, same layout
    layers: tuple                    # views [4H, Kp_l] of w
    layers_lo: tuple                 # views of wlo (f32), else ()
    wout: torch.Tensor               # [64 T, Hp]
    wout_lo: Optional[torch.Tensor]


@dataclass(frozen=True)
class FusedWeights:
    """Decoder weights in the kernels' layouts, all on one device.

    ``wcat`` holds every layer's ``[K_l + H, 4H]`` combined weight back to
    back (``K_0 = E + C``, ``K_l = H`` above); ``layers`` are views into it.
    Weight matrices are in the compute dtype, biases in float32. ``tc`` holds
    the tensor-core kernel's operands where it takes the config, else None.
    """

    cfg: ModelConfig
    emb: torch.Tensor      # [V, E]
    wcat: torch.Tensor     # flat
    layers: tuple          # n views [K_l + H, 4H]
    bias: torch.Tensor     # [n, 4H] f32
    wout: torch.Tensor     # [H, V]
    bout: torch.Tensor     # [V] f32
    tc: Optional[TcWeights] = None


def _flat_views(mats):
    flat = torch.cat([m.reshape(-1) for m in mats]).contiguous()
    views, off = [], 0
    for m in mats:
        views.append(flat[off:off + m.numel()].view(m.shape))
        off += m.numel()
    return flat, tuple(views)


def prepare_tc_weights(mats, wout: torch.Tensor, cfg: ModelConfig) -> TcWeights:
    """The tensor-core kernel's operands (:class:`TcWeights`) from the
    combined weights ``mats`` ``[K_l + H, 4H]`` and ``wout`` ``[H, V]``."""
    H, V = cfg.hidden_dim, cfg.vocab_size
    xp, hp = _tc_pads(cfg)
    dev = wout.device
    rows = tc_gate_rows(H, dev)
    out = []
    for i, m in enumerate(mats):
        k_in = m.shape[0] - H
        kb = xp if i == 0 else hp
        wt = torch.zeros((4 * H, kb + hp), dtype=torch.float32, device=dev)
        wt[rows[:, None], tc_reduction_cols(k_in, H, kb, dev)[None]] = m.float().T
        out.append(wt)
    head = torch.zeros((64 * (-(-(-(-V // 64)) // 4) * 4), hp), dtype=torch.float32,
                       device=dev)
    head[:V, :H] = wout.float().T
    if cfg.compute_dtype == "bfloat16":
        w, layers = _flat_views([t.to(torch.bfloat16) for t in out])
        return TcWeights(xp, hp, w, None, layers, (), head.to(torch.bfloat16).contiguous(),
                         None)
    split = [tf32_split(t) for t in out]
    w, layers = _flat_views([hi for hi, _ in split])
    wlo, layers_lo = _flat_views([lo for _, lo in split])
    hh, hl = tf32_split(head)
    return TcWeights(xp, hp, w, wlo, layers, layers_lo, hh.contiguous(), hl.contiguous())


def prepare_weights(params: dict, cfg: ModelConfig, device) -> FusedWeights:
    """Transpose, cast and stack decoder ``params`` (the ``.npz`` tree, as
    tensors) for :func:`fused_generate`, with the tensor-core kernel's
    operands where it takes the config. Do this once per model: it copies
    every weight."""
    wdt = cfg.dtype
    mats = [combined_weight(params[f"lstm_layer_{i}"]).to(device, wdt)
            for i in range(cfg.num_layers)]
    wcat, layers = _flat_views(mats)
    wout = params["fc_out"]["weight"].T.to(device, wdt).contiguous()
    return FusedWeights(
        cfg=cfg,
        emb=params["embedding"]["weight"].to(device, wdt).contiguous(),
        wcat=wcat,
        layers=layers,
        bias=torch.stack([params[f"lstm_layer_{i}"]["bias"]
                          for i in range(cfg.num_layers)]).to(device, torch.float32).contiguous(),
        wout=wout,
        bout=params["fc_out"]["bias"].to(device, torch.float32).contiguous(),
        tc=prepare_tc_weights(mats, wout, cfg) if fused_generate_tc_supported(cfg) else None,
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


def _ordered_product(a, w, ks) -> torch.Tensor:
    """``[B, N]`` sums over the reduction columns ``ks`` of the planes'
    products in a fixed order, one rank-1 update at a time, so that a
    column's value depends only on its own weights (never on N, on the other
    columns, or on how a library blocks a matmul). ``a`` and ``w`` are tuples
    of planes ``[B, K]`` and ``[N, K]``: one plane each (bf16 operands) or
    ``(hi, lo)`` (split-TF32: per k, ``hi*hi``, then ``hi*lo``, then
    ``lo*hi``). ``ks`` leaves out the padding, whose products are zeros."""
    acc = torch.zeros((a[0].shape[0], w[0].shape[0]), dtype=torch.float32,
                      device=a[0].device)
    terms = [(0, 0)] if len(a) == 1 else [(0, 0), (0, 1), (1, 0)]
    for k in ks:
        for i, j in terms:
            acc = acc + a[i][:, k:k + 1] * w[j][None, :, k]
    return acc


@torch.no_grad()
def fused_generate_split_reference(w: FusedWeights, h0: torch.Tensor,
                                   cond: torch.Tensor, seeds: torch.Tensor,
                                   temps: torch.Tensor, max_length: int,
                                   greedy: bool = False, top_k: int = 0,
                                   top_p: float = 1.0,
                                   logits_out: Optional[torch.Tensor] = None,
                                   cluster: int = 1) -> torch.Tensor:
    """Layout twin of the tensor-core kernel (the contract of
    :func:`fused_generate_reference`): the gates come from ``w.tc``'s
    interleaved K-major operands, CTA by CTA of a cluster of ``cluster``
    (each its ``4 H / cluster`` rows), as the kernel's 3-term split-TF32
    product in f32 (A split by :func:`tf32_split`, as the kernel's staging
    does) or its bf16 product, summed in a fixed order
    (:func:`_ordered_product`); the head from ``w.tc.wout``. The cell, the
    truncation and the noise are the plain version's. Its tokens are bitwise
    the same for every cluster size."""
    cfg, tc = w.cfg, w.tc
    if tc is None:
        raise NotImplementedError(f"fused_generate_split_reference: the tensor-core sampler "
                                  f"does not take {_tc_unsupported_reason(cfg)}")
    H, n, V = cfg.hidden_dim, cfg.num_layers, cfg.vocab_size
    if H % (cluster * TC_UNITS_WG):
        raise ValueError(f"cluster={cluster}: H={H} is not {TC_UNITS_WG} units a CTA "
                         f"times a whole number")
    wdt = cfg.dtype
    bf16 = cfg.compute_dtype == "bfloat16"
    B = h0.shape[0]
    dev = h0.device
    rows = torch.arange(B, device=dev)
    blk, rib = rows // block_rows(B), rows % block_rows(B)
    temp = temps.float()[blk].clamp_min(1e-6)[:, None]
    seed = seeds[blk]
    gate_cols = tc_gate_rows(H, dev)
    nc = 4 * H // cluster

    def operand(x: torch.Tensor, width: int):
        x = torch.nn.functional.pad(x.float(), (0, width - x.shape[1]))
        return (x.to(wdt).float(),) if bf16 else tf32_split(x)

    def planes(i, rows_):
        lo = () if bf16 else (tc.layers_lo[i][rows_].float(),)
        return (tc.layers[i][rows_].float(),) + lo

    emb = w.emb.float()
    cond = cond.float()
    h = [h0.float()] * n
    c = [torch.zeros_like(h0, dtype=torch.float32)] * n
    tok = torch.full((B,), cfg.start_token, dtype=torch.int64, device=dev)
    ended = torch.zeros(B, dtype=torch.bool, device=dev)
    head_w = (tc.wout.float(),) if bf16 else (tc.wout.float(), tc.wout_lo.float())
    out = []
    for t in range(max_length):
        x = torch.cat([emb[tok], cond], dim=1)
        for layer in range(n):
            a = tuple(torch.cat([p, q], dim=1) for p, q in
                      zip(operand(x, tc.xp if layer == 0 else tc.hp), operand(h[layer], tc.hp)))
            ks = tc_reduction_cols(x.shape[1], H, a[0].shape[1] - tc.hp).tolist()
            gates = torch.cat([_ordered_product(a, planes(layer, slice(r * nc, (r + 1) * nc)), ks)
                               for r in range(cluster)], dim=1)
            h[layer], c[layer] = lstm_gates(gates[:, gate_cols] + w.bias[layer], c[layer])
            x = h[layer]
        logits = _ordered_product(operand(x, tc.hp), tuple(p[:V] for p in head_w), range(H))
        scaled = (logits + w.bout) / temp
        if t == 0 and logits_out is not None:
            logits_out.copy_(scaled)
        if not greedy:
            scaled = truncate_logits_bisect(scaled, V, top_k=top_k, top_p=top_p)
            scaled = scaled + gumbel_noise(seed, rib, t, V)
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
    lib.fused_generate_tc_launch.argtypes = [p] * 13 + [i] * 10 + [f] + [i] * 8 + [p]
    lib.fused_generate_tc_launch.restype = i
    lib.fused_generate_tc_smem.argtypes = [i] * 6
    lib.fused_generate_tc_smem.restype = i
    lib.fused_generate_error_string.argtypes = [i]
    lib.fused_generate_error_string.restype = ctypes.c_char_p
    return lib


def fused_generate_route(cfg: ModelConfig, kernel: Optional[str] = None,
                         rows_per_thread: Optional[int] = None,
                         cluster: Optional[int] = None) -> str:
    """The kernel :func:`fused_generate` launches for ``cfg``: ``"tc"`` where
    :func:`fused_generate_tc_supported` holds, else ``"cuda_core"``, from
    the config alone. ``kernel`` forces one (``rows_per_thread`` implies the
    CUDA-core kernel, ``cluster`` the tensor-core one); forcing ``"tc"`` on
    a config it does not take raises ``NotImplementedError``."""
    if kernel is None:
        if rows_per_thread is not None:
            kernel = "cuda_core"
        elif cluster is not None or fused_generate_tc_supported(cfg):
            kernel = "tc"
        else:
            kernel = "cuda_core"
    if kernel not in KERNELS:
        raise ValueError(f"kernel={kernel!r}: one of {KERNELS}")
    if kernel == "tc":
        if rows_per_thread is not None:
            raise ValueError("rows_per_thread applies to the CUDA-core kernel only")
        reason = _tc_unsupported_reason(cfg)
        if reason is not None:
            raise NotImplementedError(f"the tensor-core sampler does not take {reason}")
        if cluster is not None and cluster not in tc_clusters(cfg):
            raise ValueError(f"cluster={cluster}: the tensor-core sampler takes "
                             f"{tc_clusters(cfg)} for this config")
    elif cluster is not None:
        raise ValueError("cluster applies to the tensor-core kernel only")
    return kernel


def tc_cluster_size(cfg: ModelConfig) -> int:
    """The cluster size S of a launch: the smallest of :func:`tc_clusters`,
    at every batch size. A step costs each CTA about the same whatever its share
    of the columns (its time goes to a fixed number of pipeline stages and
    cluster barriers), so the fewest CTAs a tile do the work in the fewest
    CTA-steps. ``python3 chip_smoke.py --sweep`` times every S at B = 256 /
    2048 / 8192 (PERF.md): this S was the fastest or within 4% of it. The
    tokens do not depend on S."""
    return tc_clusters(cfg)[0]


def fused_generate(w: FusedWeights, h0: torch.Tensor, cond: torch.Tensor,
                   seeds: torch.Tensor, temps: torch.Tensor, max_length: int,
                   greedy: bool = False, top_k: int = 0,
                   top_p: float = 1.0,
                   logits_out: Optional[torch.Tensor] = None,
                   rows_per_thread: Optional[int] = None,
                   kernel: Optional[str] = None,
                   cluster: Optional[int] = None) -> torch.Tensor:
    """Sample ``[B, max_length]`` int32 tokens (contract of
    :func:`fused_generate_reference`, ``logits_out`` included). CPU tensors
    run the plain version; CUDA tensors launch the kernel
    :func:`fused_generate_route` picks from the config, counted in
    ``fused_generate.launches`` and in ``fused_generate.tc_launches`` or
    ``fused_generate.core_launches``. ``kernel`` forces a kernel,
    ``rows_per_thread`` the CUDA-core kernel's tile (:func:`_tile_rows`),
    ``cluster`` the tensor-core kernel's cluster size
    (:func:`tc_cluster_size`); the tokens depend on none of them.
    """
    _check_truncation(top_k, top_p)
    route = fused_generate_route(w.cfg, kernel, rows_per_thread, cluster)
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
    l0 = logits_out.data_ptr() if logits_out is not None else None
    common = (B, max_length, cfg.vocab_size, cfg.embedding_dim, C, H, cfg.num_layers,
              block_rows(B), int(greedy), int(top_k), float(top_p),
              int(cfg.compute_dtype == "bfloat16"))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if route == "tc":
            tc = w.tc
            for name in ("w", "wlo", "wout", "wout_lo"):
                t = getattr(tc, name)
                if t is not None and (t.device != dev or not t.is_contiguous()):
                    raise ValueError(f"weights.tc.{name} must be contiguous on {dev} "
                                     f"(prepare_weights makes them so)")
            S = cluster if cluster is not None else tc_cluster_size(cfg)
            ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
            rc = lib.fused_generate_tc_launch(
                w.emb.data_ptr(), cond.data_ptr(), h0.data_ptr(), tc.w.data_ptr(),
                ptr(tc.wlo), tc.wout.data_ptr(), ptr(tc.wout_lo), w.bias.data_ptr(),
                w.bout.data_ptr(), seeds.data_ptr(), temps.data_ptr(), out.data_ptr(), l0,
                *common, S, tc.xp, tc.hp, _tc_head_tiles(cfg, S), cfg.start_token,
                cfg.end_token, cfg.pad_token, stream)
        else:
            tj, tr = _cell_layout(H)
            rc = lib.fused_generate_launch(
                w.emb.data_ptr(), w.wcat.data_ptr(), w.bias.data_ptr(),
                w.wout.data_ptr(), w.bout.data_ptr(), h0.data_ptr(),
                cond.data_ptr(), seeds.data_ptr(), temps.data_ptr(),
                out.data_ptr(), l0, *common, _tile_rows(cfg, rows_per_thread), tj, tr,
                cfg.start_token, cfg.end_token, cfg.pad_token, stream)
    if rc != 0:
        raise RuntimeError(f"fused_generate ({route}) launch failed: "
                           f"{lib.fused_generate_error_string(rc).decode()} ({rc})")
    with _count_lock:  # a server's warm-up thread and dispatcher both launch
        fused_generate.launches += 1
        if route == "tc":
            fused_generate.tc_launches += 1
        else:
            fused_generate.core_launches += 1
    return out


_count_lock = threading.Lock()
fused_generate.launches = 0       # every launch
fused_generate.tc_launches = 0    # gen_tc_kernel
fused_generate.core_launches = 0  # fused_generate_kernel
