"""Fused autoregressive sampler: the CUDA kernels, their wrapper and their
plain PyTorch versions.

Counterpart of ``mlx_vae_tpu/ops/pallas_decoder.py:pallas_generate``. Three
routes, each a kernel design of its own; their designs and what bounds them
are noted at the top of their sources:

* ``"tc"``: ``csrc/fused_generate.cu:tc::gen_tc_kernel``, the whole loop in
  one launch: a cluster of S CTAs a 64-row tile, gate columns split over the
  cluster, ``wgmma`` products (split-TF32 in f32). It takes every config
  :func:`fused_generate_tc_supported` admits (the default model in f32 and
  bf16: a power-of-two H, V <= 256, every layer's h and c in a CTA).
* ``"steps"``: ``csrc/fused_generate_steps.cu``, the training decoder's
  forward frame without its residuals: 1 + n * L + L launches a call, each
  step n step launches (bf16: ``gen_step_tma_kernel``, a TMA producer warpgroup
  and ``wgmma`` consumers that keep the f32 stage sums, a persistent grid of
  :func:`steps_tile`'s tiles; f32: ``train_common.cuh``'s
  split-TF32 forward step) and one sampling head on the tensor cores. It
  takes the configs :func:`fused_generate_steps_supported` admits and
  :func:`steps_preferred` gives it (the hidden-1024 / 4-layer model, H=768,
  V > 256).
* ``"cuda_core"``: ``csrc/fused_generate.cu:fused_generate_kernel``, the
  whole loop in one launch on the CUDA cores: every other config that
  :func:`fused_generate_supported` admits.

The route depends on the config alone, never on the batch, and is decided
before any launch (:func:`fused_generate_route`).
``fused_generate_reference`` below is the function in plain torch on the
same prepared weights and the same hash-based Gumbel noise: the CPU tests
run it, and ``chip_smoke.py`` holds every route against it on the card.
``fused_generate_split_reference`` is the tensor-core kernel's layout twin:
its interleaved operands, its per-CTA column slices and its 3-term product;
``fused_generate_steps_reference`` the step route's, launch by launch.

:func:`fused_generate` takes the plain version only for tensors that lie on
the CPU. On a CUDA tensor it launches a kernel or raises: shapes outside
:func:`fused_generate_supported` (or outside the forced route's own
predicate) raise ``NotImplementedError``, a failed build or launch raises
``RuntimeError``; nothing falls back to another route.

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
import functools
import threading
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from mlx_vae_tpu_torch.config import ModelConfig
from mlx_vae_tpu_torch.ops.build import load_library
from mlx_vae_tpu_torch.ops.fused_train_decoder import _fwd_unsupported_reason
from mlx_vae_tpu_torch.ops.lstm import combined_weight, lstm_gates
from mlx_vae_tpu_torch.ops.sampling import _check_truncation, truncate_logits_bisect
from mlx_vae_tpu_torch.ops.train_common import (  # noqa: F401 (re-exported)
    BK, MAX_SMEM, MAX_V, NT, RPTS, TF32_SMEM, _tf32_rna, check, fwd_step_plan, interleave_weight,
    seq_fwd_step_reference, split_tf32_matmul, tf32_split)

KERNELS = ("tc", "steps", "cuda_core")  # the sampler's routes

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
class StepsWeights:
    """The step route's operands: every layer's gate-interleaved, K-major
    copy (``ops/train_common.py:interleave_weight``, layer 0 with the
    conditions' segment) back to back, and ``fc_out`` as a K-major ``[V,
    H]``, both in the compute dtype."""

    wt: torch.Tensor       # flat
    woutT: torch.Tensor    # [V, H]


@dataclass(frozen=True)
class FusedWeights:
    """Decoder weights in the kernels' layouts, all on one device.

    ``wcat`` holds every layer's ``[K_l + H, 4H]`` combined weight back to
    back (``K_0 = E + C``, ``K_l = H`` above); ``layers`` are views into it.
    Weight matrices are in the compute dtype, biases in float32. ``tc`` holds
    the tensor-core kernel's operands where it takes the config, ``steps``
    the step route's where the route is ``"steps"``, else None.
    """

    cfg: ModelConfig
    emb: torch.Tensor      # [V, E]
    wcat: torch.Tensor     # flat
    layers: tuple          # n views [K_l + H, 4H]
    bias: torch.Tensor     # [n, 4H] f32
    wout: torch.Tensor     # [H, V]
    bout: torch.Tensor     # [V] f32
    tc: Optional[TcWeights] = None
    steps: Optional[StepsWeights] = None


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


def step_weights(mats, cfg: ModelConfig) -> torch.Tensor:
    """Every layer's interleaved copy (``interleave_weight``, layer 0 over
    ``[x | cond | h]``) of the combined weights ``mats``, flat, back to
    back, in their dtype: the step route's ``wt``."""
    E, C, H = cfg.embedding_dim, cfg.num_conditions, cfg.hidden_dim
    return torch.cat([interleave_weight(m, E if l == 0 else H, H, C if l == 0 else 0).reshape(-1)
                      for l, m in enumerate(mats)])


def prepare_weights(params: dict, cfg: ModelConfig, device,
                    kernel: Optional[str] = None) -> FusedWeights:
    """Transpose, cast and stack decoder ``params`` (the ``.npz`` tree, as
    tensors) for :func:`fused_generate`, with the tensor-core kernel's
    operands where it takes the config and the step route's where the route
    (:func:`fused_generate_route`; ``kernel`` forces one) is ``"steps"``. Do
    this once per model: it copies every weight."""
    wdt = cfg.dtype
    mats = [combined_weight(params[f"lstm_layer_{i}"]).to(device, wdt)
            for i in range(cfg.num_layers)]
    wcat, layers = _flat_views(mats)
    wout = params["fc_out"]["weight"].T.to(device, wdt).contiguous()
    steps = None
    if _unsupported_reason(cfg) is None and fused_generate_route(cfg, kernel) == "steps":
        steps = StepsWeights(step_weights(mats, cfg), wout.T.contiguous())
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
        steps=steps,
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


def sample_head_step_reference(w: FusedWeights, t: int, htop: torch.Tensor,
                               seeds: torch.Tensor, temps: torch.Tensor, out: torch.Tensor,
                               ended: torch.Tensor, greedy: bool = False, top_k: int = 0,
                               top_p: float = 1.0, logits_out: Optional[torch.Tensor] = None,
                               split_tf32: bool = False) -> None:
    """Plain twin of one sampling-head launch of the step route
    (``gen_head_kernel``; with ``split_tf32`` the f32 ``gen_head_tf32_kernel``,
    whose product is :func:`~mlx_vae_tpu_torch.ops.train_common.split_tf32_matmul`),
    step ``t``, in place: the logits of the top layer's h ``htop [B, H]``
    (f32 products of the rounded operands) plus the bias, divided by the
    temperature of the row's seed block (``logits_out`` gets them at t = 0);
    then, as :func:`fused_generate_reference` samples, truncation and Gumbel
    noise (unless ``greedy``), the argmax, pad after the end token
    (``ended [B]`` bool, updated) and the token into ``out[:, t]``."""
    cfg = w.cfg
    B, V = htop.shape[0], cfg.vocab_size
    rows = torch.arange(B, device=htop.device)
    blk, rib = rows // block_rows(B), rows % block_rows(B)
    mm = split_tf32_matmul if split_tf32 else torch.matmul
    temp = temps.float()[blk].clamp_min(1e-6)[:, None]
    scaled = (mm(htop.float(), w.wout.float()) + w.bout) / temp
    if t == 0 and logits_out is not None:
        logits_out.copy_(scaled)
    if not greedy:
        scaled = truncate_logits_bisect(scaled, V, top_k=top_k, top_p=top_p)
        scaled = scaled + gumbel_noise(seeds[blk], rib, t, V)
    tok = torch.where(ended, cfg.pad_token, torch.argmax(scaled, dim=1))
    ended |= tok == cfg.end_token
    out[:, t] = tok.to(out.dtype)


@torch.no_grad()
def fused_generate_steps_reference(w: FusedWeights, h0: torch.Tensor, cond: torch.Tensor,
                                   seeds: torch.Tensor, temps: torch.Tensor, max_length: int,
                                   greedy: bool = False, top_k: int = 0, top_p: float = 1.0,
                                   logits_out: Optional[torch.Tensor] = None,
                                   split_tf32: bool = False) -> torch.Tensor:
    """Plain twin of the step route launch by launch (the contract of
    :func:`fused_generate_reference`): per step, the forward step kernel's
    twin (``train_common.seq_fwd_step_reference``) per layer on the
    interleaved copies (:func:`step_weights`), layer 0 over the fed token's
    embedding row and the conditions, layer l > 0 over the layer below's h,
    every layer's h_{-1} = ``h0`` and c_{-1} = 0, one state row a layer
    (read, then overwritten, as the kernels' two slots are); then
    :func:`sample_head_step_reference`. Without ``split_tf32`` its f32
    products are :func:`fused_generate_reference`'s; ``split_tf32``: the
    f32 kernels' (the steps' and the head's), within the split's ~2^-21 of
    each product."""
    cfg = w.cfg
    n, H, E, C = cfg.num_layers, cfg.hidden_dim, cfg.embedding_dim, cfg.num_conditions
    B, dev = h0.shape[0], h0.device
    wt = step_weights(w.layers, cfg)
    wts, off = [], 0
    for l in range(n):
        _, kp, np_ = fwd_step_plan(E if l == 0 else H, H, C if l == 0 else 0)
        wts.append(wt[off:off + np_ * kp].view(np_, kp))
        off += np_ * kp
    hs = torch.empty((n, B, H), dtype=cfg.dtype, device=dev)  # one row a layer
    cs = torch.empty_like(hs)
    gs = torch.empty((n, B, 4 * H), dtype=cfg.dtype, device=dev)
    c = torch.empty((n, B, H), dtype=torch.float32, device=dev)
    toks = torch.full((B, max_length + 1), cfg.start_token, dtype=torch.int64, device=dev)
    out = torch.empty((B, max_length), dtype=torch.int32, device=dev)
    ended = torch.zeros(B, dtype=torch.bool, device=dev)
    cond, h0 = cond.float(), h0.float()
    for t in range(max_length):
        for l in range(n):
            kw = (dict(xs=w.emb, I=E, tokens=toks, cond=cond) if l == 0 else
                  dict(xs=hs, I=H, x_stride=0, x_offset=l - 1))
            seq_fwd_step_reference(wts[l], w.bias[l], t, c=c[l], hs=hs, cs=cs, gs=gs, H=H, h0=h0,
                                   res_stride=0, res_offset=l, split_tf32=split_tf32, **kw)
        sample_head_step_reference(w, t, hs[n - 1], seeds, temps, out, ended, greedy, top_k,
                                   top_p, logits_out, split_tf32)
        toks[:, t + 1] = out[:, t]
    return out


# ---- the kernels ----

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


def _steps_unsupported_reason(cfg: ModelConfig) -> Optional[str]:
    reason = _unsupported_reason(cfg)
    if reason is not None:
        return reason
    reason = _fwd_unsupported_reason(cfg)
    if reason is not None:
        return f"the train forward's frame: {reason}"
    return None


def fused_generate_steps_supported(cfg: ModelConfig) -> bool:
    """Configs the step route takes: those of :func:`fused_generate_supported`
    that the training decoder's forward frame also takes
    (``ops/fused_train_decoder.py:_fwd_unsupported_reason``), whose step
    kernels and head it runs. The config alone decides."""
    return _steps_unsupported_reason(cfg) is None


# the step route's smallest hidden width by compute dtype (steps_preferred)
STEPS_MIN_H = {"bfloat16": 48, "float32": 192}


def steps_preferred(cfg: ModelConfig) -> bool:
    """Whether a config the tensor-core kernel refuses and the step route
    takes goes to the step route rather than the CUDA-core kernel: from
    ``H >= STEPS_MIN_H[compute_dtype]``, at every batch size.

    The rule comes from a sweep over H (n=2, V=80, E=128, C=1; L=64, T=0.8,
    B = 256 / 2048 / 8192; ``python -m mlx_vae_tpu_torch.bench_sampler_routes
    --configs 48:2:80,96:2:80,160:2:80,192:2:80,384:2:80,768:2:80 --routes
    steps,cuda_core``; PERF.md). In bf16 the step route was the faster
    at every H and batch measured (4.45 against 4.70 ms at H=48, B=256). In f32
    a step launch costs more (split-TF32) and the persistent CUDA-core kernel
    won at two of the three batches at H=96 and 160 (3.7 against 6.1 ms at
    H=96, B=2048), the step route at two of three from H=192 and at all from
    H=384. Below the cut a step's n + 1 launches cost more than the CUDA-core
    kernel's step over its few weights."""
    return cfg.hidden_dim >= STEPS_MIN_H[cfg.compute_dtype]


# gen_step_tma_kernel's tile instances (csrc ws::Tile<NC>): rows a tile, 64 NC
STEP_TILES = (64, 192)
STEP_B_BYTES = 128 * 128  # a stage's weight tile (csrc ws::B_BYTES)
H100_SMS = 132  # the SMs of an H100 SXM: the tile rule's default where no card is asked


def steps_ring(bm: int) -> int:
    """Stages in flight of the ``bm``-row instance (csrc ``ws::Tile::RING``):
    6, or 4 for 192 rows (its 40 KB stages)."""
    return 4 if bm == 192 else 6


def steps_step_smem(bm: int) -> int:
    """Dynamic shared memory of one ``gen_step_tma_kernel`` block with
    ``bm`` rows a tile (csrc ``ws::Tile::SMEM``): 1 KB of alignment, the
    ring of :func:`steps_ring` stages (an A tile of ``bm`` 128-byte lines
    and the 16 KB weight tile), a full and an empty mbarrier a stage, and
    two buffers of the cell's inputs (the c_{t-1} tile, ``bm`` x 32 f32,
    and the bias slice, 4 x 32 f32) with a barrier each way each."""
    ring = steps_ring(bm)
    return 1024 + ring * (bm * 128 + STEP_B_BYTES) + 2 * ring * 8 + 4 * 8 + 2 * (bm * 128 + 512)


def steps_tile(cfg: ModelConfig, B: int, sms: int = H100_SMS) -> int:
    """The bf16 step kernel's rows a tile for a call of ``B`` rows on a card
    of ``sms`` SMs, from the config and B alone: 64 (one consumer
    warpgroup) where 128-row tiles would not fill one wave of ``sms`` CTAs,
    else 192 (three consumer warpgroups, the fewest bytes a product): on
    an H100 at the scaled model, 64-row tiles are the faster below that
    wave and 192-row tiles above it, and 128-row tiles (two consumer
    warpgroups, no longer built) lost to one or the other at every batch
    (``python -m mlx_vae_tpu_torch.bench_step_launch --tiles 64,192``;
    PERF.md). A row's tokens do not depend on the instance."""
    ncol = fwd_step_plan(cfg.embedding_dim, cfg.hidden_dim, cfg.num_conditions)[2] // 128
    return 64 if -(-B // 128) * ncol < sms else 192


def steps_bf16_operands(h0: torch.Tensor, cond: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``h0 [B, H]`` and the conditions ``[B, C]`` (f32) as the bf16 step
    kernel reads them by TMA, which converts nothing: rounded to bf16 (to
    nearest even, as the kernel's staging of an f32 row, ``wg::stage8``,
    and the twin's ``.to(bfloat16)`` round), the conditions padded with
    zeros to their stage width (C rounded up to 64 columns). Made once a
    call; fresh tensors, so aligned whatever views come in."""
    B, C = cond.shape
    condb = torch.zeros((B, -(-C // BK) * BK), dtype=torch.bfloat16, device=cond.device)
    condb[:, :C] = cond.to(torch.bfloat16)
    return h0.to(torch.bfloat16).contiguous(), condb


def steps_launch_plan(cfg: ModelConfig, B: int, L: int, sms: int = H100_SMS) -> list:
    """The launches of one step-route call (the host side of
    ``csrc/fused_generate_steps.cu:launch_steps_bf16`` / ``launch_steps_f32``),
    each ``dict(kernel, grid, smem, count)``: one set-up launch, then per
    step n step launches (one per layer, layer 0 with the conditions'
    segment) and one sampling head; grids are (x, y, z), ``smem`` a block's
    dynamic shared memory. The step launches also carry ``Kp``; in f32 they
    are split-TF32 (``seq_fwd_tf32_kernel``, 128 x 128 tiles, the 3 x 64 KB
    ring); in bf16 ``gen_step_tma_kernel<NC>`` at :func:`steps_tile`'s
    rows a tile on a card of ``sms`` SMs: a persistent grid whose ``grid``
    is an upper bound (one CTA an SM at most; the launcher asks the card
    how many it holds at once) over ``tiles`` (column tiles, row tiles),
    with ``threads`` (NC consumer warpgroups and the producer warpgroup),
    ``ring`` bytes, and ``l2_bytes``, a model of what its CTAs read from L2
    (each tile a stage's weight tile and A rows, whether TMA or the
    producer's own loads bring them), not a measurement. Layer 0's bf16 entry
    names the call's bf16 copies of h0 and the conditions (``inputs_bf16``,
    :func:`steps_bf16_operands`)."""
    E, C, H, n = cfg.embedding_dim, cfg.num_conditions, cfg.hidden_dim, cfg.num_layers
    bf16 = cfg.compute_dtype == "bfloat16"
    rows = -(-B // 128)
    out = [dict(kernel="gen_init_kernel", grid=(-(-B // 256), 1, 1), smem=0, count=1)]
    bm = steps_tile(cfg, B, sms)
    for l in range(n):
        _, kp, np_ = fwd_step_plan(E if l == 0 else H, H, C if l == 0 else 0)
        if not bf16:
            out.append(dict(kernel="seq_fwd_tf32_kernel", grid=(np_ // 128, rows, 1),
                            smem=TF32_SMEM, count=L, Kp=kp))
            continue
        gx, gy = np_ // 128, -(-B // bm)
        step = dict(kernel=f"gen_step_tma_kernel<{bm // 64}>", grid=(min(gx * gy, sms), 1, 1),
                    tiles=(gx, gy), threads=bm * 2 + 128, smem=steps_step_smem(bm),
                    ring=steps_ring(bm) * (bm * 128 + STEP_B_BYTES), count=L, Kp=kp,
                    l2_bytes=gx * gy * (kp // BK) * (STEP_B_BYTES + bm * 128))
        if l == 0:
            step["inputs_bf16"] = dict(h0=(B, H), cond=(B, -(-C // BK) * BK))
        out.append(step)
    out.append(dict(kernel="gen_head_kernel" if bf16 else "gen_head_tf32_kernel",
                    grid=(rows, 1, 1), smem=3 * 32768 + 1024 if bf16 else TF32_SMEM, count=L))
    return out


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


def build_steps_library(verbose: bool = False) -> ctypes.CDLL:
    """Build ``csrc/fused_generate_steps.cu`` for sm_90a (``ops/build.py``),
    load it and declare its C interface."""
    lib = load_library("fused_generate_steps", verbose)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.gen_steps_launch.argtypes = [p] * 18 + [i] * 10 + [f] + [i] * 5 + [p]
    lib.gen_steps_launch.restype = i
    lib.gen_step_launch.argtypes = [p, p, ctypes.c_long, i] + [p] * 7 + [i] * 5 + [p]
    lib.gen_step_launch.restype = i
    lib.gen_head_launch.argtypes = [p] * 9 + [i] * 8 + [f] + [i] * 3 + [p]
    lib.gen_head_launch.restype = i
    lib.gen_steps_error_string.argtypes = [i]
    lib.gen_steps_error_string.restype = ctypes.c_char_p
    return lib


def fused_generate_route(cfg: ModelConfig, kernel: Optional[str] = None,
                         rows_per_thread: Optional[int] = None,
                         cluster: Optional[int] = None) -> str:
    """The route :func:`fused_generate` launches for ``cfg``, from the config
    alone: ``"tc"`` where :func:`fused_generate_tc_supported` holds, else
    ``"steps"`` where :func:`fused_generate_steps_supported` and
    :func:`steps_preferred` hold, else ``"cuda_core"``. ``kernel`` forces
    one (``rows_per_thread`` implies the CUDA-core kernel, ``cluster`` the
    tensor-core one); forcing ``"tc"`` or ``"steps"`` on a config it does not
    take raises ``NotImplementedError``."""
    if kernel is None:
        if rows_per_thread is not None:
            kernel = "cuda_core"
        elif cluster is not None or fused_generate_tc_supported(cfg):
            kernel = "tc"
        elif fused_generate_steps_supported(cfg) and steps_preferred(cfg):
            kernel = "steps"
        else:
            kernel = "cuda_core"
    if kernel not in KERNELS:
        raise ValueError(f"kernel={kernel!r}: one of {KERNELS}")
    if kernel != "cuda_core" and rows_per_thread is not None:
        raise ValueError("rows_per_thread applies to the CUDA-core kernel only")
    if kernel == "tc":
        reason = _tc_unsupported_reason(cfg)
        if reason is not None:
            raise NotImplementedError(f"the tensor-core sampler does not take {reason}")
        if cluster is not None and cluster not in tc_clusters(cfg):
            raise ValueError(f"cluster={cluster}: the tensor-core sampler takes "
                             f"{tc_clusters(cfg)} for this config")
    elif cluster is not None:
        raise ValueError("cluster applies to the tensor-core kernel only")
    if kernel == "steps":
        reason = _steps_unsupported_reason(cfg)
        if reason is not None:
            raise NotImplementedError(f"the step-major sampler does not take {reason}")
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


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


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
    run the plain version; CUDA tensors launch the route
    :func:`fused_generate_route` picks from the config, counted once a call
    in ``fused_generate.launches`` and in ``fused_generate.tc_launches``,
    ``.step_launches`` or ``.core_launches``. ``kernel`` forces a route,
    ``rows_per_thread`` the CUDA-core kernel's tile (:func:`_tile_rows`),
    ``cluster`` the tensor-core kernel's cluster size
    (:func:`tc_cluster_size`); the tokens depend on none of them. The bf16
    step route takes its rows a tile from :func:`steps_tile` at the card's
    SM count.
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
    lib = build_steps_library() if route == "steps" else build_library()
    error_string = lib.gen_steps_error_string if route == "steps" else \
        lib.fused_generate_error_string
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
        elif route == "steps":
            st = w.steps
            if st is None:
                raise ValueError("weights.steps is None: prepare_weights(..., kernel='steps') "
                                 "builds the step route's operands")
            for name, t in (("wt", st.wt), ("woutT", st.woutT)):
                if t.device != dev or t.dtype != cfg.dtype or not t.is_contiguous():
                    raise ValueError(f"weights.steps.{name} must be contiguous {cfg.dtype} on "
                                     f"{dev} (prepare_weights makes them so)")
            n, V = cfg.num_layers, cfg.vocab_size
            hbuf = torch.empty((2, n, B, H), dtype=cfg.dtype, device=dev)
            cbuf = torch.empty((n, B, H), dtype=torch.float32, device=dev)
            scaled = torch.empty((B, V), dtype=torch.float32, device=dev)
            start, ended = torch.empty((2, B), dtype=torch.int32, device=dev)
            h0b = condb = None
            bm = 128  # the f32 kernel takes no tile instance
            if cfg.compute_dtype == "bfloat16":
                h0b, condb = steps_bf16_operands(h0, cond)
                bm = steps_tile(cfg, B, _sm_count(dev))
            ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
            rc = lib.gen_steps_launch(
                w.emb.data_ptr(), cond.data_ptr(), h0.data_ptr(), ptr(h0b), ptr(condb),
                st.wt.data_ptr(), w.bias.data_ptr(), st.woutT.data_ptr(), w.bout.data_ptr(),
                seeds.data_ptr(), temps.data_ptr(), out.data_ptr(), l0, hbuf.data_ptr(),
                cbuf.data_ptr(), scaled.data_ptr(), start.data_ptr(), ended.data_ptr(), *common,
                cfg.start_token, cfg.end_token, cfg.pad_token, bm // 64, stream)
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
                           f"{error_string(rc).decode()} ({rc})")
    with _count_lock:  # a server's warm-up thread and dispatcher both launch
        fused_generate.launches += 1
        if route == "tc":
            fused_generate.tc_launches += 1
        elif route == "steps":
            fused_generate.step_launches += 1
        else:
            fused_generate.core_launches += 1
    return out


_count_lock = threading.Lock()
fused_generate.launches = 0       # every call on the card
fused_generate.tc_launches = 0    # gen_tc_kernel
fused_generate.step_launches = 0  # the step route (fused_generate_steps.cu), once a call
fused_generate.core_launches = 0  # fused_generate_kernel
