"""Fused encoder stack: CUDA kernels, wrappers and their plain PyTorch
versions.

Counterpart of ``mlx_vae_tpu/ops/pallas_encoder.py:encoder_stack_pallas``:
tokens ``[B, L]`` -> the top layer's h at the last step ``[B, H]`` f32,
through the embedding and every LSTM layer from zero state, with gradients
for every layer and the embedding table. The kernels are in
``csrc/fused_encoder.cu`` (CUDA C++ for ``sm_90a``); their design and what
bounds them are noted at the top of that file.

:func:`encoder_stack` is one ``torch.autograd.Function`` whose forward is
:func:`encoder_fwd` and whose backward is :func:`encoder_bwd`. Each launches
its kernel on CUDA tensors (counted in ``.launches``) and runs its plain
version, :func:`encoder_fwd_reference` / :func:`encoder_bwd_reference`, on
CPU tensors. The plain versions store the same residuals in the same dtype
(h, c and ACTIVATED gates in the compute dtype; the backward's one
cotangent is injected into the top layer at t = L-1), so the card holds each
kernel against its plain version on identical inputs. Shapes outside
:func:`fused_encoder_supported` raise ``NotImplementedError`` on CUDA; a
failed build or launch raises ``RuntimeError``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from mlx_vae_tpu_torch.config import ModelConfig
from mlx_vae_tpu_torch.ops.build import load_library
from mlx_vae_tpu_torch.ops.train_common import (
    MAX_V, SCRATCH_ELEMS, StackWeights, bwd_rows, cell_step_reference, check, embed_rows,
    embedding_grad, fwd_tile, layer_grads, layer_leaves, prepare_stack_weights, raise_if,
    rebuild_params, require_cuda, reverse_step_reference, scratch_fits, shifted, stream_of,
    sum_outer)


# ----------------------------------------------------------- plain version

def encoder_fwd_reference(w: StackWeights, tokens: torch.Tensor):
    """Plain twin of the forward kernel: ``(h_last [B, H] f32, hs, cs
    [L, n, B, H], gs [L, n, B, 4H])``, residuals in the compute dtype."""
    cfg = w.cfg
    wdt, n, H = cfg.dtype, cfg.num_layers, cfg.hidden_dim
    B, L = tokens.shape
    dev = tokens.device
    hs = torch.empty((L, n, B, H), dtype=wdt, device=dev)
    cs = torch.empty_like(hs)
    gs = torch.empty((L, n, B, 4 * H), dtype=wdt, device=dev)
    h = [torch.zeros((B, H), dtype=torch.float32, device=dev)] * n
    c = list(h)
    xs = embed_rows(w.emb, tokens).float()
    for t in range(L):
        x = xs[:, t]
        for l in range(n):
            h[l], c[l], g = cell_step_reference(w.layers[l], w.bias[l], x, h[l], c[l], wdt)
            hs[t, l], cs[t, l], gs[t, l] = h[l], c[l], g
            x = h[l]
    return h[n - 1], hs, cs, gs


def encoder_reverse_reference(w: StackWeights, dh_last: torch.Tensor, hs: torch.Tensor,
                              cs: torch.Tensor, gs: torch.Tensor):
    """Plain twin of the reverse kernel: ``(dgates [L, n, B, 4H], dx0
    [L, B, E])`` in the compute dtype."""
    cfg = w.cfg
    wdt, n, H, E = cfg.dtype, cfg.num_layers, cfg.hidden_dim, cfg.embedding_dim
    L, _, B, _ = hs.shape
    dev = hs.device
    dgates = torch.empty((L, n, B, 4 * H), dtype=wdt, device=dev)
    dx0 = torch.empty((L, B, E), dtype=wdt, device=dev)
    dh = [torch.zeros((B, H), dtype=torch.float32, device=dev) for _ in range(n)]
    dc = [torch.zeros_like(d) for d in dh]
    dh[n - 1] = dh_last.float()
    mats = [m.float() for m in w.layers]
    for t in range(L - 1, -1, -1):
        fa = torch.zeros((B, H), dtype=torch.float32, device=dev)
        for l in range(n - 1, -1, -1):
            dg, dc[l] = reverse_step_reference(gs[t, l], cs[t, l], cs[t - 1, l] if t else None,
                                               dh[l] + fa, dc[l], wdt)
            dgates[t, l] = dg
            dinp = dg @ mats[l].T
            k = E if l == 0 else H
            if l > 0:
                fa = dinp[:, :k]
            else:
                dx0[t] = dinp[:, :k]
            dh[l] = dinp[:, k:]
    return dgates, dx0


def encoder_bwd_reference(w: StackWeights, tokens: torch.Tensor, dh_last: torch.Tensor,
                          hs: torch.Tensor, cs: torch.Tensor, gs: torch.Tensor):
    """Plain twin of the backward kernels: ``(dW, db, demb)`` with ``dW`` a
    list of per-layer ``[K_l + H, 4H]``, ``db [n, 4H]``, ``demb [V, E]``,
    all f32."""
    cfg = w.cfg
    dgates, dx0 = encoder_reverse_reference(w, dh_last, hs, cs, gs)
    tok_lb = tokens.T
    dW = []
    for l in range(cfg.num_layers):
        x = embed_rows(w.emb, tok_lb) if l == 0 else hs[:, l - 1]
        dW.append(sum_outer(torch.cat([x, shifted(hs[:, l], None)], dim=-1), dgates[:, l]))
    db = dgates.float().sum(dim=(0, 2))
    return dW, db, embedding_grad(dx0, tok_lb, cfg.vocab_size)


# ------------------------------------------------------------------ kernels

def _fwd_smem(cfg: ModelConfig):
    E, H, n = cfg.embedding_dim, cfg.hidden_dim, cfg.num_layers
    return lambda r: r * E + 3 * n * r * H


def _bwd_smem(cfg: ModelConfig):
    H, n = cfg.hidden_dim, cfg.num_layers
    return lambda r: 2 * n * r * H + r * H + 4 * r * H


def _unsupported_reason(cfg: ModelConfig) -> Optional[str]:
    if cfg.bidirectional or cfg.apply_dropout:
        return ("bidirectional / apply_dropout (they need per-layer sequences, whose "
                "kernel is not ported yet)")
    if not 1 <= cfg.num_layers <= 8:
        return f"num_layers={cfg.num_layers} (kernels take 1..8)"
    if cfg.compute_dtype not in ("float32", "bfloat16"):
        return f"compute_dtype={cfg.compute_dtype}"
    if not 1 <= cfg.vocab_size <= MAX_V:
        return f"vocab_size={cfg.vocab_size} (kernels take 1..{MAX_V})"
    if fwd_tile(cfg.hidden_dim, _fwd_smem(cfg)) is None or bwd_rows(_bwd_smem(cfg)) is None:
        return (f"shared-memory plan: one row of H={cfg.hidden_dim}, n={cfg.num_layers}, "
                f"E={cfg.embedding_dim}")
    if not scratch_fits(cfg):
        return "a weight-gradient pass exceeds the split-reduction scratch"
    return None


def fused_encoder_supported(cfg: ModelConfig) -> bool:
    """Shapes the kernels take: unidirectional without dropout, 1..8
    layers, f32 or bf16, V <= 512, one row's state within a block's shared
    memory."""
    return _unsupported_reason(cfg) is None


def build_library(verbose: bool = False) -> ctypes.CDLL:
    """Build ``csrc/fused_encoder.cu`` (``ops/build.py``), load it and
    declare its C interface."""
    lib = load_library("fused_encoder", verbose)
    p, i, lg = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    lib.enc_fwd_launch.argtypes = [p] * 8 + [i] * 10 + [p]
    lib.enc_fwd_launch.restype = i
    lib.enc_bwd_launch.argtypes = [p] * 13 + [lg] + [i] * 8 + [p]
    lib.enc_bwd_launch.restype = i
    lib.enc_error_string.argtypes = [i]
    lib.enc_error_string.restype = ctypes.c_char_p
    return lib


def launch_encoder_fwd(lib, w: StackWeights, tokens: torch.Tensor, stream: int):
    """Allocate the outputs and launch the forward kernel (no device or
    support checks: :func:`encoder_fwd` makes them)."""
    cfg = w.cfg
    B, L = tokens.shape
    H, n = cfg.hidden_dim, cfg.num_layers
    dev, wdt = tokens.device, cfg.dtype
    h_last = torch.empty((B, H), dtype=torch.float32, device=dev)
    hs = torch.empty((L, n, B, H), dtype=wdt, device=dev)
    cs = torch.empty_like(hs)
    gs = torch.empty((L, n, B, 4 * H), dtype=wdt, device=dev)
    R, tj, tr = fwd_tile(cfg.hidden_dim, _fwd_smem(cfg))
    rc = lib.enc_fwd_launch(tokens.data_ptr(), w.emb.data_ptr(), w.wcat.data_ptr(),
                            w.bias.data_ptr(), h_last.data_ptr(), hs.data_ptr(),
                            cs.data_ptr(), gs.data_ptr(), B, L, cfg.vocab_size,
                            cfg.embedding_dim, H, n, int(wdt == torch.bfloat16), R, tj, tr,
                            stream)
    raise_if(rc, "encoder forward", lib.enc_error_string)
    return h_last, hs, cs, gs


def encoder_fwd(w: StackWeights, tokens: torch.Tensor):
    """The forward (contract of :func:`encoder_fwd_reference`). CPU tensors
    run the plain version; CUDA tensors launch the kernel, counted in
    ``encoder_fwd.launches``."""
    if tokens.device.type == "cpu":
        return encoder_fwd_reference(w, tokens)
    cfg = w.cfg
    require_cuda(tokens, "fused_encoder forward", _unsupported_reason(cfg))
    check(tokens, "tokens", tuple(tokens.shape), torch.int32, tokens.device)
    lib = build_library()
    with torch.cuda.device(tokens.device):
        res = launch_encoder_fwd(lib, w, tokens, stream_of(tokens.device))
    encoder_fwd.launches += 1
    return res


encoder_fwd.launches = 0


def launch_encoder_bwd(lib, w: StackWeights, tokens, dh_last, hs, cs, gs, stream: int):
    """Allocate the outputs and scratch and launch the backward kernels (no
    device or support checks: :func:`encoder_bwd` makes them)."""
    cfg = w.cfg
    L, n, B, H = hs.shape
    E, V = cfg.embedding_dim, cfg.vocab_size
    dev, wdt = hs.device, cfg.dtype
    f32 = dict(dtype=torch.float32, device=dev)
    dgates = torch.empty((L, n, B, 4 * H), dtype=wdt, device=dev)
    dx0 = torch.empty((L, B, E), dtype=wdt, device=dev)
    sizes = [(E + H) * 4 * H] + [2 * H * 4 * H] * (n - 1)
    dW_flat = torch.empty((sum(sizes),), **f32)
    db = torch.empty((n, 4 * H), **f32)
    demb = torch.empty((V, E), **f32)
    scratch = torch.empty((SCRATCH_ELEMS,), **f32)
    R = bwd_rows(_bwd_smem(cfg))
    rc = lib.enc_bwd_launch(tokens.data_ptr(), w.emb.data_ptr(), w.wT.data_ptr(),
                            dh_last.data_ptr(), hs.data_ptr(), cs.data_ptr(), gs.data_ptr(),
                            dgates.data_ptr(), dx0.data_ptr(), dW_flat.data_ptr(),
                            db.data_ptr(), demb.data_ptr(), scratch.data_ptr(),
                            SCRATCH_ELEMS, B, L, V, E, H, n, int(wdt == torch.bfloat16), R,
                            stream)
    raise_if(rc, "encoder backward", lib.enc_error_string)
    dW, off = [], 0
    for size in sizes:
        dW.append(dW_flat[off:off + size].view(size // (4 * H), 4 * H))
        off += size
    return dW, db, demb


def encoder_bwd(w: StackWeights, tokens: torch.Tensor, dh_last: torch.Tensor,
                hs: torch.Tensor, cs: torch.Tensor, gs: torch.Tensor):
    """The backward (contract of :func:`encoder_bwd_reference`). CPU tensors
    run the plain version; CUDA tensors launch the kernels, counted once per
    call in ``encoder_bwd.launches``."""
    if hs.device.type == "cpu":
        return encoder_bwd_reference(w, tokens, dh_last, hs, cs, gs)
    cfg = w.cfg
    require_cuda(hs, "fused_encoder backward", _unsupported_reason(cfg))
    L, n, B, H = hs.shape
    dev, wdt = hs.device, cfg.dtype
    check(tokens, "tokens", (B, L), torch.int32, dev)
    check(dh_last, "dh_last", (B, H), torch.float32, dev)
    for name, t, last in (("hs", hs, H), ("cs", cs, H), ("gs", gs, 4 * H)):
        check(t, name, (L, cfg.num_layers, B, last), wdt, dev)
    lib = build_library()
    with torch.cuda.device(dev):
        res = launch_encoder_bwd(lib, w, tokens, dh_last, hs, cs, gs, stream_of(dev))
    encoder_bwd.launches += 1
    return res


encoder_bwd.launches = 0


# ------------------------------------------------------------ autograd

class _EncoderStack(torch.autograd.Function):
    """Leaves: the embedding, then (Wx, Wh, bias) of every layer."""

    @staticmethod
    def forward(ctx, cfg, tokens, emb, *leaves):
        w = prepare_stack_weights(rebuild_params(cfg, emb, leaves), cfg, with_head=False)
        h_last, hs, cs, gs = encoder_fwd(w, tokens)
        ctx.save_for_backward(tokens, hs, cs, gs)
        ctx.w = w
        return h_last

    @staticmethod
    def backward(ctx, dh_last):
        tokens, hs, cs, gs = ctx.saved_tensors
        cfg = ctx.w.cfg
        dW, db, demb = encoder_bwd(ctx.w, tokens, dh_last.float().contiguous(), hs, cs, gs)
        return (None, None, demb, *layer_grads(dW, db, cfg, cfg.embedding_dim))


def encoder_stack(params: dict, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Tokens ``[B, L]`` -> pooled feature ``h_top[:, L-1]`` ``[B, H]`` f32
    (``encoder_stack_pallas``); gradients reach the embedding and every LSTM
    layer of ``params`` (the encoder tree)."""
    return _EncoderStack.apply(cfg, tokens.to(torch.int32).contiguous(),
                               params["embedding"]["weight"], *layer_leaves(params, cfg))
