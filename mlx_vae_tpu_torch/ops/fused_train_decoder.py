"""Fused teacher-forced training decoder: CUDA kernels, wrappers and their
plain PyTorch versions.

Counterpart of ``mlx_vae_tpu/ops/pallas_train_decoder.py``
(``decoder_train_ce_pallas`` and ``decoder_train_pallas``). The kernels are
in ``csrc/fused_train_decoder.cu`` (CUDA C++ for ``sm_90a``); their design
and what bounds them are noted at the top of that file.

* :func:`decoder_train_ce` returns the per-sample reconstruction CE ``[B]``
  (``ce[b] = sum_t -log softmax(logits_t)[target_t]``); logits never reach
  device memory in either direction.
* :func:`decoder_train` returns logits ``[B, L, V]``; its backward takes
  ``dlogits``.

Both are one ``torch.autograd.Function`` whose forward is
:func:`decoder_fwd` and whose backward is :func:`decoder_bwd`. Each of those
launches its kernel on CUDA tensors (counted in ``.launches``) and runs its
plain version, :func:`decoder_fwd_reference` / :func:`decoder_bwd_reference`,
on CPU tensors. The plain versions store the same residuals in the same
dtype (h, c and ACTIVATED gates in the compute dtype) and the plain backward
computes from them what the kernel's backward computes, so the card can hold
each kernel against its plain version on identical inputs. Shapes outside
:func:`fused_train_decoder_supported` raise ``NotImplementedError`` on CUDA;
a failed build or launch raises ``RuntimeError``.

Gradient semantics are the scan decoder's: the fed-back token carries no
gradient. Cell states start at zero and every layer's h at ``h_init``, so
``d(h_init)`` is the sum over layers of dh at t = 0 and ``d(conditions)``
here is the per-step input path only (``initialize_hidden_state``'s share
is added by autograd outside). In bf16 a gate activation that saturated to
exactly 1.0 in the stored residual has a zero ``a(1-a)`` term, as on the
TPU; f32 residuals are exact.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from mlx_vae_tpu_torch.config import ModelConfig
from mlx_vae_tpu_torch.ops.build import load_library
from mlx_vae_tpu_torch.ops.train_common import (
    MAX_SMEM, MAX_V, SCRATCH_ELEMS, StackWeights, bwd_rows, cell_step_reference, check,
    embed_rows, embedding_grad, fwd_tile, layer_grads, layer_leaves, prepare_stack_weights,
    raise_if, rebuild_params, require_cuda, reverse_step_reference, scratch_fits, shifted,
    stream_of, sum_outer)


# ----------------------------------------------------------- plain version

def decoder_fwd_reference(w: StackWeights, h_init: torch.Tensor, cond: torch.Tensor,
                          targets: torch.Tensor, tf_mask: torch.Tensor, with_ce: bool):
    """Plain twin of the forward kernel. Returns ``(out, toks, hs, cs, gs)``:
    ``out`` the CE ``[B]`` (``with_ce``) or logits ``[B, L, V]``, f32;
    ``toks [L, B]`` int32 the fed tokens; ``hs``/``cs [L, n, B, H]`` and
    ``gs [L, n, B, 4H]`` in the compute dtype."""
    cfg = w.cfg
    wdt, n, H = cfg.dtype, cfg.num_layers, cfg.hidden_dim
    B, L = targets.shape
    dev = h_init.device
    hs = torch.empty((L, n, B, H), dtype=wdt, device=dev)
    cs = torch.empty_like(hs)
    gs = torch.empty((L, n, B, 4 * H), dtype=wdt, device=dev)
    toks = torch.empty((L, B), dtype=torch.int32, device=dev)
    h = [h_init.float()] * n
    c = [torch.zeros_like(h_init, dtype=torch.float32)] * n
    cond = cond.float()
    tok = torch.full((B,), cfg.start_token, dtype=torch.int32, device=dev)
    tf = tf_mask.to(dev).bool()
    wout, bout = w.wout.float(), w.bout
    ce = torch.zeros((B,), dtype=torch.float32, device=dev)
    logits_all = []
    for t in range(L):
        toks[t] = tok
        x = torch.cat([embed_rows(w.emb, tok).float(), cond], dim=1)
        for l in range(n):
            h[l], c[l], g = cell_step_reference(w.layers[l], w.bias[l], x, h[l], c[l], wdt)
            hs[t, l], cs[t, l], gs[t, l] = h[l], c[l], g
            x = h[l]
        logits = x.to(wdt).float() @ wout + bout
        target = targets[:, t].int()
        if with_ce:
            m = logits.max(dim=1, keepdim=True).values
            lse = m[:, 0] + torch.log(torch.exp(logits - m).sum(dim=1))
            ok = (target >= 0) & (target < cfg.vocab_size)
            tl = logits.gather(1, target.long().clamp(0, cfg.vocab_size - 1)[:, None])[:, 0]
            ce = ce + (lse - torch.where(ok, tl, torch.zeros_like(tl)))
        else:
            logits_all.append(logits)
        tok = torch.where(tf[t], target, torch.argmax(logits, dim=1).int())
    out = ce if with_ce else torch.stack(logits_all, dim=1)
    return out, toks, hs, cs, gs


def decoder_reverse_reference(w: StackWeights, din: torch.Tensor, targets: torch.Tensor,
                              hs: torch.Tensor, cs: torch.Tensor, gs: torch.Tensor,
                              with_ce: bool):
    """Plain twin of the reverse kernel: ``(dgates [L, n, B, 4H] and dx0
    [L, B, E] in the compute dtype, dlog [L, B, V] f32, d(h_init) [B, H],
    d(cond) [B, C])``."""
    cfg = w.cfg
    wdt, n, H, E, C, V = (cfg.dtype, cfg.num_layers, cfg.hidden_dim, cfg.embedding_dim,
                          cfg.num_conditions, cfg.vocab_size)
    L, _, B, _ = hs.shape
    dev = hs.device
    K0 = E + C
    dgates = torch.empty((L, n, B, 4 * H), dtype=wdt, device=dev)
    dx0 = torch.empty((L, B, E), dtype=wdt, device=dev)
    dlog = torch.empty((L, B, V), dtype=torch.float32, device=dev)
    dh = [torch.zeros((B, H), dtype=torch.float32, device=dev) for _ in range(n)]
    dc = [torch.zeros((B, H), dtype=torch.float32, device=dev) for _ in range(n)]
    dcond = torch.zeros((B, C), dtype=torch.float32, device=dev)
    mats = [m.float() for m in w.layers]
    wout = w.wout.float()
    for t in range(L - 1, -1, -1):
        if with_ce:
            logits = hs[t, n - 1].float() @ wout + w.bout
            p = torch.softmax(logits, dim=1)
            target = targets[:, t].long()
            onehot = torch.nn.functional.one_hot(target.clamp(0, V - 1), V).float()
            onehot = onehot * ((target >= 0) & (target < V)).float()[:, None]
            dl = (p - onehot) * din.float()[:, None]
        else:
            dl = din[:, t].float()
        dlog[t] = dl
        fa = dl.to(wdt).float() @ wout.T
        for l in range(n - 1, -1, -1):
            dg, dc[l] = reverse_step_reference(gs[t, l], cs[t, l], cs[t - 1, l] if t else None,
                                               dh[l] + fa, dc[l], wdt)
            dgates[t, l] = dg
            dinp = dg @ mats[l].T
            if l > 0:
                fa, dh[l] = dinp[:, :H], dinp[:, H:]
            else:
                dx0[t] = dinp[:, :E]
                dcond = dcond + dinp[:, E:K0]
                dh[0] = dinp[:, K0:]
    return dgates, dx0, dlog, sum(dh), dcond


def decoder_bwd_reference(w: StackWeights, din: torch.Tensor, targets: torch.Tensor,
                          toks: torch.Tensor, h_init: torch.Tensor, cond: torch.Tensor,
                          hs: torch.Tensor, cs: torch.Tensor, gs: torch.Tensor,
                          with_ce: bool):
    """Plain twin of the backward kernels. ``din`` is ``dce [B]``
    (``with_ce``) or ``dlogits [B, L, V]``. Returns ``(dW, db, dwout, dbout,
    demb, dh_init, dcond)``: ``dW`` a list of per-layer ``[K_l + H, 4H]``,
    ``db [n, 4H]``, ``dwout [H, V]``, ``dbout [V]``, ``demb [V, E]``, all
    f32."""
    cfg = w.cfg
    wdt, n = cfg.dtype, cfg.num_layers
    dgates, dx0, dlog, dh_init, dcond = decoder_reverse_reference(
        w, din, targets, hs, cs, gs, with_ce)
    L, _, B, _ = hs.shape
    h0 = h_init.to(wdt)
    dW = []
    for l in range(n):
        if l == 0:
            x = torch.cat([embed_rows(w.emb, toks), cond.to(wdt)[None].expand(L, -1, -1)], -1)
        else:
            x = hs[:, l - 1]
        dW.append(sum_outer(torch.cat([x, shifted(hs[:, l], h0)], dim=-1), dgates[:, l]))
    db = dgates.float().sum(dim=(0, 2))
    dwout = sum_outer(hs[:, n - 1], dlog.to(wdt))
    dbout = dlog.sum(dim=(0, 1))
    demb = embedding_grad(dx0, toks, cfg.vocab_size)
    return dW, db, dwout, dbout, demb, dh_init, dcond


# ------------------------------------------------------------------ kernels

def _fwd_smem(cfg: ModelConfig):
    K0, H, n = cfg.embedding_dim + cfg.num_conditions, cfg.hidden_dim, cfg.num_layers
    return lambda r: r * K0 + 3 * n * r * H + 2 * r


def _bwd_smem(cfg: ModelConfig):
    H, n, V, C = cfg.hidden_dim, cfg.num_layers, cfg.vocab_size, cfg.num_conditions
    return lambda r: 2 * n * r * H + r * H + 4 * r * H + r * V + r * C


def _fwd_unsupported_reason(cfg: ModelConfig) -> Optional[str]:
    if not 1 <= cfg.num_layers <= 8:
        return f"num_layers={cfg.num_layers} (kernels take 1..8)"
    if cfg.compute_dtype not in ("float32", "bfloat16"):
        return f"compute_dtype={cfg.compute_dtype}"
    if not 1 <= cfg.vocab_size <= MAX_V:
        return f"vocab_size={cfg.vocab_size} (kernels take 1..{MAX_V})"
    if fwd_tile(cfg.hidden_dim, _fwd_smem(cfg)) is None:
        return (f"shared-memory plan: one row of H={cfg.hidden_dim}, n={cfg.num_layers}, "
                f"E+C={cfg.embedding_dim + cfg.num_conditions} > {MAX_SMEM} B")
    return None


def _unsupported_reason(cfg: ModelConfig) -> Optional[str]:
    reason = _fwd_unsupported_reason(cfg)
    if reason is not None:
        return reason
    if bwd_rows(_bwd_smem(cfg)) is None:
        return (f"shared-memory plan: one reverse row of H={cfg.hidden_dim}, "
                f"n={cfg.num_layers}, V={cfg.vocab_size} > {MAX_SMEM} B")
    if not scratch_fits(cfg):
        return "a weight-gradient pass exceeds the split-reduction scratch"
    return None


def fused_train_decoder_fwd_supported(cfg: ModelConfig) -> bool:
    """Shapes the forward kernel takes (the backward may refuse more)."""
    return _fwd_unsupported_reason(cfg) is None


def fused_train_decoder_supported(cfg: ModelConfig) -> bool:
    """Shapes the kernels take: 1..8 layers, f32 or bf16, V <= 512, and one
    row's state within a block's shared memory. ``reference_zero_state``
    is the caller's to route (the kernels carry the state)."""
    return _unsupported_reason(cfg) is None


def build_library(verbose: bool = False) -> ctypes.CDLL:
    """Build ``csrc/fused_train_decoder.cu`` (``ops/build.py``), load it and
    declare its C interface."""
    lib = load_library("fused_train_decoder", verbose)
    p, i, lg = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    lib.dec_fwd_launch.argtypes = [p] * 14 + [i] * 13 + [p]
    lib.dec_fwd_launch.restype = i
    lib.dec_bwd_launch.argtypes = [p] * 24 + [lg] + [i] * 10 + [p]
    lib.dec_bwd_launch.restype = i
    lib.dec_error_string.argtypes = [i]
    lib.dec_error_string.restype = ctypes.c_char_p
    return lib


def launch_decoder_fwd(lib, w: StackWeights, h_init, cond, targets, tf, with_ce: bool,
                       stream: int):
    """Allocate the outputs and launch the forward kernel (no device or
    support checks: :func:`decoder_fwd` makes them)."""
    cfg = w.cfg
    B, L = targets.shape
    H, n, V = cfg.hidden_dim, cfg.num_layers, cfg.vocab_size
    dev, wdt = h_init.device, cfg.dtype
    out = torch.empty((B,) if with_ce else (B, L, V), dtype=torch.float32, device=dev)
    toks = torch.empty((L, B), dtype=torch.int32, device=dev)
    hs = torch.empty((L, n, B, H), dtype=wdt, device=dev)
    cs = torch.empty_like(hs)
    gs = torch.empty((L, n, B, 4 * H), dtype=wdt, device=dev)
    R, tj, tr = fwd_tile(cfg.hidden_dim, _fwd_smem(cfg))
    rc = lib.dec_fwd_launch(
        targets.data_ptr(), tf.data_ptr(), cond.data_ptr(), h_init.data_ptr(),
        w.emb.data_ptr(), w.wcat.data_ptr(), w.bias.data_ptr(), w.wout.data_ptr(),
        w.bout.data_ptr(), out.data_ptr(), toks.data_ptr(), hs.data_ptr(), cs.data_ptr(),
        gs.data_ptr(), B, L, V, cfg.embedding_dim, cfg.num_conditions, H, n,
        int(wdt == torch.bfloat16), R, tj, tr, int(with_ce), cfg.start_token, stream)
    raise_if(rc, "decoder forward", lib.dec_error_string)
    return out, toks, hs, cs, gs


def decoder_fwd(w: StackWeights, h_init: torch.Tensor, cond: torch.Tensor,
                targets: torch.Tensor, tf_mask: torch.Tensor, with_ce: bool):
    """The forward (contract of :func:`decoder_fwd_reference`). CPU tensors
    run the plain version; CUDA tensors launch the kernel, counted in
    ``decoder_fwd.launches`` (the CE specialization) or
    ``decoder_fwd.logits_launches`` (the logits one, which
    ``ops/decoder_cv.py:decoder_train_cvp`` also runs)."""
    if h_init.device.type == "cpu":
        return decoder_fwd_reference(w, h_init, cond, targets, tf_mask, with_ce)
    cfg = w.cfg
    require_cuda(h_init, "fused_train_decoder forward", _fwd_unsupported_reason(cfg))
    B, L = targets.shape
    dev = h_init.device
    check(targets, "targets", (B, L), torch.int32, dev)
    check(h_init, "h_init", (B, cfg.hidden_dim), torch.float32, dev)
    check(cond, "cond", (B, cfg.num_conditions), torch.float32, dev)
    tf = tf_mask.to(device=dev, dtype=torch.int32).contiguous()
    check(tf, "tf_mask", (L,), torch.int32, dev)
    lib = build_library()
    with torch.cuda.device(dev):
        res = launch_decoder_fwd(lib, w, h_init, cond, targets, tf, with_ce, stream_of(dev))
    if with_ce:
        decoder_fwd.launches += 1
    else:
        decoder_fwd.logits_launches += 1
    return res


decoder_fwd.launches = 0
decoder_fwd.logits_launches = 0


def launch_decoder_bwd(lib, w: StackWeights, din, targets, toks, h_init, cond, hs, cs, gs,
                       with_ce: bool, stream: int):
    """Allocate the outputs and scratch and launch the backward kernels (no
    device or support checks: :func:`decoder_bwd` makes them)."""
    cfg = w.cfg
    L, n, B, H = hs.shape
    E, C, V = cfg.embedding_dim, cfg.num_conditions, cfg.vocab_size
    dev, wdt = hs.device, cfg.dtype
    K0 = E + C
    f32 = dict(dtype=torch.float32, device=dev)
    dgates = torch.empty((L, n, B, 4 * H), dtype=wdt, device=dev)
    dx0 = torch.empty((L, B, E), dtype=wdt, device=dev)
    dlog = torch.empty((L, B, V), **f32)
    dh_init = torch.empty((B, H), **f32)
    dcond = torch.empty((B, C), **f32)
    sizes = [(K0 + H) * 4 * H] + [2 * H * 4 * H] * (n - 1)
    dW_flat = torch.empty((sum(sizes),), **f32)
    db = torch.empty((n, 4 * H), **f32)
    dwout = torch.empty((H, V), **f32)
    dbout = torch.empty((V,), **f32)
    demb = torch.empty((V, E), **f32)
    scratch = torch.empty((SCRATCH_ELEMS,), **f32)
    h0 = h_init.to(wdt).contiguous()
    cond_w = cond.to(wdt).contiguous()
    R = bwd_rows(_bwd_smem(cfg))
    rc = lib.dec_bwd_launch(
        din.data_ptr(), targets.data_ptr(), toks.data_ptr(), hs.data_ptr(), cs.data_ptr(),
        gs.data_ptr(), w.emb.data_ptr(), w.wT.data_ptr(), w.wout.data_ptr(),
        w.woutT.data_ptr(), w.bout.data_ptr(), h0.data_ptr(), cond_w.data_ptr(),
        dgates.data_ptr(), dx0.data_ptr(), dlog.data_ptr(), dh_init.data_ptr(),
        dcond.data_ptr(), dW_flat.data_ptr(), db.data_ptr(), dwout.data_ptr(),
        dbout.data_ptr(), demb.data_ptr(), scratch.data_ptr(), SCRATCH_ELEMS,
        B, L, V, E, C, H, n, int(wdt == torch.bfloat16), R, int(with_ce), stream)
    raise_if(rc, "decoder backward", lib.dec_error_string)
    dW, off = [], 0
    for l, size in enumerate(sizes):
        dW.append(dW_flat[off:off + size].view(size // (4 * H), 4 * H))
        off += size
    return dW, db, dwout, dbout, demb, dh_init, dcond


def decoder_bwd(w: StackWeights, din: torch.Tensor, targets: torch.Tensor,
                toks: torch.Tensor, h_init: torch.Tensor, cond: torch.Tensor,
                hs: torch.Tensor, cs: torch.Tensor, gs: torch.Tensor, with_ce: bool):
    """The backward (contract of :func:`decoder_bwd_reference`). CPU tensors
    run the plain version; CUDA tensors launch the kernels, counted once per
    call in ``decoder_bwd.launches``."""
    if hs.device.type == "cpu":
        return decoder_bwd_reference(w, din, targets, toks, h_init, cond, hs, cs, gs, with_ce)
    cfg = w.cfg
    require_cuda(hs, "fused_train_decoder backward", _unsupported_reason(cfg))
    L, n, B, H = hs.shape
    dev, wdt = hs.device, cfg.dtype
    check(din, "dce" if with_ce else "dlogits",
          (B,) if with_ce else (B, L, cfg.vocab_size), torch.float32, dev)
    check(targets, "targets", (B, L), torch.int32, dev)
    check(toks, "toks", (L, B), torch.int32, dev)
    check(h_init, "h_init", (B, H), torch.float32, dev)
    check(cond, "cond", (B, cfg.num_conditions), torch.float32, dev)
    for name, t, last in (("hs", hs, H), ("cs", cs, H), ("gs", gs, 4 * H)):
        check(t, name, (L, cfg.num_layers, B, last), wdt, dev)
    lib = build_library()
    with torch.cuda.device(dev):
        res = launch_decoder_bwd(lib, w, din, targets, toks, h_init, cond, hs, cs, gs,
                                 with_ce, stream_of(dev))
    decoder_bwd.launches += 1
    return res


decoder_bwd.launches = 0


# ------------------------------------------------------------ autograd

class _TrainDecoder(torch.autograd.Function):
    """Leaves: h_init, cond, embedding, fc_out weight and bias, then
    (Wx, Wh, bias) of every layer."""

    @staticmethod
    def forward(ctx, cfg, with_ce, targets, tf_mask, h_init, cond, emb, fc_w, fc_b, *leaves):
        params = rebuild_params(cfg, emb, leaves, head=(fc_w, fc_b))
        w = prepare_stack_weights(params, cfg, with_head=True)
        h_init = h_init.detach().float().contiguous()
        cond = cond.detach().float().contiguous()
        out, toks, hs, cs, gs = decoder_fwd(w, h_init, cond, targets, tf_mask, with_ce)
        ctx.save_for_backward(targets, toks, h_init, cond, hs, cs, gs)
        ctx.w, ctx.with_ce = w, with_ce
        return out

    @staticmethod
    def backward(ctx, dout):
        targets, toks, h_init, cond, hs, cs, gs = ctx.saved_tensors
        cfg = ctx.w.cfg
        dW, db, dwout, dbout, demb, dh_init, dcond = decoder_bwd(
            ctx.w, dout.float().contiguous(), targets, toks, h_init, cond, hs, cs, gs,
            ctx.with_ce)
        k0 = cfg.embedding_dim + cfg.num_conditions
        return (None, None, None, None, dh_init, dcond, demb, dwout.T.contiguous(), dbout,
                *layer_grads(dW, db, cfg, k0))


def _apply(params, cfg, h_init, cond, targets, tf_mask, with_ce):
    fc = params["fc_out"]
    return _TrainDecoder.apply(cfg, with_ce, targets.to(torch.int32).contiguous(),
                               tf_mask.bool(), h_init, cond, params["embedding"]["weight"],
                               fc["weight"], fc["bias"], *layer_leaves(params, cfg))


def decoder_train_ce(params: dict, cfg: ModelConfig, h_init: torch.Tensor,
                     conditions: torch.Tensor, target_seq: torch.Tensor,
                     tf_mask: torch.Tensor) -> torch.Tensor:
    """Teacher-forced decode + per-sample reconstruction CE ``[B]``
    (``decoder_train_ce_pallas``). ``h_init [B, H]`` is the shared per-layer
    initial h, ``tf_mask [L]`` the per-step coin flips."""
    return _apply(params, cfg, h_init, conditions, target_seq, tf_mask, True)


def decoder_train(params: dict, cfg: ModelConfig, h_init: torch.Tensor,
                  conditions: torch.Tensor, target_seq: torch.Tensor,
                  tf_mask: torch.Tensor) -> torch.Tensor:
    """Teacher-forced decode -> logits ``[B, L, V]``
    (``decoder_train_pallas``)."""
    return _apply(params, cfg, h_init, conditions, target_seq, tf_mask, False)
