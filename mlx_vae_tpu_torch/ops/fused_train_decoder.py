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
launches its kernels on CUDA tensors (counted once per call in
``.launches``) and runs its plain version, :func:`decoder_fwd_reference` /
:func:`decoder_bwd_reference`, on CPU tensors. The forward's route is chosen
by dtype before any launch, in one frame: one set-up launch, then per step
n launches of ``csrc/train_common.cuh``'s forward step kernel
(``seq_fwd_step_kernel`` on bf16 ``wgmma``, ``seq_fwd_tf32_kernel`` as
split-TF32 in f32) and one launch of the vocab head (``dec_head_kernel``,
``dec_head_tf32_kernel``); :func:`decoder_fwd_steps_reference` is the plain
twin launch by launch (``split_tf32=True`` for f32),
:func:`decoder_head_step_reference` of one head launch, and
:func:`decoder_fwd_launch_plan` the host side's plan. So is the backward's,
in one frame for both dtypes: a head pass over all L * B rows (two launches,
``dec_head_bwd_kernel`` and ``dec_dtop_kernel`` on bf16 ``wgmma``,
``dec_head_bwd_tf32_kernel`` and ``dec_dtop_tf32_kernel`` as split-TF32 in
f32; :func:`decoder_head_bwd_reference`), then the reverse chain, 1 + n * L
tensor-core launches (``dec_step_kernel``, ``dec_step_tf32_kernel``;
:func:`decoder_reverse_step_reference` is the plain twin of one,
:func:`decoder_reverse_steps_reference` of the whole reverse launch by
launch, ``split_tf32=True`` for f32), and the sum of d(h_init). Then the
weight-gradient sums (:func:`decoder_grads`). The plain
versions store the same residuals in the same dtype (h, c and ACTIVATED
gates in the compute dtype) and the plain backward computes from them what
the kernels' backward computes, so the card can hold each kernel against
its plain version on identical inputs. Shapes outside
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
    MAX_SMEM, MAX_V, SCRATCH_ELEMS, TF32_SMEM, StackWeights, bwd_rows, cell_step_reference,
    check, embed_rows, embedding_grad, fwd_step_plan, fwd_tile, interleave_weight, layer_grads,
    layer_leaves, prepare_stack_weights, raise_if, rebuild_params, require_cuda,
    reverse_gate_reference, reverse_step_reference, scratch_fits, seq_fwd_step_reference, shifted,
    split_tf32_matmul, stream_of, sum_outer)


# ----------------------------------------------------------- plain version

def _fwd_outputs(cfg: ModelConfig, B: int, L: int, dev, with_ce: bool):
    """``(out, toks, hs, cs, gs)`` of a forward, with ``toks[0]`` the start
    token and ``out`` zeros."""
    n, H = cfg.num_layers, cfg.hidden_dim
    hs = torch.empty((L, n, B, H), dtype=cfg.dtype, device=dev)
    gs = torch.empty((L, n, B, 4 * H), dtype=cfg.dtype, device=dev)
    toks = torch.empty((L, B), dtype=torch.int32, device=dev)
    toks[0] = cfg.start_token
    out = torch.zeros((B,) if with_ce else (B, L, cfg.vocab_size), dtype=torch.float32,
                      device=dev)
    return out, toks, hs, torch.empty_like(hs), gs


def decoder_head_step_reference(w: StackWeights, t: int, hs: torch.Tensor,
                                targets: torch.Tensor, tf: torch.Tensor, toks: torch.Tensor,
                                out: torch.Tensor, with_ce: bool,
                                split_tf32: bool = False) -> None:
    """Plain twin of one vocab-head launch (``dec_head_kernel``; with
    ``split_tf32`` the f32 ``dec_head_tf32_kernel``, whose product is
    :func:`~mlx_vae_tpu_torch.ops.train_common.split_tf32_matmul`), step
    ``t``, in place: the logits of the top layer's stored h ``hs[t, n-1]``
    (f32 products of the rounded operands); with CE, ``out [B] += logsumexp
    - logit[target]`` (0 for a target outside [0, V)), else ``out[:, t] =
    logits`` (``out [B, L, V]``); and for ``t + 1 < L``, ``toks[t + 1]`` is
    the target where ``tf[t]``, else the argmax (ties to the lowest
    index)."""
    V = w.cfg.vocab_size
    L, n = hs.shape[:2]
    mm = split_tf32_matmul if split_tf32 else torch.matmul
    logits = mm(hs[t, n - 1].float(), w.wout.float()) + w.bout
    target = targets[:, t].int()
    if with_ce:
        m = logits.max(dim=1, keepdim=True).values
        lse = m[:, 0] + torch.log(torch.exp(logits - m).sum(dim=1))
        ok = (target >= 0) & (target < V)
        tl = logits.gather(1, target.long().clamp(0, V - 1)[:, None])[:, 0]
        out += lse - torch.where(ok, tl, torch.zeros_like(tl))
    else:
        out[:, t] = logits
    if t + 1 < L:
        toks[t + 1] = torch.where(tf[t], target, torch.argmax(logits, dim=1).int())


def decoder_fwd_reference(w: StackWeights, h_init: torch.Tensor, cond: torch.Tensor,
                          targets: torch.Tensor, tf_mask: torch.Tensor, with_ce: bool):
    """Plain twin of the forward kernels. Returns ``(out, toks, hs, cs, gs)``:
    ``out`` the CE ``[B]`` (``with_ce``) or logits ``[B, L, V]``, f32;
    ``toks [L, B]`` int32 the fed tokens; ``hs``/``cs [L, n, B, H]`` and
    ``gs [L, n, B, 4H]`` in the compute dtype."""
    cfg = w.cfg
    wdt, n = cfg.dtype, cfg.num_layers
    B, L = targets.shape
    dev = h_init.device
    out, toks, hs, cs, gs = _fwd_outputs(cfg, B, L, dev, with_ce)
    h = [h_init.float()] * n
    c = [torch.zeros_like(h_init, dtype=torch.float32)] * n
    cond = cond.float()
    tf = tf_mask.to(dev).bool()
    for t in range(L):
        x = torch.cat([embed_rows(w.emb, toks[t]).float(), cond], dim=1)
        for l in range(n):
            h[l], c[l], g = cell_step_reference(w.layers[l], w.bias[l], x, h[l], c[l], wdt)
            hs[t, l], cs[t, l], gs[t, l] = h[l], c[l], g
            x = h[l]
        decoder_head_step_reference(w, t, hs, targets, tf, toks, out, with_ce)
    return out, toks, hs, cs, gs


def decoder_fwd_steps_reference(w: StackWeights, h_init: torch.Tensor, cond: torch.Tensor,
                                targets: torch.Tensor, tf_mask: torch.Tensor, with_ce: bool,
                                split_tf32: bool = False):
    """Plain twin of the forward kernels, launch by launch (contract of
    :func:`decoder_fwd_reference`, which it equals bit for bit without
    ``split_tf32``): per step, the step kernel's twin
    (``train_common.seq_fwd_step_reference``) per layer, layer 0 over the
    fed tokens' embedding rows and the conditions, layer l > 0 over the
    layer below's stored h, with residuals at rows ``t * n + l``, h_{-1} =
    ``h_init`` and c_{-1} = 0; then :func:`decoder_head_step_reference`.
    ``split_tf32``: the f32 kernels' products (the step's and the head's),
    within the split's ~2^-21 of each product."""
    cfg = w.cfg
    n, H, E, C = cfg.num_layers, cfg.hidden_dim, cfg.embedding_dim, cfg.num_conditions
    B, L = targets.shape
    dev = h_init.device
    out, toks, hs, cs, gs = _fwd_outputs(cfg, B, L, dev, with_ce)
    hs2, cs2, gs2 = (a.view(L * n, B, a.shape[-1]) for a in (hs, cs, gs))
    wts = [interleave_weight(m, E if l == 0 else H, H, C if l == 0 else 0)
           for l, m in enumerate(w.layers)]
    c = torch.empty((n, B, H), dtype=torch.float32, device=dev)
    cond, h_init = cond.float(), h_init.float()
    tf = tf_mask.to(dev).bool()
    for t in range(L):
        for l in range(n):
            kw = (dict(xs=w.emb, I=E, tokens=toks.T, cond=cond) if l == 0 else
                  dict(xs=hs2, I=H, x_stride=n, x_offset=l - 1))
            seq_fwd_step_reference(wts[l], w.bias[l], t, c=c[l], hs=hs2, cs=cs2, gs=gs2, H=H,
                                   h0=h_init, res_stride=n, res_offset=l,
                                   split_tf32=split_tf32, **kw)
        decoder_head_step_reference(w, t, hs, targets, tf, toks, out, with_ce, split_tf32)
    return out, toks, hs, cs, gs


def _head_bwd_step(w: StackWeights, t: int, din: torch.Tensor, targets: torch.Tensor,
                   hs: torch.Tensor, with_ce: bool, split_tf32: bool = False):
    """Step ``t`` of the vocab head's backward: ``(dlogits [B, V], the top
    layer's h cotangent [B, H])``, both f32. With CE, dlogits is (softmax of
    the logits recomputed from the stored top h - onehot(target)) * dce,
    where a target outside [0, V) adds no one-hot; the cotangent is dlogits
    rounded to the compute dtype times fc_out^T, f32 sums (JAX's
    ``from_above``). ``split_tf32``: both products as the f32 kernels form
    them (:func:`~mlx_vae_tpu_torch.ops.train_common.split_tf32_matmul`)."""
    V, wdt = w.cfg.vocab_size, w.cfg.dtype
    n = hs.shape[1]
    wout = w.wout.float()
    mm = split_tf32_matmul if split_tf32 else torch.matmul
    if with_ce:
        logits = mm(hs[t, n - 1].float(), wout) + w.bout
        p = torch.softmax(logits, dim=1)
        target = targets[:, t].long()
        onehot = torch.nn.functional.one_hot(target.clamp(0, V - 1), V).float()
        onehot = onehot * ((target >= 0) & (target < V)).float()[:, None]
        dl = (p - onehot) * din.float()[:, None]
    else:
        dl = din[:, t].float()
    return dl, mm(dl.to(wdt).float(), wout.T)


def decoder_reverse_reference(w: StackWeights, din: torch.Tensor, targets: torch.Tensor,
                              hs: torch.Tensor, cs: torch.Tensor, gs: torch.Tensor,
                              with_ce: bool):
    """Plain twin of the reverse kernels: ``(dgates [L, n, B, 4H] and dx0
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
    for t in range(L - 1, -1, -1):
        dlog[t], fa = _head_bwd_step(w, t, din, targets, hs, with_ce)
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


def decoder_head_bwd_reference(w: StackWeights, din: torch.Tensor, targets: torch.Tensor,
                               hs: torch.Tensor, with_ce: bool, split_tf32: bool = False):
    """Plain twin of the backward's head pass (``dec_head_bwd_kernel`` then
    ``dec_dtop_kernel``; with ``split_tf32`` the f32
    ``dec_head_bwd_tf32_kernel`` then ``dec_dtop_tf32_kernel``): ``(dlog [L,
    B, V], dtop [L, B, H])`` f32, the head's backward of every step, each
    formed as :func:`decoder_reverse_reference` forms it (``split_tf32``:
    within the split's ~2^-21 of each product)."""
    L, _, B, H = hs.shape
    f32 = dict(dtype=torch.float32, device=hs.device)
    dlog = torch.empty((L, B, w.cfg.vocab_size), **f32)
    dtop = torch.empty((L, B, H), **f32)
    for t in range(L):
        dlog[t], dtop[t] = _head_bwd_step(w, t, din, targets, hs, with_ce, split_tf32)
    return dlog, dtop


def decoder_reverse_step_reference(w: StackWeights, t: int, l: int, cs: torch.Tensor,
                                   gs: torch.Tensor, dtop: torch.Tensor, dgates: torch.Tensor,
                                   dx0: torch.Tensor, dcond: torch.Tensor, dh: torch.Tensor,
                                   dc: torch.Tensor, split_tf32: bool = False) -> None:
    """Plain twin of one ``dec_step_kernel`` launch, (step ``t``, layer
    ``l``), in place (``split_tf32``: of one f32 ``dec_step_tf32_kernel``
    launch, whose product is
    :func:`~mlx_vae_tpu_torch.ops.train_common.split_tf32_matmul`).

    ``dinp = dgates[t, l] W_l^T`` (f32 products of the rounded operands, as
    :func:`decoder_reverse_reference` forms them), then each column as the
    kernel's epilogue routes it: the input columns run the gate step of
    ``(t, l-1)`` with ``dh[l-1] + value`` (``l > 0``), or are ``dx0[t]``
    (``k < E``) and added to ``dcond`` (``E <= k < E + C``) at ``l = 0``; the
    top layer's h columns at ``t > 0`` run the gate step of ``(t-1, n-1)``
    with ``value + dtop[t-1]``; the other h columns go to ``dh[l]``. ``dh``,
    ``dc``: the kernels' ``[n, B, H]`` f32 buffers, and ``dcond [B, C]``,
    zeros before the chain's first launch."""
    cfg = w.cfg
    n, E = cfg.num_layers, cfg.embedding_dim
    kx = E + cfg.num_conditions if l == 0 else cfg.hidden_dim
    mm = split_tf32_matmul if split_tf32 else torch.matmul
    dinp = mm(dgates[t, l].float(), w.layers[l].float().T)
    if l > 0:
        reverse_gate_reference(cfg, t, l - 1, dh[l - 1] + dinp[:, :kx], cs, gs, dgates, dc)
    else:
        dx0[t] = dinp[:, :E]
        dcond += dinp[:, E:kx]
    if l == n - 1 and t > 0:
        reverse_gate_reference(cfg, t - 1, l, dinp[:, kx:] + dtop[t - 1], cs, gs, dgates, dc)
    else:
        dh[l] = dinp[:, kx:]


def decoder_reverse_steps_reference(w: StackWeights, din: torch.Tensor, targets: torch.Tensor,
                                    hs: torch.Tensor, cs: torch.Tensor, gs: torch.Tensor,
                                    with_ce: bool, split_tf32: bool = False):
    """Plain twin of the reverse, launch by launch (contract of
    :func:`decoder_reverse_reference`, which it equals bit for bit without
    ``split_tf32``): the head pass (:func:`decoder_head_bwd_reference`); the
    gate step of (L-1, n-1) from ``dh[n-1] + dtop[L-1]``;
    :func:`decoder_reverse_step_reference` for t = L-1 .. 0, l = n-1 .. 0;
    then d(h_init), the sum of ``dh`` over layers, layer 0 first.
    ``split_tf32``: the f32 kernels' products (the head pass's and the
    chain's), within the split's ~2^-21 of each product."""
    cfg = w.cfg
    L, n, B, H = hs.shape
    dev = hs.device
    dgates = torch.empty((L, n, B, 4 * H), dtype=cfg.dtype, device=dev)
    dx0 = torch.empty((L, B, cfg.embedding_dim), dtype=cfg.dtype, device=dev)
    dcond = torch.zeros((B, cfg.num_conditions), dtype=torch.float32, device=dev)
    dh, dc = torch.zeros((2, n, B, H), dtype=torch.float32, device=dev)
    dlog, dtop = decoder_head_bwd_reference(w, din, targets, hs, with_ce, split_tf32)
    reverse_gate_reference(cfg, L - 1, n - 1, dh[n - 1] + dtop[L - 1], cs, gs, dgates, dc)
    for t in range(L - 1, -1, -1):
        for l in range(n - 1, -1, -1):
            decoder_reverse_step_reference(w, t, l, cs, gs, dtop, dgates, dx0, dcond, dh, dc,
                                           split_tf32)
    return dgates, dx0, dlog, sum(dh), dcond


def decoder_grads(w: StackWeights, toks: torch.Tensor, h_init: torch.Tensor,
                  cond: torch.Tensor, hs: torch.Tensor, dgates: torch.Tensor,
                  dx0: torch.Tensor, dlog: torch.Tensor):
    """The weight-gradient sums from the reverse chain's outputs: ``(dW, db,
    dwout, dbout, demb)``: ``dW`` a list of per-layer ``[K_l + H, 4H]``,
    ``db [n, 4H]``, ``dwout [H, V]``, ``dbout [V]``, ``demb [V, E]``, all
    f32."""
    cfg = w.cfg
    wdt, n = cfg.dtype, cfg.num_layers
    L = hs.shape[0]
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
    return dW, db, dwout, dbout, demb


def decoder_bwd_reference(w: StackWeights, din: torch.Tensor, targets: torch.Tensor,
                          toks: torch.Tensor, h_init: torch.Tensor, cond: torch.Tensor,
                          hs: torch.Tensor, cs: torch.Tensor, gs: torch.Tensor,
                          with_ce: bool):
    """Plain twin of the backward kernels. ``din`` is ``dce [B]``
    (``with_ce``) or ``dlogits [B, L, V]``. Returns ``(dW, db, dwout, dbout,
    demb, dh_init, dcond)``: :func:`decoder_grads` of
    :func:`decoder_reverse_reference`, then its d(h_init) and d(cond)."""
    dgates, dx0, dlog, dh_init, dcond = decoder_reverse_reference(
        w, din, targets, hs, cs, gs, with_ce)
    return (*decoder_grads(w, toks, h_init, cond, hs, dgates, dx0, dlog), dh_init, dcond)


# ------------------------------------------------------------------ kernels

# The forward's and the backward's shared-memory rules are those of the
# row-tiled kernels they replaced: the head, step and chain launches take
# every width, but the rules stay the support predicate, so that the routes
# (which ask it, as the JAX package asks its own) do not move.
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


HEAD_STATE = 5 * 128 * 4  # csrc HEAD_STATE: a head block's per-row state, bytes


def decoder_fwd_launch_plan(cfg: ModelConfig, B: int, L: int) -> list:
    """The launches of one forward call (the host side of
    ``csrc/fused_train_decoder.cu:launch_fwd``), each ``dict(kernel, grid,
    smem, count)``, the step launches also with ``Kp``: one set-up launch,
    then per step n step launches (one per layer, layer 0 with the
    conditions' segment) and one vocab head, in bf16 on ``wgmma``, in f32
    as split-TF32. ``smem`` is a block's dynamic shared memory: the bf16
    ring (3 x 32 KB) or the split-TF32 ring (3 x 64 KB), each with 1 KB of
    alignment slack, and the head's per-row state; grids are (x, y, z)."""
    E, C, H, n = cfg.embedding_dim, cfg.num_conditions, cfg.hidden_dim, cfg.num_layers
    bf16 = cfg.compute_dtype == "bfloat16"
    ring = 3 * 32768 + 1024 if bf16 else TF32_SMEM
    rows = -(-B // 128)
    out = [dict(kernel="dec_init_kernel", grid=(-(-B // 256), 1, 1), smem=0, count=1)]
    for l in range(n):
        _, kp, np_ = fwd_step_plan(E if l == 0 else H, H, C if l == 0 else 0)
        out.append(dict(kernel="seq_fwd_step_kernel" if bf16 else "seq_fwd_tf32_kernel",
                        grid=(np_ // 128, rows, 1), smem=ring, count=L, Kp=kp))
    out.append(dict(kernel="dec_head_kernel" if bf16 else "dec_head_tf32_kernel",
                    grid=(rows, 1, 1), smem=HEAD_STATE + ring, count=L))
    return out


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
    lib.dec_fwd_launch.argtypes = [p] * 15 + [i] * 10 + [p]
    lib.dec_fwd_launch.restype = i
    lib.dec_head_launch.argtypes = [p] * 7 + [i] * 7 + [p]
    lib.dec_head_launch.restype = i
    lib.dec_bwd_launch.argtypes = [p] * 27 + [lg] + [i] * 9 + [p]
    lib.dec_bwd_launch.restype = i
    lib.dec_head_bwd_launch.argtypes = [p] * 8 + [i] * 7 + [p]
    lib.dec_head_bwd_launch.restype = i
    lib.dec_error_string.argtypes = [i]
    lib.dec_error_string.restype = ctypes.c_char_p
    return lib


def launch_decoder_fwd(lib, w: StackWeights, h_init, cond, targets, tf, with_ce: bool,
                       stream: int):
    """Allocate the outputs, the interleaved weights and the layers'
    running c, and launch the forward kernels (no device or support checks:
    :func:`decoder_fwd` makes them)."""
    cfg = w.cfg
    B, L = targets.shape
    H, n, V, E, C = (cfg.hidden_dim, cfg.num_layers, cfg.vocab_size, cfg.embedding_dim,
                     cfg.num_conditions)
    dev, wdt = h_init.device, cfg.dtype
    out = torch.empty((B,) if with_ce else (B, L, V), dtype=torch.float32, device=dev)
    toks = torch.empty((L, B), dtype=torch.int32, device=dev)
    hs = torch.empty((L, n, B, H), dtype=wdt, device=dev)
    cs = torch.empty_like(hs)
    gs = torch.empty((L, n, B, 4 * H), dtype=wdt, device=dev)
    # each layer's interleaved copy, back to back, and the running c
    wt = torch.cat([interleave_weight(m, E if l == 0 else H, H, C if l == 0 else 0).reshape(-1)
                    for l, m in enumerate(w.layers)])
    cbuf = torch.empty((n, B, H), dtype=torch.float32, device=dev)
    rc = lib.dec_fwd_launch(
        targets.data_ptr(), tf.data_ptr(), cond.data_ptr(), h_init.data_ptr(), w.emb.data_ptr(),
        wt.data_ptr(), w.bias.data_ptr(), w.woutT.data_ptr(), w.bout.data_ptr(), out.data_ptr(),
        toks.data_ptr(), hs.data_ptr(), cs.data_ptr(), gs.data_ptr(), cbuf.data_ptr(),
        B, L, V, E, C, H, n, int(with_ce), cfg.start_token, int(wdt == torch.bfloat16), stream)
    raise_if(rc, "decoder forward", lib.dec_error_string)
    return out, toks, hs, cs, gs


def launch_decoder_head(lib, w: StackWeights, t: int, hs, targets, tf, toks, out,
                        with_ce: bool, stream: int) -> None:
    """One vocab-head launch alone, step ``t`` of a forward, in place on
    ``toks`` and ``out``: ``dec_head_kernel`` for bf16 ``hs``,
    ``dec_head_tf32_kernel`` for f32 (contract of
    :func:`decoder_head_step_reference`, with ``split_tf32`` in f32; for
    holding the kernel against its twin: no checks, no count)."""
    L, n, B, H = hs.shape
    rc = lib.dec_head_launch(hs[t, n - 1].data_ptr(), w.woutT.data_ptr(), w.bout.data_ptr(),
                             targets.data_ptr(), tf.data_ptr(), out.data_ptr(), toks.data_ptr(),
                             B, L, w.cfg.vocab_size, H, t, int(with_ce),
                             int(hs.dtype == torch.bfloat16), stream)
    raise_if(rc, "decoder head", lib.dec_error_string)


def decoder_fwd(w: StackWeights, h_init: torch.Tensor, cond: torch.Tensor,
                targets: torch.Tensor, tf_mask: torch.Tensor, with_ce: bool):
    """The forward (contract of :func:`decoder_fwd_reference`). CPU tensors
    run the plain version; CUDA tensors launch the kernels (the step and
    head chain: :func:`decoder_fwd_launch_plan`), counted once per call in
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
                       with_ce: bool, stream: int, with_reverse: bool = False):
    """Allocate the outputs and scratch and launch the backward kernels (no
    device or support checks: :func:`decoder_bwd` makes them): the head pass
    and the tensor-core reverse chain on ``wcat`` (bf16 ``wgmma``, f32
    split-TF32) with zeroed ``[n, B, H]`` dh and dc buffers and an ``[L, B,
    H]`` dtop, then the weight-gradient sums. Returns ``(dW, db, dwout, dbout,
    demb, dh_init, dcond)``, and with ``with_reverse`` also the reverse's
    ``(dgates, dx0, dlog, dh_init, dcond)`` (the contract of
    :func:`decoder_reverse_reference`)."""
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
    dcond = torch.zeros((B, C), **f32)
    sizes = [(K0 + H) * 4 * H] + [2 * H * 4 * H] * (n - 1)
    dW_flat = torch.empty((sum(sizes),), **f32)
    db = torch.empty((n, 4 * H), **f32)
    dwout = torch.empty((H, V), **f32)
    dbout = torch.empty((V,), **f32)
    demb = torch.empty((V, E), **f32)
    scratch = torch.empty((SCRATCH_ELEMS,), **f32)
    dh, dc = torch.zeros((2, n, B, H), **f32)
    dtop = torch.empty((L, B, H), **f32)
    h0 = h_init.to(wdt).contiguous()
    cond_w = cond.to(wdt).contiguous()
    rc = lib.dec_bwd_launch(
        din.data_ptr(), targets.data_ptr(), toks.data_ptr(), hs.data_ptr(), cs.data_ptr(),
        gs.data_ptr(), w.emb.data_ptr(), w.wcat.data_ptr(), w.wout.data_ptr(),
        w.woutT.data_ptr(), w.bout.data_ptr(), h0.data_ptr(), cond_w.data_ptr(),
        dh.data_ptr(), dc.data_ptr(), dtop.data_ptr(), dgates.data_ptr(), dx0.data_ptr(),
        dlog.data_ptr(), dh_init.data_ptr(), dcond.data_ptr(), dW_flat.data_ptr(),
        db.data_ptr(), dwout.data_ptr(), dbout.data_ptr(), demb.data_ptr(), scratch.data_ptr(),
        SCRATCH_ELEMS, B, L, V, E, C, H, n, int(wdt == torch.bfloat16), int(with_ce), stream)
    raise_if(rc, "decoder backward", lib.dec_error_string)
    dW, off = [], 0
    for size in sizes:
        dW.append(dW_flat[off:off + size].view(size // (4 * H), 4 * H))
        off += size
    res = (dW, db, dwout, dbout, demb, dh_init, dcond)
    return res + (dgates, dx0, dlog, dh_init, dcond) if with_reverse else res


def launch_decoder_head_bwd(lib, w: StackWeights, din, targets, hs, with_ce: bool,
                            stream: int):
    """The backward's head pass alone, by the residuals' dtype
    (``dec_head_bwd_kernel`` then ``dec_dtop_kernel`` for bf16 ``hs``,
    ``dec_head_bwd_tf32_kernel`` then ``dec_dtop_tf32_kernel`` for f32):
    ``(dlog [L, B, V], dtop [L, B, H])`` f32, the contract of
    :func:`decoder_head_bwd_reference` (with ``split_tf32`` in f32; for
    holding the kernels against their twin: no checks, no count)."""
    L, n, B, H = hs.shape
    V = w.cfg.vocab_size
    dlog = torch.empty((L, B, V), dtype=torch.float32, device=hs.device)
    dtop = torch.empty((L, B, H), dtype=torch.float32, device=hs.device)
    rc = lib.dec_head_bwd_launch(hs.data_ptr(), w.woutT.data_ptr(), w.wout.data_ptr(),
                                 w.bout.data_ptr(), targets.data_ptr(), din.data_ptr(),
                                 dlog.data_ptr(), dtop.data_ptr(), B, L, V, H, n,
                                 int(with_ce), int(hs.dtype == torch.bfloat16), stream)
    raise_if(rc, "decoder head backward", lib.dec_error_string)
    return dlog, dtop


def decoder_bwd(w: StackWeights, din: torch.Tensor, targets: torch.Tensor,
                toks: torch.Tensor, h_init: torch.Tensor, cond: torch.Tensor,
                hs: torch.Tensor, cs: torch.Tensor, gs: torch.Tensor, with_ce: bool):
    """The backward (contract of :func:`decoder_bwd_reference`). CPU tensors
    run the plain version; CUDA tensors launch the kernels (the head pass
    and the tensor-core reverse chain: bf16 ``wgmma``, f32 split-TF32), then
    the weight-gradient sums, counted once per call in
    ``decoder_bwd.launches``."""
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
