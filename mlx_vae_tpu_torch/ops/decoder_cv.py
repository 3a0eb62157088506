"""Custom-VJP teacher-forced decoders for shapes beyond the whole-stack
kernels (counterpart of ``mlx_vae_tpu/ops/decoder_cv.py``).

Both return logits ``[B, L, V]`` f32 from ``h_init [B, H]`` (every layer's
initial h; cell states start at zero), the conditions and the per-step
teacher-forcing flips ``tf_mask [L]``. The fed-back argmax carries no
gradient, as in the scan decoder.

* :func:`decoder_train_cv`: the plain port of the JAX ``decoder_train_cv``.
  The forward stores the activated gates and c in the compute dtype (h is
  recomputed as ``o * tanh(c)`` in the backward); the backward is one
  reverse-time loop over every layer with the weight gradients summed step
  by step.
* :func:`decoder_train_cvp`: the JAX ``decoder_train_cvp``. The forward is
  the fused training decoder's logits specialization
  (``ops/fused_train_decoder.py:decoder_fwd``, ``with_ce=False``), which
  stores the layer-stacked ``[L, n, B, .]`` residuals. Because the token
  feedback carries no gradient, the backward factorizes by layer: the
  ``fc_out`` gradients and the top layer's cotangent are flat products
  over ``[L*B, .]``, then the per-layer sequence backward
  (``ops/fused_seq_lstm.py:seq_lstm_bwd_tm``) runs top-down over strided
  views of the stacked residuals, layer 0 over ``[embedding rows,
  conditions]``. The TPU version zero-padded layer 0's input to 128 lanes;
  the gradients are the same without it. On CUDA tensors both halves are
  kernels; on CPU tensors their plain versions.
"""

from __future__ import annotations

from typing import Optional

import torch

from mlx_vae_tpu_torch.config import ModelConfig
from mlx_vae_tpu_torch.models.layers import embedding, linear, mm_f32
from mlx_vae_tpu_torch.ops.fused_seq_lstm import _unsupported_reason as seq_unsupported_reason
from mlx_vae_tpu_torch.ops.fused_seq_lstm import seq_lstm_bwd_tm
from mlx_vae_tpu_torch.ops.fused_train_decoder import _fwd_unsupported_reason, decoder_fwd
from mlx_vae_tpu_torch.ops.lstm import combined_weight, gate_activations
from mlx_vae_tpu_torch.ops.train_common import (
    embed_rows, embedding_grad, layer_grads, layer_leaves, prepare_stack_weights,
    rebuild_params)


def _h_of(acts: torch.Tensor, c: torch.Tensor, H: int) -> torch.Tensor:
    """h = o * tanh(c) from one layer's stored residuals."""
    return acts[:, 3 * H:].float() * torch.tanh(c.float())


class _DecoderCV(torch.autograd.Function):
    """Leaves: h_init, cond, embedding, fc_out weight and bias, then (Wx,
    Wh, bias) of every layer."""

    @staticmethod
    def forward(ctx, cfg, targets, tf_mask, h_init, cond, emb, fc_w, fc_b, *leaves):
        params = rebuild_params(cfg, emb, leaves, head=(fc_w, fc_b))
        dtype, n, H = cfg.dtype, cfg.num_layers, cfg.hidden_dim
        B, L = targets.shape
        cond_f = cond.float()
        ws = [combined_weight(params[f"lstm_layer_{l}"]).to(dtype) for l in range(n)]
        bs = [params[f"lstm_layer_{l}"]["bias"].float() for l in range(n)]
        h = [h_init.float()] * n
        c = [torch.zeros_like(h_init, dtype=torch.float32)] * n
        token = torch.full((B,), cfg.start_token, dtype=torch.int32, device=h_init.device)
        logits_all, gates_res, cs_res, toks = [], [], [], []
        for t in range(L):
            toks.append(token)
            e = embedding(params["embedding"], token, dtype, onehot=True)
            x = torch.cat([e.float(), cond_f], dim=1)
            g_t, c_t = [], []
            for l in range(n):
                gates = mm_f32(torch.cat([x, h[l]], dim=1), ws[l], dtype) + bs[l]
                i, f, g, o = gate_activations(gates, H)
                c[l] = f * c[l] + i * g
                h[l] = o * torch.tanh(c[l])
                g_t.append(torch.cat([i, f, g, o], dim=1).to(dtype))
                c_t.append(c[l].to(dtype))
                x = h[l]
            logits = linear(params["fc_out"], x, dtype)
            logits_all.append(logits)
            gates_res.append(torch.stack(g_t))
            cs_res.append(torch.stack(c_t))
            token = torch.where(tf_mask[t], targets[:, t], torch.argmax(logits, dim=1).int())
        ctx.save_for_backward(h_init, cond_f, torch.stack(toks), torch.stack(gates_res),
                              torch.stack(cs_res), *ws, params["embedding"]["weight"], fc_w)
        ctx.cfg = cfg
        return torch.stack(logits_all, dim=1)

    @staticmethod
    def backward(ctx, dlogits):
        cfg = ctx.cfg
        h_init, cond_f, toks, gs, cs, *rest = ctx.saved_tensors
        dtype, n, H = cfg.dtype, cfg.num_layers, cfg.hidden_dim
        ws, emb_w, wout = rest[:n], rest[n].to(dtype), rest[n + 1].to(dtype)
        L, _, B, _ = gs.shape
        V, E = emb_w.shape
        C = cond_f.shape[1]
        dev = h_init.device
        f32 = dict(dtype=torch.float32, device=dev)
        dws = [torch.zeros(w.shape, **f32) for w in ws]
        dbs = [torch.zeros((4 * H,), **f32) for _ in range(n)]
        dwout, dbout = torch.zeros((V, H), **f32), torch.zeros((V,), **f32)
        demb, dcond = torch.zeros((V, E), **f32), torch.zeros((B, C), **f32)
        dh = [torch.zeros((B, H), **f32) for _ in range(n)]
        dc = [torch.zeros((B, H), **f32) for _ in range(n)]
        h_init_f = h_init.float()
        for t in range(L - 1, -1, -1):
            dlog = dlogits[:, t].float()
            dlog_c = dlog.to(dtype)
            dwout += mm_f32(dlog_c.T, _h_of(gs[t, n - 1], cs[t, n - 1], H), dtype)
            dbout += dlog.sum(dim=0)
            from_above = mm_f32(dlog_c, wout, dtype)
            for l in range(n - 1, -1, -1):
                i, f, g, o = (a.float() for a in torch.split(gs[t, l], H, dim=1))
                if t == 0:
                    c_prev, h_prev = torch.zeros_like(h_init_f), h_init_f
                else:
                    c_prev = cs[t - 1, l].float()
                    h_prev = _h_of(gs[t - 1, l], cs[t - 1, l], H)
                tc = torch.tanh(cs[t, l].float())
                dh_total = dh[l] + from_above
                dc_tot = dc[l] + dh_total * o * (1.0 - tc * tc)
                dgates = torch.cat([dc_tot * g * i * (1.0 - i), dc_tot * c_prev * f * (1.0 - f),
                                    dc_tot * i * (1.0 - g * g), dh_total * tc * o * (1.0 - o)],
                                   dim=1).to(dtype)
                dinp = mm_f32(dgates, ws[l].T, dtype)
                dbs[l] += dgates.float().sum(dim=0)
                dc[l] = dc_tot * f
                if l > 0:
                    x_in = _h_of(gs[t, l - 1], cs[t, l - 1], H)
                    dws[l] += mm_f32(torch.cat([x_in, h_prev], dim=1).T, dgates, dtype)
                    from_above, dh[l] = dinp[:, :H], dinp[:, H:]
                else:
                    oh = torch.nn.functional.one_hot(toks[t].long(), V).to(dtype)
                    e = mm_f32(oh, emb_w, dtype).to(dtype)
                    x0 = torch.cat([e.float(), cond_f], dim=1)
                    dws[0] += mm_f32(torch.cat([x0, h_prev], dim=1).T, dgates, dtype)
                    demb += mm_f32(oh.T, dinp[:, :E], dtype)
                    dcond += dinp[:, E:E + C]
                    dh[0] = dinp[:, E + C:]
        k0 = E + C
        return (None, None, None, sum(dh), dcond, demb, dwout, dbout,
                *layer_grads(dws, torch.stack(dbs), cfg, k0))


class _DecoderCVP(torch.autograd.Function):
    """Leaves as :class:`_DecoderCV`."""

    @staticmethod
    def forward(ctx, cfg, targets, tf_mask, h_init, cond, emb, fc_w, fc_b, *leaves):
        w = prepare_stack_weights(rebuild_params(cfg, emb, leaves, head=(fc_w, fc_b)), cfg,
                                  with_head=True)
        h_init = h_init.detach().float().contiguous()
        cond = cond.detach().float().contiguous()
        logits, toks, hs, cs, gs = decoder_fwd(w, h_init, cond, targets, tf_mask, False)
        ctx.save_for_backward(h_init, cond, toks, hs, cs, gs)
        ctx.w = w
        return logits

    @staticmethod
    def backward(ctx, dlogits):
        h_init, cond, toks, hs, cs, gs = ctx.saved_tensors
        w = ctx.w
        cfg = w.cfg
        wdt, E = cfg.dtype, cfg.embedding_dim
        L, n, B, H = hs.shape
        V = cfg.vocab_size
        # fc_out's gradients and the top layer's cotangent, flat over [L*B, .]
        dlog = dlogits.float().transpose(0, 1).reshape(L * B, V)
        dlog_c = dlog.to(wdt)
        h_top = hs[:, n - 1].reshape(L * B, H)
        dwout = mm_f32(dlog_c.T, h_top, wdt)
        dbout = dlog.sum(dim=0)
        dh_stream = mm_f32(dlog_c, w.woutT, wdt).reshape(L, B, H)
        # per-layer reverse passes, top-down, over [L*n, B, .] views
        hs2, cs2, gs2 = (a.view(L * n, B, a.shape[-1]) for a in (hs, cs, gs))
        zero = torch.zeros_like(h_init)
        dh_init = torch.zeros_like(h_init)
        dW, db = [None] * n, [None] * n
        for l in range(n - 1, -1, -1):
            if l > 0:
                xs = dict(xs_t=hs2, xs_stride=n, xs_offset=l - 1)
            else:
                x0 = torch.cat([embed_rows(w.emb, toks),
                                cond.to(wdt)[None].expand(L, -1, -1)], dim=-1)
                xs = dict(xs_t=x0.contiguous())
            dxs, dW[l], db[l], dh0, _ = seq_lstm_bwd_tm(
                w.layers[l], h0=h_init, c0=zero, hs_t=hs2, cs_t=cs2, gs_t=gs2, dhs_t=dh_stream,
                dhf=zero, dcf=zero, res_stride=n, res_offset=l, **xs)
            dh_init += dh0
            dh_stream = dxs
        demb = embedding_grad(dh_stream[..., :E].to(wdt), toks, V)
        dcond = dh_stream[..., E:].sum(dim=0)
        return (None, None, None, dh_init, dcond, demb, dwout, dbout,
                *layer_grads(dW, torch.stack(db), cfg, E + cfg.num_conditions))


def _apply(fn, params, cfg, h_init, conditions, target_seq, tf_mask):
    fc = params["fc_out"]
    return fn.apply(cfg, target_seq.to(torch.int32).contiguous(),
                    tf_mask.to(h_init.device).bool(), h_init, conditions,
                    params["embedding"]["weight"], fc["weight"], fc["bias"],
                    *layer_leaves(params, cfg))


def decoder_train_cv(params: dict, cfg: ModelConfig, h_init: torch.Tensor,
                     conditions: torch.Tensor, target_seq: torch.Tensor,
                     tf_mask: torch.Tensor) -> torch.Tensor:
    """Teacher-forced decode -> logits ``[B, L, V]`` with the plain
    hand-written backward (``decoder_train_cv``)."""
    return _apply(_DecoderCV, params, cfg, h_init, conditions, target_seq, tf_mask)


def decoder_train_cvp(params: dict, cfg: ModelConfig, h_init: torch.Tensor,
                      conditions: torch.Tensor, target_seq: torch.Tensor,
                      tf_mask: torch.Tensor) -> torch.Tensor:
    """Teacher-forced decode -> logits ``[B, L, V]`` through the fused
    forward and the per-layer backward (``decoder_train_cvp``)."""
    return _apply(_DecoderCVP, params, cfg, h_init, conditions, target_seq, tf_mask)


def cvp_unsupported_reason(cfg: ModelConfig) -> Optional[str]:
    """Why the fused forward or a per-layer backward refuses ``cfg`` (that
    kernel's own reason), or None."""
    H = cfg.hidden_dim
    widths = [cfg.embedding_dim + cfg.num_conditions] + [H] * (cfg.num_layers > 1)
    reasons = [_fwd_unsupported_reason(cfg)] + [seq_unsupported_reason(i, H, cfg.dtype)
                                                for i in widths]
    return next((r for r in reasons if r is not None), None)


def decoder_cvp_supported(cfg: ModelConfig) -> bool:
    """Whether the fused forward and every per-layer backward take ``cfg``."""
    return cvp_unsupported_reason(cfg) is None
