"""What the port's kernel wrappers share (the Python twin of
``csrc/train_common.cuh``).

* The card's limits and the kernels' built-in instances: threads per block,
  shared memory per block, L2, the largest vocabulary, the rows-per-thread
  and reverse-rows instances, the split-reduction scratch. The sampler's wrapper
  (``ops/fused_decoder.py``) uses the first four too.
* The train kernels' layout: :class:`StackWeights` and
  :func:`prepare_stack_weights`, the mapping between the params' ``{Wx, Wh,
  bias}`` leaves and the kernels' stacked weights and gradients.
* The tile rule (:func:`fwd_tile`, :func:`bwd_rows`, :func:`scratch_fits`)
  and the route rule (:func:`stack_fits_l2`).
* The plain versions' shared steps (one LSTM cell, its reverse step from
  activated gates, the weight- and embedding-gradient sums).
* The argument and device checks every wrapper makes before a launch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from mlx_vae_tpu_torch.config import ModelConfig
from mlx_vae_tpu_torch.ops.lstm import combined_weight, gate_activations

NT = 256            # CUDA threads per block (csrc: NT, train::NT)
MAX_SMEM = 232448   # bytes of shared memory one H100 block may use
L2_BYTES = 50 * 1024 * 1024  # the H100's L2 cache
MAX_V = 512         # csrc: 32 lanes x 16 vocab entries per lane
RPTS = (8, 4, 2, 1)  # forward rows per thread the kernels are built for
RS = (8, 4, 2, 1)    # reverse-kernel rows per block the kernels are built for
SCRATCH_ELEMS = 1 << 23  # f32 partial sums of the split reductions (32 MB)


# ----------------------------------------------------------- weights

@dataclass(frozen=True)
class StackWeights:
    """An LSTM stack's weights in the kernels' layout, on one device.

    ``wcat`` holds every layer's ``[K_l + H, 4H]`` combined weight back to
    back and ``wT`` every layer's transpose ``[4H, K_l + H]`` (the reverse
    kernels read input columns from it); ``layers`` are views of ``wcat``.
    Matrices are in the compute dtype, biases in float32. ``wout``,
    ``woutT`` and ``bout`` (decoder only) are ``fc_out`` as ``[H, V]``,
    ``[V, H]`` and ``[V]``.
    """

    cfg: ModelConfig
    emb: torch.Tensor
    wcat: torch.Tensor
    wT: torch.Tensor
    layers: tuple
    bias: torch.Tensor
    wout: Optional[torch.Tensor] = None
    woutT: Optional[torch.Tensor] = None
    bout: Optional[torch.Tensor] = None


def prepare_stack_weights(params: dict, cfg: ModelConfig,
                          with_head: bool) -> StackWeights:
    """Cast and stack ``params`` (an encoder or decoder tree, f32 masters)
    into :class:`StackWeights` on the params' device. Copies every weight:
    the train step does this once per step."""
    wdt = cfg.dtype
    with torch.no_grad():
        mats = [combined_weight(params[f"lstm_layer_{i}"]).to(wdt)
                for i in range(cfg.num_layers)]
        wcat = torch.cat([m.reshape(-1) for m in mats])
        wT = torch.cat([m.T.reshape(-1) for m in mats])
        layers, off = [], 0
        for m in mats:
            layers.append(wcat[off:off + m.numel()].view(m.shape))
            off += m.numel()
        bias = torch.stack([params[f"lstm_layer_{i}"]["bias"]
                            for i in range(cfg.num_layers)]).float().contiguous()
        head = {}
        if with_head:
            wout = params["fc_out"]["weight"].to(wdt)
            head = dict(wout=wout.T.contiguous(), woutT=wout.contiguous(),
                        bout=params["fc_out"]["bias"].float().contiguous())
        return StackWeights(cfg=cfg, emb=params["embedding"]["weight"].to(wdt).contiguous(),
                            wcat=wcat, wT=wT, layers=tuple(layers), bias=bias, **head)


def layer_grads(dW: List[torch.Tensor], db: torch.Tensor, cfg: ModelConfig,
                k0: int) -> list:
    """Per-layer ``[K_l + H, 4H]`` dW and ``[n, 4H]`` db -> the flat list of
    ``(Wx, Wh, bias)`` gradients in the params' layout."""
    out = []
    for l, d in enumerate(dW):
        k = k0 if l == 0 else cfg.hidden_dim
        out += [d[:k].T.contiguous(), d[k:].T.contiguous(), db[l]]
    return out


def layer_leaves(params: dict, cfg: ModelConfig) -> list:
    return [params[f"lstm_layer_{l}"][k] for l in range(cfg.num_layers)
            for k in ("Wx", "Wh", "bias")]


def rebuild_params(cfg: ModelConfig, emb, leaves, head=None) -> dict:
    p = {"embedding": {"weight": emb}}
    for l in range(cfg.num_layers):
        p[f"lstm_layer_{l}"] = dict(zip(("Wx", "Wh", "bias"), leaves[3 * l:3 * l + 3]))
    if head is not None:
        p["fc_out"] = {"weight": head[0], "bias": head[1]}
    return p


# ----------------------------------------------------------- plain steps

def embed_rows(emb: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``emb[tokens]`` with a zero row for a token outside ``[0, V)`` (the
    one-hot matmul's value, which the kernels reproduce)."""
    V = emb.shape[0]
    ok = (tokens >= 0) & (tokens < V)
    return emb[tokens.long().clamp(0, V - 1)] * ok.unsqueeze(-1).to(emb.dtype)


def cell_step_reference(w: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
                        h: torch.Tensor, c: torch.Tensor, wdt):
    """One LSTM cell: ``[x, h]`` rounded to ``wdt`` times the combined
    weight ``w`` in f32, plus ``bias``. Returns ``(h', c', activated gates
    [B, 4H])``, all f32."""
    gates = torch.cat([x, h], dim=1).to(wdt).float() @ w.float() + bias
    i, f, g, o = gate_activations(gates, h.shape[1])
    c = f * c + i * g
    return o * torch.tanh(c), c, torch.cat([i, f, g, o], dim=1)


def reverse_step_reference(gs: torch.Tensor, c_t: torch.Tensor,
                           c_prev: Optional[torch.Tensor], dh: torch.Tensor,
                           dc: torch.Tensor, wdt) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reverse cell step from stored activations: ``dh`` (the total h
    cotangent) and ``dc`` -> ``(dgates rounded to wdt as f32, new dc)``."""
    H = dh.shape[1]
    a = gs.float()
    i, f, g, o = a[:, :H], a[:, H:2 * H], a[:, 2 * H:3 * H], a[:, 3 * H:]
    cp = c_prev.float() if c_prev is not None else torch.zeros_like(dh)
    tc = torch.tanh(c_t.float())
    dct = dc + dh * o * (1.0 - tc * tc)
    dg = torch.cat([dct * g * i * (1.0 - i), dct * cp * f * (1.0 - f),
                    dct * i * (1.0 - g * g), dh * tc * o * (1.0 - o)], dim=1)
    return dg.to(wdt).float(), dct * f


def shifted(h_t: torch.Tensor, h0: Optional[torch.Tensor]) -> torch.Tensor:
    """``[L, B, H]`` previous-step h: ``h0`` (or zeros) at t = 0."""
    first = h0.to(h_t.dtype)[None] if h0 is not None else torch.zeros_like(h_t[:1])
    return torch.cat([first, h_t[:-1]], dim=0)


def sum_outer(a: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """``sum_{t,b} a[t,b]^T d[t,b]`` in f32 for ``[L, B, K]`` and ``[L, B, N]``."""
    return a.reshape(-1, a.shape[-1]).float().T @ d.reshape(-1, d.shape[-1]).float()


def embedding_grad(dx0: torch.Tensor, tokens_lb: torch.Tensor, V: int) -> torch.Tensor:
    """``[V, E]`` f32: row v sums ``dx0 [L, B, E]`` where ``tokens_lb == v``."""
    tok = tokens_lb.reshape(-1).long()
    ok = (tok >= 0) & (tok < V)
    out = torch.zeros((V, dx0.shape[-1]), dtype=torch.float32, device=dx0.device)
    return out.index_add_(0, tok[ok], dx0.reshape(-1, dx0.shape[-1])[ok].float())


# ----------------------------------------------------------- tile rule

def fwd_tile(hidden: int, smem_floats) -> Optional[Tuple[int, int, int]]:
    """(R, TJ, TR) of a forward kernel at a hidden width: TJ threads over
    hidden units, TR row groups, 8 rows per thread where ``smem_floats(R)``
    fits (the rule ``chip_smoke.py --sweep`` found best for the sampler),
    else fewer."""
    tj = min(hidden, NT)
    tr = NT // tj
    for rpt in RPTS:
        if 4 * smem_floats(rpt * tr) <= MAX_SMEM:
            return rpt * tr, tj, tr
    return None


def bwd_rows(smem_floats) -> Optional[int]:
    """Rows per block of a reverse kernel: the most that fit."""
    for r in RS:
        if 4 * smem_floats(r) <= MAX_SMEM:
            return r
    return None


def scratch_fits(cfg: ModelConfig) -> bool:
    """Whether one split of every weight-gradient pass fits the scratch: the
    passes sum dW one input segment at a time (embedding, conditions, h:
    ``K_seg x 4H`` plus the bias row) and d(embedding) as ``V x E``."""
    H, E = cfg.hidden_dim, cfg.embedding_dim
    k_seg = max(E, cfg.num_conditions, H)
    return k_seg * 4 * H + 4 * H <= SCRATCH_ELEMS and cfg.vocab_size * E <= SCRATCH_ELEMS


def stack_fits_l2(cfg: ModelConfig) -> bool:
    """Whether one stack's LSTM weights, in the compute dtype, fit in L2.

    The whole-stack kernels (fused encoder, fused training decoder) read
    every layer's weights in every block at every step, so they are the
    route only while the whole stack stays in L2; the per-layer kernels
    stream one layer at a time. The stack counted is the decoder's (layer
    0 takes the embedding and the conditions): ~1.8 MB at the default model
    in bf16, ~60 MB at hidden 1024 / 4 layers."""
    H, n = cfg.hidden_dim, cfg.num_layers
    rows = cfg.embedding_dim + cfg.num_conditions + H + (n - 1) * 2 * H
    return rows * 4 * H * torch.finfo(cfg.dtype).bits // 8 <= L2_BYTES


# ----------------------------------------------------------- checks

def check(t: torch.Tensor, name: str, shape, dtype, device) -> None:
    """Raise ``ValueError`` unless ``t`` is a contiguous ``dtype`` tensor of
    ``shape`` on ``device``."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous {dtype} {tuple(shape)} on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device} "
                         f"(contiguous={t.is_contiguous()})")


def stream_of(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def require_cuda(t: torch.Tensor, what: str, reason: Optional[str]) -> None:
    """Raise unless ``t`` is a CUDA tensor and the kernel takes the shape
    (``reason`` is None)."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {t.device}")
    if reason is not None:
        raise NotImplementedError(f"{what} kernel does not take {reason}")


def raise_if(rc: int, what: str, error_string) -> None:
    """Raise on a non-zero cudaError_t returned by a launch function."""
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: {error_string(rc).decode()} ({rc})")
