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
  activated gates and the reverse chains' gate step, the weight- and
  embedding-gradient sums).
* The forward step kernels' layout (``csrc/train_common.cuh``:
  ``seq_fwd_step_kernel`` in bf16, ``seq_fwd_tf32_kernel`` in f32):
  :func:`fwd_step_plan` and :func:`step_columns` (input, optional
  conditions, h), the gate-interleaved weight copy :func:`interleave_weight`,
  and the kernels' plain twin of one step, :func:`seq_fwd_step_reference`.
* Split-TF32, the f32 route on the tensor cores (``csrc/wgmma.cuh``:
  ``gemm_tf32``): :func:`tf32_split` and the three-term product
  :func:`split_tf32_matmul`.
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
BK = 64              # csrc wg::BK: reduction depth of one wgmma stage
TF32_SMEM = 3 * 4 * 16384 + 1024  # csrc wg::TF_SMEM: the split-TF32 ring, 3 x 64 KB + slack
UNITS = 32           # hidden units per 128-wide output tile of the forward step


# ----------------------------------------------------------- weights

@dataclass(frozen=True)
class StackWeights:
    """An LSTM stack's weights in the kernels' layout, on one device.

    ``wcat`` holds every layer's ``[K_l + H, 4H]`` combined weight back to
    back (the reverse chains read it as it lies); ``layers`` are views of
    ``wcat``.
    Matrices are in the compute dtype, biases in float32. ``wout``,
    ``woutT`` and ``bout`` (decoder only) are ``fc_out`` as ``[H, V]``,
    ``[V, H]`` and ``[V]``.
    """

    cfg: ModelConfig
    emb: torch.Tensor
    wcat: torch.Tensor
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
                            wcat=wcat, layers=tuple(layers), bias=bias, **head)


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


def cell_from_gates(gates: torch.Tensor, c: torch.Tensor):
    """The cell's tail from pre-activation ``gates [B, 4H]`` (f32, gate-major)
    and ``c``: ``(h', c', activated gates [B, 4H])``, all f32."""
    i, f, g, o = gate_activations(gates, c.shape[1])
    c = f * c + i * g
    return o * torch.tanh(c), c, torch.cat([i, f, g, o], dim=1)


def cell_step_reference(w: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
                        h: torch.Tensor, c: torch.Tensor, wdt):
    """One LSTM cell: ``[x, h]`` rounded to ``wdt`` times the combined
    weight ``w`` in f32, plus ``bias``. Returns ``(h', c', activated gates
    [B, 4H])``, all f32."""
    return cell_from_gates(torch.cat([x, h], dim=1).to(wdt).float() @ w.float() + bias, c)


# ----------------------------------------------------------- split-TF32

def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """TF32 of float32 ``x`` rounded to nearest, ties away from zero (csrc:
    ``cvt.rna.tf32.f32``): the low 13 mantissa bits cleared after adding
    half of their range to the magnitude."""
    b = x.float().contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)``: ``hi = TF32(x)``, ``lo = TF32(x - hi)``, both float32
    with the low 13 mantissa bits zero; ``hi + lo`` is within ``2**-21 |x|``
    of ``x``."""
    hi = _tf32_rna(x)
    return hi, _tf32_rna(x.float() - hi)


def split_tf32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the split-TF32 kernels form it (``csrc/wgmma.cuh``:
    ``gemm_tf32``): both f32 operands split (:func:`tf32_split`), the product
    ``hi_a hi_b + hi_a lo_b + lo_a hi_b`` in f32 (the kernels drop ``lo_a
    lo_b``, ~2^-22 of each product, and sum in another order)."""
    ah, al = tf32_split(a)
    bh, bl = tf32_split(b)
    return ah @ bh + ah @ bl + al @ bh


# ----------------------------------------------------------- forward step

def fwd_step_plan(I: int, H: int, C: int = 0) -> Tuple[int, int, int]:
    """``(Ixp, Kp, Np)`` of the forward step kernel for input width ``I``,
    hidden width ``H`` and ``C`` condition columns (csrc: ``fwd_ixp``,
    ``fwd_kp``, ``fwd_np``): the input's reduction columns run from 0, the
    conditions' from ``I`` rounded up to ``BK``, and the recurrent ones from
    ``Ixp`` (that plus ``C`` rounded up to ``BK``) to ``Kp = Ixp + H``
    rounded up to ``BK``; ``Np`` output columns, 128 for each 32 units.
    ``C = 0``: no condition segment."""
    ixp = -(-I // BK) * BK + -(-C // BK) * BK
    return ixp, ixp + -(-H // BK) * BK, -(-H // UNITS) * 4 * UNITS


def gate_columns(H: int, device=None) -> torch.Tensor:
    """``[4H]``: the forward step kernel's output column of gate-major
    column ``q * H + u``: ``128 (u // 32) + 32 q + u % 32``."""
    u = torch.arange(H, device=device)
    return torch.cat([(u // UNITS) * 4 * UNITS + q * UNITS + u % UNITS for q in range(4)])


def step_columns(I: int, H: int, C: int = 0, device=None) -> torch.Tensor:
    """The reduction columns of the forward step kernel that hold weights,
    in the combined weight's row order: ``[input, conditions, h]``."""
    ixp = fwd_step_plan(I, H, C)[0]
    return torch.cat([torch.arange(I, device=device),
                      -(-I // BK) * BK + torch.arange(C, device=device),
                      ixp + torch.arange(H, device=device)])


def interleave_weight(w: torch.Tensor, I: int, H: int, C: int = 0) -> torch.Tensor:
    """The forward step kernel's weight: the combined ``w [I + C + H, 4H]``
    (gate-major columns) as a K-major ``[Np, Kp]`` copy (:func:`fwd_step_plan`)
    whose row :func:`gate_columns` ``[q * H + u]`` holds column ``q * H + u``
    of ``w``, each row of ``w`` at its reduction column
    (:func:`step_columns`). The other entries are zeros. So one 128-wide
    output tile of the kernel holds all four gates of 32 units."""
    _, kp, np_ = fwd_step_plan(I, H, C)
    with torch.no_grad():
        out = w.new_zeros((np_, kp))
        out[gate_columns(H, w.device)[:, None], step_columns(I, H, C, w.device)[None]] = w.T
    return out


def seq_fwd_step_reference(wt: torch.Tensor, bias: torch.Tensor, t: int, xs: torch.Tensor,
                           c: torch.Tensor, hs: torch.Tensor, cs: torch.Tensor,
                           gs: torch.Tensor, I: int, H: int, x_stride: int = 1,
                           x_offset: int = 0, tokens: Optional[torch.Tensor] = None,
                           h0: Optional[torch.Tensor] = None, c0: Optional[torch.Tensor] = None,
                           res_stride: int = 1, res_offset: int = 0,
                           hf: Optional[torch.Tensor] = None,
                           cond: Optional[torch.Tensor] = None,
                           split_tf32: bool = False) -> None:
    """Plain twin of one launch of the forward step kernel, step ``t`` of
    one layer, in place (``split_tf32``: of the f32 kernel, whose product is
    :func:`split_tf32_matmul`).

    A ``[B, Kp]``: columns ``k < I`` hold step t's input rows, row ``t *
    x_stride + x_offset`` of ``xs [., B, I]``, or with ``tokens [B, L]`` the
    rows ``tokens[:, t]`` of the table ``xs [V, I]`` (zeros outside [0, V));
    with ``cond [B, C]`` (f32) the next segment holds the conditions;
    columns ``Ixp + j`` hold h_{t-1}, residual row ``(t - 1) * res_stride +
    res_offset`` of ``hs``, or at t = 0 ``h0`` f32 (zeros if None); all
    rounded to ``wt``'s dtype. A times ``wt`` (:func:`interleave_weight`)
    gives the gates in the kernel's column order; with the bias and c_{t-1}
    (``c0`` at t = 0, zeros if None; else ``c [B, H]`` f32) the cell writes
    ``c`` and residual row ``t * res_stride + res_offset`` of ``hs``, ``cs``
    and ``gs`` (and ``hf`` if given). The padding's zero columns add nothing
    to the kernel's sums; the product here runs over the columns that hold
    weights, in the combined weight's order, so that in f32 its sums equal
    :func:`cell_step_reference`'s bit for bit (``split_tf32``: within the
    split's ~2^-21 of each product)."""
    wdt = wt.dtype
    C = cond.shape[1] if cond is not None else 0
    B = c.shape[0]
    dev = c.device
    x = embed_rows(xs, tokens[:, t]) if tokens is not None else xs[t * x_stride + x_offset]
    if t > 0:
        hp = hs[(t - 1) * res_stride + res_offset]
    else:
        hp = h0 if h0 is not None else torch.zeros((B, H), device=dev)
    a = torch.cat([x.to(wdt), *((cond.to(wdt),) if C else ()), hp.to(wdt)], dim=1).float()
    wsel = wt[:, step_columns(I, H, C, dev)].float().T.contiguous()
    prod = split_tf32_matmul(a, wsel) if split_tf32 else a @ wsel
    c_prev = c if t > 0 else (c0.float() if c0 is not None else torch.zeros_like(c))
    h, c_new, g = cell_from_gates(prod[:, gate_columns(H, dev)] + bias, c_prev)
    c.copy_(c_new)
    row = t * res_stride + res_offset
    hs[row], cs[row], gs[row] = h, c_new, g
    if hf is not None:
        hf.copy_(h)


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


def reverse_gate_reference(cfg: ModelConfig, s: int, l: int, dh: torch.Tensor,
                           cs: torch.Tensor, gs: torch.Tensor, dgates: torch.Tensor,
                           dc: torch.Tensor) -> None:
    """A bf16 reverse chain's gate step of (step ``s``, layer ``l``) in
    place (``csrc/train_common.cuh:gate_step``): from the total h cotangent
    ``dh [B, H]`` f32 and the running ``dc[l]`` (``dc [n, B, H]`` f32; zero
    state before s = 0) it writes ``dgates[s, l]`` and the new ``dc[l]``.
    A chain's first launch is this step at ``(L-1, n-1)``."""
    dg, dc[l] = reverse_step_reference(gs[s, l], cs[s, l], cs[s - 1, l] if s else None, dh,
                                       dc[l], cfg.dtype)
    dgates[s, l] = dg


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


def wgrad_splits(K: int, N: int, M: int, bf16: bool) -> int:
    """The row splits of one weight-gradient pass (``csrc/train_common.cuh``:
    ``wgrad`` / ``split_count``): 128 x 128 tiles of the ``[K, N]`` sum over
    ``M`` rows; the fewest splits that fill whole waves of resident blocks
    (264 in bf16, two an SM; 132 as split-TF32, one an SM) to within 10%,
    at most 32, at least 8 stages of rows each (stages of 64 rows in bf16,
    32 in f32), at most what the scratch holds."""
    slots, bk = (264, 64) if bf16 else (132, 32)
    tiles = -(-K // 128) * -(-N // 128)
    cap = SCRATCH_ELEMS // (K * N)

    def eff(s):
        return tiles * s / (-(-tiles * s // slots) * slots)

    best, best_eff = 1, eff(1)
    for s in range(2, 33):
        if best_eff >= 0.9:
            break
        if eff(s) > best_eff + 0.05:
            best, best_eff = s, eff(s)
    if best * 8 * bk > M:
        best = -(-M // (8 * bk))
    best = max(1, min(best, cap))
    chunk = -(-(-(-M // best)) // bk) * bk
    return -(-M // chunk)


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
