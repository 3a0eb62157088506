"""Token sampling ops (counterpart of ``mlx_vae_tpu/ops/sampling.py``).

``truncate_logits`` is the sort-based top-k / nucleus mask and
``truncate_logits_bisect`` its sort-free twin, the one the fused sampler
runs each step. ``sample_logits`` draws with the Gumbel-max trick from an
explicit ``torch.Generator`` (the JAX version uses ``jax.random``; the two
streams never match, so tests compare them by distribution).
"""

from __future__ import annotations

import torch

_TRUNC_NEG = -1e30  # mask value (finite: -inf - -inf NaNs under later adds)
_BIG = 3.4e38


def _check_truncation(top_k: int, top_p: float) -> None:
    if top_k < 0:
        raise ValueError(f"top_k must be >= 0 (0 disables), got {top_k}")
    if not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1] (1.0 disables), got {top_p}")


def truncate_logits(scaled: torch.Tensor, top_k: int = 0,
                    top_p: float = 1.0) -> torch.Tensor:
    """Mask ``scaled [..., V]`` outside the top-k / nucleus support to -inf.

    Nucleus keeps the smallest descending-probability prefix whose
    cumulative mass reaches ``top_p`` (the crossing token is included, so
    the set is never empty); both filters together intersect.
    """
    if top_k and 0 < top_k < scaled.shape[-1]:
        kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
        scaled = torch.where(scaled < kth, float("-inf"), scaled)
    if top_p < 1.0:
        desc = torch.sort(scaled, dim=-1, descending=True).values
        probs = torch.softmax(desc, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        kept = cum - probs < top_p
        cutoff = torch.where(kept, desc, float("inf")).min(dim=-1, keepdim=True).values
        scaled = torch.where(scaled < cutoff, float("-inf"), scaled)
    return scaled


def _bisect(scaled, weights, thresh, kept, iters):
    """Largest-gap cutoff: pred(t) := sum(weights[scaled > t]) < thresh is
    monotone in t; ``iters`` halvings from (min - 1, max) over the kept
    entries converge ``lo`` to just below the cutoff."""
    hi = torch.where(kept, scaled, -_BIG).max(dim=-1, keepdim=True).values
    lo = torch.where(kept, scaled, _BIG).min(dim=-1, keepdim=True).values - 1.0
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        m = torch.where(scaled > mid, weights, 0.0).sum(dim=-1, keepdim=True)
        ok = m < thresh
        lo, hi = torch.where(ok, lo, mid), torch.where(ok, mid, hi)
    return lo


def truncate_logits_bisect(scaled: torch.Tensor, valid_vocab: int,
                           top_k: int = 0, top_p: float = 1.0,
                           iters: int = 40) -> torch.Tensor:
    """Sort-free twin of :func:`truncate_logits`, masking to ``-1e30``.

    An element survives top-k iff fewer than k elements are strictly
    greater, and top-p iff the softmax mass of strictly greater elements is
    below p; both cutoffs are found by a fixed 40-step per-row bisection
    (see ``mlx_vae_tpu/ops/sampling.py:truncate_logits_bisect``). Only the
    first ``valid_vocab`` entries of the last axis are real: the rest never
    count toward k or the nucleus mass and are always masked.
    """
    V = valid_vocab
    do_k = bool(top_k) and 0 < top_k < V
    do_p = top_p < 1.0
    if not (do_k or do_p):
        return scaled
    real = torch.arange(scaled.shape[-1], device=scaled.device) < V
    real = real.expand_as(scaled)
    if do_k:
        lo = _bisect(scaled, real.float(), float(top_k), real, iters)
        scaled = torch.where(real & (scaled > lo), scaled, _TRUNC_NEG)
    if do_p:
        kept = real & (scaled > 0.5 * _TRUNC_NEG)
        m = torch.where(kept, scaled, -_BIG).max(dim=-1, keepdim=True).values
        e = torch.where(kept, torch.exp(scaled - m), 0.0)
        probs = e / e.sum(dim=-1, keepdim=True)
        lo = _bisect(scaled, probs, float(top_p), kept, iters)
        scaled = torch.where(kept & (scaled > lo), scaled, _TRUNC_NEG)
    return scaled


def sample_logits(logits: torch.Tensor, generator: torch.Generator = None,
                  temperature=1.0, greedy: bool = False, top_k: int = 0,
                  top_p: float = 1.0) -> torch.Tensor:
    """Sample token ids ``[...]`` (int32) from ``logits [..., V]``.

    ``greedy`` takes the argmax of the unscaled, untruncated row (the
    reference's behaviour). Otherwise the row is scaled by
    ``1/max(temperature, 1e-6)``, truncated, and sampled with ``generator``
    (which must live on the logits' device).
    """
    _check_truncation(top_k, top_p)
    if greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    temp = torch.as_tensor(temperature, dtype=logits.dtype, device=logits.device)
    scaled = logits / temp.clamp_min(1e-6)
    scaled = truncate_logits(scaled, top_k=top_k, top_p=top_p)
    # Gumbel-max: argmax(scaled + Gumbel noise) is a draw from softmax(scaled)
    u = torch.rand(scaled.shape, generator=generator, device=scaled.device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return torch.argmax(scaled - torch.log(-torch.log(u)), dim=-1).to(torch.int32)
