"""The sampler's Gumbel noise, recomputed by the reference: a frozen copy of
the stream the measured sampler documents. Its random numbers are a pure
function of (block seed, row in block, step, vocabulary index):
``r24 = mix(mix(key ^ v)) >> 8`` with ``key = mix(mix(mix(seed) ^ row) ^
t)``, ``mix`` the lowbias32 hash, and the noise ``-log(-log(r24 2^-24 +
1e-12))``."""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for int64 ``x`` in [0, 2**32), in 16-bit limbs."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + (((hi * (c & 0xFFFF)) & 0xFFFF) << 16)) & _M32


def _mix(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def gumbel_noise(seeds: torch.Tensor, rows: torch.Tensor, t: int, vocab: int) -> torch.Tensor:
    """``[B, vocab]`` f32 noise for each row's block seed ``seeds [B]`` and
    its row in the block ``rows [B]`` at step ``t``."""
    key = _mix(_mix(_mix(seeds.long() & _M32) ^ rows.long()) ^ t)
    v = torch.arange(vocab, device=seeds.device, dtype=torch.int64)
    bits = _mix(_mix(key[:, None] ^ v[None, :]))
    u = (bits >> 8).to(torch.float32) * (1.0 / (1 << 24)) + 1e-12
    return -torch.log(-torch.log(u))
