"""The work of the AR-CVAE (family ``arcvae``), counted from shapes alone.

FLOPs are 2 x the multiply-adds of the products the algorithm needs; an
embedding lookup is no product, and recomputation is not counted. A train
step is 3 x one forward (the forward, and the backward's two products per
forward product). Bytes count each input and state byte read once and
each output byte written once. A frozen copy of the counting in the port's
``chip_smoke.py:lstm_flops`` and ``bench_sampler_routes.py:sampler_flops``,
extended to the whole step and the whole request.
"""

from __future__ import annotations


def _shape(cfg: dict) -> tuple:
    return (cfg["vocab_size"], cfg["embedding_dim"], cfg["hidden_dim"], cfg["latent_dim"],
            cfg["num_conditions"], cfg["num_layers"])


def n_params(cfg: dict, parts=("encoder", "decoder")) -> int:
    V, E, H, Z, C, n = _shape(cfg)
    lstm = lambda i: 4 * H * (i + H) + 4 * H  # noqa: E731
    enc = (V * E + lstm(E) + (n - 1) * lstm(H) + (C * H + H) + (2 * H * Z + Z)
           + (4 * H * H + 2 * H) + (2 * H * Z + Z))
    dec = ((Z * H + H) + (C * H + H) + V * E + lstm(E + C) + (n - 1) * lstm(H)
           + (H * V + V))
    return (enc if "encoder" in parts else 0) + (dec if "decoder" in parts else 0)


def _decoder_macs_per_row(cfg: dict, L: int) -> int:
    V, E, H, Z, C, n = _shape(cfg)
    init = Z * H + C * H
    steps = L * ((E + C + H) * 4 * H + (n - 1) * 2 * H * 4 * H + H * V)
    return init + steps


def train_forward_flops(cfg: dict, B: int, L: int) -> float:
    """One teacher-forced forward: encoder stack and heads, decoder init,
    stack and vocabulary head."""
    V, E, H, Z, C, n = _shape(cfg)
    enc = L * ((E + H) * 4 * H + (n - 1) * 2 * H * 4 * H)
    heads = C * H + 2 * H * Z + 2 * H * 2 * H + 2 * H * Z
    return 2.0 * B * (enc + heads + _decoder_macs_per_row(cfg, L))


def train_step_flops(cfg: dict, B: int, L: int) -> float:
    return 3.0 * train_forward_flops(cfg, B, L)


def train_step_bytes(cfg: dict, B: int, L: int, token_bytes: int = 1) -> float:
    """Tokens, conditions and the reparameterization noise read; every
    parameter and both Adam moments read and written (f32)."""
    _, _, _, Z, C, _ = _shape(cfg)
    P = n_params(cfg)
    return float(B * L * token_bytes + B * C * 4 + B * Z * 4 + L + 3 * 2 * P * 4)


def gen_request_flops(cfg: dict, B: int, L: int) -> float:
    """One request of B molecules: the decoder's init from z, and L steps
    of the stack and the head."""
    return 2.0 * B * _decoder_macs_per_row(cfg, L)


def gen_request_bytes(cfg: dict, B: int, L: int, dtype_bytes: int = 4) -> float:
    """The decoder's weights in the compute dtype, z and the conditions in
    f32 read once; the int32 tokens written once."""
    _, _, _, Z, C, _ = _shape(cfg)
    return float(n_params(cfg, ("decoder",)) * dtype_bytes + B * (Z + C) * 4 + B * L * 4)

