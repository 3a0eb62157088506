"""The work of one ``gen_requests`` request of an ``arcvae`` configuration."""

from portbench.work import arcvae


def per_unit(cfg: dict, mix: dict) -> dict:
    B, L = mix["batch"], mix["seq_len"]
    return {"flops": arcvae.gen_request_flops(cfg, B, L),
            "bytes": arcvae.gen_request_bytes(cfg, B, L)}
