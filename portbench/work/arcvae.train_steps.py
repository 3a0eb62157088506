"""The work of one ``train_steps`` step of an ``arcvae`` configuration."""

from portbench.work import arcvae


def per_unit(cfg: dict, mix: dict) -> dict:
    B, L = mix["batch"], mix["seq_len"]
    return {"flops": arcvae.train_step_flops(cfg, B, L),
            "bytes": arcvae.train_step_bytes(cfg, B, L)}
