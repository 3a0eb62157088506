"""Train-step benchmark of the port on one CUDA card; prints ONE JSON line.

    python -m mlx_vae_tpu_torch.bench

Same contract and configuration as the JAX package's ``bench.py``: metric
``train_tokens_per_sec_per_chip`` of the steady-state train step at the
reference default model (V=80, E=128, H=256, latent 128, C=1, 2 layers),
bf16 matmul inputs with f32 accumulation, batch 4096, sequence length 64,
beta 0.05, teacher forcing 0.9, on the fused route (``use_pallas``: the
hand-written CUDA encoder and decoder kernels), eight cycled random
batches. Warm-up steps run outside the timed region; the timed region ends
in a scalar readback and ``torch.cuda.synchronize()``. ``vs_baseline`` is
``value / 1.0e6``, the JAX bench's anchor (20x an estimated 50k tokens/s of
the MLX reference on an M2).

The JSON line also carries ``"scaled"``, the JAX bench's second line: the
hidden-1024 / 4-layer / latent-512 model at batch 2048, L=64, bf16, on the
fused route, which at that size is the per-layer one (the encoder's
sequence kernels, the decoder's fused forward and per-layer backward). It
runs in a subprocess (``--scaled_only``, bounded by 600 seconds) with 1
warm-up and 4 timed steps, as a step takes seconds.
Diagnostics, the card's name and power limit go to stderr. Without CUDA the
script exits 2 and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from mlx_vae_tpu_torch.config import ModelConfig, TrainConfig
from mlx_vae_tpu_torch.models.vae import ARCVAE
from mlx_vae_tpu_torch.train.optim import adam_init
from mlx_vae_tpu_torch.train.steps import train_step

BASELINE_TOKENS_PER_SEC = 1.0e6


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def init_train_params(cfg: ModelConfig, device, seed: int = 0) -> dict:
    """Random encoder + decoder params (f32 masters) from ``seed``, on
    ``device``."""
    return ARCVAE(cfg, torch.Generator().manual_seed(seed), device=device).params


def bench_train(batch: int = 4096, seq_len: int = 64, steps: int = 24, warmup: int = 2,
                compute_dtype: str = "bfloat16", use_pallas: bool = True,
                n_batches: int = 8, device: str = "cuda", hidden_dim: int = 256,
                latent_dim: int = 128, num_layers: int = 2) -> dict:
    """Steady-state train step on ``device``: ``{"step_ms", "tokens_per_sec",
    "loss"}``."""
    mcfg = ModelConfig(compute_dtype=compute_dtype, use_pallas=use_pallas,
                       hidden_dim=hidden_dim, latent_dim=latent_dim, num_layers=num_layers)
    tcfg = TrainConfig(batch_size=batch)
    params = init_train_params(mcfg, device)
    opt = {name: adam_init(p) for name, p in params.items()}
    rng = np.random.default_rng(0)
    xs = torch.as_tensor(rng.integers(0, mcfg.vocab_size, (n_batches, batch, seq_len)),
                         dtype=torch.int32, device=device)
    conds = torch.as_tensor(rng.normal(size=(n_batches, batch, mcfg.num_conditions)),
                            dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(1)

    def step(i):
        return train_step(params, opt, mcfg, tcfg, xs[i % n_batches], conds[i % n_batches],
                          gen, 0.05, 0.9)

    for i in range(warmup):
        _, _, m = step(i)
    float(m["total_loss"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        _, _, m = step(i)
    loss = float(m["total_loss"])
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / steps
    return {"step_ms": dt * 1e3, "tokens_per_sec": batch * seq_len / dt, "loss": loss}


# The JAX bench's scaled line: hidden 1024 / 4 LSTM layers / latent 512 at
# batch 2048 (4 timed steps here, where the JAX bench times 24).
SCALED = dict(batch=2048, seq_len=64, steps=4, warmup=1, hidden_dim=1024, latent_dim=512,
              num_layers=4, n_batches=2)


def bench_scaled() -> dict:
    res = bench_train(**SCALED)
    log(f"scaled: step_ms={res['step_ms']:.3f} tokens/sec={res['tokens_per_sec']:,.0f} "
        f"loss={res['loss']:.4f} (H=1024 n=4 B=2048 L=64 bf16, fused route)")
    return {
        "config": "hidden1024_layers4_latent512_bf16_batch2048",
        "tokens_per_sec_per_chip": round(res["tokens_per_sec"], 1),
        "step_ms": round(res["step_ms"], 1),
    }


def main() -> int:
    if not torch.cuda.is_available():
        log("bench: CUDA is not available; this benchmark needs an NVIDIA GPU")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if "--scaled_only" in sys.argv:
        print(json.dumps(bench_scaled()))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    log(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi.stdout.strip()}")
    res = bench_train()
    log(f"step_ms={res['step_ms']:.3f} tokens/sec={res['tokens_per_sec']:,.0f} "
        f"loss={res['loss']:.4f} (B=4096 L=64 bf16, fused route)")
    per_chip = res["tokens_per_sec"]  # the step runs on one card
    # The scaled line runs in its own process and time budget, so that a
    # failure or a hang there never costs the default line.
    scaled = None
    try:
        r = subprocess.run([sys.executable, "-m", "mlx_vae_tpu_torch.bench", "--scaled_only"],
                           capture_output=True, text=True, timeout=600)
        sys.stderr.write(r.stderr)
        if r.returncode == 0:
            scaled = json.loads(r.stdout.strip().splitlines()[-1])
    except (subprocess.TimeoutExpired, ValueError, IndexError) as e:
        log(f"scaled-config bench skipped: {type(e).__name__}")
    print(json.dumps({
        "metric": "train_tokens_per_sec_per_chip",
        "value": round(per_chip, 1),
        "unit": "tokens/sec/chip",
        "vs_baseline": round(per_chip / BASELINE_TOKENS_PER_SEC, 3),
        **({"scaled": scaled} if scaled else {}),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
