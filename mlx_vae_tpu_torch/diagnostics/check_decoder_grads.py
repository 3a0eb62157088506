"""Gradient-flow smoke test: run 10 real optimizer steps and assert the
decoder's ``fc_out`` weights actually move (counterpart of
``diagnostics/check_decoder_grads.py``: the same corpus, model, step count
and threshold, on the plain route, on ``--device``).

    python -m mlx_vae_tpu_torch.diagnostics.check_decoder_grads [--device cpu]
"""

import argparse
import os
import sys
import tempfile

import torch

from mlx_vae_tpu_torch.cli.common import resolve_device
from mlx_vae_tpu_torch.config import ModelConfig, TrainConfig
from mlx_vae_tpu_torch.data.prepare import make_synthetic_dataset
from mlx_vae_tpu_torch.data.split import load_and_split
from mlx_vae_tpu_torch.models.vae import ARCVAE
from mlx_vae_tpu_torch.train.optim import adam_init
from mlx_vae_tpu_torch.train.steps import train_step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda[:N] (default) or cpu")
    device = resolve_device(ap.parse_args(argv).device)

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "synthetic.json")
        make_synthetic_dataset(n=300, vocab_size=40, max_length=24, path=path)
        train_ds, _, _, _ = load_and_split(path)

    mcfg = ModelConfig(vocab_size=40, embedding_dim=32, hidden_dim=64,
                       latent_dim=16, num_conditions=1, num_layers=2)
    tcfg = TrainConfig(batch_size=32, learning_rate=2e-4)
    params = ARCVAE(mcfg, torch.Generator().manual_seed(0), device=device).params
    opt = {n: adam_init(p) for n, p in params.items()}

    gen = torch.Generator(device=device).manual_seed(1)
    ok = True
    prev_w = params["decoder"]["fc_out"]["weight"].detach().clone()
    for step, (mol, cond) in enumerate(train_ds.to_batches(32, shuffle=False)):
        if step >= 10:
            break
        params, opt, m = train_step(params, opt, mcfg, tcfg,
                                    torch.as_tensor(mol, device=device),
                                    torch.as_tensor(cond, device=device), gen, 0.01, 0.9)
        w = params["decoder"]["fc_out"]["weight"].detach()
        delta = float((w - prev_w).abs().max())
        moved = delta >= 1e-6
        ok &= moved
        print(f"step {step}: loss={float(m['total_loss']):.4f} "
              f"max|Δfc_out.weight|={delta:.2e} {'✅' if moved else '❌'}")
        prev_w = w.clone()

    print("\nDecoder gradients flow ✅" if ok else "\nDecoder gradients STUCK ❌")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
