"""Train/val distribution diagnostic (counterpart of
``diagnostics/data_diagnostic.py``): re-derive the exact seed-67 split,
report sizes, shapes and normalization, and compare untrained losses on a
few train vs val batches to localize any distribution mismatch. The same
corpus, model and printed lines, on the plain route, on ``--device``.

    python -m mlx_vae_tpu_torch.diagnostics.data_diagnostic [--data JSON] [--device cpu]
"""

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

from mlx_vae_tpu_torch.cli.common import resolve_device
from mlx_vae_tpu_torch.config import ModelConfig, TrainConfig
from mlx_vae_tpu_torch.data.prepare import make_synthetic_dataset
from mlx_vae_tpu_torch.data.split import load_and_split
from mlx_vae_tpu_torch.models.vae import ARCVAE
from mlx_vae_tpu_torch.train.steps import eval_step


def avg_loss(params, mcfg, tcfg, ds, device, n_batches=5):
    losses = []
    gen = torch.Generator(device=device).manual_seed(0)
    for i, (mol, cond) in enumerate(ds.to_batches(32, shuffle=False)):
        if i >= n_batches:
            break
        m = eval_step(params, mcfg, tcfg, torch.as_tensor(mol, device=device),
                      torch.as_tensor(cond, device=device), gen, 0.05, 0.0)
        losses.append(float(m["total_loss"]))
    return float(np.mean(losses))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", default=None, help="dataset JSON (synthetic if omitted)")
    ap.add_argument("--device", default="cuda", help="cuda[:N] (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    with tempfile.TemporaryDirectory() as tmp:
        data_path = args.data
        if data_path is None:
            data_path = os.path.join(tmp, "synthetic.json")
            make_synthetic_dataset(n=500, vocab_size=40, max_length=24, path=data_path)
            print(f"(no --data given; using synthetic dataset at {data_path})")
        train_ds, val_ds, test_ds, raw = load_and_split(data_path)

    print(f"split sizes: train={len(train_ds)} val={len(val_ds)} test={len(test_ds)}")
    print(f"max_length={raw['max_length']} molecules shape={train_ds.molecules.shape}")
    print(f"train norm stats: mean={train_ds.properties_mean.flatten()} "
          f"std={train_ds.properties_std.flatten()}")
    print(f"val normalized props: mean={val_ds.properties_normalized.mean():.3f} "
          f"std={val_ds.properties_normalized.std():.3f} (≈0/≈1 if homogeneous)")

    vocab = int(train_ds.molecules.max()) + 1
    mcfg = ModelConfig(vocab_size=max(vocab, 40), embedding_dim=32, hidden_dim=64,
                       latent_dim=16, num_conditions=1, num_layers=2)
    tcfg = TrainConfig(batch_size=32)
    params = ARCVAE(mcfg, torch.Generator().manual_seed(0), device=device).params

    tr = avg_loss(params, mcfg, tcfg, train_ds, device)
    va = avg_loss(params, mcfg, tcfg, val_ds, device)
    print(f"\nuntrained 5-batch loss: train={tr:.4f} val={va:.4f} "
          f"(|Δ|={abs(tr - va):.4f})")
    if abs(tr - va) > 0.5:
        print("⚠️  train/val diverge before training — check the split/normalization")
    else:
        print("✅ train/val consistent at init")
    return 0


if __name__ == "__main__":
    sys.exit(main())
