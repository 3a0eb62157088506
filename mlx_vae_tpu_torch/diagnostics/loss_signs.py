"""Standalone sign/shape sanity checks on random tensors, printing ✅/❌ per
check (counterpart of ``diagnostics/test_loss_signs.py``, renamed so that
no test runner collects it as a test module). The same shapes and checks;
the random inputs come from a ``torch.Generator`` on ``--device``.

    python -m mlx_vae_tpu_torch.diagnostics.loss_signs [--device cpu]
"""

import argparse
import sys

import torch

from mlx_vae_tpu_torch.cli.common import resolve_device
from mlx_vae_tpu_torch.losses import (
    kl_divergence,
    mutual_information,
    posterior_collapse,
    property_prediction_loss,
    reconstruction_loss,
)


def check(name, cond, detail=""):
    print(f"{'✅' if cond else '❌'} {name} {detail}")
    return bool(cond)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda[:N] (default) or cpu")
    device = resolve_device(ap.parse_args(argv).device)

    gen = torch.Generator(device=device).manual_seed(67)
    B, L, V, D = 8, 20, 40, 16

    logits = torch.randn((B, L, V), generator=gen, device=device)
    targets = torch.randint(0, V, (B, L), generator=gen, device=device)
    mu = torch.randn((B, D), generator=gen, device=device) * 0.5
    logvar = torch.randn((B, D), generator=gen, device=device) * 0.3 - 1.0

    ok = True
    r = reconstruction_loss(logits, targets)
    ok &= check("reconstruction_loss > 0", float(r) > 0, f"(= {float(r):.4f})")

    kl = kl_divergence(mu, logvar, free_bits=0.5)
    ok &= check("kl_divergence >= free_bits", float(kl) >= 0.5, f"(= {float(kl):.4f})")

    mi = mutual_information(mu, logvar)
    ok &= check("mutual_information >= 0", float(mi) >= 0, f"(= {float(mi):.4f})")

    pc = posterior_collapse(mu, logvar, target_mi=4.85, weight=0.1)
    ok &= check("posterior_collapse >= 0", float(pc) >= 0, f"(= {float(pc):.4f})")

    pred = torch.randn((B, 3), generator=gen, device=device)
    target_props = torch.zeros((B, 3), device=device)
    pl = property_prediction_loss(pred, target_props)
    ok &= check("property_prediction_loss > 0 (corrected signature)",
                float(pl) > 0, f"(= {float(pl):.4f})")

    print("\nAll checks passed ✅" if ok else "\nSome checks FAILED ❌")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
