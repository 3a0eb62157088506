"""Training history: the 15-series dict, JSON export, and the 2x3 plot grid.

Schema and plot layout match the reference exactly
(``reference/trainer.py:84-100`` for the series,
``trainer.py:605-683`` for JSON + the matplotlib grid with the MI target line
at 4.85 and the collapse line at 1.0).
"""

from __future__ import annotations

import json
from pathlib import Path

HISTORY_KEYS = [
    "epoch",
    "train_loss", "train_recon", "train_kl", "train_collapse", "train_prop",
    "val_loss", "val_recon", "val_kl", "val_collapse", "val_prop",
    "beta", "teacher_forcing", "learning_rate", "mutual_info",
]


def make_history() -> dict:
    return {k: [] for k in HISTORY_KEYS}


def anneal_best_warning(history: dict, best_metric: str = "val_loss"):
    """Warn when best-val selection landed on a pre-anneal epoch.

    Under beta annealing, val_loss includes the *growing* beta*KL term, so
    its minimum can land before the anneal bites — for richly-conditioned
    or latent-heavy configs it lands on epoch 0/1, whose posterior is
    prior-mismatched and whose prior sampling is broken even though every
    training metric looks fine (measured:
    benchmarks/conditioning_strength_study.json arm B_best, prior decode
    0.28 at best@ep0 vs 1.00 at the final epoch of the same run).

    Returns a warning string when ``best_metric`` is the reference's
    val_loss, its argmin epoch is not the last, and beta at that epoch was
    below half the final beta; otherwise None. val_recon is
    beta-independent, so no warning applies.
    """
    if best_metric != "val_loss":
        return None
    series = history.get(best_metric) or []
    betas = history.get("beta") or []
    if len(series) < 2 or len(betas) != len(series):
        return None
    best = min(range(len(series)), key=series.__getitem__)
    final_beta = betas[-1]
    if final_beta <= 0 or best == len(series) - 1:
        return None
    if betas[best] >= 0.5 * final_beta:
        return None
    return (
        f"WARNING: checkpoint_best is epoch {best} of {len(series)}, "
        f"selected while beta was still annealing (beta {betas[best]:.4f} "
        f"there vs {final_beta:.4f} at the end). val_loss includes the "
        "growing beta*KL term, so it favors pre-anneal epochs whose "
        "posterior may not match the prior — generation from this "
        "checkpoint can collapse to fragments while train/val losses look "
        "fine. Prefer --best_metric val_recon, or generate from the last "
        "checkpoint_epoch_*.npz "
        "(benchmarks/conditioning_strength_study.json, arms B_best/B_final)."
    )


def save_history(history: dict, path) -> None:
    history_path = Path(path) / "training_history.json"
    with open(history_path, "w") as f:
        json.dump(history, f, indent=2)
    print(f"    Saved history: {history_path}")


def plot_history(history: dict, save_path=None) -> None:
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("    matplotlib not available for plotting")
        return

    fig, axes = plt.subplots(2, 3, figsize=(15, 10))
    ep = history["epoch"]

    axes[0, 0].plot(ep, history["train_loss"], label="Train")
    axes[0, 0].plot(ep, history["val_loss"], label="Val")
    axes[0, 0].set_xlabel("Epoch"); axes[0, 0].set_ylabel("Total Loss")
    axes[0, 0].legend(); axes[0, 0].set_title("Total Loss")
    axes[0, 0].grid(True, alpha=0.3)

    axes[0, 1].plot(ep, history["train_recon"], label="Recon")
    axes[0, 1].plot(ep, history["train_kl"], label="KL")
    axes[0, 1].set_xlabel("Epoch"); axes[0, 1].set_ylabel("Loss")
    axes[0, 1].legend(); axes[0, 1].set_title("Loss Components")
    axes[0, 1].grid(True, alpha=0.3)

    axes[0, 2].plot(ep, history["train_collapse"], label="Collapse Penalty")
    axes[0, 2].set_xlabel("Epoch"); axes[0, 2].set_ylabel("Penalty")
    axes[0, 2].legend(); axes[0, 2].set_title("Posterior Collapse Penalty")
    axes[0, 2].grid(True, alpha=0.3)

    axes[1, 0].plot(ep, history["train_prop"], label="Train")
    axes[1, 0].plot(ep, history["val_prop"], label="Val")
    axes[1, 0].set_xlabel("Epoch"); axes[1, 0].set_ylabel("Property Loss")
    axes[1, 0].legend(); axes[1, 0].set_title("Property Prediction Loss")
    axes[1, 0].grid(True, alpha=0.3)

    axes[1, 1].plot(ep, history["beta"], label="Beta")
    ax2 = axes[1, 1].twinx()
    ax2.plot(ep, history["teacher_forcing"], label="TF Ratio", color="orange")
    axes[1, 1].set_xlabel("Epoch")
    axes[1, 1].set_ylabel("Beta", color="blue")
    ax2.set_ylabel("TF Ratio", color="orange")
    axes[1, 1].set_title("Annealing Schedules")
    axes[1, 1].grid(True, alpha=0.3)

    axes[1, 2].plot(ep, history["mutual_info"], label="MI")
    axes[1, 2].axhline(y=4.85, color="r", linestyle="--", label="Target")
    axes[1, 2].axhline(y=1.0, color="orange", linestyle="--", label="Collapse")
    axes[1, 2].set_xlabel("Epoch"); axes[1, 2].set_ylabel("Mutual Information")
    axes[1, 2].legend(); axes[1, 2].set_title("Latent Space Health")
    axes[1, 2].grid(True, alpha=0.3)

    plt.tight_layout()
    if save_path:
        plt.savefig(save_path, dpi=150)
        print(f"    Saved plot: {save_path}")
    plt.close(fig)
