"""`.npz` checkpointing with the reference key contract (counterpart of
``mlx_vae_tpu/train/checkpoint.py``).

Same keys, same pickled nested dicts (``np.load(..., allow_pickle=True)``
and ``.item()``), the alphabet as an object array: a file written by either
package loads in the other. Leaves stay numpy until the caller moves them
to a device (``utils/tree.py:params_from_numpy``);
:func:`train_state_from_checkpoint` does that for the encoder, decoder and
predictor trees and their Adam states, so a checkpoint written by either
package resumes the train step in the other.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from mlx_vae_tpu_torch.utils.tree import params_from_numpy, params_to_numpy


def build_checkpoint_host(epoch: int, params: dict, opt_states: dict,
                          history: dict, best_val_loss: float = float("inf"),
                          data_stats: Optional[dict] = None) -> dict:
    """Host-side checkpoint dict from tensor (or numpy) trees.

    ``data_stats`` (optional): ``{"properties_mean", "properties_std",
    "alphabet"}`` — the train-set normalization stats and token alphabet."""
    ckpt = {
        "epoch": epoch,
        "encoder_weights": params_to_numpy(params["encoder"]),
        "decoder_weights": params_to_numpy(params["decoder"]),
        "encoder_optimizer_state": params_to_numpy(opt_states["encoder"]),
        "decoder_optimizer_state": params_to_numpy(opt_states["decoder"]),
        "history": history,
        "best_val_loss": best_val_loss,
    }
    if "predictor" in params:
        ckpt["predictor_weights"] = params_to_numpy(params["predictor"])
        ckpt["predictor_optimizer_state"] = params_to_numpy(opt_states["predictor"])
    if data_stats:
        for k in ("properties_mean", "properties_std"):
            if data_stats.get(k) is not None:
                ckpt[k] = np.asarray(data_stats[k], np.float32)
        if data_stats.get("alphabet"):
            ckpt["alphabet"] = np.asarray(list(data_stats["alphabet"]), object)
    return ckpt


def write_checkpoint(path, ckpt: dict) -> None:
    """Atomically serialize a host checkpoint dict to ``path`` (written to
    ``<path>.tmp.<pid>``, then ``os.replace``d)."""
    path = Path(path)
    tmp = path.with_name(f"{path.name}.tmp.{os.getpid()}")
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **ckpt)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)


def _convert_mlx_optimizer_state(state: dict) -> dict:
    """MLX ``optimizer.state`` layout (leaves ``{"m", "v"}`` plus top-level
    ``step`` / ``learning_rate``) -> ``{"step", "m": tree, "v": tree}``."""
    def walk(node):
        if (isinstance(node, dict) and {"m", "v"} <= set(node)
                and not isinstance(node["m"], dict)):
            return node["m"], node["v"]
        ms, vs = {}, {}
        for k, val in node.items():
            if k in ("step", "learning_rate"):
                continue
            ms[k], vs[k] = walk(val)
        return ms, vs

    m, v = walk(state)
    step = int(np.asarray(state.get("step", 0)))
    return {"step": np.int32(step), "m": m, "v": v}


def _is_mlx_optimizer_state(state: dict) -> bool:
    return isinstance(state, dict) and set(state) != {"step", "m", "v"}


def stale_best_notice(path, epoch: int) -> Optional[str]:
    """Notice when ``checkpoint_best.npz`` is far older than its siblings
    (at least 5 epochs and twice as long past the loaded "best" epoch)."""
    p = Path(path)
    if p.name != "checkpoint_best.npz":
        return None
    sibling_epochs = []
    for s in p.parent.glob("checkpoint_epoch_*.npz"):
        try:
            sibling_epochs.append(int(s.stem.rsplit("_", 1)[1]))
        except ValueError:
            continue
    if not sibling_epochs:
        return None
    last = max(sibling_epochs)
    if last - epoch < 5 or (epoch + 1) * 2 > last + 1:
        return None
    return (
        f"note: {p} is epoch {epoch}, but sibling checkpoints in "
        f"{p.parent} reach epoch {last}. If this run annealed beta, "
        "val_loss-selected 'best' checkpoints from early epochs can have "
        "prior-mismatched posteriors that break sampling — consider "
        f"checkpoint_epoch_{last:03d}.npz or retraining with "
        "--best_metric val_recon."
    )


def load_checkpoint(path) -> dict:
    """Load an .npz checkpoint -> dict with numpy param / optimizer trees.

    Accepts checkpoints from either package and from the MLX reference
    (whose optimizer state is converted)."""
    raw = np.load(str(path), allow_pickle=True)
    out = {
        "epoch": int(raw["epoch"]),
        "best_val_loss": float(raw["best_val_loss"]) if "best_val_loss" in raw
        else float("inf"),
        "history": raw["history"].item() if "history" in raw else None,
    }
    params, opt_states = {}, {}
    for name in ("encoder", "decoder", "predictor"):
        wkey, okey = f"{name}_weights", f"{name}_optimizer_state"
        if wkey in raw:
            params[name] = raw[wkey].item()
        if okey in raw:
            state = raw[okey].item()
            if _is_mlx_optimizer_state(state):
                state = _convert_mlx_optimizer_state(state)
            opt_states[name] = state
    out["params"] = params
    out["opt_states"] = opt_states
    out["data_stats"] = {
        "properties_mean": np.asarray(raw["properties_mean"])
        if "properties_mean" in raw else None,
        "properties_std": np.asarray(raw["properties_std"])
        if "properties_std" in raw else None,
        "alphabet": [str(t) for t in raw["alphabet"]]
        if "alphabet" in raw else None,
    }
    notice = stale_best_notice(path, out["epoch"])
    if notice:
        print(notice, file=sys.stderr)
    return out


def train_state_from_checkpoint(ckpt: dict, device="cpu") -> Tuple[dict, dict]:
    """``(params, opt_states)`` of a :func:`load_checkpoint` result as
    tensors on ``device``, ready for ``train/steps.py:train_step``: float32
    params (f32 masters), Adam states ``{"step": int32 scalar, "m", "v"}``
    with the params' tree structure."""
    params = {name: params_from_numpy(tree, device, torch.float32)
              for name, tree in ckpt["params"].items()}
    opt_states = {
        name: {"step": torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32,
                                    device=device),
               "m": params_from_numpy(state["m"], device, torch.float32),
               "v": params_from_numpy(state["v"], device, torch.float32)}
        for name, state in ckpt["opt_states"].items()}
    return params, opt_states
