"""Multi-device dry run (counterpart of ``__graft_entry__.py:dryrun_multichip``).

    python -m mlx_vae_tpu_torch.parallel.dryrun N [--device cpu]

starts N ranks (``parallel/launch.py``) on the cards: one per card with
NCCL where N cards are visible, else N gloo ranks sharing the visible cards
(rank r on card r mod the count; NCCL refuses two ranks on one card).
``--device cpu`` runs N gloo ranks on the CPU instead. On a ``(N/2, 2)``
mesh (``(N, 1)`` where N is odd or below 4, as the JAX dry run picks) it
takes one tensor-parallel train step; on an ``(N, 1)`` mesh one gather-fed
data-parallel step, one data-parallel eval step and one data-parallel
greedy generation with ``use_pallas``: the kernels on the cards (a model
whose train step would take no train-kernel route is an error,
:func:`kernel_route_refusal`, and so is a data-parallel step that launched
none), their plain versions on the CPU. It then runs the same at the
scaled width (hidden 1024, 4 layers, latent 512, 3 conditions), and rank 0
prints one line in the JAX dry run's format. Every loss must be finite and
every shape right.
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch


def _finite(x: torch.Tensor, what: str) -> float:
    v = float(x)
    if not np.isfinite(v):
        raise RuntimeError(f"dry run: {what} is not finite ({v})")
    return v


# the kernels of the data-parallel steps and generation (``ops/build.py`` names)
SOURCES = ("fused_encoder", "fused_train_decoder", "fused_seq_lstm", "fused_generate",
           "fused_generate_steps")


def launch_counts() -> dict:
    """Every kernel wrapper's launch count so far, by kernel."""
    from mlx_vae_tpu_torch.ops import fused_encoder as fe
    from mlx_vae_tpu_torch.ops import fused_seq_lstm as fs
    from mlx_vae_tpu_torch.ops import fused_train_decoder as fd
    from mlx_vae_tpu_torch.ops.fused_decoder import fused_generate

    return {"fused_encoder_fwd": fe.encoder_fwd.launches,
            "fused_encoder_bwd": fe.encoder_bwd.launches,
            "fused_train_decoder_fwd": fd.decoder_fwd.launches,
            "fused_train_decoder_fwd_logits": fd.decoder_fwd.logits_launches,
            "fused_train_decoder_bwd": fd.decoder_bwd.launches,
            "seq_lstm_fwd": fs.seq_lstm_fwd.launches,
            "seq_lstm_bwd": fs.seq_lstm_bwd_tm.launches,
            "fused_generate_tc": fused_generate.tc_launches,
            "fused_generate_steps": fused_generate.step_launches,
            "fused_generate": fused_generate.core_launches}


def kernel_route_refusal(cfg) -> Optional[str]:
    """Why the train step of ``cfg`` would take no train-kernel route on the
    card, in the refusing kernel's own words, or None. The dry run exists to
    launch the kernels, so it asks for more than the model's routes do: the
    encoder ``"fused"`` or ``"seq"`` (``models/encoder.py:encoder_route``)
    and the decoder ``"fused"`` or ``"cvp"``
    (``models/decoder.py:train_decoder_route``)."""
    from mlx_vae_tpu_torch.models.decoder import train_decoder_route
    from mlx_vae_tpu_torch.models.encoder import encoder_route, layer_input_widths
    from mlx_vae_tpu_torch.ops import fused_seq_lstm as fs
    from mlx_vae_tpu_torch.ops import fused_train_decoder as fd
    from mlx_vae_tpu_torch.ops.decoder_cv import cvp_unsupported_reason

    if not cfg.use_pallas:
        return "use_pallas is off"
    if encoder_route(cfg) not in ("fused", "seq"):
        reason = next(r for r in (fs._unsupported_reason(i, cfg.hidden_dim, cfg.dtype)
                                  for i in layer_input_widths(cfg)) if r is not None)
        return f"the encoder's sequence kernels do not take {reason}"
    route = train_decoder_route(cfg)
    if route == "cv":
        return f"decoder_train_cvp's kernels do not take {cvp_unsupported_reason(cfg)}"
    if route == "scan":
        reason = ("reference_zero_state" if cfg.reference_zero_state else
                  fd._unsupported_reason(cfg) or "a stack whose weights exceed L2")
        return f"the fused training decoder does not take {reason}"
    return None


def _since(before: dict) -> dict:
    return {k: v - before[k] for k, v in launch_counts().items()}


def _tier(mcfg, B: int, L: int, device, seed: int) -> dict:
    """One tensor-parallel step, then the data-parallel gather-fed step,
    eval step and greedy generation, at ``mcfg`` on this rank; with each
    data-parallel part's kernel launches on this rank (``"launches"``)."""
    from mlx_vae_tpu_torch.config import TrainConfig
    from mlx_vae_tpu_torch.models.vae import ARCVAE, decode_latents
    from mlx_vae_tpu_torch.parallel.comm import host_gather_rows
    from mlx_vae_tpu_torch.parallel.mesh import (fold_seed, make_mesh, param_layout,
                                                 shard_params, world_size)
    from mlx_vae_tpu_torch.train.optim import adam_init
    from mlx_vae_tpu_torch.train.steps import (local_rows, make_dp_eval_step,
                                               make_dp_train_step, make_dp_train_step_gather)
    from mlx_vae_tpu_torch.utils.tree import tree_map

    n = world_size()
    tp = 2 if n % 2 == 0 and n >= 4 else 1
    tcfg = TrainConfig(batch_size=B)
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.integers(0, mcfg.vocab_size, (B, L)), dtype=torch.int32,
                        device=device)
    cond = torch.as_tensor(rng.normal(size=(B, mcfg.num_conditions)), dtype=torch.float32,
                           device=device)
    full = ARCVAE(mcfg, torch.Generator().manual_seed(seed), with_predictor=True,
                  device=device).params
    out = {}

    # 1) tensor parallelism (the GSPMD step: global noise, cut by data rank)
    mesh = make_mesh(tp)
    layouts = param_layout(full, tp)
    params = shard_params(mesh, tree_map(torch.clone, full), layouts)
    opt = {k: adam_init(p) for k, p in params.items()}
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    _, _, m = make_dp_train_step(mesh, mcfg, tcfg, layouts)(params, opt, x, cond, gen,
                                                             0.05, 0.9)
    out["mesh"] = mesh.shape
    out["loss"] = _finite(m["total_loss"], "the tensor-parallel step's loss")

    # 2)-4) data parallelism over every rank, the kernels where they take it
    dp = make_mesh(1)
    kcfg = mcfg.replace(use_pallas=True)
    refusal = kernel_route_refusal(kcfg)
    if refusal is not None:
        raise RuntimeError(f"dry run: {refusal}")
    params = tree_map(torch.clone, full)
    opt = {k: adam_init(p) for k, p in params.items()}
    gen = torch.Generator(device=device).manual_seed(fold_seed(seed + 2, dp.data_rank))
    toks = torch.as_tensor(rng.integers(0, mcfg.vocab_size, (4 * B, L)), dtype=torch.uint8,
                           device=device)
    props = torch.as_tensor(rng.normal(size=(4 * B, mcfg.num_conditions)),
                            dtype=torch.float32, device=device)
    idx = torch.as_tensor(rng.permutation(4 * B)[:B], device=device)
    launches, before = {}, launch_counts()
    _, _, m = make_dp_train_step_gather(dp, kcfg, tcfg)(params, opt, toks, props, idx, gen,
                                                         0.05, 0.9)
    out["gather_loss"] = _finite(m["total_loss"], "the gather-fed data-parallel loss")
    launches["train"], before = _since(before), launch_counts()
    if device.type == "cuda" and not any(launches["train"].values()):
        raise RuntimeError("dry run: the data-parallel step launched no kernel")
    m = make_dp_eval_step(dp, kcfg, tcfg)(params, x, cond, gen, 0.05, 0.0)
    out["eval_loss"] = _finite(m["total_loss"], "the data-parallel eval loss")
    launches["eval"], before = _since(before), launch_counts()
    gz = torch.Generator(device=device).manual_seed(seed + 4)
    z = torch.randn((B, mcfg.latent_dim), generator=gz, device=device)
    gs = torch.Generator(device=device).manual_seed(fold_seed(seed + 5, dp.data_rank))
    tokens = decode_latents({"decoder": params["decoder"]}, kcfg, local_rows(dp, z),
                            local_rows(dp, cond), gs, max_length=L, greedy=True)
    tokens = host_gather_rows(dp, [tokens.cpu().numpy()])[0]
    if tokens.shape != (B, L):
        raise RuntimeError(f"dry run: generation gave {tokens.shape}, not {(B, L)}")
    out["gen"] = tokens.shape
    launches["generate"] = _since(before)
    out["launches"] = launches
    return out


def _rank(rank: int, device: str) -> dict:
    """This rank's part: ``{"line": the summary, "launches": {tier: {part:
    {kernel: launches}}}}``."""
    from mlx_vae_tpu_torch.config import ModelConfig
    from mlx_vae_tpu_torch.parallel.mesh import build_kernels_once, rank_device, world_size

    dev = rank_device(device)
    build_kernels_once(dev, SOURCES)
    n = world_size()
    tiny = ModelConfig(vocab_size=32, embedding_dim=16, hidden_dim=32, latent_dim=16,
                       num_conditions=1, num_layers=2)
    t = _tier(tiny, 2 * n, 12, dev, 0)
    scaled = ModelConfig(vocab_size=128, embedding_dim=128, hidden_dim=1024, latent_dim=512,
                         num_conditions=3, num_layers=4)
    s = _tier(scaled, n, 8, dev, 10)
    line = (f"dryrun_multichip({n}): mesh={t['mesh']} loss={t['loss']:.4f} "
            f"gather_loss={t['gather_loss']:.4f} eval_loss={t['eval_loss']:.4f} "
            f"gen={t['gen']} scaled[H=1024/4L mesh={s['mesh']} loss={s['loss']:.4f} "
            f"gather={s['gather_loss']:.4f} eval={s['eval_loss']:.4f} gen={s['gen']}] OK")
    return {"line": line, "launches": {"tiny": t["launches"], "scaled": s["launches"]}}


def dryrun(n: int, device: str = "cuda", timeout: float = 1200.0) -> list:
    """Run the dry run on ``n`` ranks on ``device`` (the module docstring);
    prints rank 0's line and returns every rank's :func:`_rank` result."""
    from mlx_vae_tpu_torch.parallel.launch import spawn
    from mlx_vae_tpu_torch.parallel.mesh import visible_devices

    on_cuda = torch.device(device).type == "cuda"
    if on_cuda and not torch.cuda.is_available():
        raise SystemExit("dry run: CUDA is not available; pass --device cpu to run "
                         "the ranks on the CPU")
    backend = "nccl" if on_cuda and visible_devices(device) >= n else "gloo"
    results = spawn(_rank, n, device, backend, args=(device,), timeout=timeout)
    print(results[0]["line"])
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, help="ranks")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the cards, shared where fewer than N) or cpu (gloo ranks)")
    args = ap.parse_args(argv)
    dryrun(args.n, args.device)


if __name__ == "__main__":
    main()
