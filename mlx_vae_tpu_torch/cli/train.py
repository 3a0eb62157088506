#!/usr/bin/env python3
"""Training CLI (counterpart of ``mlx_vae_tpu/cli/train.py``).

``python -m mlx_vae_tpu_torch.cli.train`` with the JAX CLI's flags, names
and defaults, plus ``--device`` (default ``cuda``; ``--device cpu`` runs the
plain PyTorch versions). The same fixed seed-67 80/10/10 split with the
train stats propagated to val/test, checkpoint clearing on fresh runs,
``--resume`` from ``checkpoint_best.npz`` (written by either package),
per-epoch history, best-metric checkpointing and the history plot.

Flag mapping on the port:

* ``--use_pallas``: the fused CUDA kernels (on CPU tensors their plain
  versions). The defaults stay ``float32`` without ``--use_pallas``, as in
  the JAX CLI; pass ``--use_pallas --compute_dtype bfloat16`` for the
  tensor-core kernels. On the card a model the fused training decoder does
  not take is refused before the corpus is loaded
  (``models/decoder.py:train_route_refusal``, beside the dispatch).
* ``--profile LOGDIR``: a ``torch.profiler`` Chrome trace of the first
  epoch (``utils/profiler.py``).
* ``--compilation_cache`` / ``--no_compilation_cache``: accepted, no effect
  (the port has no compile cache).
* ``--data_parallel`` on one visible device trains there;
  ``--data_parallel`` over more devices and ``--model_parallel`` > 1 exit
  with "not yet ported (multi-device slice)".
* The init draws come from a ``torch.Generator`` seeded with ``--seed``
  (``models/vae.py:ARCVAE``); the batch order is the JAX CLI's exactly.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
import torch

from mlx_vae_tpu_torch.cli.common import add_cache_flags


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Train AR-CVAE for molecular generation")

    # Data arguments (reference train.py:21-22)
    parser.add_argument("--data", type=str, default="mlx_data/chembl_cns_selfies.json",
                        help="Path to dataset JSON file")

    # Model arguments (reference train.py:25-31)
    parser.add_argument("--vocab_size", type=int, default=80, help="Vocabulary size")
    parser.add_argument("--embedding_dim", type=int, default=128, help="Embedding dimension")
    parser.add_argument("--hidden_dim", type=int, default=256, help="Hidden dimension")
    parser.add_argument("--latent_dim", type=int, default=128, help="Latent dimension")
    parser.add_argument("--num_conditions", type=int, default=1, help="Number of conditions")
    parser.add_argument("--num_layers", type=int, default=2, help="Number of LSTM layers")
    parser.add_argument("--dropout", type=float, default=0.2, help="Dropout rate")

    # Training arguments (reference train.py:34-44)
    parser.add_argument("--epochs", type=int, default=30, help="Number of epochs")
    parser.add_argument("--batch_size", type=int, default=32, help="Batch size")
    parser.add_argument("--learning_rate", type=float, default=2e-4, help="Learning rate")
    parser.add_argument("--beta_start", type=float, default=0.0, help="Initial beta value")
    parser.add_argument("--beta_end", type=float, default=0.05, help="Final beta value")
    parser.add_argument("--beta_warmup_epochs", type=int, default=20, help="Beta warmup epochs")
    parser.add_argument("--lambda_prop", type=float, default=0.1, help="Property loss weight")
    parser.add_argument("--lambda_collapse", type=float, default=0.001,
                        help="Posterior collapse weight")
    parser.add_argument("--free_bits", type=float, default=1.0,
                        help="Free bits constraint (min KL per dimension)")
    parser.add_argument("--lambda_mi", type=float, default=0.01,
                        help="Mutual information penalty weight")
    parser.add_argument("--target_mi", type=float, default=4.85,
                        help="MI target driving the MI penalty "
                             "lambda_mi*max(0, target_mi - MI)")
    parser.add_argument("--grad_clip", type=float, default=1.0, help="Gradient clipping norm")

    # Output arguments (reference train.py:47-54)
    parser.add_argument("--checkpoint_dir", type=str, default="./checkpoints",
                        help="Checkpoint directory")
    parser.add_argument("--checkpoint_freq", type=int, default=10,
                        help="Checkpoint frequency (epochs)")
    parser.add_argument("--verbose", action="store_true",
                        help="Print detailed epoch summaries")
    parser.add_argument("--resume", action="store_true",
                        help="Resume from checkpoint_best.npz in checkpoint directory "
                             "(if not specified, clears old checkpoints)")

    # Extensions of the JAX CLI
    parser.add_argument("--properties", type=str, default="tpsa",
                        help="Comma-separated property keys for conditioning "
                             "(e.g. tpsa,logp,mw)")
    parser.add_argument("--use_property_predictor", action="store_true",
                        help="Train the z->properties predictor head")
    parser.add_argument("--data_parallel", action="store_true",
                        help="Shard the batch over all visible devices (one "
                             "visible device: trains there; more: not yet ported)")
    parser.add_argument("--model_parallel", type=int, default=1,
                        help="Tensor-parallel degree (> 1 not yet ported); "
                             "disables --use_pallas")
    parser.add_argument("--steps_per_dispatch", type=int, default=1,
                        help="Run K optimizer steps per dispatch call")
    parser.add_argument("--sync_checkpoint", action="store_true",
                        help="Block the epoch loop on checkpoint writes "
                        "(default: the host copy + npz write run on a "
                        "background thread)")
    parser.add_argument("--host_data", action="store_true",
                        help="Feed batches from host instead of keeping the "
                        "corpus device-resident (for corpora too large "
                        "for device memory)")
    parser.add_argument("--compute_dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"], help="Matmul compute dtype")
    parser.add_argument("--use_pallas", action="store_true",
                        help="Use the fused CUDA kernels (encoder, training "
                             "decoder, sequence LSTM, generation)")
    parser.add_argument("--custom_vjp", action="store_true",
                        help="Hand-written big-matmul LSTM backward (the "
                             "per-layer route of the scaled model)")
    parser.add_argument("--reference_zero_state", action="store_true",
                        help="Reproduce the reference decoder's zero-state quirk")
    parser.add_argument("--bidirectional", action="store_true",
                        help="Bi-directional encoder (what the reference README "
                             "claims; its code is forward-only)")
    parser.add_argument("--apply_dropout", action="store_true",
                        help="Actually apply the --dropout rate between encoder "
                             "layers (the reference accepts but ignores it)")
    parser.add_argument("--profile", type=str, default=None, metavar="LOGDIR",
                        help="Record a torch.profiler trace of the first epoch "
                             "(LOGDIR/trace.json, Chrome trace format)")
    parser.add_argument("--synthetic", type=int, default=0, metavar="N",
                        help="Generate an N-molecule synthetic dataset at --data first")
    parser.add_argument("--eval_test", action="store_true",
                        help="Evaluate the held-out test split after training")
    parser.add_argument("--best_metric", type=str, default="val_loss",
                        choices=["val_loss", "val_recon"],
                        help="Series that selects checkpoint_best (val_recon is "
                             "beta-independent; keep the flag consistent "
                             "across a resumed run)")
    parser.add_argument("--seed", type=int, default=67,
                        help="Seed for model init, shuffling, TF masks, and "
                             "reparameterization noise. The 80/10/10 data "
                             "split always uses seed 67")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda[:N] (the kernels) or cpu (their plain versions)")
    add_cache_flags(parser)
    return parser


def main(argv=None):
    from mlx_vae_tpu_torch.cli.common import resolve_device
    from mlx_vae_tpu_torch.config import ModelConfig, TrainConfig
    from mlx_vae_tpu_torch.data.prepare import make_synthetic_dataset
    from mlx_vae_tpu_torch.data.split import load_and_split
    from mlx_vae_tpu_torch.models.decoder import train_route_refusal
    from mlx_vae_tpu_torch.models.vae import ARCVAE
    from mlx_vae_tpu_torch.train.trainer import (ARCVAETrainer, multi_device_refusal,
                                                 visible_devices)

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)

    print("=" * 80)
    print("AR-CVAE Training (PyTorch port)")
    print("=" * 80)
    print("\nConfiguration:")
    print(f"  Dataset: {args.data}")
    print(f"  Model: embedding={args.embedding_dim}, hidden={args.hidden_dim}, "
          f"latent={args.latent_dim}")
    print(f"  Training: epochs={args.epochs}, batch_size={args.batch_size}, "
          f"lr={args.learning_rate}")
    print(f"  Beta: start={args.beta_start}, end={args.beta_end}, "
          f"warmup={args.beta_warmup_epochs}")
    print("  Splits: train=0.8, val=0.1, test=0.1")
    print(f"  Device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))
    print("=" * 80)

    property_keys = tuple(k.strip() for k in args.properties.split(",") if k.strip())
    if len(property_keys) != args.num_conditions:
        print(f"  Note: num_conditions={args.num_conditions} adjusted to match "
              f"{len(property_keys)} property keys {property_keys}")
        args.num_conditions = len(property_keys)

    if args.model_parallel > 1 and args.use_pallas:
        print("⚠️  --model_parallel > 1 disables --use_pallas: the fused "
              "kernels have no partitioning rule for model-sharded operands")
        args.use_pallas = False

    mcfg = ModelConfig(
        vocab_size=args.vocab_size,
        embedding_dim=args.embedding_dim,
        hidden_dim=args.hidden_dim,
        latent_dim=args.latent_dim,
        num_conditions=args.num_conditions,
        num_layers=args.num_layers,
        dropout=args.dropout,
        compute_dtype=args.compute_dtype,
        use_pallas=args.use_pallas,
        custom_vjp=args.custom_vjp,
        reference_zero_state=args.reference_zero_state,
        bidirectional=args.bidirectional,
        apply_dropout=args.apply_dropout,
    )
    tcfg = TrainConfig(
        epochs=args.epochs,
        batch_size=args.batch_size,
        learning_rate=args.learning_rate,
        beta_start=args.beta_start,
        beta_end=args.beta_end,
        beta_warmup_epochs=args.beta_warmup_epochs,
        lambda_prop=args.lambda_prop,
        lambda_collapse=args.lambda_collapse,
        free_bits=args.free_bits,
        lambda_mi=args.lambda_mi,
        target_mi=args.target_mi,
        grad_clip=args.grad_clip,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_freq=args.checkpoint_freq,
        data_parallel=args.data_parallel,
        model_parallel=args.model_parallel,
        steps_per_dispatch=args.steps_per_dispatch,
        async_checkpoint=not args.sync_checkpoint,
        host_data=args.host_data,
        seed=args.seed,
    )
    # refusals come before any corpus is made or loaded
    for refusal in (multi_device_refusal(tcfg, visible_devices(device)),
                    train_route_refusal(mcfg, device)):
        if refusal is not None:
            raise SystemExit(f"ERROR: {refusal}")

    if args.synthetic:
        Path(args.data).parent.mkdir(parents=True, exist_ok=True)
        make_synthetic_dataset(n=args.synthetic, vocab_size=args.vocab_size,
                               path=args.data)
        print(f"✓ Generated synthetic dataset ({args.synthetic} molecules) at {args.data}")

    print("\nLoading dataset...")
    train_dataset, val_dataset, test_dataset, data = load_and_split(
        args.data, seed=67, property_keys=property_keys)

    print("✓ Property normalization (using train set stats):")
    print(f"  Mean: {train_dataset.properties_mean.flatten()}")
    print(f"  Std:  {train_dataset.properties_std.flatten()}")
    n_total = len(train_dataset) + len(val_dataset) + len(test_dataset)
    print(f"✓ Loaded {n_total:,} samples")
    print(f"  - Training: {len(train_dataset):,} samples")
    print(f"  - Validation: {len(val_dataset):,} samples")
    print(f"  - Test: {len(test_dataset):,} samples")

    checkpoint_dir = Path(args.checkpoint_dir)
    checkpoint_path = checkpoint_dir / "checkpoint_best.npz"
    start_epoch = 0
    best_val_loss = float("inf")

    if args.resume:
        if not checkpoint_path.exists():
            raise FileNotFoundError(f"Checkpoint not found: {checkpoint_path}")
        print(f"\nResuming from checkpoint: {checkpoint_path}")
    elif checkpoint_dir.exists():
        # Fresh runs wipe old checkpoints + plot (reference train.py:157-166).
        print(f"\nClearing old checkpoints in {checkpoint_dir}")
        for f in checkpoint_dir.glob("*.npz"):
            f.unlink()
        plot = checkpoint_dir / "training_history.png"
        if plot.exists():
            plot.unlink()
        print("✓ Cleared old checkpoints")

    print("\nCreating VAE model...")
    vae = ARCVAE(mcfg, torch.Generator().manual_seed(tcfg.seed),
                 with_predictor=args.use_property_predictor, device=device)
    print("✓ VAE model created")

    print("\nCreating trainer...")
    trainer = ARCVAETrainer(vae.params, mcfg, tcfg, train_dataset)
    trainer.alphabet = data.get("alphabet")
    print("✓ Trainer created")

    if args.resume:
        from mlx_vae_tpu_torch.train.checkpoint import load_checkpoint
        best_val_loss = load_checkpoint(checkpoint_path)["best_val_loss"]
        loaded_epoch = trainer.load_checkpoint(checkpoint_path)
        start_epoch = loaded_epoch + 1
        print(f"✓ Loaded model weights from epoch {loaded_epoch}")
        print(f"  Resuming from epoch {start_epoch}")
        print(f"  Best validation loss so far: {best_val_loss:.4f}")

    from mlx_vae_tpu_torch.utils.profiler import trace

    # The async save thread is a daemon: always join before unwinding, so an
    # exception (or Ctrl-C) never leaves a checkpoint write unlanded.
    try:
        for epoch in range(start_epoch, args.epochs):
            print(f"\nEpoch {epoch + 1}/{args.epochs}")
            with trace(args.profile if epoch == start_epoch else None):
                metrics = trainer.train_epoch(epoch=epoch,
                                              total_epochs=args.epochs,
                                              val_dataset=val_dataset)

            trainer.history["epoch"].append(epoch)
            for k in ("train_loss", "train_recon", "train_kl",
                      "train_collapse", "train_prop", "val_loss", "val_recon",
                      "val_kl", "val_collapse", "val_prop", "beta",
                      "teacher_forcing", "mutual_info"):
                trainer.history[k].append(metrics[k])
            trainer.history["learning_rate"].append(args.learning_rate)

            is_best = metrics[args.best_metric] < best_val_loss
            if is_best:
                best_val_loss = metrics[args.best_metric]

            if (epoch + 1) % args.checkpoint_freq == 0 or is_best:
                trainer.save_checkpoint(epoch=epoch, is_best=is_best,
                                        best_val_loss=best_val_loss)
                trainer.save_history(args.checkpoint_dir)

            if args.verbose:
                print(f"\nEpoch {epoch + 1}/{args.epochs}: "
                      f"Train Loss: {metrics['train_loss']:.4f}, "
                      f"Val Loss: {metrics['val_loss']:.4f}, "
                      f"Beta: {metrics['beta']:.4f}")
    finally:
        trainer.join_saves()  # land any in-flight async checkpoint write
    trainer.plot_history(save_path=f"{args.checkpoint_dir}/training_history.png")

    from mlx_vae_tpu_torch.train.history import anneal_best_warning
    warning = anneal_best_warning(trainer.history, args.best_metric)
    if warning:
        print(warning, file=sys.stderr)

    if args.eval_test:
        beta = trainer.compute_beta(args.epochs - 1)
        tm = trainer._eval_batches(test_dataset, beta, None, "Test")
        print(f"\nTest set ({len(test_dataset):,} samples): "
              f"loss={tm['loss']:.4f} recon={tm['recon']:.4f} "
              f"kl={tm['kl']:.4f}")

    print("\n✓ Training complete! ✓")


if __name__ == "__main__":
    main()
