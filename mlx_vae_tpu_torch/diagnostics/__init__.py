"""Console diagnostics (counterparts of the repo-root ``diagnostics/``
scripts): :mod:`.check_decoder_grads`, :mod:`.data_diagnostic` and
:mod:`.loss_signs`. Each runs as ``python -m
mlx_vae_tpu_torch.diagnostics.<name> [--device cpu]`` (the card by
default), and each ``main(argv)`` returns its exit code."""
