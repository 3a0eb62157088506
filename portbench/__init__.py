"""The benchmark of the PyTorch and CUDA port (``mlx_vae_tpu_torch``) on one
NVIDIA H100. ``python -m portbench.run --workload <name> --seed <n>
--seconds <s> --trace <0|1>``; see README.md."""
