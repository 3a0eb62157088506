"""Studies run with the port (counterparts of the JAX package's
``benchmarks/`` harnesses): :mod:`.elbo_compare`, the ELBO curve-parity
study held against the JAX package's recorded curves."""
