"""Studies run with the port (counterparts of the JAX package's
``benchmarks/`` harnesses): :mod:`.elbo_compare`, the ELBO curve-parity
study held against the JAX package's recorded curves;
:mod:`.conditioning_fidelity` and :mod:`.latent_opt_fidelity`, generation
at a requested property from a trained checkpoint; :mod:`.quality_parity`,
which trains the ``examples/`` run and holds both studies, reconstruction
and bulk validity against the JAX records."""
