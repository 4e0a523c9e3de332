"""Training of the port: the JAX package's ``training/`` in PyTorch
(synthetic data, AdamW, the chunked cross-entropy train step,
checkpoints).  The entry point is ``launch.train``."""
