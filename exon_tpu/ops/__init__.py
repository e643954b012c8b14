"""Device operator kernels (JAX/XLA) for the exon-tpu query engine."""
