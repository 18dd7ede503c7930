"""Atomic, digest-checked checkpoints in the JAX package's on-disk format."""
