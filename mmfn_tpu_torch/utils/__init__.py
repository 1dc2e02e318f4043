"""Checkpoint loading and weights carried across from the JAX package."""
