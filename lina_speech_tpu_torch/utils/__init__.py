"""Utilities: weights, gradients and states to and from the JAX package's layout."""
