"""Conversion between the JAX package's flax params and the port."""

from .convert import load_flax_params, to_flax_grads, to_flax_params

__all__ = ["load_flax_params", "to_flax_grads", "to_flax_params"]
