"""flax param tree <-> the port's modules.

The inverse direction of ``sfc_vit_tpu/utils/torch_compat.py``.  A flax
tree is a nested dict of numpy arrays, e.g.
``jax.tree_util.tree_map(np.asarray, variables['params'])``; its path
``a/b/leaf`` is the module parameter ``a.b.leaf``.  The port keeps flax's
names and ``[in, out]`` Dense kernels everywhere except in ``nn.Linear``
layers, whose ``weight`` is ``[out, in]``: there ``kernel`` is
transposed into ``weight``.  Pure numpy and torch, no jax.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

__all__ = ["load_flax_params", "to_flax_params"]


def _leaves(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _is_linear_kernel(model: nn.Module, path: Tuple[str, ...]) -> bool:
    if path[-1] != "kernel":
        return False
    try:
        owner = model.get_submodule(".".join(path[:-1]))
    except AttributeError:  # not in the model: reported as an extra leaf
        return False
    return isinstance(owner, nn.Linear)


def load_flax_params(model: nn.Module, params: Dict[str, Any]) -> nn.Module:
    """Fill every parameter of ``model`` from a flax tree; returns
    ``model``.  Raises on a missing, extra or mis-shaped leaf."""
    state = {}
    for path, value in _leaves(params):
        arr = np.asarray(value)
        if _is_linear_kernel(model, path):
            path, arr = path[:-1] + ("weight",), arr.T
        state[".".join(path)] = torch.from_numpy(np.ascontiguousarray(arr))
    own = dict(model.named_parameters())
    if set(state) != set(own):
        raise KeyError(
            f"flax tree and model differ: missing {sorted(set(own) - set(state))}, "
            f"extra {sorted(set(state) - set(own))}"
        )
    with torch.no_grad():
        for name, p in own.items():
            src = state[name]
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(
                    f"{name}: flax shape {tuple(src.shape)} vs model "
                    f"{tuple(p.shape)}")
            p.copy_(src)
    return model


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def to_flax_params(model: nn.Module) -> Dict[str, Any]:
    """The flax tree of ``model``'s parameters (numpy leaves; bf16
    parameters come out as float32)."""
    tree: Dict[str, Any] = {}
    for name, p in model.named_parameters():
        path = name.split(".")
        arr = _to_numpy(p)
        owner = model.get_submodule(".".join(path[:-1]))
        if isinstance(owner, nn.Linear) and path[-1] == "weight":
            path[-1], arr = "kernel", np.ascontiguousarray(arr.T)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = arr
    return tree
