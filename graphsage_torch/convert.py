"""Carry parameters between the JAX package and the port.

Both packages lay parameters out the same way: nested dicts and lists with
weights ``[out, in]``, e.g. ``{"sage": {"layers": [{"weight"}]},
"clf": {"weight", "bias"}}``.  So the conversion is leaf by leaf, with no
transposes.  Serving bundles store the flattened form: one array per
pytree path (``"sage/layers/0/weight"``).
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch


def _tree_map(fn: Callable[[Any], Any], tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _to_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to(device)
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16, as JAX gives it
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        # a copy: never a view of a live CPU tensor that SGD updates
        return x.numpy().copy()
    return np.asarray(x)


def params_from_jax(tree, device: str | torch.device = "cpu"):
    """A param pytree of numpy arrays (as ``jax.device_get`` returns it) ->
    the same nesting of torch tensors on ``device``.  Tensor leaves are moved;
    bfloat16 leaves stay bfloat16."""
    return _tree_map(lambda x: _to_tensor(x, device), tree)


def params_to_numpy(tree):
    """The port's param pytree -> the same nesting of numpy arrays (bfloat16
    tensors come back as float32)."""
    return _tree_map(_to_numpy, tree)


def flatten_params(tree, prefix: str = "") -> dict[str, Any]:
    """{"a": {"b": [x]}} -> {"a/b/0": x}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    flat: dict[str, Any] = {}
    for k, v in items:
        flat.update(flatten_params(v, f"{prefix}/{k}" if prefix else str(k)))
    return flat


def unflatten_params(flat: dict[str, Any]):
    """Inverse of :func:`flatten_params`: integer path parts become list
    positions."""
    root: dict = {}
    for path, value in flat.items():
        node = root
        *parents, last = path.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = value
    return _lists_from_int_keys(root)


def _lists_from_int_keys(node):
    if not isinstance(node, dict):
        return node
    node = {k: _lists_from_int_keys(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        return [node[str(i)] for i in range(len(node))]
    return node
