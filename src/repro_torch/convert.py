"""Parameters from the JAX package's layout, as numpy arrays, to the port's.

The JAX models stack per-layer parameters under ``"layers"`` (every leaf has
a leading layer axis, for ``lax.scan``); the port keeps a list of per-layer
dicts. ``params_from_numpy`` takes the JAX tree with numpy leaves (e.g.
``jax.tree.map(np.asarray, params)``) and returns the port's tree of tensors.

bfloat16 arrays arrive with the ``ml_dtypes`` bfloat16 dtype, which
``torch.from_numpy`` rejects; they are recognised by the dtype's name and
cross bit for bit as a uint16 view. ``ml_dtypes`` itself is not imported.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def tensor_from_numpy(x: np.ndarray, device="cpu") -> torch.Tensor:
    """A copy of ``x`` as a tensor on ``device``, bit for bit."""
    x = np.ascontiguousarray(x)
    if x.dtype.name == "bfloat16":
        t = torch.from_numpy(x.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(x.copy())
    return t.to(device)


def _convert(tree, device):
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    return tensor_from_numpy(np.asarray(tree), device)


def _unstack(tree, i: int):
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return tree[i]


def params_from_numpy(tree: Any, device="cpu") -> Any:
    """The port's parameter tree from the JAX package's (numpy leaves).

    The stacked ``"layers"`` subtree is split into a list of per-layer dicts.
    """
    out = {k: v for k, v in tree.items() if k != "layers"}
    out = _convert(out, device)
    if "layers" in tree:
        stacked = tree["layers"]
        n_layers = len(next(iter(_leaves(stacked))))
        out["layers"] = [_convert(_unstack(stacked, i), device)
                         for i in range(n_layers)]
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
