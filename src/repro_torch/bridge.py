"""Weight bridge: the reference's parameter tree -> the port's parameters.

The reference (``repro.models``) keeps parameters as nested dicts of JAX
arrays with each layer stack on axis 0 (``transformer.py:47``); the port
keeps the same tree of torch tensors.  The caller hands the tree over as
numpy arrays (``jax.tree.map(np.asarray, params)``), so this module needs
neither JAX nor ``ml_dtypes``: a bf16 leaf arrives as an ``ml_dtypes``
array, which ``torch.from_numpy`` refuses, and is carried over bit for bit
through its uint16 view.
"""
from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .models.layers import leaf_path
from .models.model import build_model


def _to_tensor(arr: np.ndarray, path: str) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    if arr.dtype not in (np.float32, np.float16, np.float64):
        raise TypeError(f"{path}: unsupported leaf dtype {arr.dtype}")
    return torch.from_numpy(np.array(arr, copy=True))


def params_from_reference(tree: dict, cfg, device=None) -> dict:
    """Convert the reference's param tree (nested dicts of numpy arrays)
    for ``cfg`` into the port's params on ``device`` (``cuda`` by
    default).  The tree must hold exactly the port's leaves, at the
    port's shapes; dtypes are kept."""
    dev = resolve_device(device)
    templates = build_model(cfg).templates

    def walk(t, node, path):
        if set(t) != set(node):
            raise ValueError(f"{leaf_path(path) or 'root'}: reference keys "
                             f"{sorted(node)} != port keys {sorted(t)}")
        out = {}
        for k, tk in t.items():
            p = path + (k,)
            if isinstance(tk, dict):
                out[k] = walk(tk, node[k], p)
                continue
            x = _to_tensor(node[k], leaf_path(p))
            if tuple(x.shape) != tk.shape:
                raise ValueError(f"{leaf_path(p)}: shape {tuple(x.shape)}, "
                                 f"the port expects {tk.shape}")
            out[k] = x.to(dev)
        return out

    return walk(templates, tree, ())
