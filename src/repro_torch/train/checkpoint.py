"""Checkpoints on local disk, the port's counterpart of
``repro/train/checkpoint.py``, in its layout: ``<dir>/step_<N>/`` (N in
eight digits) holding one ``.npy`` a leaf (``leaf_00000.npy``, ...) and
``tree.json`` (the tree's structure, each leaf's file, shape and dtype).
A bf16 leaf, which numpy cannot hold, is stored as its raw bytes (uint8)
with the dtype ``raw:bfloat16``, as the reference stores it, so either
package restores the other's checkpoints; every other leaf, the 8-bit
AdamW's int8 and uint8 moments among them, is numpy's own dtype.

A save first copies every leaf to the host (synchronous), then writes, on
a background thread if asked: into ``step_<N>.tmp``, renamed to
``step_<N>`` once complete, so a save cut short never leaves a partial
checkpoint where :func:`list_steps` looks.  Only the newest ``keep_last``
are kept.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading

import numpy as np
import torch

from ..tree import tree_leaves

_SAVE_LOCK = threading.Lock()


def _leafpath(i: int) -> str:
    return f"leaf_{i:05d}.npy"


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def _to_native(t: torch.Tensor):
    """(numpy array to store, dtype string) of a host tensor."""
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.uint8).numpy(), "raw:bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _from_native(a: np.ndarray, dtype: str, shape) -> torch.Tensor:
    if dtype == "raw:bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a)).view(
            torch.bfloat16).reshape(shape)
    if dtype.startswith("raw:"):
        raise TypeError(f"checkpoint leaf of dtype {dtype[4:]}: the port "
                        "restores bfloat16 and numpy's own dtypes")
    return torch.from_numpy(np.array(a, copy=True)).reshape(shape)


def save(ckpt_dir: str, step: int, tree, *, async_: bool = False,
         keep_last: int = 3):
    """Copy ``tree``'s leaves to the host now; write them to disk now or,
    with ``async_``, on a thread (returned; join it before relying on the
    files).  Returns None when the write is done."""
    host = [t.detach().to("cpu", copy=True) for t in tree_leaves(tree)]
    natives = [_to_native(t) for t in host]
    meta = {
        "step": step,
        "treedef": _treedef_to_json(tree),
        "leaves": [{"file": _leafpath(i), "shape": list(t.shape),
                    "dtype": d}
                   for i, (t, (_, d)) in enumerate(zip(host, natives))],
    }

    def write():
        with _SAVE_LOCK:
            final = _step_dir(ckpt_dir, step)
            tmp = final + ".tmp"
            os.makedirs(tmp, exist_ok=True)
            for i, (a, _) in enumerate(natives):
                np.save(os.path.join(tmp, _leafpath(i)), a)
            with open(os.path.join(tmp, "tree.json"), "w") as f:
                json.dump(meta, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            _cleanup(ckpt_dir, keep_last)

    if async_:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t
    write()
    return None


def _cleanup(ckpt_dir: str, keep_last: int):
    for s in list_steps(ckpt_dir)[:-keep_last]:
        shutil.rmtree(_step_dir(ckpt_dir, s), ignore_errors=True)


def list_steps(ckpt_dir: str) -> list[int]:
    """Steps of the complete checkpoints under ``ckpt_dir``, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "tree.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir: str) -> int | None:
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: int | None = None, *, device="cpu"):
    """(step, tree) of checkpoint ``step`` (the latest by default), its
    leaves as tensors on ``device``."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    d = _step_dir(ckpt_dir, step)
    with open(os.path.join(d, "tree.json")) as f:
        meta = json.load(f)
    leaves = [_from_native(np.load(os.path.join(d, info["file"])),
                           info["dtype"], tuple(info["shape"])).to(device)
              for info in meta["leaves"]]
    return step, _treedef_from_json(meta["treedef"], leaves)


# -- the tree's structure as json: nested dicts / lists / tuples -----------

def _treedef_to_json(tree):
    if isinstance(tree, dict):
        # leaves are stored in sorted key order (tree_leaves, as jax
        # flattens a dict); the json keeps that order
        return {"__d__": {k: _treedef_to_json(tree[k])
                          for k in sorted(tree)}}
    if isinstance(tree, (list, tuple)):
        return {"__l__" if isinstance(tree, list) else "__t__":
                [_treedef_to_json(v) for v in tree]}
    return "LEAF"


def _treedef_from_json(spec, leaves):
    it = iter(leaves)

    def build(node):
        if node == "LEAF":
            return next(it)
        if "__d__" in node:
            return {k: build(v) for k, v in node["__d__"].items()}
        if "__l__" in node:
            return [build(v) for v in node["__l__"]]
        return tuple(build(v) for v in node["__t__"])

    out = build(spec)
    rest = list(it)
    if rest:
        raise ValueError(f"checkpoint {spec!r}: {len(rest)} unused leaves")
    return out
