"""Lane striping layout transforms (paper contribution C1, §2): a copy of
the reference's ``repro/core/lanes.py``, on torch tensors and numpy byte
images.

Ara2 assigns consecutive vector elements to consecutive lanes ("to ease
mixed-width operations").  These helpers realize that byte layout as array
transforms: ``stripe`` / ``unstripe`` on tensors (the 3-step reduction's
first phase, :func:`repro_torch.core.reduction.hierarchical_reduce`), and
the byte-level VRF image with the reshuffle the SLDU performs as its second
job (``stripe_bytes``, ``unstripe_bytes``, ``reshuffle``).

Logical element ``i`` of a vector lives at ``lanes[i % L, i // L]``.
"""
from __future__ import annotations

import numpy as np
import torch

from .vector_engine import ceil_div


def stripe(x: torch.Tensor, n_lanes: int, fill=0) -> torch.Tensor:
    """Logical 1-D vector -> (n_lanes, elems_per_lane), Ara2 byte layout."""
    (n,) = x.shape
    epl = ceil_div(n, n_lanes)
    pad = epl * n_lanes - n
    if pad:
        x = torch.cat([x, torch.full((pad,), fill, dtype=x.dtype,
                                     device=x.device)])
    # element i -> [i % L, i // L]
    return x.reshape(epl, n_lanes).T


def unstripe(lanes: torch.Tensor, n: int | None = None) -> torch.Tensor:
    """Inverse of :func:`stripe`."""
    n_lanes, epl = lanes.shape
    x = lanes.T.reshape(n_lanes * epl)
    return x if n is None else x[:n]


def stripe_bytes(x: np.ndarray, n_lanes: int) -> np.ndarray:
    """Byte-accurate VRF image of a vector register group: element i's bytes go
    to lane ``i % L`` at byte offset ``(i // L) * ew``.  Returns
    ``(n_lanes, bytes_per_lane)`` uint8."""
    raw = np.ascontiguousarray(x).view(np.uint8).reshape(x.size, x.itemsize)
    epl = ceil_div(x.size, n_lanes)
    img = np.zeros((n_lanes, epl * x.itemsize), dtype=np.uint8)
    for i in range(x.size):
        img[i % n_lanes, (i // n_lanes) * x.itemsize:(i // n_lanes + 1) * x.itemsize] = raw[i]
    return img


def unstripe_bytes(img: np.ndarray, dtype, n: int) -> np.ndarray:
    """Read ``n`` elements of ``dtype`` back out of a VRF byte image."""
    itemsize = np.dtype(dtype).itemsize
    n_lanes = img.shape[0]
    raw = np.zeros((n, itemsize), dtype=np.uint8)
    for i in range(n):
        raw[i] = img[i % n_lanes, (i // n_lanes) * itemsize:(i // n_lanes + 1) * itemsize]
    return raw.reshape(-1).view(dtype)[:n]


def reshuffle(img: np.ndarray, old_dtype, new_dtype, n_old: int) -> np.ndarray:
    """The Ara2 *reshuffle* micro-operation (§2 "Source Registers"): reinterpret
    a register group encoded with EW_old under EW_new.  The logical byte stream
    is preserved; only the lane/byte placement changes.  In hardware this is a
    whole-register SLDU pass; here it is the layout transform the SLDU
    implements, used as the oracle for the slide-unit tests."""
    n_lanes = img.shape[0]
    stream = unstripe_bytes(img, np.uint8, n_old * np.dtype(old_dtype).itemsize) \
        if np.dtype(old_dtype).itemsize == 1 else \
        np.ascontiguousarray(unstripe_bytes(img, old_dtype, n_old)).view(np.uint8)
    new_it = np.dtype(new_dtype).itemsize
    n_new = len(stream) // new_it
    return stripe_bytes(stream[: n_new * new_it].view(new_dtype), n_lanes)
