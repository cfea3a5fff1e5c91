"""The port's block pool (``repro_torch.serving.kvcache``) against the
reference's (``repro.serving.kvcache``): the same random operation stream
drives both allocators, which must agree on every outcome and statistic;
the in-place device helpers match the reference's functional ones."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import kvcache as jkv
from repro_torch.serving import kvcache as tkv


def _apply(alloc, op, arg, held):
    """One operation; returns its outcome (a value, or the exception type)."""
    try:
        if op == "alloc":
            blk = alloc.alloc(owner=arg % 2)
            held.append((blk, arg % 2))
            return blk
        if op == "free" and held:
            blk, owner = held.pop(arg % len(held))
            alloc.free([blk], owner)
            return blk
        if op == "reserve":
            alloc.reserve(arg % 3)
            return "reserved"
        if op == "unreserve":
            alloc.unreserve(min(arg % 3, alloc.n_reserved))
            return "unreserved"
        if op == "register" and held:
            blk, owner = held[arg % len(held)]
            alloc.register((None, (arg % 4,)), blk, owner)
            return "registered"
        if op == "lookup":
            return alloc.lookup((None, (arg % 4,)), arg % 2)
        if op == "incref" and held:
            blk, _ = held[arg % len(held)]
            alloc.incref(blk, 1)
            held.append((blk, 1))
            return "incref"
        return None
    except (MemoryError, ValueError) as e:
        return type(e).__name__


@pytest.mark.parametrize("seed", range(4))
def test_allocator_matches_reference_on_random_streams(seed):
    rng = np.random.default_rng(seed)
    ops = ["alloc", "free", "reserve", "unreserve", "register", "lookup",
           "incref"]
    ref, port = jkv.BlockAllocator(9, 4), tkv.BlockAllocator(9, 4)
    held_r, held_p = [], []
    for _ in range(300):
        op, arg = ops[rng.integers(len(ops))], int(rng.integers(1000))
        assert _apply(port, op, arg, held_p) == _apply(ref, op, arg, held_r)
        assert dataclasses.astuple(port.stats()) == \
            dataclasses.astuple(ref.stats())
        port.check_integrity()
    assert tkv.prefix_chain_keys(list(range(10)), 4) == \
        jkv.prefix_chain_keys(list(range(10)), 4)


def test_device_helpers_match_reference():
    rng = np.random.default_rng(5)
    kp = rng.standard_normal((2, 6, 2, 4, 3)).astype(np.float32)
    bt = rng.integers(0, 6, (3, 5)).astype(np.int32)
    pos = np.asarray([4, 9, 2], np.int32)
    tc = {"kp": torch.from_numpy(kp.copy()), "bt": torch.from_numpy(bt.copy()),
          "pos": torch.from_numpy(pos.copy())}
    jc = {"kp": jnp.asarray(kp), "bt": jnp.asarray(bt),
          "pos": jnp.asarray(pos)}
    tkv.bt_set_entry(tc, 1, 3, 5)
    jc = jkv.bt_set_entry(jc, 1, 3, 5)
    tkv.pool_copy_block(tc, 2, 4)
    jc = jkv.pool_copy_block(jc, 2, 4)
    tkv.slot_release(tc, 0)
    jc = jkv.slot_release(jc, 0)
    for k in tc:
        np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]))
