"""The port's dense decoder (``repro_torch.models``) against the reference's
(``repro.models``): the reference's own ``Model.init`` weights carried over
by the bridge, chunk-by-chunk paged prefill and then paged decode, logits
compared at every call.

Two configs: qwen3's ``SMOKE``, and a narrow copy of the real config
(``CONFIG`` with 2 layers, d_model 128, d_ff 256, vocab 1000), which keeps
what ``SMOKE`` hides — 16/8 heads of head_dim 128 (Hq * hd != d_model),
tied embeddings, rope_theta 1e6 and a padded vocab.

Tolerances: with fp32-cast weights, atol = rtol = 1e-4 (same math, other
summation orders).  With bf16 weights, |err| <= 4% of the logits' scale:
activations round to bf16 (8 mantissa bits) after every op, at different
points in XLA (which fuses elementwise chains in fp32) and in PyTorch, so
after two layers the logits drift by a few bf16 steps (measured: 1.3% of
the scale on SMOKE, 0.9% on the narrow real config)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get
from repro.configs import smoke_config as ref_smoke
from repro.models import build_model as ref_build
from repro_torch.bridge import params_from_reference
from repro_torch.configs import get_config, list_archs, smoke_config
from repro_torch.models import build_model

NARROW = dict(n_layers=2, d_model=128, d_ff=256, vocab_size=1000)
CONFIGS = {
    "smoke": (ref_smoke("qwen3-0.6b"), smoke_config("qwen3-0.6b")),
    "narrow-real": (dataclasses.replace(ref_get("qwen3-0.6b"), **NARROW),
                    dataclasses.replace(get_config("qwen3-0.6b"), **NARROW)),
}
BS, M, B, N = 8, 8, 2, 20


def _ref_params(ref_cfg, dtype):
    p = ref_build(ref_cfg).init(jax.random.key(0))
    if dtype == "float32":
        p = jax.tree.map(lambda a: a.astype(jnp.float32), p)
    return p


def _logit_rows(ref_cfg, cfg, dtype):
    """Every logits row of a 21-token prompt prefilled in 3 chunks into
    slot 0 (shuffled blocks) and 4 greedy decode steps, slot 1 idle —
    from the reference and from the port."""
    rmodel, model = ref_build(ref_cfg), build_model(cfg)
    rp = _ref_params(ref_cfg, dtype)
    params = params_from_reference(jax.tree.map(np.asarray, rp), cfg,
                                   device="cpu")
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    rpc = rmodel.paged_cache_init(batch=B, n_blocks=N, block_size=BS,
                                  max_blocks=M, dtype=jdt)
    pc = model.paged_cache_init(batch=B, n_blocks=N, block_size=BS,
                                max_blocks=M, dtype=tdt, device="cpu")
    for i, blk in enumerate([3, 7, 1, 12, 5]):
        rpc["bt"] = rpc["bt"].at[0, i].set(blk)
        pc["bt"][0, i] = blk
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, 21)
    prefill, decode = jax.jit(rmodel.prefill_paged), jax.jit(
        rmodel.decode_paged)
    want, got = [], []
    for c in range(3):
        toks = np.zeros((1, BS), np.int32)
        seg = prompt[c * BS:(c + 1) * BS]
        toks[0, :len(seg)] = seg
        rl, rpc = prefill(rp, rpc, {"tokens": jnp.asarray(toks)}, 0, c, 21)
        tl, pc = model.prefill_paged(params, pc,
                                     {"tokens": torch.from_numpy(toks)},
                                     0, c, 21)
        want.append(np.asarray(rl)[0])
        got.append(tl[0].numpy())
    assert int(pc["pos"][0]) == int(rpc["pos"][0]) == 21
    for _ in range(4):
        feed = np.array([[int(np.argmax(want[-1]))], [0]], np.int32)
        rl, rpc = decode(rp, rpc, jnp.asarray(feed))
        tl, pc = model.decode_paged(params, pc, torch.from_numpy(feed))
        want.append(np.asarray(rl)[0])
        got.append(tl[0].numpy())
    np.testing.assert_array_equal(pc["pos"].numpy(), np.asarray(rpc["pos"]))
    return np.stack(got), np.stack(want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_paged_logits_match_reference(name, dtype):
    got, want = _logit_rows(*CONFIGS[name], dtype)
    assert got.shape == want.shape == (7, CONFIGS[name][1].vocab_size)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        assert np.abs(got - want).max() <= 0.04 * np.abs(want).max()


def test_bridge_carries_bf16_bits_and_rejects_mismatches():
    """bf16 leaves arrive bit for bit (without ml_dtypes on the port's
    side); a missing leaf or a wrong shape raises."""
    ref_cfg, cfg = CONFIGS["smoke"]
    tree = jax.tree.map(np.asarray, _ref_params(ref_cfg, "bfloat16"))
    params = params_from_reference(tree, cfg, device="cpu")
    wq = params["layers"]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        wq.view(torch.int16).numpy(),
        tree["layers"]["attn"]["wq"].view(np.int16))
    bad = dict(tree, final_norm=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="final_norm"):
        params_from_reference(bad, cfg, device="cpu")
    del bad["final_norm"]
    with pytest.raises(ValueError, match="keys"):
        params_from_reference(bad, cfg, device="cpu")


def test_registry_and_templates_match_reference():
    """The port builds the dense archs qwen3-0.6b and qwen2.5-3b, the
    hybrid zamba2-1.2b, the moe archs granite-moe-1b-a400m and
    qwen3-moe-235b-a22b and the vlm phi-3-vision-4.2b, with the
    reference's configs and the reference's param trees (names, shapes and
    leaf dtypes: the moe router stays fp32) at full width.  The families
    still to port raise."""
    assert list_archs() == ["granite-moe-1b-a400m", "phi-3-vision-4.2b",
                            "qwen2.5-3b", "qwen3-0.6b",
                            "qwen3-moe-235b-a22b", "zamba2-1.2b"]

    def shapes(t, f):
        return {k: shapes(v, f) if isinstance(v, dict) else f(v)
                for k, v in t.items()}
    for arch in list_archs():
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(ref_get(arch))
        assert dataclasses.asdict(smoke_config(arch)) == \
            dataclasses.asdict(ref_smoke(arch))
        ref_model = ref_build(ref_get(arch))
        model = build_model(get_config(arch))
        assert shapes(model.templates, lambda t: t.shape) == \
            shapes(ref_model.templates, lambda t: t.shape)
        assert shapes(model.templates, lambda t: t.dtype == torch.float32) \
            == shapes(ref_model.templates,
                      lambda t: t.dtype == jnp.float32)
        assert model.n_params == ref_model.n_params
    for family in ("ssm", "encdec"):
        with pytest.raises(NotImplementedError, match=family):
            build_model(dataclasses.replace(get_config("qwen3-0.6b"),
                                            family=family))


def test_entry_points_need_a_gpu_unless_cpu_is_asked(monkeypatch):
    """``cuda`` is the default device; with no GPU it raises instead of
    quietly running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build_model(smoke_config("qwen3-0.6b"))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        model.init(0)
    assert model.init(0, device="cpu")["final_norm"].device.type == "cpu"
