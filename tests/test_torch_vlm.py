"""The port's vlm family (phi-3-vision's patch prefix) and the engine's
``extra_inputs`` against the reference:

* prefill, paged-chunk and decode logits of the phi-3-vision smoke config
  with seeded patch rows (``torch_parity``: fp32 at atol = rtol = 1e-4,
  bf16 at 4% of the logits' scale);
* greedy tokens of the engine equal the reference's with fp32 weights and
  one patch row a request, dense, paged and bucketed;
* the prefix counted everywhere the engine counts positions: the first
  decode position is ``n_patches + len(prompt)``, the bucket cap leaves
  room for the prefix, the write budget counts it;
* ``_gather_extra``: one row broadcasts, rows follow submission order, a
  missing row raises; the prefix cache is refused for vlm (engine and
  cluster);
* a preempted vlm request resumes invisibly on both layouts;
* the serve CLI builds the reference's stub patches.
"""
import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity
from repro.configs import smoke_config as ref_smoke
from repro.models import build_model as ref_build
from repro.serving import Request as RefRequest
from repro.serving import ServeEngine as RefServeEngine
from repro_torch.configs import smoke_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models import build_model
from repro_torch.serving import ClusterEngine, Request, ServeEngine

ARCH = "phi-3-vision-4.2b"
CFG = smoke_config(ARCH)


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """The smoke models' ops are tiny: one intra-op thread runs them about
    as fast as many and keeps parallel test workers off each other's
    cores.  The old count comes back after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def smoke():
    model = build_model(CFG)
    return model, model.init(0, device="cpu", dtype=torch.float32)


def _patches(n, seed=0):
    return torch.from_numpy(torch_parity.patches(CFG, n, seed))


def _prompts(n=4):
    return [[(5 * i + j) % CFG.vocab_size for j in range(4 + 3 * i)]
            for i in range(n)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vlm_logits_match_reference(dtype):
    """Dense prefill (two prompts, each with its patch rows), dense decode,
    a prompt's paged chunks (the first one all patches) and paged decode
    against the reference."""
    got, want, gaps = torch_parity.logit_rows(ref_smoke(ARCH), CFG, dtype)
    assert np.isinf(gaps).all()          # no router: nothing is excused
    assert torch_parity.assert_logits_close(got, want, gaps, dtype) == []


@pytest.mark.parametrize("layout,bucket", [("dense", None),
                                           ("dense", "pow2"),
                                           ("paged", None)])
def test_vlm_engine_tokens_equal_reference(layout, bucket):
    """fp32 weights, one seeded patch row a request: the port's engine
    serves the reference's greedy tokens."""
    rp, params = torch_parity.weights(ref_smoke(ARCH), CFG)
    pat = torch_parity.patches(CFG, 4)
    kw = dict(block_size=8) if layout == "paged" else dict(bucket=bucket)
    ref = RefServeEngine(ref_build(ref_smoke(ARCH)), rp, max_batch=3,
                         cache_len=48, kv_layout=layout,
                         extra_inputs={"patches": jnp.asarray(pat)}, **kw)
    eng = ServeEngine(build_model(CFG), params, max_batch=3, cache_len=48,
                      kv_layout=layout,
                      extra_inputs={"patches": torch.from_numpy(pat)}, **kw)
    want = [r.tokens for r in ref.generate(
        [RefRequest(p, 6, rid=i) for i, p in enumerate(_prompts())])]
    got = [r.tokens for r in eng.generate(
        [Request(p, 6, rid=i) for i, p in enumerate(_prompts())])]
    assert got == want


@contextlib.contextmanager
def _first_decode_positions(eng):
    """Record the cache positions the first decode step writes."""
    seen = []
    orig = eng._decode

    def spy(params, cache, toks):
        if not seen:
            seen.append(cache["pos"].clone())
        return orig(params, cache, toks)
    eng._decode = spy
    try:
        yield seen
    finally:
        eng._decode = orig


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_first_decode_position_counts_the_prefix(smoke, layout):
    """Every request's first decode writes position ``n_patches +
    len(prompt)`` (4 requests in 4 slots, all admitted before it)."""
    model, params = smoke
    kw = dict(block_size=8) if layout == "paged" else {}
    eng = ServeEngine(model, params, max_batch=4, cache_len=48,
                      kv_layout=layout,
                      extra_inputs={"patches": _patches(4)}, **kw)
    with _first_decode_positions(eng) as seen:
        eng.generate([Request(p, 3, rid=i)
                      for i, p in enumerate(_prompts())])
    assert seen[0].tolist() == [CFG.n_patches + len(p) for p in _prompts()]


def test_gather_extra_broadcasts_and_raises(smoke):
    """One row broadcasts to every request; several rows are taken by
    submission order; too few rows is an error, not a clamp."""
    model, params = smoke
    one = ServeEngine(model, params, max_batch=2, cache_len=48,
                      extra_inputs={"patches": _patches(1)})
    got = one._gather_extra([0, 3, 5])["patches"]
    assert got.shape == (3, CFG.n_patches, CFG.patch_embed_dim)
    assert all(torch.equal(got[i], _patches(1)[0]) for i in range(3))
    three = ServeEngine(model, params, max_batch=2, cache_len=48,
                        extra_inputs={"patches": _patches(3)})
    assert torch.equal(three._gather_extra([2, 0])["patches"],
                       _patches(3)[[2, 0]])
    with pytest.raises(ValueError, match="has 3 rows but request #3"):
        three._gather_extra([3])
    with pytest.raises(ValueError, match="has 3 rows but request #3"):
        three.generate([Request([1, 2], 2, rid=i) for i in range(4)])


def test_prefix_cache_refused_for_vlm(smoke):
    model, params = smoke
    with pytest.raises(ValueError, match="patch prefix"):
        ServeEngine(model, params, kv_layout="paged", prefix_cache=True,
                    extra_inputs={"patches": _patches(1)})
    with pytest.raises(ValueError, match="patch prefix"):
        ClusterEngine(model, params, replicas=2, total_slots=2,
                      block_size=8, cache_len=48, prefix_cache=True,
                      extra_inputs={"patches": _patches(1)})


def test_bucket_cap_and_budget_count_the_prefix(smoke):
    """pow2 buckets stop at ``cache_len - n_patches`` (the prefix still
    fits), and the write budget counts the prefix."""
    model, params = smoke
    eng = ServeEngine(model, params, max_batch=2, cache_len=40,
                      bucket="pow2", extra_inputs={"patches": _patches(1)})
    assert eng._n_prefix() == CFG.n_patches == 8
    assert eng._bucket_len(5) == 8
    assert eng._bucket_len(17) == eng._bucket_len(30) == 32   # 32 + 8 fits
    tight = ServeEngine(model, params, max_batch=2, cache_len=36,
                       bucket="pow2", extra_inputs={"patches": _patches(1)})
    assert tight._bucket_len(17) == 28            # pow2 32 capped at 36 - 8
    got = tight.generate([Request(list(range(1, 18)), 3, rid=0)])
    assert len(got[0].tokens) == 3
    with pytest.raises(ValueError, match="cache positions"):
        tight.generate([Request(list(range(1, 30)), 2, rid=0)])


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_preempted_vlm_request_resumes_invisibly(smoke, layout):
    """A vlm request preempted after 3 decode steps and re-admitted (its
    patch row again, by its submission order) emits the uninterrupted
    stream."""
    model, params = smoke
    kw = dict(block_size=8) if layout == "paged" else {}
    extra = {"patches": _patches(2)}
    reqs = [Request(p, 8, rid=i) for i, p in enumerate(_prompts(2))]
    eng = ServeEngine(model, params, max_batch=2, cache_len=48,
                      kv_layout=layout, extra_inputs=extra, **kw)
    want = [r.tokens for r in eng.generate(reqs)]
    eng.begin_session()
    eng.session_admit(reqs[0], tag=0, extra_row=0)
    eng.session_admit(reqs[1], tag=1, extra_row=1)
    out = {}
    for _ in range(4):
        out.update(eng.session_step())
    tag, requeued = eng.session_preempt(1)
    assert tag == 1 and len(requeued.done) >= 3
    eng.session_admit(requeued, tag=1, extra_row=1)
    while eng.session_active:
        out.update(eng.session_step())
    eng.end_session()
    assert [out[0].tokens, out[1].tokens] == want


def test_cli_serves_vlm_with_stub_patches():
    """``--arch phi-3-vision-4.2b`` serves with the reference's stub
    patches (zeros), dense and paged, the same tokens."""
    lines = {}
    for layout in ("dense", "paged"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                            "--kv-layout", layout, "--max-new", "4"])
        lines[layout] = [ln.split("tokens=")[1] for ln in
                         buf.getvalue().splitlines()
                         if ln.startswith("[serve] rid=")]
    assert len(lines["dense"]) == 2 and lines["dense"] == lines["paged"]
