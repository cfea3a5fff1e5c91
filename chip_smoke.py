#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root with one card visible:

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. device   - the card's name and power limit; no CUDA device -> exit 1;
2. build    - ``nvcc`` builds every kernel source, one process each, all
              at once, with ``-Xptxas -v`` registers / shared memory / spills;
3. parity   - each kernel against its plain PyTorch version on the same
              inputs.  Paged: the paged path's shapes (bf16, Hq 16, Hkv 8,
              D 128, bs 16, B 8, M 64), NaN planted wherever neither may
              read.  Flash: bf16 and fp32, g 2 and 8, causal, non-causal and
              window 64, Sq = Sk in {7, 128, 900}, Sq < Sk, and Sq > Sk
              causal (fully masked rows: the mean of V);
4. timing   - kernel, plain version, one PyTorch library call, and the
              least time the card could take (the bound), in ms;
5. checks   - the whole model on the card against the plain CPU path: a
              narrow fp32 copy of qwen3-0.6b, and the full-width model;
6. serve    - the paged path: ``ServeEngine(kv_layout="paged")`` serving 8
              greedy requests with the full qwen3-0.6b config on seeded
              random bf16 weights, with every kernel's launch count read
              just after, the pool drained, and a repeat run token-identical;
7. dense    - the dense path, the engine's default: the same 8 requests
              served continuous, continuous with ``bucket="pow2"`` and
              lockstep, each twice (token-identical), 28 flash launches per
              prefill and no paged launch; first-token logits of dense vs
              paged within 4% of their scale; then the trace with half its
              rows sampled at temperature 0.7 (repeat-identical, greedy rows
              unchanged);
8. profile  - wall and device time of one full-width decode step and one
              prefill chunk, with the top kernels (torch.profiler).

The last lines are the card's ``nvidia-smi`` name and power limit, one
``{"kernels": [...]}`` JSON line, and the result line
``{"ok": true, "device": {...}}``.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
TOL = 1e-2     # bf16 outputs rounded from fp32: one ulp at |x|~1 is 7.8e-3
TOL_FP32 = 1e-4    # fp32 outputs, other summation orders
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor-core peak
B, HQ, HKV, D, BS, M = 8, 16, 8, 128, 16, 64
DECODE_KV_LENS = [1, 15, 16, 17, 1023, 1024, 500, M * BS + 16]   # last: idle
IDLE_ROW = 7
PREFILL_CHUNKS = [0, 1, 63]
SERVE_PROMPT_LENS = [7, 16, 17, 64, 200, 333, 511, 900]
SERVE_MAX_NEW = 32
SAMPLED_TEMPERATURE = 0.7
FLASH_S = 900          # timing: B = 1, Hq 16, Hkv 8, D 128, causal
REPLACES = {
    "paged_decode_attention": "src/repro/kernels/paged_attention.py:103",
    "paged_prefill_attention": "src/repro/kernels/paged_attention.py:224",
    "flash_attention": "src/repro/kernels/attention.py:73",
}
SOURCES = {
    "paged_decode_attention": "src/repro_torch/kernels/csrc/paged_attention.cu",
    "paged_prefill_attention":
        "src/repro_torch/kernels/csrc/paged_attention.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
}


class SmokeFailure(Exception):
    pass


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, args_list, iters: int) -> float:
    """Mean ms per call over ``iters`` calls, rotating through
    ``args_list`` (input copies that together exceed the 50 MB L2, as the
    28 layers' pools do on the main path), after a warm-up."""
    for a in args_list:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*args_list[i % len(args_list)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Phases.
# ---------------------------------------------------------------------------

def phase_build(build):
    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"build: {len(libs)} source(s) in {time.perf_counter() - t0:.1f} s")
    for source in libs:
        for line in build.ptxas_report(source).splitlines():
            if any(w in line for w in ("Compiling entry", "registers",
                                       "spill", "smem")):
                log(f"ptxas {source}: {line.strip()}")


def _pools(torch, gen, dev, n_blocks):
    shape = (n_blocks, HKV, BS, D)
    kp = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    vp = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    return kp, vp


def decode_case(torch, gen, dev):
    """The decode parity batch: kv_len in {1, 15, 16, 17, 1023, 1024, 500}
    on shuffled tables, plus an idle row (null table, kv_len > M * bs).
    Returns (clean inputs, inputs with NaN wherever the kernel must not
    read)."""
    n_blocks = B * M + 1
    kp, vp = _pools(torch, gen, dev, n_blocks)
    perm = torch.randperm(n_blocks - 1, generator=gen, device=dev) + 1
    bt = perm.reshape(B, M).to(torch.int32)
    bt[IDLE_ROW] = 0
    kv = torch.tensor(DECODE_KV_LENS, dtype=torch.int32, device=dev)
    q = torch.randn((B, HQ, 1, D), generator=gen,
                    device=dev).to(torch.bfloat16)
    kpn, vpn = kp.clone(), vp.clone()
    for b, n in enumerate(DECODE_KV_LENS):
        if b == IDLE_ROW:
            continue            # reads its whole (null) table: all valid
        for j in range(M):
            lo = max(n - j * BS, 0)
            if lo < BS:
                kpn[bt[b, j], :, lo:] = float("nan")
                vpn[bt[b, j], :, lo:] = float("nan")
    return (q, kp, vp, bt, kv), (q, kpn, vpn, bt, kv)


def prefill_case(torch, gen, dev, chunk):
    """One prefill chunk (B = 1, Sq = bs) at ``chunk`` on a shuffled table,
    NaN planted in every block past the causal frontier."""
    kp, vp = _pools(torch, gen, dev, M + 1)
    bt = (torch.randperm(M, generator=gen, device=dev) + 1).to(
        torch.int32)[None]
    qs = torch.tensor([chunk * BS], dtype=torch.int32, device=dev)
    q = torch.randn((1, HQ, BS, D), generator=gen,
                    device=dev).to(torch.bfloat16)
    kpn, vpn = kp.clone(), vp.clone()
    past = bt[0, chunk + 1:].long()
    kpn[past] = float("nan")
    vpn[past] = float("nan")
    return (q, kp, vp, bt, qs), (q, kpn, vpn, bt, qs)


def _compare(torch, name, got, want, tol=TOL):
    err = (got.float() - want.float()).abs().max().item()
    ok = bool(torch.isfinite(got).all()) and torch.allclose(
        got.float(), want.float(), atol=tol, rtol=tol)
    log(f"parity {name}: max_abs_err={err:.3e} (atol=rtol={tol}) "
        f"{'ok' if ok else 'FAIL'}")
    require(ok, f"{name}: kernel disagrees with its plain version")
    return err


def phase_parity(torch, pa, dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    errs = {}
    _, dirty = decode_case(torch, gen, dev)
    got = pa.paged_decode_attention_cuda(*dirty)
    want = pa.paged_decode_attention_plain(*dirty)
    torch.cuda.synchronize()
    errs["paged_decode_attention"] = _compare(
        torch, f"decode kv_len={DECODE_KV_LENS}", got, want)
    worst = 0.0
    for chunk in PREFILL_CHUNKS:
        _, dirty = prefill_case(torch, gen, dev, chunk)
        got = pa.paged_prefill_attention_cuda(*dirty)
        want = pa.paged_prefill_attention_plain(*dirty)
        torch.cuda.synchronize()
        worst = max(worst, _compare(torch, f"prefill chunk={chunk}", got,
                                    want))
    errs["paged_prefill_attention"] = worst
    return errs


def flash_cases():
    """(g, sq, sk, causal, window) of the flash parity phase."""
    cases = []
    for g in (2, 8):
        cases += [(g, s, s, True, None) for s in (7, 128, 900)]
        cases += [(g, s, s, False, None) for s in (128, 900)]
        cases += [(g, 900, 900, True, 64), (g, 100, 900, True, None),
                  (g, 300, 200, True, None)]
    return cases


def _flash_inputs(torch, gen, dev, dtype, g, sq, sk, b=2, hq=HQ):
    hkv = hq // g
    return [torch.randn(shape, generator=gen, device=dev).to(dtype)
            for shape in ((b, hq, sq, D), (b, hkv, sk, D), (b, hkv, sk, D))]


def phase_flash_parity(torch, fa, dev):
    """The flash kernel against its plain version on every case of
    ``flash_cases`` in bf16 and fp32.  Returns the worst bf16 error (the
    main path's dtype)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    worst = {}
    for dtype, tol in ((torch.bfloat16, TOL), (torch.float32, TOL_FP32)):
        name = str(dtype).split(".")[-1]
        for g, sq, sk, causal, window in flash_cases():
            q, k, v = _flash_inputs(torch, gen, dev, dtype, g, sq, sk)
            got = fa.flash_attention_cuda(q, k, v, causal=causal,
                                          window=window)
            want = fa.flash_attention_plain(q, k, v, causal=causal,
                                            window=window)
            torch.cuda.synchronize()
            err = _compare(torch, f"flash {name} g={g} Sq={sq} Sk={sk} "
                           f"causal={causal} window={window}", got, want, tol)
            worst[name] = max(worst.get(name, 0.0), err)
            if causal and sq > sk:      # rows 0 .. sq-sk-1 see no key
                mean_v = v.float().mean(dim=2).repeat_interleave(g, dim=1)
                empty = got[:, :, :sq - sk].float()
                require(torch.allclose(empty, mean_v[:, :, None].expand_as(
                    empty), atol=tol, rtol=tol),
                    "flash: a fully masked row must be the mean of V")
    log(f"parity flash worst max_abs_err: {worst}")
    return worst["bfloat16"]


def _sdpa_inputs(torch, pa, q, kp, vp, bt, lens, causal):
    """Dense K/V gathered ahead of time (excluded from the library time)
    and the boolean mask of the same function."""
    g = HQ // HKV
    k = pa.gather_pool(kp, bt).repeat_interleave(g, dim=1)
    v = pa.gather_pool(vp, bt).repeat_interleave(g, dim=1)
    kpos = torch.arange(k.shape[2], device=q.device)
    if causal:
        qpos = lens[:, None].long() + torch.arange(q.shape[2],
                                                   device=q.device)
        mask = (kpos[None, None, :] <= qpos[:, :, None])[:, None]
    else:
        mask = (kpos[None, :] < lens[:, None].long())[:, None, None]
    return q, k, v, mask


def phase_timing(torch, pa, fa, dev):
    """kernel / plain / library / bound, in ms, for each kernel."""
    import torch.nn.functional as F
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    copies = 4      # 4 pool sets > 50 MB L2: every launch starts cold
    out = {}

    dec = [decode_case(torch, gen, dev)[0] for _ in range(copies)]
    kv_blocks = sum(min(math.ceil(n / BS), M) for n in DECODE_KV_LENS)
    kv_pos = sum(min(n, M * BS) for n in DECODE_KV_LENS)
    q_bytes = B * HQ * D * 2
    dbytes = kv_blocks * BS * HKV * D * 2 * 2 + 2 * q_bytes \
        + kv_blocks * 4 + B * 4
    dflops = 4 * HQ * D * kv_pos
    sdpa = [_sdpa_inputs(torch, pa, *a, causal=False) for a in dec]
    out["paged_decode_attention"] = dict(
        zip(("ms", "plain_ms", "library_ms"), (
            time_ms(torch, pa.paged_decode_attention_cuda, dec, 200),
            time_ms(torch, pa.paged_decode_attention_plain, dec, 20),
            time_ms(torch, lambda q, k, v, m: F.scaled_dot_product_attention(
                q, k, v, attn_mask=m), sdpa, 100))),
        **dict(zip(("bound_ms", "bound_by"), bound(dbytes, dflops))))

    chunk = PREFILL_CHUNKS[-1]
    pre = [prefill_case(torch, gen, dev, chunk)[0] for _ in range(copies)]
    q_start = chunk * BS
    pbytes = (chunk + 1) * BS * HKV * D * 2 * 2 + 2 * HQ * BS * D * 2 \
        + (chunk + 1) * 4 + 4
    pflops = sum(4 * HQ * D * (q_start + i + 1) for i in range(BS))
    sdpa = [_sdpa_inputs(torch, pa, *a, causal=True) for a in pre]
    out["paged_prefill_attention"] = dict(
        zip(("ms", "plain_ms", "library_ms"), (
            time_ms(torch, pa.paged_prefill_attention_cuda, pre, 200),
            time_ms(torch, pa.paged_prefill_attention_plain, pre, 20),
            time_ms(torch, lambda q, k, v, m: F.scaled_dot_product_attention(
                q, k, v, attn_mask=m), sdpa, 100))),
        **dict(zip(("bound_ms", "bound_by"), bound(pbytes, pflops))))
    # flash: a 900-token causal prefill, the dense path's longest prompt
    fgen = torch.Generator(device=dev)
    fgen.manual_seed(5)
    fl = [_flash_inputs(torch, fgen, dev, torch.bfloat16, HQ // HKV,
                        FLASH_S, FLASH_S, b=1) for _ in range(6)]
    fbytes = sum(x.numel() for x in fl[0]) * 2 + fl[0][0].numel() * 2
    fflops = 4 * HQ * D * FLASH_S * (FLASH_S + 1) // 2
    out["flash_attention"] = dict(
        zip(("ms", "plain_ms", "library_ms"), (
            time_ms(torch, fa.flash_attention_cuda, fl, 50),
            time_ms(torch, fa.flash_attention_plain, fl, 10),
            time_ms(torch, lambda q, k, v: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), fl, 50))),
        **dict(zip(("bound_ms", "bound_by"), bound(fbytes, fflops))))
    for name, t in out.items():
        shape = {"paged_decode_attention": "B=8 kv_len="
                 + str(DECODE_KV_LENS),
                 "paged_prefill_attention": f"B=1 Sq=16 chunk={chunk}",
                 "flash_attention": f"B=1 Hq={HQ} Hkv={HKV} D={D} "
                                    f"S={FLASH_S} causal bf16"}[name]
        log(f"timing {name} ({shape}): kernel_ms={t['ms']:.4f} "
            f"plain_ms={t['plain_ms']:.4f} library_ms={t['library_ms']:.4f}"
            f" (SDPA; paged: on pre-gathered dense K/V, gather excluded) "
            f"bound_ms={t['bound_ms']:.4f} ({t['bound_by']})")
    return out


def _run_path(torch, model, params, pc_kw, prompt, n_decode, dev):
    """Chunked paged prefill of ``prompt`` into slot 0 of a 2-slot cache,
    then ``n_decode`` greedy steps; returns every logits row."""
    bs = pc_kw["block_size"]
    pc = model.paged_cache_init(batch=2, device=dev,
                                dtype=model.cache_dtype(params), **pc_kw)
    n_chunks = -(-len(prompt) // bs)
    pc["bt"][0, :n_chunks + 1] = torch.arange(
        1, n_chunks + 2, dtype=torch.int32, device=dev)
    rows = []
    for c in range(n_chunks):
        toks = torch.zeros((1, bs), dtype=torch.int32)
        seg = prompt[c * bs:(c + 1) * bs]
        toks[0, :len(seg)] = torch.tensor(seg, dtype=torch.int32)
        logits, pc = model.prefill_paged(params, pc, {"tokens": toks.to(dev)},
                                         0, c, len(prompt))
        rows.append(logits.float().cpu())
    tok = int(rows[-1].argmax())
    for _ in range(n_decode):
        feed = torch.tensor([[tok], [0]], dtype=torch.int32, device=dev)
        logits, pc = model.decode_paged(params, pc, feed)
        rows.append(logits[:1].float().cpu())
        tok = int(rows[-1].argmax())
    return torch.cat(rows)


def phase_checks(torch, cfgs, build_model, dev):
    """The model on the card (kernels) against the plain path on the CPU,
    on the same weights: a narrow fp32 copy of qwen3-0.6b at fp32
    tolerance, and the full-width bf16 model against fp32 on the CPU."""
    cfg = cfgs.get_config("qwen3-0.6b")
    narrow = dataclasses.replace(cfg, n_layers=2, d_model=128, d_ff=256,
                                 vocab_size=1000)
    prompt = [int(t) for t in torch.randint(
        0, 1000, (37,), generator=torch.Generator().manual_seed(2))]
    pc_kw = dict(n_blocks=8, block_size=BS, max_blocks=4)
    for cfg_i, dtype, tol in ((narrow, torch.float32, 1e-3),
                              (cfg, torch.bfloat16, None)):
        model = build_model(cfg_i)
        params = model.init(3, device=dev, dtype=dtype)

        def to_cpu(tree):
            return {k: to_cpu(v) if isinstance(v, dict) else v.float().cpu()
                    for k, v in tree.items()}
        cpu = to_cpu(params)
        toks = [t % cfg_i.vocab_size for t in prompt]
        got = _run_path(torch, model, params, pc_kw, toks, 3, dev)
        want = _run_path(torch, model, cpu, pc_kw, toks, 3, "cpu")
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        # bf16 on the card vs fp32 on the CPU: activations round to bf16
        # after every op (8 mantissa bits), so hold the logits to 4% of
        # their scale (about ten bf16 steps)
        atol = tol if tol is not None else 0.04 * scale
        ok = bool(torch.isfinite(got).all()) and err <= atol
        log(f"check {cfg_i.name} L={cfg_i.n_layers} d={cfg_i.d_model} "
            f"{str(dtype).split('.')[-1]}: card vs CPU logits "
            f"max_abs_err={err:.3e} (scale {scale:.3e}, atol {atol:.3e}) "
            f"{'ok' if ok else 'FAIL'}")
        require(ok, f"{cfg_i.name}: the card's logits disagree with the "
                    "plain CPU path")
        del params, cpu
        torch.cuda.empty_cache()


def serve_prompts(vocab):
    import numpy as np
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, n).tolist() for n in SERVE_PROMPT_LENS]


def reset_launches(kernel_modules):
    for mod in kernel_modules:
        mod.reset_launches()


def read_launches(kernel_modules):
    return {k: n for mod in kernel_modules for k, n in mod.LAUNCHES.items()}


def phase_serve(torch, cfgs, build_model, serving, kmods, dev, name):
    cfg = cfgs.get_config("qwen3-0.6b")
    model = build_model(cfg)
    params = model.init(0, device=dev)
    log(f"serve: {cfg.name} n_layers={cfg.n_layers} d_model={cfg.d_model} "
        f"heads={cfg.n_heads}/{cfg.n_kv_heads} vocab={cfg.vocab_size} "
        f"params={model.n_params} bf16 on {name}")
    prompts = serve_prompts(cfg.vocab_size)
    n_chunks = sum(math.ceil(n / BS) for n in SERVE_PROMPT_LENS)
    eng = serving.ServeEngine(model, params, kv_layout="paged", max_batch=8,
                              cache_len=1024, block_size=BS)
    runs = []
    for run in range(2):
        reqs = [serving.Request(p, SERVE_MAX_NEW, rid=i)
                for i, p in enumerate(prompts)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(kmods)
        t0 = time.perf_counter()
        results = eng.generate(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches(kmods)
        s = eng.last_stats
        toks = [r.tokens for r in results]
        for r in results:
            log(f"serve run {run} rid={r.rid} prompt_len="
                f"{SERVE_PROMPT_LENS[r.rid]} tokens={r.tokens}")
        log(f"serve run {run} on {name}: wall_s={wall:.3f} "
            f"tokens_per_s={s.tokens_per_s:.1f} "
            f"ttft_ms_mean={s.ttft_ms_mean:.1f} "
            f"tpot_ms_mean={s.tpot_ms_mean:.2f} "
            f"decode_steps={s.decode_steps} prefill_chunks={n_chunks} "
            f"launches={launches} "
            f"max_memory_allocated={torch.cuda.max_memory_allocated()}")
        require(all(len(t) == SERVE_MAX_NEW and
                    all(0 <= x < cfg.vocab_size for x in t) for t in toks),
                "every request must return max_new_tokens in-vocab tokens")
        require(launches["paged_decode_attention"]
                == cfg.n_layers * s.decode_steps > 0,
                f"decode kernel launches {launches} != "
                f"{cfg.n_layers} x {s.decode_steps} decode steps")
        require(launches["paged_prefill_attention"]
                == cfg.n_layers * n_chunks,
                f"prefill kernel launches {launches} != "
                f"{cfg.n_layers} x {n_chunks} chunks")
        require(launches["flash_attention"] == 0,
                f"the paged path launched the flash kernel: {launches}")
        require(eng.allocator.n_live == 0 and eng.allocator.n_reserved == 0,
                "the block pool did not drain")
        eng.allocator.check_integrity()
        log(f"serve run {run}: pool drained (n_live=0, integrity ok)")
        runs.append((toks, launches))
    require(runs[0][0] == runs[1][0], "a repeat run changed the tokens")
    log("serve: repeat run token-identical")
    return runs[0][1], model, params


def _dense_run(torch, serving, kmods, eng, reqs, label, name):
    """One generate on the card with the counts zeroed just before and read
    just after; returns (tokens, launches)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(kmods)
    t0 = time.perf_counter()
    results = eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(kmods)
    s = eng.last_stats
    toks = [r.tokens for r in results]
    log(f"dense {label} on {name}: wall_s={wall:.3f} "
        f"tokens_per_s={s.tokens_per_s:.1f} ttft_ms_mean={s.ttft_ms_mean:.1f}"
        f" tpot_ms_mean={s.tpot_ms_mean:.2f} decode_steps={s.decode_steps} "
        f"prefill_shapes={s.prefill_compiles} launches={launches} "
        f"max_memory_allocated={torch.cuda.max_memory_allocated()}")
    require(all(len(t) == r.max_new_tokens and
                all(0 <= x < eng.model.cfg.vocab_size for x in t)
                for t, r in zip(toks, reqs)),
            f"dense {label}: every request must return max_new_tokens "
            "in-vocab tokens")
    return toks, launches


def phase_dense(torch, serving, kmods, model, params, dev, name):
    """The dense path at full width: continuous, bucketed and lockstep
    serving of the serve trace, each twice; dense vs paged first-token
    logits; then the sampled trace.  Returns the flash launches of the
    default (continuous, unbucketed) run."""
    cfg = model.cfg
    prompts = serve_prompts(cfg.vocab_size)
    n = len(prompts)
    greedy = None
    main_launches = None
    for label, kw, prefills in (
            ("continuous", {}, n),
            ("continuous bucket=pow2", {"bucket": "pow2"}, n),
            ("lockstep", {"mode": "lockstep"}, -(-n // 8))):
        eng = serving.ServeEngine(model, params, max_batch=8, cache_len=1024,
                                  **kw)
        runs = []
        for run in range(2):
            reqs = [serving.Request(p, SERVE_MAX_NEW, rid=i)
                    for i, p in enumerate(prompts)]
            runs.append(_dense_run(torch, serving, kmods, eng, reqs,
                                   f"{label} run {run}", name))
            launches = runs[-1][1]
            require(launches["flash_attention"] == cfg.n_layers * prefills,
                    f"dense {label}: flash launches {launches} != "
                    f"{cfg.n_layers} x {prefills} prefills")
            require(launches["paged_decode_attention"] == 0
                    and launches["paged_prefill_attention"] == 0,
                    f"dense {label} launched a paged kernel: {launches}")
        require(runs[0][0] == runs[1][0],
                f"dense {label}: a repeat run changed the tokens")
        log(f"dense {label}: repeat run token-identical")
        if greedy is None:
            greedy, main_launches = runs[0]
        for rid, t in enumerate(runs[0][0]):
            log(f"dense {label} rid={rid} prompt_len={len(prompts[rid])} "
                f"tokens={t}")

    # dense vs paged first-token logits: other kernels, other summation
    # orders, bf16 activations -> 4% of the logits' scale (as phase_checks)
    pc_kw = dict(n_blocks=65, block_size=BS, max_blocks=64)
    for p in (prompts[0], prompts[4], prompts[-1]):
        dense = model.prefill(params, {"tokens": torch.tensor(
            [p], dtype=torch.int32, device=dev)}, cache_len=1024)[0]
        paged = _run_path(torch, model, params, pc_kw, p, 0, dev)[-1:]
        dense = dense.float().cpu()
        scale = paged.abs().max().item()
        err = (dense - paged).abs().max().item()
        ok = bool(torch.isfinite(dense).all()) and err <= 0.04 * scale
        log(f"dense vs paged first-token logits, prompt_len={len(p)}: "
            f"max_abs_err={err:.3e} (scale {scale:.3e}, atol "
            f"{0.04 * scale:.3e}) {'ok' if ok else 'FAIL'}")
        require(ok, "dense and paged first-token logits disagree")

    # sampled: odd rids at temperature 0.7, even rids greedy
    eng = serving.ServeEngine(model, params, max_batch=8, cache_len=1024)
    runs = []
    for run in range(2):
        reqs = [serving.Request(p, SERVE_MAX_NEW,
                                SAMPLED_TEMPERATURE if i % 2 else 0.0, rid=i)
                for i, p in enumerate(prompts)]
        runs.append(_dense_run(torch, serving, kmods, eng, reqs,
                               f"sampled run {run}", name)[0])
    require(runs[0] == runs[1], "sampled: a repeat run changed the tokens")
    require(all(runs[0][i] == greedy[i] for i in range(0, n, 2)),
            "sampled: a greedy row changed beside sampled rows")
    for rid, t in enumerate(runs[0]):
        log(f"dense sampled rid={rid} temperature="
            f"{SAMPLED_TEMPERATURE if rid % 2 else 0.0} tokens={t}")
    log("dense sampled: repeat run token-identical, greedy rows unchanged")
    from repro_torch.serving.engine import _sample_rows
    import numpy as np
    logits = torch.randn((8, cfg.vocab_size), device=dev) * 4
    temps = np.full(8, SAMPLED_TEMPERATURE, np.float32)
    ids = np.arange(8, dtype=np.int32)
    for _ in range(2):
        _sample_rows(logits, temps, (0, 0), ids, ids)
    t0 = time.perf_counter()
    for _ in range(10):
        _sample_rows(logits, temps, (0, 0), ids, ids)
    log(f"dense sampled: threefry sampling of 8 rows x {cfg.vocab_size} "
        f"logits, host wall ms per step (to tokens on the host): "
        f"{(time.perf_counter() - t0) / 10 * 1e3:.3f}")
    return main_launches


def _profile(torch, fn, n):
    """(device kernel ms per call, top kernels) of ``n`` calls of ``fn``
    under torch.profiler, or (None, []) if the trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return ((total if kernels else None),
            [(e.key[:60], e.self_device_time_total / 1e3 / n, e.count // n)
             for e in top])


def phase_profile(torch, model, params, dev):
    """Where a decode step and a prefill spend their time at full width,
    paged and dense: wall ms per call (host clock around synchronized
    calls), the device's kernel ms per call and busy share from
    torch.profiler, and the top kernels.  Decode: 8 slots at the serve
    trace's prompt lengths; paged prefill: one chunk at position 320
    (chunk 20); dense prefill: one 900-token prompt."""
    cfg = model.cfg
    pc = model.paged_cache_init(batch=B, n_blocks=B * M + 1, block_size=BS,
                                max_blocks=M, dtype=torch.bfloat16,
                                device=dev)
    pc["bt"].copy_(torch.arange(1, B * M + 1, dtype=torch.int32,
                                device=dev).reshape(B, M))
    lens = torch.tensor(SERVE_PROMPT_LENS, dtype=torch.int32, device=dev)
    feed = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    chunk = {"tokens": torch.zeros((1, BS), dtype=torch.int32, device=dev)}

    def decode():
        pc["pos"].copy_(lens)
        model.decode_paged(params, pc, feed)

    def prefill():
        model.prefill_paged(params, pc, chunk, 0, 20, 21 * BS)

    prompt = {"tokens": torch.zeros((1, FLASH_S), dtype=torch.int32,
                                    device=dev)}
    dc = model.cache_expand(model.prefill(params, prompt,
                                          cache_len=1024)[1], B)

    def dense_decode():
        dc["pos"] = lens.clone()
        model.decode(params, dc, feed)

    def dense_prefill():
        model.prefill(params, prompt, cache_len=1024)

    for name, fn in (("paged decode step (B=8)", decode),
                     ("paged prefill chunk 20 (B=1, 16 tokens)", prefill),
                     ("dense decode step (B=8)", dense_decode),
                     (f"dense prefill (B=1, {FLASH_S} tokens)",
                      dense_prefill)):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 10 * 1e3
        dev_ms, top = _profile(torch, fn, 3)
        busy = (f"device_kernel_ms={dev_ms:.3f} busy_share={dev_ms / wall:.3f}"
                if dev_ms is not None else "device time not captured")
        log(f"profile {cfg.name} {name}: wall_ms={wall:.3f} {busy}")
        for kname, ms, count in top:
            log(f"profile   {ms:8.4f} ms x{count} {kname}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: {src}/repro_torch not found (run from a "
              "checkout of the repository)", file=sys.stderr)
        return 1
    sys.path.insert(0, src)
    from repro_torch import configs as cfgs
    from repro_torch import resolve_device, serving
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import build_model

    t_start = time.perf_counter()
    try:
        smi = nvidia_smi()
        dev = resolve_device("cuda")
        name = torch.cuda.get_device_name(0)
        log(f"device: {name} | nvidia-smi: {smi} | torch {torch.__version__}"
            f" cuda {torch.version.cuda} | count {torch.cuda.device_count()}")
        kmods = (pa, fa)
        phase_build(build)
        errs = phase_parity(torch, pa, dev)
        errs["flash_attention"] = phase_flash_parity(torch, fa, dev)
        times = phase_timing(torch, pa, fa, dev)
        phase_checks(torch, cfgs, build_model, dev)
        launches, model, params = phase_serve(torch, cfgs, build_model,
                                              serving, kmods, dev, name)
        launches["flash_attention"] = phase_dense(
            torch, serving, kmods, model, params, dev, name)[
                "flash_attention"]
        phase_profile(torch, model, params, dev)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(f"total {time.perf_counter() - t_start:.1f} s")
    kernels = [dict(name=k, route="cuda", source=SOURCES[k],
                    replaces=REPLACES[k], launches=launches[k],
                    max_abs_err=errs[k], ms=times[k]["ms"],
                    plain_ms=times[k]["plain_ms"],
                    bound_ms=times[k]["bound_ms"],
                    bound_by=times[k]["bound_by"],
                    library_ms=times[k]["library_ms"])
               for k in REPLACES]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
