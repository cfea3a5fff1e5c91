"""Serving launcher of the port: generation through ``ServeEngine`` on the
card by default.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
      --prompts "1 2 3" "4 5" --max-new 16

The flags are those of ``repro.launch.serve``: ``--mode`` picks the
scheduler (continuous / lockstep), ``--kv-layout`` the cache layout (dense,
the default, or paged), ``--bucket`` the dense prefill bucketing and
``--temperature`` sampled decoding (JAX's threefry streams under the
reference's default key, seed 0; see ``repro_torch.serving.sampling``).  ``--device``
(default ``cuda``) picks the device; ``--device cpu --smoke`` runs the
plain PyTorch path at the smoke size.  Weights are seeded random
(``--seed``).  The flags of parts not ported yet — ``--replicas > 1``,
``--driver threaded`` and ``--attribution`` — stop with "not yet ported".
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from .. import resolve_device
from ..configs import get_config, list_archs, smoke_config
from ..models import build_model
from ..serving import POLICIES, Request, ServeEngine, Tracer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b", choices=list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; cpu runs the plain "
                         "PyTorch path)")
    ap.add_argument("--prompts", nargs="+", default=["1 2 3", "7 8"],
                    help="space-separated token ids per prompt")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--mode", default="auto",
                    choices=["auto", "continuous", "lockstep"])
    ap.add_argument("--kv-layout", default="dense",
                    choices=["dense", "paged"])
    ap.add_argument("--admission", default="reserve",
                    choices=["reserve", "overcommit"],
                    help="paged admission: worst-case reservation vs "
                         "first-chunk overcommit")
    ap.add_argument("--block-size", type=int, default=16,
                    help="KV positions per pool block")
    ap.add_argument("--n-blocks", type=int, default=None,
                    help="pool size (default: max_batch * cache_len "
                         "positions)")
    ap.add_argument("--bucket", default=None,
                    help="dense prefill length bucketing: 'pow2' or an "
                         "integer pad-to-multiple (default: exact lengths)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="admit shared prompt prefixes by referencing "
                         "resident pool blocks (refcounted, "
                         "copy-on-write)")
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--router", default="round_robin")
    ap.add_argument("--driver", default="sequential",
                    choices=["sequential", "threaded"])
    ap.add_argument("--policy", default="fifo", choices=list(POLICIES))
    ap.add_argument("--slo-ttft", type=float, default=None, metavar="MS")
    ap.add_argument("--slo-tpot", type=float, default=None, metavar="MS")
    ap.add_argument("--stream", action="store_true",
                    help="print tokens as they are sampled")
    ap.add_argument("--hysteresis", type=int, default=4)
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="write a Chrome-trace-event JSON of the run")
    ap.add_argument("--metrics", nargs="?", const=True, default=None,
                    metavar="OUT.json",
                    help="print the metrics-registry summary; with a file "
                         "argument, also write stats + snapshot as JSON")
    ap.add_argument("--attribution", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    not_ported = [
        ("--replicas > 1", args.replicas > 1),
        ("--driver threaded", args.driver != "sequential"),
        ("--attribution", args.attribution),
    ]
    for flag, asked in not_ported:
        if asked:
            ap.error(f"{flag}: not yet ported to repro_torch")
    if args.stream and args.mode == "lockstep":
        ap.error("--stream needs the continuous scheduler (tokens only "
                 "exist one group at a time under lockstep)")
    bucket = args.bucket
    if bucket is not None and bucket != "pow2":
        if not bucket.isdigit() or int(bucket) < 1:
            ap.error(f"--bucket {bucket}: expected 'pow2' or a positive "
                     "integer")
        bucket = int(bucket)

    device = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg)
    params = model.init(args.seed, device=device)
    tracer = Tracer() if (args.trace or args.metrics) else None
    eng = ServeEngine(model, params, max_batch=args.max_batch,
                      cache_len=args.cache_len, mode=args.mode,
                      kv_layout=args.kv_layout, bucket=bucket,
                      block_size=args.block_size,
                      n_blocks=args.n_blocks, admission=args.admission,
                      prefix_cache=args.prefix_cache, policy=args.policy,
                      tracer=tracer)
    reqs = [Request([int(t) % cfg.vocab_size for t in p.split()],
                    args.max_new, args.temperature, rid=i,
                    slo_ttft_ms=args.slo_ttft, slo_tpot_ms=args.slo_tpot)
            for i, p in enumerate(args.prompts)]
    if args.stream:
        streamed: dict[int, list[int]] = {}
        for ev in eng.stream(reqs):
            streamed.setdefault(ev.rid, []).append(ev.token)
            print(f"[stream] rid={ev.rid} i={ev.index} token={ev.token}"
                  f"{' (final)' if ev.final else ''}")
        for rid in sorted(streamed):
            print(f"[serve] rid={rid} tokens={streamed[rid]}")
    else:
        for r in eng.generate(reqs):
            print(f"[serve] rid={r.rid} ttft={r.prefill_ms:.1f}ms "
                  f"decode={r.decode_ms_per_tok:.1f}ms/tok "
                  f"tokens={r.tokens}")
    s = eng.last_stats
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else str(device))
    extra = (f" block_util_peak={s.block_util_peak:.2f}"
             f" preempted={s.preempted} requeued={s.requeued}"
             if args.kv_layout == "paged" else "")
    if args.prefix_cache:
        extra += (f" prefix_hits={s.prefix_hits}"
                  f" prefix_reused={s.prefix_tokens_reused}")
    if args.slo_ttft is not None or args.slo_tpot is not None:
        extra += (f" policy={s.sched_policy}"
                  f" slo_attainment={s.slo_attainment:.2f}"
                  f" (ttft {s.slo_ttft_attained}/{s.slo_ttft_total}"
                  f" tpot {s.slo_tpot_attained}/{s.slo_tpot_total})")
    print(f"[serve] device={where} mode={s.mode} kv={s.kv_layout} "
          f"tokens/s={s.tokens_per_s:.1f} "
          f"generated={s.generated_tokens} steps={s.decode_steps} "
          f"occupancy={s.occupancy:.2f} ttft_mean={s.ttft_ms_mean:.1f}ms "
          f"prefill_compiles={s.prefill_compiles}{extra}")
    if args.metrics:
        print(f"[metrics] ttft_ms p50={s.ttft_ms_p50:.1f} "
              f"p90={s.ttft_ms_p90:.1f} p99={s.ttft_ms_p99:.1f} "
              f"mean={s.ttft_ms_mean:.1f}")
        print(f"[metrics] tpot_ms p50={s.tpot_ms_p50:.2f} "
              f"p90={s.tpot_ms_p90:.2f} p99={s.tpot_ms_p99:.2f} "
              f"mean={s.tpot_ms_mean:.2f}")
        print(f"[metrics] queue_age_ms mean={s.queue_age_ms_mean:.1f} "
              f"p99={s.queue_age_ms_p99:.1f}")
        for name, val in sorted(eng.last_metrics.snapshot().items()):
            print(f"[metrics] {name}={val}")
        if isinstance(args.metrics, str):
            with open(args.metrics, "w") as f:
                json.dump({"bench": "repro_torch.launch.serve",
                           "device": where,
                           "stats": dataclasses.asdict(s),
                           "metrics": eng.last_metrics.snapshot()},
                          f, indent=2, sort_keys=True, default=str)
            print(f"[metrics] wrote {args.metrics}")
    if args.trace:
        n = tracer.export(args.trace)
        print(f"[trace] wrote {n} events to {args.trace}")


if __name__ == "__main__":
    main()
