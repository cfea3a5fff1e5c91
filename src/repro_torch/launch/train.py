"""Training launcher of the port, on the card by default.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
      --steps 50 --batch 8 --seq 1024 --ckpt-dir build/ckpt

The flags are those of ``repro.launch.train``, plus ``--device`` (default
``cuda``; ``--device cpu --smoke`` trains the smoke config on the plain
PyTorch path).  Weights are seeded random (seed 0, as in the reference),
the data synthetic or a flat token file on local disk (``--data PATH``,
uint16 tokens), drawn or shuffled from ``--seed``; with
``--ckpt-dir`` the run resumes from the latest checkpoint there.  The port
trains every arch, with AdamW in fp32 (``--opt adamw``) or in 8 bits
(``--opt adamw8bit``), on one device: a mesh other than 1x1, ``--fsdp`` and
``--sp`` raise (distributed training, ROADMAP section 1 item 4).
"""
from __future__ import annotations

import argparse

from ..configs import get_config, list_archs, smoke_config
from ..data import MMapTokens, SyntheticTokens
from ..models import build_model
from ..optim import AdamW, AdamW8bit, warmup_cosine
from ..train import TrainConfig, Trainer

_NEXT = "not ported yet (ROADMAP section 1 item 4)"


def _refuse(args) -> None:
    """Raise on the distributed flags, which the reference's launcher takes
    and the port does not."""
    if args.mesh != "1x1":
        raise NotImplementedError(f"--mesh {args.mesh}: distributed "
                                  f"training is {_NEXT}; use 1x1")
    for flag in ("fsdp", "sp"):
        if getattr(args, flag):
            raise NotImplementedError(f"--{flag}: distributed training is "
                                      f"{_NEXT}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b", choices=list_archs())
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; cpu runs the plain "
                         "PyTorch path)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--mesh", default="1x1", help="DATAxMODEL (1x1 only)")
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--sp", action="store_true")
    ap.add_argument("--opt", default="adamw", choices=["adamw", "adamw8bit"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--data", default="synthetic",
                    help="'synthetic' or a path to a flat token file")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-step-time", type=float, default=None)
    args = ap.parse_args(argv)

    _refuse(args)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg)
    print(f"[train] {cfg.name}: {model.n_params/1e6:.1f}M params")
    opt_cls = {"adamw": AdamW, "adamw8bit": AdamW8bit}[args.opt]
    opt = opt_cls(lr=warmup_cosine(args.lr, args.warmup, args.steps))
    if args.data == "synthetic":
        data = SyntheticTokens(cfg, args.batch, args.seq, seed=args.seed)
    else:
        data = MMapTokens(args.data, cfg, args.batch, args.seq,
                          seed=args.seed)
    tc = TrainConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                     ckpt_every=args.ckpt_every,
                     max_step_time=args.max_step_time)
    trainer = Trainer(model, opt, data, tc, device=args.device)
    _, log = trainer.run()
    print(f"[train] done: {log[-1]}")
    return log


if __name__ == "__main__":
    main()
