"""Training runtime on one device, the port's counterpart of
``repro/train/trainer.py``: the train step (gradients through
``Model.loss``, microbatch accumulation, the global-norm clip, AdamW in
fp32 or 8 bits (``opt: AdamW`` takes its subclass ``AdamW8bit``); K steps
a call as a loop), the loop with checkpoints and auto-resume, and the
straggler watchdog.  The reference's mesh and sharding policy are
distributed's (not ported).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from .. import resolve_device
from ..data.pipeline import to_device
from ..models.model import Model
from ..optim import AdamW, clip_by_global_norm
from ..tree import tree_leaves, tree_map


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    steps_per_dispatch: int = 1       # optimizer steps a step_fn call
    grad_clip: float = 1.0
    ckpt_dir: str | None = None
    ckpt_every: int = 200
    ckpt_async: bool = True
    log_every: int = 10
    straggler_factor: float = 2.0     # step > factor x median -> straggler
    max_step_time: float | None = None  # abort-and-resume watchdog


def param_dtypes(model: Model):
    """The compute dtype of every parameter: its template's own, else bf16
    (``Model.init``'s default), as the reference's ``param_template``."""
    def walk(t):
        return {k: walk(v) if isinstance(v, dict)
                else (v.dtype or torch.bfloat16) for k, v in t.items()}
    return walk(model.templates)


def _step_body(model: Model, opt: AdamW, grad_clip: float, remat: bool,
               microbatches: int = 1):
    like = param_dtypes(model)

    def grads_of(params, batch):
        for p in tree_leaves(params):
            p.requires_grad_(True)
        loss, metrics = model.loss(params, batch, remat=remat)
        loss.backward()
        grads = tree_map(lambda p: p.grad, params)
        return grads, {k: v.detach() for k, v in metrics.items()}

    def step_fn(state, batch):
        params = opt.params_from_state(state, like)
        if microbatches == 1:
            grads, metrics = grads_of(params, batch)
        else:
            # gradient accumulation: activation-scale temporaries shrink by
            # the microbatch factor at the cost of one fp32 gradient tree
            n = next(iter(batch.values())).shape[0] // microbatches
            grads, ms = None, []
            for i in range(microbatches):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                g, m = grads_of(params, mb)
                for p in tree_leaves(params):
                    p.grad = None
                grads = (tree_map(lambda x: x.float(), g) if grads is None
                         else tree_map(lambda a, b: a + b.float(), grads, g))
                ms.append(m)
            grads = tree_map(lambda g: g / microbatches, grads)
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}
        grads, gnorm = clip_by_global_norm(grads, grad_clip)
        state = opt.update(grads, state)
        return state, dict(metrics, grad_norm=gnorm)

    return step_fn


def make_train_step(model: Model, opt: AdamW, *, grad_clip: float = 1.0,
                    remat: bool = True, steps_per_dispatch: int = 1,
                    microbatches: int = 1):
    """``(state, batch) -> (state, metrics)``: one optimizer step, the state
    updated in place.  With ``steps_per_dispatch`` K > 1, ``batch`` holds K
    batches stacked on a leading axis and one call runs K steps in a loop,
    returning the last step's metrics.  ``microbatches`` splits each batch
    along its rows and accumulates the gradients in fp32."""
    body = _step_body(model, opt, grad_clip, remat, microbatches)
    if steps_per_dispatch == 1:
        return body

    def fn(state, batches):
        metrics = None
        for k in range(steps_per_dispatch):
            state, metrics = body(state, {n: v[k] for n, v in batches.items()})
        return state, metrics
    return fn


class Watchdog:
    """Step-time anomaly detector: logs stragglers, optionally aborts."""

    def __init__(self, factor: float = 2.0,
                 max_step_time: float | None = None):
        self.times: list[float] = []
        self.factor = factor
        self.max_step_time = max_step_time
        self.stragglers = 0

    def observe(self, dt: float) -> str | None:
        self.times.append(dt)
        med = float(np.median(self.times[-50:]))
        if self.max_step_time and dt > self.max_step_time:
            return "abort"
        if len(self.times) > 5 and dt > self.factor * med:
            self.stragglers += 1
            return "straggler"
        return None


class Trainer:
    """The training loop with auto-resume on one device (``cuda`` unless
    ``device`` says otherwise).  ``data(step) -> host batch`` (numpy)."""

    def __init__(self, model: Model, opt: AdamW,
                 data: Callable[[int], dict], tc: TrainConfig, *,
                 device=None, log: Callable[[str], None] = print):
        self.model, self.opt, self.data, self.tc, self.log = \
            model, opt, data, tc, log
        self.device = resolve_device(device)
        self.step_fn = make_train_step(model, opt, grad_clip=tc.grad_clip)
        self.watchdog = Watchdog(tc.straggler_factor, tc.max_step_time)
        self.metrics_log: list[dict] = []

    def init_state(self, seed: int = 0) -> dict:
        """Seeded random parameters (``Model.init``) as the optimizer's
        state, on the trainer's device."""
        return self.opt.init(self.model.init(seed, device=self.device))

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, state=None, start_step: int = 0):
        """Train to ``tc.steps``: from ``state``, else from the latest
        checkpoint under ``tc.ckpt_dir``, else from ``init_state()``.
        Saves every ``ckpt_every`` steps (before the last) and at the end.
        Returns (state, the per-step metrics rows)."""
        from . import checkpoint as ckpt
        tc = self.tc
        if state is None:
            if tc.ckpt_dir and ckpt.latest_step(tc.ckpt_dir) is not None:
                start_step, state = ckpt.restore(tc.ckpt_dir,
                                                 device=self.device)
                self.log(f"[trainer] resumed from step {start_step}")
            else:
                state = self.init_state()
        step = start_step
        pending_save = None
        while step < tc.steps:
            batch = to_device(self.data(step), self.device)
            self._sync()
            t0 = time.perf_counter()
            state, metrics = self.step_fn(state, batch)
            self._sync()
            dt = time.perf_counter() - t0
            verdict = self.watchdog.observe(dt)
            if verdict == "straggler":
                self.log(f"[watchdog] straggler step {step}: {dt:.3f}s")
            elif verdict == "abort":
                self.log(f"[watchdog] step {step} exceeded max_step_time; "
                         "checkpoint + abort for external restart")
                if tc.ckpt_dir:
                    ckpt.save(tc.ckpt_dir, step, state)
                raise TimeoutError(f"step {step} took {dt:.3f}s")
            step += 1
            row = {"step": step, "time_s": dt,
                   **{k: float(v) for k, v in metrics.items()}}
            self.metrics_log.append(row)
            if step % tc.log_every == 0 or step == tc.steps:
                self.log(f"[train] step {step} loss {row['loss']:.4f} "
                         f"acc {row.get('accuracy', 0):.3f} {dt*1e3:.0f}ms")
            if tc.ckpt_dir and step % tc.ckpt_every == 0 and step < tc.steps:
                if pending_save is not None:
                    pending_save.join()
                pending_save = ckpt.save(tc.ckpt_dir, step, state,
                                         async_=tc.ckpt_async)
        if pending_save is not None:
            pending_save.join()
        if tc.ckpt_dir:
            ckpt.save(tc.ckpt_dir, step, state)
        return state, self.metrics_log
