"""Closed-loop training: the port's train step, one after the other, on
minibatches gathered on the device from a pooled set resident there.

Set-up builds one train state (model, optimizer, schedule) from the
benchmark's weights, drives it through its first ``check_steps`` steps by
the window's own call and feed, and hands that same state to the window.
The reference follows those first steps from the same weights, batches
and dropout generator; ``correct`` compares each step's loss, the worst
leaf's norm of the first gradient as the optimizer took it (AdamW's first
moment after one step, over 1 - beta1) and the norm of the parameters'
change after the last of them, each by its worst leaf.
"""

from __future__ import annotations

import time

import torch

from portbench.core import compare
from portbench.core.stats import covered, rate
from portbench.core.trace import (ModuleSpans, idle_gaps, profiled, ranges,
                                  top_ops)
from portbench.core.weights import draw, sub_seed

now = time.perf_counter


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Feed:
    """Minibatches of ``rows`` gathered from the pool by a permutation of
    its rows drawn each epoch, the last one of an epoch filled from the
    start of the same permutation (``train.loops.fit``'s batches); the
    whole pool, ungathered, where ``rows`` covers it."""

    def __init__(self, pool, rows: int, gen):
        self.pool, self.rows, self.gen = pool, rows, gen
        self.n = int(pool[0].shape[0])
        self.perm, self.pos = None, self.n

    def next(self):
        if self.rows >= self.n:
            return self.pool, None
        if self.pos >= self.n:
            self.perm = torch.randperm(self.n, generator=self.gen,
                                       device=self.pool[0].device)
            self.pos = 0
        idx = self.perm[self.pos:self.pos + self.rows]
        if idx.numel() < self.rows:
            idx = torch.cat([idx, self.perm[:self.rows - idx.numel()]])
        self.pos += self.rows
        return tuple(a[idx] for a in self.pool), idx


def optimizer_grads(state) -> dict:
    """The gradients the optimizer took at its first update: AdamW's
    first moment over 1 - beta1."""
    opt = state.optimizer
    b1 = opt.param_groups[0]["betas"][0]
    return {n: (opt.state[p]["exp_avg"] / (1.0 - b1)).detach().clone()
            for n, p in state.model.named_parameters()}


def mark(run, stage: str) -> None:
    """A set-up stage's end, once the device has done its work."""
    sync(run.device)
    run.mark(stage)


def setup(run) -> None:
    cfg, tr, dev = run.cfg, run.traffic, run.device
    run.rows = int(tr["batch_rows"])
    run.weights = draw(run.ref.leaves(cfg), run.seed, dev)
    mark(run, "weights")
    run.model = run.fam.build(cfg, run.weights, dev)
    mark(run, "model")
    g_data = torch.Generator(device=dev).manual_seed(
        sub_seed(run.seed, "data"))
    run.pool = run.fam.make_pool(cfg, tr, int(tr["pool_rows"]), g_data, dev)
    mark(run, "inputs")
    run.state, run.step = run.fam.train_step(cfg, run.model)
    run.gen = torch.Generator(device=dev).manual_seed(
        sub_seed(run.seed, "dropout"))
    run.feed = Feed(run.pool, run.rows, g_data)
    mark(run, "optimizer")
    run.check_idx, run.check_losses = [], []
    for k in range(int(tr["check_steps"])):
        mb, idx = run.feed.next()
        run.fam.reset_launch_counts()
        run.state, m = run.step(run.state, mb, run.gen)
        if k == 0:
            run.note(launches_per_step=run.fam.launch_counts())
            run.first_grads = optimizer_grads(run.state)
            mark(run, "first_step")
        run.check_idx.append(idx)
        run.check_losses.append(m["loss"])
    run.after = {n: p.detach().clone()
                 for n, p in run.model.named_parameters()}
    run.window_losses = []
    mark(run, "later_steps")


def _step(run) -> None:
    mb, _ = run.feed.next()
    run.state, m = run.step(run.state, mb, run.gen)
    run.window_losses.append(m["loss"])


def _steps(run, seconds: float, least: int = 1):
    """Steps until ``seconds`` have passed (at least ``least``); returns
    (steps, seconds) from the first launch to the device's end."""
    sync(run.device)
    t0 = now()
    n = 0
    while n < least or now() - t0 < seconds:
        _step(run)
        n += 1
    sync(run.device)
    return n, now() - t0


def window(run, seconds: float) -> dict:
    n, dt = _steps(run, seconds)
    run.attempted = n
    return {"train_samples_per_s": rate(n * run.rows, dt)}


def traced(run, seconds: float):
    """A plain stretch (for the model FLOP rate), a stretch with CUDA
    events at the recurrent stacks' boundaries, then ``profile_steps``
    steps under the profiler."""
    cfg, tr = run.cfg, run.traffic
    n_plain, dt_plain = _steps(run, seconds / 2)
    spans = ModuleSpans(run.model, cfg["rnn_modules"], backward=True)
    n_sp, _ = _steps(run, seconds / 4, least=2)
    spans = spans.close()
    with profiled(run.device) as prof:
        for _ in range(int(tr["profile_steps"])):
            with torch.profiler.record_function("step"):
                _step(run)
    run.attempted = n_plain + n_sp + int(tr["profile_steps"])
    return record(run, "train", n_plain, dt_plain, spans, prof,
                  run.fam.train_flops(cfg, tr, run.rows))


def record(run, kind, n_plain, dt_plain, spans, prof, flops_per_step):
    """What the per-layer readers read."""
    steps = ranges(prof["host"], "step")
    lo = min(s for s, _ in steps)
    hi = max([e for _, e in steps] + [e for _, e in
                                      ranges(prof["host"], "sync")])
    dev_ev = prof["device"]
    return {
        "kind": kind, "plain_steps": n_plain, "plain_s": dt_plain,
        "rows": run.rows, "flops_per_step": flops_per_step,
        "spans": spans,
        "span_work": run.fam.span_work(run.cfg, run.traffic, run.rows),
        "device": dev_ev,
        "busy_s": covered([(s, e) for _, s, e in dev_ev], lo, hi),
        "window_s": hi - lo,
        "breakdown": {
            "device_ops": top_ops(dev_ev, lo, hi),
            "idle_gaps": idle_gaps(dev_ev, prof["host"], lo, hi,
                                   skip=("step", "sync")),
        },
    }


def release(run) -> None:
    """Free the port's state; keep the checked batches and the outputs."""
    run.check_batches = [run.pool if idx is None
                         else tuple(a[idx] for a in run.pool)
                         for idx in run.check_idx]
    losses = torch.stack(run.window_losses) if run.window_losses else None
    run.failed = 0 if losses is None else int((~torch.isfinite(losses))
                                              .sum())
    for name in ("state", "step", "model", "pool", "feed", "window_losses"):
        setattr(run, name, None)
    if run.device.type == "cuda":
        torch.cuda.empty_cache()


def _reference(run, lower: bool):
    return run.ref.train_steps(run.cfg, run.weights, run.check_batches,
                               sub_seed(run.seed, "dropout"), lower=lower)


def _numbers(run, losses, grads, after) -> dict:
    ref = run.ref_out
    leaves = compare.counted_leaves(ref["grads"])
    run.note(leaves_left_out=sorted(set(ref["grads"]) - set(leaves)))
    change = {k: after[k] - run.weights[k] for k in leaves}
    ref_change = {k: ref["params"][k] - run.weights[k] for k in leaves}
    grad = compare.norm_gaps(grads, ref["grads"], leaves)
    moved = compare.norm_gaps(change, ref_change, leaves)
    grad_gap, grad_leaf = compare.worst(grad)
    change_gap, change_leaf = compare.worst(moved)
    run.note(worst_grad_leaf=grad_leaf, worst_change_leaf=change_leaf)
    return {
        "loss_gap": max(compare.rel_gap(a, b)
                        for a, b in zip(losses, ref["losses"])),
        "grad_norm_gap": grad_gap,
        "change_norm_gap": change_gap,
    }


def numbers(run) -> dict:
    run.ref_out = _reference(run, lower=False)
    return _numbers(run, [float(v) for v in run.check_losses],
                    run.first_grads, run.after)


def control_numbers(run) -> dict:
    """The reference one precision below (TF32) in the port's place."""
    ctl = _reference(run, lower=True)
    return _numbers(run, ctl["losses"], ctl["grads"], ctl["params"])
