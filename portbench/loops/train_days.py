"""Closed-loop training on batches drawn day by day: each step takes
``days_per_batch`` recording days without replacement and
``trials_per_day_batch`` trials of each without replacement from a pool
resident on the device, crops the batch to its longest trial and hands
the port's train step each row's day.

The draw runs on the host (its generator seeded from the run's seed),
where the trials' lengths are kept, so the crop reads nothing back from
the device; the rows are gathered on the device by an index copied from
pinned memory. The window, the traced run, the reference's steps and the
numbers compared are ``loops/train.py``'s.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.core.weights import draw, sub_seed
from portbench.loops import train as base
from portbench.loops.train import (  # noqa: F401  (the loop's stages)
    control_numbers,
    numbers,
    traced,
    window,
)


class DayFeed:
    """Batches of ``days`` days x ``per_day`` trials from a day-major pool
    of ``n_days`` x ``trials`` rows, each cropped to its longest trial:
    (x (B, T_max, C), labels, input lengths, label lengths, days (B,) on
    the host)."""

    def __init__(self, pool, lengths, n_days: int, trials: int, days: int,
                 per_day: int, seed: int):
        self.pool, self.lengths = pool, lengths
        self.n_days, self.trials = n_days, trials
        self.days, self.per_day = days, per_day
        self.rng = np.random.default_rng(seed)
        self.dev = pool[0].device

    def draw(self):
        """(row indices, days) of the next batch, on the host."""
        days = self.rng.choice(self.n_days, self.days, replace=False)
        rows = [d * self.trials + self.rng.choice(self.trials, self.per_day,
                                                  replace=False)
                for d in days]
        return np.concatenate(rows), np.repeat(days, self.per_day)

    def next(self):
        idx, days = self.draw()
        t_max = int(self.lengths[idx].max())
        i = torch.from_numpy(idx)
        if self.dev.type == "cuda":
            i = i.pin_memory().to(self.dev, non_blocking=True)
        x, labels, il, ll = self.pool
        batch = (x[i, :t_max], labels[i], il[i], ll[i],
                 torch.from_numpy(days))
        return batch, None


def setup(run) -> None:
    cfg, tr, dev = run.cfg, run.traffic, run.device
    run.rows = int(tr["batch_rows"])
    if run.rows != tr["days_per_batch"] * tr["trials_per_day_batch"]:
        raise ValueError("batch_rows is days_per_batch x "
                         "trials_per_day_batch")
    run.weights = draw(run.ref.leaves(cfg), run.seed, dev)
    base.mark(run, "weights")
    run.model = run.fam.build(cfg, run.weights, dev)
    base.mark(run, "model")
    g_data = torch.Generator(device=dev).manual_seed(
        sub_seed(run.seed, "data"))
    run.pool = run.fam.make_pool(cfg, tr, g_data, dev)
    lengths = run.pool[2].cpu().numpy()
    base.mark(run, "inputs")
    run.state, run.step = run.fam.train_step(cfg, run.model)
    run.gen = torch.Generator(device=dev).manual_seed(
        sub_seed(run.seed, "dropout"))
    run.feed = DayFeed(run.pool, lengths, cfg["n_days"],
                       int(tr["trials_per_day"]), int(tr["days_per_batch"]),
                       int(tr["trials_per_day_batch"]),
                       sub_seed(run.seed, "feed"))
    base.mark(run, "optimizer")
    run.check_batches, run.check_losses = [], []
    for k in range(int(tr["check_steps"])):
        mb, _ = run.feed.next()
        run.fam.reset_launch_counts()
        run.state, m = run.step(run.state, mb, run.gen)
        if k == 0:
            run.note(launches_per_step=run.fam.launch_counts())
            run.first_grads = base.optimizer_grads(run.state)
            base.mark(run, "first_step")
        run.check_batches.append(mb)
        run.check_losses.append(m["loss"])
    run.after = {n: p.detach().clone()
                 for n, p in run.model.named_parameters()}
    run.window_losses = []
    base.mark(run, "later_steps")


def release(run) -> None:
    """Free the port's state and the pool; keep the checked batches (the
    crops the port trained on) and the outputs."""
    losses = torch.stack(run.window_losses) if run.window_losses else None
    run.failed = 0 if losses is None else int((~torch.isfinite(losses))
                                              .sum())
    for name in ("state", "step", "model", "pool", "feed", "window_losses"):
        setattr(run, name, None)
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
