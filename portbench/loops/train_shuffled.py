"""Closed-loop training on batches shuffled across every recording day:
each step takes ``batch_rows`` trials without replacement from a pool
resident on the device, by a permutation of the whole pool drawn each
epoch (the last batch of an epoch filled from the start of the same
permutation), crops the batch to its longest trial and hands the port's
train step each row's day (its trial's row over ``trials_per_day``).

The draw runs on the host (its generator seeded from the run's seed),
where the trials' lengths are kept, so the crop reads nothing back from
the device; the rows are gathered on the device by an index copied from
pinned memory (``train_days.py``'s gather). The window, the traced run,
the reference's steps and the numbers compared are ``loops/train.py``'s,
with one more: ``first_loss_gap``, the first checked step's loss against
the reference's. That step's loss is formed from the drawn weights alone,
so the port and the reference agree there to a float32 ulp; later steps'
losses follow Adam's updates, after which the bf16 layer-0 frames round
apart and the loss's gap reads as high as one precision lower's.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.core import compare
from portbench.core.weights import draw, sub_seed
from portbench.loops import train as base
from portbench.loops.train import traced, window  # noqa: F401
from portbench.loops.train_days import DayFeed, release  # noqa: F401


class ShuffleFeed(DayFeed):
    """Batches of ``rows`` trials from a day-major pool of ``trials`` rows
    a day, a permutation of the pool an epoch, each cropped to its longest
    trial: (x (B, T_max, C), labels, input lengths, label lengths, days
    (B,) on the host)."""

    def __init__(self, pool, lengths, trials: int, rows: int, seed: int):
        self.pool, self.lengths = pool, lengths
        self.trials, self.rows = trials, rows
        self.n = int(pool[0].shape[0])
        self.rng = np.random.default_rng(seed)
        self.dev = pool[0].device
        self.perm, self.pos = None, self.n

    def draw(self):
        """(row indices, days) of the next batch, on the host."""
        if self.pos >= self.n:
            self.perm = self.rng.permutation(self.n)
            self.pos = 0
        idx = self.perm[self.pos:self.pos + self.rows]
        if len(idx) < self.rows:
            idx = np.concatenate([idx, self.perm[:self.rows - len(idx)]])
        self.pos += self.rows
        return idx, idx // self.trials


def setup(run) -> None:
    cfg, tr, dev = run.cfg, run.traffic, run.device
    run.rows = int(tr["batch_rows"])
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
    run.feed = ShuffleFeed(run.pool, lengths, int(tr["trials_per_day"]),
                           run.rows, sub_seed(run.seed, "feed"))
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


def _first_loss(out: dict, losses, ref: dict) -> dict:
    out["first_loss_gap"] = compare.rel_gap(float(losses[0]),
                                            ref["losses"][0])
    return out


def numbers(run) -> dict:
    return _first_loss(base.numbers(run), run.check_losses, run.ref_out)


def control_numbers(run) -> dict:
    """The reference one precision below (TF32) in the port's place."""
    ctl = base._reference(run, lower=True)
    return _first_loss(base._numbers(run, ctl["losses"], ctl["grads"],
                                     ctl["params"]), ctl["losses"],
                       run.ref_out)
