"""Plain pieces the references share: a GRU direction as a loop of
float32 products, the optimizer (global-norm clipping, AdamW, linear
decay), dropout masks, and the precision switch.

Written from the published equations (torch's GRU convention, gate order
r, z, n, separate input and recurrent biases; optax's AdamW chain), not
from the port: nothing here imports it.
"""

from __future__ import annotations

import math
from contextlib import contextmanager

import torch


@contextmanager
def precision(lower: bool):
    """Float32 products in full float32 (``lower=False``, the reference) or
    in TF32 (``lower=True``, the control one precision below)."""
    m, c = torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = lower
    torch.backends.cudnn.allow_tf32 = lower
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def gru(x, h0, wi, bi, wh, bh, reverse: bool = False):
    """x (T, B, F), h0 (B, H) -> hs (T, B, H), hs[t] the state after
    step t of the sweep (the reverse sweep runs from T - 1 down)."""
    T, B, F = x.shape
    H = wh.shape[0]
    gi = (x.reshape(T * B, F) @ wi + bi).reshape(T, B, 3 * H)
    h = h0
    hs = [None] * T
    for s in range(T):
        t = T - 1 - s if reverse else s
        gh = h @ wh + bh
        r = torch.sigmoid(gi[t, :, :H] + gh[:, :H])
        z = torch.sigmoid(gi[t, :, H:2 * H] + gh[:, H:2 * H])
        n = torch.tanh(gi[t, :, 2 * H:] + r * gh[:, 2 * H:])
        h = (1.0 - z) * n + z * h
        hs[t] = h
    return torch.stack(hs)


def dropout(x, rate: float, gen):
    """Keep with probability 1 - rate, kept values scaled by 1/(1 - rate);
    the mask is ``torch.rand(x.shape, generator=gen) < 1 - rate``."""
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), device=x.device))


class AdamW:
    """Global-norm clipping, then AdamW (b1 0.9, b2 0.999, eps 1e-8
    outside the root, weight decay decoupled and scaled by the learning
    rate), at the learning rate lr * factor(k) of update k, with factor
    falling linearly from 1 to ``end_factor`` over ``decay_steps`` updates
    and held there."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, params: dict, lr, weight_decay, decay_steps,
                 end_factor=0.0, clip=None):
        self.p = params
        self.lr, self.wd, self.decay, self.end = lr, weight_decay, \
            decay_steps, end_factor
        self.clip = clip
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.k = 0

    def factor(self, k: int) -> float:
        if self.decay <= 0:
            return 1.0
        frac = 1.0 - min(k, self.decay) / self.decay
        return (1.0 - self.end) * frac + self.end

    @torch.no_grad()
    def update(self, grads: dict) -> dict:
        """Apply one update; returns the gradients as clipped."""
        if self.clip is not None:
            norm = torch.sqrt(sum((g.double() ** 2).sum()
                                  for g in grads.values()))
            if float(norm) >= self.clip:
                grads = {k: g / norm.float() * self.clip
                         for k, g in grads.items()}
        lr = self.lr * self.factor(self.k)
        t = self.k + 1
        c1, c2 = 1.0 - self.B1 ** t, 1.0 - self.B2 ** t
        for k, p in self.p.items():
            g = grads[k]
            self.m[k].mul_(self.B1).add_(g, alpha=1.0 - self.B1)
            self.v[k].mul_(self.B2).addcmul_(g, g, value=1.0 - self.B2)
            p.mul_(1.0 - lr * self.wd)
            denom = self.v[k].sqrt() / math.sqrt(c2) + self.EPS
            p.addcdiv_(self.m[k], denom, value=-lr / c1)
        self.k += 1
        return grads


def train(params0: dict, loss_fn, batches, opt_cfg: dict, gen):
    """Run ``loss_fn(params, batch, gen)`` and one update a batch from
    copies of ``params0``. Returns the losses, the first update's
    gradients as clipped, and the parameters after the last update."""
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in params0.items()}
    opt = AdamW(p, **opt_cfg)
    losses, first = [], None
    for batch in batches:
        loss = loss_fn(p, batch, gen)
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        clipped = opt.update(grads)
        if first is None:
            first = {k: g.detach().clone() for k, g in clipped.items()}
        losses.append(float(loss.detach()))
    return {"losses": losses, "grads": first,
            "params": {k: v.detach() for k, v in p.items()}}
