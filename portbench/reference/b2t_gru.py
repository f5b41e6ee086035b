"""Plain reference of ``b2t_gru``: the brain-to-text GRU decoder, float32.

Written from the published model (Card et al., NEJM 2024;
github.com/Neuroprosthetics-Lab/nejm-brain-to-text,
``model_training/rnn_model.py:GRUDecoder`` and the trainer's optimizer and
schedule), not from the port: nothing here imports it.

- Day layer: the published gather and einsum, each row's (C, C) map and
  bias taken by its day index, then softsign, then dropout
  (``input_dropout``).
- Patches: ``unfold`` over time, ``win_size`` frames every ``stride``,
  flattened time-major ([t0 c0..cC, t1 c0..cC, ...]); the frames rounded to
  bf16 on the way in with a straight-through gradient (departure: the
  published run casts everything under bf16 autocast; the configuration
  is float32 with the layer-0 frames read in bf16, as the port's windowed
  kernels read them).
- A unidirectional GRU stack (``common.gru``, torch's gate convention)
  from one trainable initial state ``h0`` shared by every layer, dropout
  between layers in training; a dense head per window.
- CTC loss (blank 0) over the window-adjusted lengths with the port's
  reduction: each sequence's loss, 0 where infinite or above 1e4, over its
  label length, averaged (departure: the published trainer averages the
  per-sequence sums with ``zero_infinity=False``).
- AdamW (betas from the configuration, ``eps`` added outside the root,
  decoupled weight decay scaled by the learning rate; no weight decay on
  the day layers), global-norm clipping before it (departure: the
  published ``clip_grad_norm_`` adds 1e-6 to the norm), and the published
  schedule: a linear warm-up from 0 over ``warmup_steps``, then a cosine
  from ``lr`` to ``min_lr`` at ``decay_steps``. Departures, as the port
  has them: the day layers are one tensor each (``day.w``, ``day.b``), so
  a day absent from a batch gets a zero gradient and still moves by its
  moments, under the one step count of all days (the published model
  keeps a parameter a day, which AdamW skips without a gradient); and
  only the day layers go without weight decay (the published trainer, as
  recalled, also exempts the biases).
- Dropout masks drawn in the port's order from one generator: the day
  layer's over (B, T, C), then each layer's over (B, n_win, H).

Leaves carry the port's names, kernels (in, out).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.common import dropout, gru, precision
from portbench.reference.rnn_fig5 import ctc_loss


def leaves(cfg: dict) -> dict:
    """name -> (shape, scale, offset) of every weight."""
    C, H, L, V, D = (cfg["in_channels"], cfg["hidden"], cfg["n_layers"],
                     cfg["n_classes"], cfg["n_days"])
    out = {"day.w": ((D, C, C), 1 / math.sqrt(C), 0.0),
           "day.b": ((D, C), 0.1, 0.0),
           "h0": ((1, 1, H), 0.1, 0.0)}
    for layer in range(L):
        Fi = cfg["win_size"] * C if layer == 0 else H
        p = f"rnn.fwd{layer}."
        out[p + "wi"] = ((Fi, 3 * H), 1 / math.sqrt(Fi), 0.0)
        out[p + "wh"] = ((H, 3 * H), 1 / math.sqrt(H), 0.0)
        out[p + "bi"] = ((3 * H,), 0.1, 0.0)
        out[p + "bh"] = ((3 * H,), 0.1, 0.0)
    out["head.kernel"] = ((H, V), 1 / math.sqrt(H), 0.0)
    out["head.bias"] = ((V,), 0.1, 0.0)
    return out


def day_layer(p, x, days):
    """softsign(x_b W_{d(b)} + b_{d(b)}) by the published gather."""
    w = p["day.w"][days]  # (B, C, C)
    b = p["day.b"][days][:, None]  # (B, 1, C)
    return F.softsign(torch.einsum("btd,bdk->btk", x, w) + b)


def patches(cfg, y):
    """(B, T, C) -> (B, n_win, win*C), the frames rounded to bf16 with the
    gradient passed straight through."""
    y = y + (y.to(torch.bfloat16).float() - y).detach()
    w, s = cfg["win_size"], cfg["stride"]
    n_win = (y.shape[1] - w) // s + 1
    pw = y.unfold(1, w, s)[:, :n_win]  # (B, n_win, C, win)
    return pw.transpose(2, 3).reshape(y.shape[0], n_win, -1)


def forward(cfg, p, x, days, gen=None):
    """Logits (B, n_win, V); the dropouts when ``gen`` is given
    (training)."""
    B, H, L = x.shape[0], cfg["hidden"], cfg["n_layers"]
    y = day_layer(p, x, days)
    if gen is not None:
        y = dropout(y, cfg["input_dropout"], gen)
    out = patches(cfg, y).transpose(0, 1)  # (T, B, F)
    h0 = p["h0"][0].expand(B, H)
    for layer in range(L):
        q = f"rnn.fwd{layer}."
        out = gru(out, h0, p[q + "wi"], p[q + "bi"], p[q + "wh"],
                  p[q + "bh"])
        if gen is not None and layer < L - 1:
            out = dropout(out.transpose(0, 1), cfg["dropout"],
                          gen).transpose(0, 1)
    return out.transpose(0, 1) @ p["head.kernel"] + p["head.bias"]


class AdamW:
    """Global-norm clipping (g clip / ||g|| where ||g|| >= clip), then
    AdamW with the configuration's betas and eps, weight decay
    ``weight_decay`` except on leaves under a ``no_decay`` prefix, at the
    learning rate lr * factor(k) of update k."""

    def __init__(self, params: dict, lr, weight_decay, decay_steps,
                 betas=(0.9, 0.999), eps=1e-8, warmup_steps=0, min_lr=0.0,
                 clip=None, no_decay=(), schedule="cosine"):
        self.p, self.lr, self.clip = params, lr, clip
        self.b1, self.b2 = betas
        self.eps, self.decay, self.warm = eps, decay_steps, warmup_steps
        self.r = min_lr / lr
        self.wd = {k: 0.0 if k.startswith(tuple(no_decay)) else weight_decay
                   for k in params}
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.k = 0

    def factor(self, k: int) -> float:
        if k < self.warm:
            return k / self.warm
        if k >= self.decay:
            return self.r
        prog = (k - self.warm) / max(1, self.decay - self.warm)
        return max(self.r, self.r + (1.0 - self.r) * 0.5
                   * (1.0 + math.cos(math.pi * prog)))

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
        c1, c2 = 1.0 - self.b1 ** t, 1.0 - self.b2 ** t
        for k, p in self.p.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.mul_(1.0 - lr * self.wd[k])
            denom = self.v[k].sqrt() / math.sqrt(c2) + self.eps
            p.addcdiv_(self.m[k], denom, value=-lr / c1)
        self.k += 1
        return grads


def train_steps(cfg: dict, weights: dict, batches, dropout_seed: int,
                lower: bool = False) -> dict:
    """The first len(batches) train steps from ``weights``, each batch (x,
    labels, input lengths, label lengths, days): losses, the first
    gradients as the optimizer takes them, the parameters after."""
    dev = next(iter(weights.values())).device
    gen = torch.Generator(device=dev).manual_seed(dropout_seed)
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in weights.items()}
    opt = AdamW(p, betas=tuple(cfg["betas"]), **cfg["optimizer"])
    losses, first = [], None
    with precision(lower):
        for x, labels, il, ll, days in batches:
            days = torch.as_tensor(days, device=dev).long()
            loss = ctc_loss(cfg, forward(cfg, p, x, days, gen), labels, il,
                            ll)
            grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
            clipped = opt.update(grads)
            if first is None:
                first = {k: g.detach().clone() for k, g in clipped.items()}
            losses.append(float(loss.detach()))
    return {"losses": losses, "grads": first,
            "params": {k: v.detach() for k, v in p.items()}}
