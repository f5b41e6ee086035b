"""Plain reference of ``b2t24_bigru``: the Brain-to-Text '24 baseline
decoder, float32, TF32 off (``common.precision``).

Written from the published model and trainer (Willett et al., Nature 2023;
github.com/cffan/neural_seq_decoder, ``src/neural_decoder/model.py``
``GRUDecoder``, ``augmentations.py`` ``GaussianSmoothing``,
``neural_decoder_trainer.py``, ``scripts/train_competition_baseline.py``),
not from the port: nothing here imports it. A train step, in order:

- Noise, drawn from the one generator of the step in the port's order:
  white noise of sd ``white_sd`` over (B, T, C), then a constant offset of
  sd ``offset_sd`` over (B, 1, C), each added to the batch (the published
  trainer draws both from torch's global generator, in this order).
- Smoothing: ``F.conv1d(groups=C, padding="same")`` over time with the
  published kernel (20 taps, fixed in the published model, of a Gaussian
  of sd ``smooth_sigma``, normalised to sum 1).
- Day layer: the published gather and einsum, each row's (C, C) map and
  bias taken by its day index, then softsign; no dropout.
- Patches: ``unfold`` over time, ``win_size`` frames every ``stride``,
  flattened time-major ([t0 c0..cC, t1 c0..cC, ...]; departure: the
  published ``nn.Unfold`` orders them channel-major, a fixed permutation of
  ``wi``'s rows), the frames rounded to bf16 with a straight-through
  gradient (departure: the configuration reads the layer-0 frames in bf16,
  as the port's windowed kernels read them).
- A bidirectional GRU stack (``common.gru`` forward and reversed per layer,
  torch's gate convention) from a zero state, the two directions'
  outputs concatenated, dropout between layers in training (masks over
  (B, n_win, 2H) in layer order, after the noise); a dense head per
  window.
- CTC loss (blank 0) with the port's reduction: each sequence's loss, 0
  where infinite or above 1e4, over its label length, averaged (the
  published ``CTCLoss(reduction="mean", zero_infinity=True)`` zeroes only
  the infinite); over the window count floor((L - win) / stride) + 1
  (departure: the published trainer passes floor((L - win) / stride)).
- Adam with coupled L2 (``torch.optim.Adam(weight_decay=...)``): the
  weight decay added to the gradient before the moments, betas and eps
  from the configuration, no clipping, at the learning rate of the
  ``LinearLR`` schedule (constant where ``end_factor`` is 1).

Departure left out of both sides: the per-day ``nn.Linear`` modules the
published model builds and never calls. Leaves carry the port's names,
kernels (in, out).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.b2t_gru import day_layer, patches
from portbench.reference.common import dropout, gru, precision
from portbench.reference.rnn_fig5 import ctc_loss


def leaves(cfg: dict) -> dict:
    """name -> (shape, scale, offset) of every weight."""
    C, H, L, V, D = (cfg["in_channels"], cfg["hidden"], cfg["n_layers"],
                     cfg["n_classes"], cfg["n_days"])
    out = {"day.w": ((D, C, C), 1 / math.sqrt(C), 0.0),
           "day.b": ((D, C), 0.1, 0.0)}
    for layer in range(L):
        Fi = cfg["win_size"] * C if layer == 0 else 2 * H
        for d in ("fwd", "bwd"):
            p = f"rnn.{d}{layer}."
            out[p + "wi"] = ((Fi, 3 * H), 1 / math.sqrt(Fi), 0.0)
            out[p + "wh"] = ((H, 3 * H), 1 / math.sqrt(H), 0.0)
            out[p + "bi"] = ((3 * H,), 0.1, 0.0)
            out[p + "bh"] = ((3 * H,), 0.1, 0.0)
    out["head.kernel"] = ((2 * H, V), 1 / math.sqrt(2 * H), 0.0)
    out["head.bias"] = ((V,), 0.1, 0.0)
    return out


def noisy(cfg, x, gen):
    """x plus the trainer's white noise, then its constant offsets."""
    aug = cfg["augment"]
    B, T, C = x.shape
    x = x + torch.randn(x.shape, generator=gen, device=x.device) \
        * aug["white_sd"]
    return x + torch.randn((B, 1, C), generator=gen, device=x.device) \
        * aug["offset_sd"]


# the published kernel's length (model.py: GaussianSmoothing(nInputFeatures,
# 20, gaussianSmoothWidth))
SMOOTH_TAPS = 20


def kernel(cfg):
    """The published Gaussian kernel (taps,), float32."""
    taps, sd = SMOOTH_TAPS, cfg["smooth_sigma"]
    j = torch.arange(taps, dtype=torch.float32)
    k = 1 / (sd * math.sqrt(2 * math.pi)) * torch.exp(
        -(((j - (taps - 1) / 2) / sd) ** 2) / 2)
    return k / torch.sum(k)


def smooth(cfg, x):
    """(B, T, C) -> (B, T, C), each channel convolved over time."""
    C = x.shape[2]
    w = kernel(cfg).to(x.device).view(1, 1, -1).repeat(C, 1, 1)
    return F.conv1d(x.transpose(1, 2), w, groups=C,
                    padding="same").transpose(1, 2)


def forward(cfg, p, x, days, gen=None):
    """Logits (B, n_win, V) of the noised batch; the dropouts when ``gen``
    is given (training)."""
    B, H, L = x.shape[0], cfg["hidden"], cfg["n_layers"]
    y = day_layer(p, smooth(cfg, x), days)
    out = patches(cfg, y).transpose(0, 1)  # (T, B, F)
    h0 = torch.zeros((B, H), device=x.device)
    for layer in range(L):
        f, b = f"rnn.fwd{layer}.", f"rnn.bwd{layer}."
        out = torch.cat([
            gru(out, h0, p[f + "wi"], p[f + "bi"], p[f + "wh"], p[f + "bh"]),
            gru(out, h0, p[b + "wi"], p[b + "bi"], p[b + "wh"], p[b + "bh"],
                reverse=True)], dim=-1)
        if gen is not None and layer < L - 1:
            out = dropout(out.transpose(0, 1), cfg["dropout"],
                          gen).transpose(0, 1)
    return out.transpose(0, 1) @ p["head.kernel"] + p["head.bias"]


class Adam:
    """``torch.optim.Adam`` with coupled L2: g + weight_decay p into the
    moments, eps outside the root, at the learning rate lr * factor(k) of
    update k, factor falling linearly from 1 to ``end_factor`` over
    ``decay_steps`` updates (``LinearLR``)."""

    def __init__(self, params: dict, lr, weight_decay, decay_steps,
                 end_factor=0.0, eps=1e-8, betas=(0.9, 0.999)):
        self.p, self.lr, self.wd = params, lr, weight_decay
        self.decay, self.end, self.eps = decay_steps, end_factor, eps
        self.b1, self.b2 = betas
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.k = 0

    def factor(self, k: int) -> float:
        frac = 1.0 - min(k, self.decay) / self.decay
        return (1.0 - self.end) * frac + self.end

    @torch.no_grad()
    def update(self, grads: dict) -> dict:
        """Apply one update; returns the gradients as the moments took
        them (the weight decay added)."""
        grads = {k: g + self.wd * self.p[k] for k, g in grads.items()}
        lr = self.lr * self.factor(self.k)
        t = self.k + 1
        c1, c2 = 1.0 - self.b1 ** t, 1.0 - self.b2 ** t
        for k, p in self.p.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
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
    opt_cfg = {k: v for k, v in cfg["optimizer"].items() if k != "decoupled"}
    if cfg["optimizer"].get("decoupled", True):
        raise ValueError("the '24 baseline's Adam couples its weight decay")
    opt = Adam(p, betas=tuple(cfg["betas"]), **opt_cfg)
    losses, first = [], None
    with precision(lower):
        for x, labels, il, ll, days in batches:
            days = torch.as_tensor(days, device=dev).long()
            x = noisy(cfg, x, gen)
            loss = ctc_loss(cfg, forward(cfg, p, x, days, gen), labels, il,
                            ll)
            grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
            taken = opt.update(grads)
            if first is None:
                first = {k: g.detach().clone() for k, g in taken.items()}
            losses.append(float(loss.detach()))
    return {"losses": losses, "grads": first,
            "params": {k: v.detach() for k, v in p.items()}}
