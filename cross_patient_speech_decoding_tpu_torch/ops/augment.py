"""Tensor augmentations of the CTC training set.

Port of the five tensor-level transforms of
``cross_patient_speech_decoding_tpu/ops/augment.py:23-72`` (the reference's
``augmentations.py``): time warping, time masking, time shifting, noise
jitter and scaling, each on (N, T, C) trials.

Each transform is split in two: ``<name>_draw(generator, x)`` takes its
random numbers from a ``torch.Generator`` on x's device, and
``<name>_apply(x, draws)`` is the deterministic rest, so that a test can
feed the JAX package's own draws to the apply. ``<name>(generator, x)``
is the two in turn. The draws' distributions are the JAX package's; the
streams differ (``torch.Generator`` against ``jax.random``). MixUp and
the time-jitter windows, which no ported driver uses, come with the
offline NN family (ROADMAP queue 1, item 7).
"""

from __future__ import annotations

import torch


def time_warping_draw(generator, x, min_f: float = 0.8, max_f: float = 1.2):
    """(N,) warp factors, uniform in [min_f, max_f)."""
    u = torch.rand(x.shape[0], generator=generator, device=x.device,
                   dtype=x.dtype)
    return min_f + (max_f - min_f) * u


def time_warping_apply(x, factors):
    """Resample trial n at positions t * factors[n] (clamped to [0, T-1])
    with linear interpolation: a stretch or squeeze resized back to T."""
    N, T, C = x.shape
    t = torch.arange(T, dtype=x.dtype, device=x.device)
    pos = (t[None, :] * factors[:, None]).clamp(0, T - 1)
    lo = torch.floor(pos).long()
    hi = (lo + 1).clamp(max=T - 1)
    frac = (pos - lo.to(x.dtype))[..., None]
    xl = torch.gather(x, 1, lo[..., None].expand(N, T, C))
    xh = torch.gather(x, 1, hi[..., None].expand(N, T, C))
    return xl * (1 - frac) + xh * frac


def time_warping(generator, x, min_f: float = 0.8, max_f: float = 1.2):
    """Random temporal stretch or squeeze per trial, resized back to T."""
    return time_warping_apply(x, time_warping_draw(generator, x, min_f,
                                                   max_f))


def time_masking_draw(generator, x, max_width: int = 10):
    """(widths (N,) in [0, max_width], starts (N,) in
    [0, max(T - max_width, 1)))."""
    N, T = x.shape[0], x.shape[1]
    widths = torch.randint(0, max_width + 1, (N,), generator=generator,
                           device=x.device)
    starts = torch.randint(0, max(T - max_width, 1), (N,),
                           generator=generator, device=x.device)
    return widths, starts


def time_masking_apply(x, draws):
    """Zero frames [start, start + width) of each trial."""
    widths, starts = draws
    t = torch.arange(x.shape[1], device=x.device)[None, :]
    keep = (t < starts[:, None]) | (t >= (starts + widths)[:, None])
    return x * keep[..., None].to(x.dtype)


def time_masking(generator, x, max_width: int = 10):
    """Zero a random time window per trial."""
    return time_masking_apply(x, time_masking_draw(generator, x, max_width))


def time_shifting_draw(generator, x, max_shift: int = 10):
    """(N,) shifts in [-max_shift, max_shift]."""
    return torch.randint(-max_shift, max_shift + 1, (x.shape[0],),
                         generator=generator, device=x.device)


def time_shifting_apply(x, shifts):
    """Circular roll of each trial along time by its shift."""
    N, T, C = x.shape
    t = torch.arange(T, device=x.device)[None, :]
    src = torch.remainder(t - shifts[:, None], T)
    return torch.gather(x, 1, src[..., None].expand(N, T, C))


def time_shifting(generator, x, max_shift: int = 10):
    """Circular roll along time, random per trial."""
    return time_shifting_apply(x, time_shifting_draw(generator, x,
                                                     max_shift))


def noise_jitter_draw(generator, x):
    """Unit normal noise of x's shape."""
    return torch.randn(x.shape, generator=generator, device=x.device,
                       dtype=x.dtype)


def noise_jitter_apply(x, noise, sigma: float = 0.1):
    return x + sigma * noise


def noise_jitter(generator, x, sigma: float = 0.1):
    """Additive Gaussian noise of standard deviation ``sigma``."""
    return noise_jitter_apply(x, noise_jitter_draw(generator, x), sigma)


def scaling_draw(generator, x):
    """(N, 1, 1) unit normal per-trial draws."""
    return torch.randn((x.shape[0], 1, 1), generator=generator,
                       device=x.device, dtype=x.dtype)


def scaling_apply(x, draws, sigma: float = 0.1):
    return x * (1.0 + sigma * draws)


def scaling(generator, x, sigma: float = 0.1):
    """Random per-trial amplitude scaling around 1."""
    return scaling_apply(x, scaling_draw(generator, x), sigma)
