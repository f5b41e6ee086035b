"""Data augmentations: the tensor transforms of the CTC training set and
the classical decoders' MixUp and time-jitter windows.

Port of ``cross_patient_speech_decoding_tpu/ops/augment.py``: the five
tensor-level transforms of the reference's ``augmentations.py`` (time
warping, time masking, time shifting, noise jitter and scaling, each on
(N, T, C) trials), within-class MixUp with Beta(alpha, alpha) weights and
the re-centred time-jitter crops of ``data_augmentation.py``.

Each random transform is split in two: ``<name>_draw(generator, ...)``
takes its random numbers from a ``torch.Generator`` on the data's device,
and ``<name>_apply(..., draws)`` is the deterministic rest, so that a test
can feed the JAX package's own draws to the apply. ``<name>(generator,
...)`` is the two in turn. The draws' distributions are the JAX package's;
the streams differ (``torch.Generator`` against ``jax.random``), and
:func:`x_key` gives a per-index generator where the JAX package folds an
index into a key.
"""

from __future__ import annotations

import numpy as np
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


def x_key(generator, i: int, device=None) -> torch.Generator:
    """A generator of its own for index ``i`` (the JAX package's
    ``fold_in(key, i)``): seeded from ``generator``'s initial seed, or from
    an int seed, and ``i``, through numpy's ``SeedSequence``, so that
    neighbouring indices get unrelated streams. ``generator`` is not
    advanced. The new generator lies on ``generator``'s device (the CPU for
    an int seed) unless ``device`` is given."""
    if isinstance(generator, torch.Generator):
        base, dev = generator.initial_seed(), generator.device
    else:
        base, dev = int(generator), torch.device("cpu")
    seed = np.random.SeedSequence([base, int(i)]).generate_state(
        1, np.uint64)[0]
    out = torch.Generator(device=dev if device is None else device)
    return out.manual_seed(int(seed) & (2**63 - 1))


def mixup_pairs_draw(generator, class_ids, n_aug: int):
    """(idx_a (n_aug,) uniform over the N trials, gumbel (n_aug, N) standard
    Gumbel noise from ``torch.rand``)."""
    N = class_ids.shape[0]
    dev = class_ids.device
    idx_a = torch.randint(0, N, (n_aug,), generator=generator, device=dev)
    u = torch.rand((n_aug, N), generator=generator, device=dev)
    tiny = torch.finfo(u.dtype).tiny
    return idx_a, -torch.log(-torch.log(u.clamp(min=tiny)))


def mixup_pairs_apply(class_ids, draws):
    """Gumbel-max over each a's class members: b is the same-class trial of
    largest noise, a uniform draw among them (a itself for a class of one).
    Returns (idx_a, idx_b), each (n_aug,) int32."""
    idx_a, gumbel = draws
    idx_a = idx_a.long()
    same = class_ids[None, :] == class_ids[idx_a][:, None]
    scores = torch.where(same, gumbel, torch.full_like(gumbel, -torch.inf))
    return idx_a.to(torch.int32), scores.argmax(dim=1).to(torch.int32)


def mixup_pairs(generator, class_ids, n_classes: int, n_aug: int):
    """Within-class MixUp pairs (idx_a, idx_b): a uniform over the trials,
    b uniform over a's class, on ``class_ids``' device."""
    return mixup_pairs_apply(class_ids,
                             mixup_pairs_draw(generator, class_ids, n_aug))


def mixup_draw(generator, class_ids, n_aug: int, alpha: float = 0.5):
    """(the pairs' draws, lam (n_aug,) ~ Beta(alpha, alpha) float32).

    ``torch.distributions.Beta`` takes no generator, so lam comes from
    numpy's ``Generator.beta`` seeded by one draw of ``generator``: the
    global random state is never used."""
    pairs = mixup_pairs_draw(generator, class_ids, n_aug)
    seed = torch.randint(0, 2**62, (1,), generator=generator,
                         device=class_ids.device)
    lam = np.random.default_rng(int(seed)).beta(alpha, alpha, n_aug)
    return pairs, torch.as_tensor(lam, dtype=torch.float32,
                                  device=class_ids.device)


def mixup_apply(X, class_ids, draws):
    """lam X[a] + (1 - lam) X[b] for each pair, with a's class id.
    Returns (X_aug (n_aug, ...), ids_aug (n_aug,))."""
    pairs, lam = draws
    idx_a, idx_b = mixup_pairs_apply(class_ids, pairs)
    idx_a, idx_b = idx_a.long(), idx_b.long()
    lam = lam.to(X.dtype).reshape((-1,) + (1,) * (X.dim() - 1))
    return (lam * X[idx_a] + (1.0 - lam) * X[idx_b],
            class_ids[idx_a])


def mixup(generator, X, class_ids, n_classes: int, n_aug: int,
          alpha: float = 0.5):
    """Within-class MixUp (the reference's ``augment_mixup``): ``n_aug``
    blends of two trials of one class, lam ~ Beta(alpha, alpha). Returns
    (X_aug (n_aug, ...), ids_aug (n_aug,))."""
    return mixup_apply(X, class_ids,
                       mixup_draw(generator, class_ids, n_aug, alpha))


def time_jitter_windows(X_wide, center_start: int, win_len: int, offsets):
    """Re-centred window crops (the reference's ``augment_time_jitter``).

    X_wide: (N, T_wide, C) uncropped trials. Returns (len(offsets), N,
    win_len, C): the crop at ``center_start + offset`` for each offset,
    its start clamped to [0, T_wide - win_len]."""
    T_wide = X_wide.shape[1]
    crops = []
    for off in offsets:
        s = max(0, min(center_start + off, T_wide - win_len))
        crops.append(X_wide[:, s:s + win_len])
    return torch.stack(crops)
