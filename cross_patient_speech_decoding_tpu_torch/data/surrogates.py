"""Tensor-Maximum-Entropy (TME) and mode-shuffle surrogates of a trial
tensor: the structure-destroying controls of ``cpsd svm-decode``
(``surrogate=tme|shuffle``; the reference's supp_fig_11 and
``pt_decoding_data_S62_TME.pkl``, consumed at
`scripts/aligned_decode_svm_ncv.py:261-263`).

Port of ``cross_patient_speech_decoding_tpu/data/surrogates.py``. TME
(Elsayed & Cunningham 2017) samples the maximum-entropy Gaussian whose
mode-wise marginal covariances (trials / time / channels) match the
data's: its covariance is diagonal in the Kronecker product of the mode
eigenbases with entries 1/(a_i + b_j + c_k), and a, b, c are fitted so
that the implied marginal eigenvalues match the data's.

Where the work runs:

- the mode scatter matrices and their eigendecompositions stay on the
  host in float64 numpy, as in the JAX package;
- :func:`fit_tme` is an autograd loop on the caller's device (the first
  CUDA card by default) with the JAX package's parameterisation
  (log a, log b, log c), float32 loss and initialisation, and Adam as
  optax computes it (:func:`_adam_step`); the loss is read once, after
  the last step;
- :func:`sample_tme` is a draw (:func:`sample_tme_draw`, standard normals
  from a ``torch.Generator`` on the device: ``jax.random`` streams cannot
  be reproduced) and an apply (:func:`sample_tme_apply`: the std scaling
  and the three mode rotations in true float32, as the JAX package pins
  ``Precision.HIGHEST``); the sample stays on the device;
- :func:`mode_shuffle_surrogate` draws its permutations with the caller's
  numpy generator in the JAX package's order and gathers on the device,
  so its result is the JAX package's bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from cross_patient_speech_decoding_tpu_torch.ops.precision import true_f32
from cross_patient_speech_decoding_tpu_torch.utils.device import (
    resolve_device,
)

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults


def _mode_covs(X: np.ndarray):
    """Mode-wise SCATTER matrices of a mean-centered 3-way tensor, and the
    centered tensor.

    Unnormalized (sum over the other modes, not mean): TME feasibility
    requires equal traces across modes — trace(S1) = trace(S2) = trace(S3)
    = ||Xc||^2 — which normalized covariances would break.
    """
    Xc = X - X.mean(axis=0, keepdims=True)
    N, T, C = Xc.shape
    mats = [
        Xc.reshape(N, T * C),
        np.moveaxis(Xc, 1, 0).reshape(T, N * C),
        np.moveaxis(Xc, 2, 0).reshape(C, N * T),
    ]
    return [m @ m.T for m in mats], Xc


def _implied_marginals(la, lb, lc):
    """Marginal eigenvalues of the max-ent model: sums of 1/(a_i + b_j +
    c_k) over the other two modes."""
    a, b, c = la.exp(), lb.exp(), lc.exp()
    v = 1.0 / (a[:, None, None] + b[None, :, None] + c[None, None, :])
    return v.sum((1, 2)), v.sum((0, 2)), v.sum((0, 1))


def _loss(params, log_eigs):
    """Squared log-space error of the implied marginals against the data's
    (``log_eigs``: log(eigenvalue + 1e-9) per mode); the log space handles
    the orders-of-magnitude eigen spread."""
    return sum(((m + 1e-9).log() - d).square().sum()
               for m, d in zip(_implied_marginals(*params), log_eigs))


def _adam_step(params, grads, mu, nu, count: int, lr: float) -> None:
    """One Adam update in place, in optax's order of operations
    (``scale_by_adam``, then ``-lr``, then ``apply_updates``); the bias
    corrections are float32, as optax's."""
    bc1 = float(np.float32(1.0) - np.float32(ADAM_B1) ** count)
    bc2 = float(np.float32(1.0) - np.float32(ADAM_B2) ** count)
    for p, g, m, n in zip(params, grads, mu, nu):
        m.copy_((1.0 - ADAM_B1) * g + ADAM_B1 * m)
        n.copy_((1.0 - ADAM_B2) * g.square() + ADAM_B2 * n)
        p.add_(-lr * ((m / bc1) / ((n / bc2).sqrt() + ADAM_EPS)))


def fit_tme(X, steps: int = 2000, lr: float = 5e-2, seed: int = 0,
            device=None) -> dict:
    """Fit the TME max-ent eigen-parameters to a (N, T, C) tensor (numpy,
    or a tensor, copied to the host for the float64 mode eigenbases), by
    ``steps`` Adam steps on ``device`` (the first CUDA card by default).
    ``seed`` is unused, as in the JAX package (the fit is deterministic).

    Returns the JAX package's dict: per-mode eigenbases ``Qs`` (float64),
    the fitted ``log_abc`` defining Kronecker-diagonal variances
    1/(a_i + b_j + c_k), the trial mean, the loss before the last update,
    and the data's and the fit's marginal eigenvalues (numpy).
    """
    del seed
    dev = resolve_device(device)
    X = X.cpu().numpy() if torch.is_tensor(X) else np.asarray(X)
    covs, _ = _mode_covs(X)
    eigs, Qs = [], []
    for cov in covs:
        w, q = np.linalg.eigh(cov)
        eigs.append(torch.as_tensor(np.maximum(w[::-1], 0.0).copy(),
                                    dtype=torch.float32, device=dev))
        Qs.append(q[:, ::-1])

    N, T, C = X.shape

    def init_vec(d, n_other):
        # the decoupled solution: marginal_i ~ (#other entries) / a_i
        return (n_other / d.clamp(min=1e-6) / 3.0).clamp(min=1e-8).log()

    params = [init_vec(eigs[0], T * C), init_vec(eigs[1], N * C),
              init_vec(eigs[2], N * T)]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    log_eigs = [(d + 1e-9).log() for d in eigs]
    loss = None
    for count in range(1, steps + 1):
        ps = [p.detach().requires_grad_() for p in params]
        loss = _loss(ps, log_eigs)
        grads = torch.autograd.grad(loss, ps)
        with torch.no_grad():
            _adam_step(params, grads, mu, nu, count, lr)
    with torch.no_grad():
        implied = _implied_marginals(*params)
    return {
        "Qs": Qs,
        "log_abc": tuple(p.cpu().numpy() for p in params),
        "mean": X.mean(axis=0, keepdims=True),
        "final_loss": float("nan") if loss is None else float(loss.detach()),
        "data_eigs": tuple(d.cpu().numpy() for d in eigs),
        "implied_eigs": tuple(m.cpu().numpy() for m in implied),
    }


def sample_tme_draw(fit: dict, seed: int = 0, device=None) -> torch.Tensor:
    """The standard normals of one TME sample: (N, T, C) float32 from a
    ``torch.Generator`` seeded with ``seed`` on ``device``."""
    dev = resolve_device(device)
    shape = tuple(q.shape[0] for q in fit["Qs"])
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)


def sample_tme_apply(fit: dict, eps: torch.Tensor) -> torch.Tensor:
    """A TME sample from standard normals ``eps`` (N, T, C) on its device:
    eps scaled by the model's std, rotated out of the three eigenbases
    (X = eps x1 Q1 x2 Q2 x3 Q3) in true float32, plus the trial mean."""
    dev = eps.device

    def f32(a):
        return torch.as_tensor(np.array(a, np.float32), device=dev)

    la, lb, lc = (f32(v) for v in fit["log_abc"])
    Q1, Q2, Q3 = (f32(q) for q in fit["Qs"])
    s = la.exp()[:, None, None] + lb.exp()[None, :, None] \
        + lc.exp()[None, None, :]
    out = eps * (1.0 / s.sqrt())
    with true_f32():
        out = torch.einsum("ntc,in->itc", out, Q1)
        out = torch.einsum("itc,jt->ijc", out, Q2)
        out = torch.einsum("ijc,kc->ijk", out, Q3)
    return out + f32(fit["mean"])


def sample_tme(fit: dict, n_samples: int | None = None, seed: int = 0,
               device=None) -> torch.Tensor:
    """One surrogate tensor from a fitted TME model, on ``device`` (the
    first CUDA card by default). ``n_samples`` is unused, as in the JAX
    package."""
    del n_samples
    return sample_tme_apply(fit, sample_tme_draw(fit, seed, device))


def tme_surrogate(X, steps: int = 2000, seed: int = 0, device=None):
    """One-call TME surrogate of a (N, T, C) trial tensor: (sample on
    ``device``, fit)."""
    f = fit_tme(X, steps=steps, seed=seed, device=device)
    return sample_tme(f, seed=seed, device=device), f


def mode_shuffle_surrogate(X, rng: np.random.Generator) -> torch.Tensor:
    """Cheap control: independently permute trials per (time, channel) —
    destroys trial structure, preserves per-(t, c) marginals. The
    permutations are ``rng``'s, drawn time-major as the JAX package draws
    them; the gather runs on X's device (numpy X: the CPU)."""
    X = torch.as_tensor(X)
    N, T, C = X.shape
    perms = np.empty((T, C, N), np.int64)
    for t in range(T):
        for c in range(C):
            perms[t, c] = rng.permutation(N)
    idx = torch.as_tensor(perms, device=X.device).permute(2, 0, 1)
    return torch.gather(X, 0, idx)
