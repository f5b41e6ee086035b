"""Latent-space clustering scores and embeddings (fig_2 machinery).

Port of ``cross_patient_speech_decoding_tpu/analysis/cluster.py``. The
reference's fig_2 notebook scores latent spaces with sklearn's
``silhouette_samples`` (averaged over positive samples only, its custom
``silhouette_scorer``), ``calinski_harabasz_score`` and
``davies_bouldin_score`` on t-SNE / PCA embeddings, 50 iterations against
shuffled-label chance distributions (`figure_analyses/fig_2.ipynb` cells
29-44). Here the O(N^2) geometry runs on the device: pairwise distances,
one-hot cluster reductions, and an exact t-SNE whose affinity products are
true float32 matmuls (``ops/precision.py:hdot``).

Every public function takes host arrays or tensors and returns numpy. It
runs on ``device`` (default: the first CUDA card; raises without one
unless ``device='cpu'``).

The t-SNE loop is a host loop of small tensor ops per iteration (the JAX
package fuses it into one jitted ``fori_loop``). Its initial embedding is
drawn from a host ``torch.Generator`` (``_tsne_y0``) and applied by
``_tsne_run``, so the card and the CPU start from the same points.
"""

from __future__ import annotations

import numpy as np
import torch

from cross_patient_speech_decoding_tpu_torch.ops.precision import hdot
from cross_patient_speech_decoding_tpu_torch.utils.device import (
    resolve_device,
)


def pairwise_sq_dists(x: torch.Tensor, y: torch.Tensor | None = None):
    """Squared euclidean distance matrix via one true float32 product.

    One shared implementation with the classifier kernels
    (``ops/classifiers.py:_sq_dists``): the |x|^2 + |y|^2 - 2xy expansion
    is cancellative at reduced precision, and that caveat lives in ONE
    place."""
    from cross_patient_speech_decoding_tpu_torch.ops.classifiers import (
        _sq_dists,
    )

    return _sq_dists(x, x if y is None else y)


def _on(x, dev) -> torch.Tensor:
    """``x`` as float32 on ``dev``."""
    if torch.is_tensor(x):
        return x.to(dev, torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=dev)


def _dense_labels(labels, dev):
    """(dense int64 labels on ``dev``, number of clusters)."""
    if torch.is_tensor(labels):
        labels = labels.cpu().numpy()
    _, dense = np.unique(np.asarray(labels), return_inverse=True)
    dense = dense.ravel()
    return torch.as_tensor(dense, dtype=torch.int64, device=dev), \
        int(dense.max()) + 1


def _silhouette_samples(x, labels, n_clusters: int):
    d = torch.sqrt(pairwise_sq_dists(x))
    onehot = torch.nn.functional.one_hot(labels, n_clusters).to(x.dtype)
    counts = onehot.sum(0)  # (K,)
    sums = hdot(d, onehot)  # (N, K) summed distance into each cluster
    own = counts[labels]  # cluster size of each sample
    intra_sum = sums.gather(1, labels[:, None])[:, 0]
    a = intra_sum / (own - 1.0).clamp(min=1.0)
    mean_other = sums / counts.clamp(min=1.0)[None, :]
    # exclude own cluster and empty clusters from the min
    blocked = onehot.bool() | (counts == 0)[None, :]
    b = torch.where(blocked, torch.inf, mean_other).amin(1)
    s = (b - a) / torch.maximum(a, b).clamp(min=1e-30)
    return torch.where(own <= 1.0, 0.0, s)  # sklearn: singletons -> 0


def silhouette_samples(x, labels, device=None) -> np.ndarray:
    """Per-sample silhouette coefficients (sklearn semantics)."""
    dev = resolve_device(device)
    lab, k = _dense_labels(labels, dev)
    return _silhouette_samples(_on(x, dev), lab, k).cpu().numpy()


def silhouette_positive_mean(x, labels, device=None) -> float:
    """The reference's ``silhouette_scorer``: mean of the *positive*
    silhouette samples only (fig_2 cell 29)."""
    s = silhouette_samples(x, labels, device)
    pos = s[s > 0]
    return float(pos.mean()) if pos.size else float("nan")


def _ch_db(x, labels, n_clusters: int):
    onehot = torch.nn.functional.one_hot(labels, n_clusters).to(x.dtype)
    counts = onehot.sum(0)
    centroids = hdot(onehot.T, x) / counts.clamp(min=1.0)[:, None]
    grand = x.mean(0)
    n = x.shape[0]
    # Calinski-Harabasz
    between = (counts * ((centroids - grand) ** 2).sum(-1)).sum()
    resid = ((x - centroids[labels]) ** 2).sum(-1)
    within_sq = resid.sum()
    ch = (between / max(n_clusters - 1, 1)) / (
        within_sq.clamp(min=1e-30) / max(n - n_clusters, 1))
    # Davies-Bouldin
    dist_to_centroid = torch.sqrt(resid.clamp(min=0.0))
    s = hdot(dist_to_centroid[None, :], onehot)[0] / counts.clamp(min=1.0)
    m = torch.sqrt(pairwise_sq_dists(centroids))
    r = (s[:, None] + s[None, :]) / torch.where(m > 0, m, torch.inf)
    eye = torch.eye(n_clusters, dtype=torch.bool, device=x.device)
    db = torch.where(eye, -torch.inf, r).amax(1).mean()
    return ch, db


def calinski_harabasz(x, labels, device=None) -> float:
    """sklearn ``calinski_harabasz_score`` (fig_2 cluster scores)."""
    dev = resolve_device(device)
    lab, k = _dense_labels(labels, dev)
    return float(_ch_db(_on(x, dev), lab, k)[0])


def davies_bouldin(x, labels, device=None) -> float:
    """sklearn ``davies_bouldin_score`` (fig_2 cluster scores)."""
    dev = resolve_device(device)
    lab, k = _dense_labels(labels, dev)
    return float(_ch_db(_on(x, dev), lab, k)[1])


def pca_embed(x, n_components: int = 2, device=None) -> np.ndarray:
    """Centered PCA embedding (the fig_2 `PCA(n_components=2)` path), each
    component's sign fixed so that its largest loading is positive (the
    port's rule, ``decoders/pooled.py:_pca_latents``; the JAX package
    keeps its solver's signs)."""
    from cross_patient_speech_decoding_tpu_torch.ops.pca import (
        pca_fit_transform,
    )

    dev = resolve_device(device)
    st, z = pca_fit_transform(_on(x, dev), n_components)
    comp = st.components[:, :n_components]
    lead = comp.gather(0, comp.abs().argmax(0, keepdim=True))[0]
    return (z[:, :n_components] * torch.where(lead < 0, -1.0, 1.0)).cpu() \
        .numpy()


# ---------------------------------------------------------------------------
# t-SNE
# ---------------------------------------------------------------------------


def _conditional_probs(d2: torch.Tensor, perplexity: float,
                       n_steps: int = 60):
    """Per-row binary search of the Gaussian bandwidth to hit perplexity."""
    n = d2.shape[0]
    target = float(np.log(perplexity))
    mask = ~torch.eye(n, dtype=torch.bool, device=d2.device)

    def entropy_and_p(beta):
        logits = torch.where(mask, -d2 * beta[:, None], -torch.inf)
        p = torch.softmax(logits, dim=1)
        h = -torch.where(p > 0, p * torch.log(p), 0.0).sum(1)
        return h, p

    beta = torch.ones(n, dtype=d2.dtype, device=d2.device)
    lo = torch.zeros_like(beta)
    hi = torch.full_like(beta, torch.inf)
    for _ in range(n_steps):
        h, _ = entropy_and_p(beta)
        too_high = h > target  # entropy too high -> increase beta
        lo = torch.where(too_high, beta, lo)
        hi = torch.where(too_high, hi, beta)
        beta = torch.where(torch.isinf(hi), beta * 2.0, 0.5 * (lo + hi))
    return entropy_and_p(beta)[1]


def _tsne_step(y, vel, gains, p, off, momentum: float, lr: float):
    """One gradient-descent step of the KL divergence with momentum and
    adaptive gains: (y, vel, gains) -> their next values, y centred."""
    w = off / (1.0 + pairwise_sq_dists(y))  # student-t kernel
    q = w / w.sum().clamp(min=1e-12)
    pq = (p - q) * w
    # grad_i = 4 * sum_j pq_ij (y_i - y_j)
    g = 4.0 * (y * pq.sum(1, keepdim=True) - hdot(pq, y))
    same_sign = torch.sign(g) == torch.sign(vel)
    gains = torch.where(same_sign, gains * 0.8, gains + 0.2).clamp(min=0.01)
    vel = momentum * vel - lr * gains * g
    y = y + vel
    return y - y.mean(0), vel, gains


def _tsne_run(p_sym: torch.Tensor, y0: torch.Tensor, n_iter: int,
              exaggeration_iters: int, lr: float) -> torch.Tensor:
    """``n_iter`` steps (:func:`_tsne_step`) from ``y0``: the first
    ``exaggeration_iters`` on 12 x P at momentum 0.5, then on P at 0.8 (the
    JAX package's jitted loop, one host iteration a step)."""
    n = p_sym.shape[0]
    off = 1.0 - torch.eye(n, dtype=p_sym.dtype, device=p_sym.device)
    p_ex = p_sym * 12.0
    y, vel, gains = y0, torch.zeros_like(y0), torch.ones_like(y0)
    for i in range(n_iter):
        early = i < exaggeration_iters
        y, vel, gains = _tsne_step(y, vel, gains, p_ex if early else p_sym,
                                   off, 0.5 if early else 0.8, lr)
    return y


def _tsne_y0(n: int, n_components: int, seed: int) -> torch.Tensor:
    """The initial embedding, 1e-4 x a standard normal (n, n_components)
    drawn on the host from ``seed``: the same on every device."""
    gen = torch.Generator().manual_seed(seed)
    return 1e-4 * torch.randn(n, n_components, generator=gen)


def _tsne_p(x: torch.Tensor, perplexity: float) -> torch.Tensor:
    """The symmetrised input affinities P of ``x`` (N, F)."""
    n = x.shape[0]
    p_cond = _conditional_probs(pairwise_sq_dists(x), perplexity)
    p_sym = (p_cond + p_cond.T) / (2.0 * n)
    return p_sym.clamp(min=1e-12)


def tsne_embed(x, n_components: int = 2, *, perplexity: float = 30.0,
               n_iter: int = 500, learning_rate: float | str = "auto",
               seed: int = 0, device=None) -> np.ndarray:
    """t-SNE embedding on the device: affinities, KL gradient and the
    gradient-descent loop (the fig_2 ``TSNE(n_components=2,
    perplexity=30)`` replacement).

    Standard formulation (van der Maaten & Hinton 2008): symmetrized
    conditional Gaussians -> student-t low-dim kernel, early exaggeration
    x12 for the first quarter of iterations, adaptive per-dim gains.
    """
    dev = resolve_device(device)
    x = _on(x, dev)
    n = x.shape[0]
    perplexity = min(perplexity, (n - 1) / 3.0)
    if learning_rate == "auto":  # sklearn heuristic: n / early_exag / 4
        learning_rate = max(n / 48.0, 50.0)
    p_sym = _tsne_p(x, perplexity)
    y0 = _tsne_y0(n, n_components, seed).to(dev)
    y = _tsne_run(p_sym, y0, n_iter, max(50, n_iter // 4), learning_rate)
    return y.cpu().numpy()
