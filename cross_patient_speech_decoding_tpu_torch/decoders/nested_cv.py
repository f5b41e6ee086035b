"""Nested cross-validation hyperparameter search, the BayesSearchCV analog.

Port of ``cross_patient_speech_decoding_tpu/decoders/nested_cv.py``. The
reference tunes its classical pipeline with
``BayesSearchCV(n_iter=25, n_points=5)`` inside every outer fold. Here the
tuned hyperparameters (the PCA variance fraction, the ridge strength, the
RBF bandwidth scale) are per-fit tensors of the fold program, so a table
of candidates x inner folds runs as one batch of fits: the JAX package's
``vmap x vmap`` becomes a leading batch dim of the masks and the
hyperparameters (``decoders/pooled.py``). The TPE proposals stay on the
host (``sweep/bayes.py``), as in the JAX package, and the numpy draws of
the splits and proposals are the JAX package's, call for call.

With ``mesh=`` the outer folds are sharded over the mesh's ranks
(``parallel.mesh.map_fold_blocks``): each rank scores and refits its
contiguous block of outer folds, padded by repeated folds to a multiple
of the world size, and the results are gathered. Each rank keeps the
``fit_batch`` chunking of its block, where JAX's mesh path drops it.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from cross_patient_speech_decoding_tpu_torch.data.splits import (
    stratified_kfold_masks,
    stratified_train_subsample_masks,
)
from cross_patient_speech_decoding_tpu_torch.decoders.pooled import (
    _STRATEGIES,
    DecodeConfig,
    PatientArrays,
)
from cross_patient_speech_decoding_tpu_torch.parallel.mesh import (
    map_fold_blocks,
)
from cross_patient_speech_decoding_tpu_torch.sweep.bayes import (
    Float,
    TPESampler,
    sample_random,
)
from cross_patient_speech_decoding_tpu_torch.utils.device import (
    resolve_device,
)

def _on(a, dev) -> torch.Tensor:
    """Host masks or hyperparameter values as float32 on ``dev``."""
    return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)


def sample_candidates(n: int, seed: int = 0, n_comp_range=(0.5, 0.99),
                      lam_range=(1e-3, 1e2), gamma_scale_range=(0.1, 10.0),
                      device=None):
    """Random candidate table (the reference's search space: the PCA
    ``n_components`` and the SVC's C and gamma analogs) as float32
    tensors of shape (n,) on ``device`` (the first CUDA card by default)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    vals = {
        "n_comp": rng.uniform(*n_comp_range, n),
        "lam": np.exp(rng.uniform(*np.log(lam_range), n)),
        "gamma_scale": np.exp(rng.uniform(*np.log(gamma_scale_range), n)),
    }
    return {k: _on(v, dev) for k, v in vals.items()}


def inner_cv_masks(train_mask: np.ndarray, y: np.ndarray, n_inner: int,
                   rng: np.random.Generator):
    """Split one outer fold's train set into inner folds: (inner_tr,
    inner_te) masks (n_inner, N) over the full trial axis; rows outside
    the outer train set are excluded everywhere. Stratified on ``y``,
    with the plain-KFold fallback of ``stratified_kfold_masks``."""
    idx = np.where(train_mask > 0)[0]
    _, sub_te = stratified_kfold_masks(np.asarray(y)[idx], n_inner, rng)
    inner_te = np.zeros((n_inner, len(train_mask)))
    inner_te[:, idx] = sub_te
    inner_tr = train_mask[None, :] - inner_te
    return inner_tr, inner_te


def _scores(fold_fn, cfg, tar, cross, itr, ite, hp):
    """Mean inner accuracy of each candidate: masks (b, I, N), hp values
    (b, P) -> (b, P), all b*P*I fits as one batch."""
    b, n_inner, n = itr.shape
    n_points = next(iter(hp.values())).shape[1]
    shape = (b, n_points, n_inner)
    tr = itr[:, None].expand(shape + (n,)).reshape(-1, n)
    te = ite[:, None].expand(shape + (n,)).reshape(-1, n)
    hp_flat = {k: v[..., None].expand(shape).reshape(-1)
               for k, v in hp.items()}
    acc, _ = fold_fn(tar, cross, tr, te, cfg, hp=hp_flat)
    return acc.reshape(shape).mean(-1)


def make_nested_cv_decoder(strategy: str, cfg: DecodeConfig,
                           n_candidates: int = 25, n_inner: int = 5,
                           candidate_batch: int = 5, seed: int = 0,
                           device=None):
    """A nested-CV decoder over a fixed random candidate table.

    Returns ``(run, candidates)``: run(tar, cross, train_masks,
    test_masks, inner_tr, inner_te) -> (accs (n_outer,), best_idx
    (n_outer,)), where inner_tr/inner_te are (n_outer, n_inner, N) mask
    stacks from :func:`inner_cv_masks`. Per outer fold the candidates are
    scored ``candidate_batch`` at a time (each with all inner folds in the
    batch), the best (first maximum of the mean inner accuracy) is refitted
    on the outer split.
    """
    fold_fn = _STRATEGIES[strategy]
    candidates = sample_candidates(n_candidates, seed, device=device)

    def run(tar, cross, train_masks, test_masks, inner_tr, inner_te):
        cross = tuple(cross)
        accs, best = [], []
        for k in range(train_masks.shape[0]):
            scores = []
            for c in range(0, n_candidates, candidate_batch):
                hp = {name: v[None, c:c + candidate_batch]
                      for name, v in candidates.items()}
                scores.append(_scores(fold_fn, cfg, tar, cross,
                                      inner_tr[k:k + 1], inner_te[k:k + 1],
                                      hp)[0])
            b = torch.argmax(torch.cat(scores))
            acc, _ = fold_fn(tar, cross, train_masks[k:k + 1],
                             test_masks[k:k + 1], cfg,
                             hp={name: v[b].reshape(1)
                                 for name, v in candidates.items()})
            accs.append(acc)
            best.append(b.reshape(1))
        return torch.cat(accs), torch.cat(best)

    return run, candidates


def make_candidate_scorer(strategy: str, cfg: DecodeConfig,
                          fit_batch: int = 100, mesh=None,
                          fold_axis: str = "data"):
    """``(score, final_eval)`` of the nested search.

    score(tar, cross, inner_tr, inner_te, hp_table) -> (n_outer, P) mean
    inner accuracies of a table of candidates (dict of (n_outer, P)
    tensors). ``fit_batch`` bounds the fits of one batch: outer folds are
    taken max(1, fit_batch // (P * n_inner)) at a time, each batch all
    their candidates and inner folds at once (one Jacobi launch per source
    on the card for sep_align).

    final_eval(tar, cross, train_masks, test_masks, hp_best) -> (accs
    (n_outer,), preds (n_outer, N)): each outer fold refitted at its best
    hyperparameters (dict of (n_outer,) tensors), min(n_outer, fit_batch)
    folds a batch.

    With ``mesh`` the outer-fold axis of both is sharded over its ranks
    (``fold_axis`` is the mesh's one axis), padded by repeating leading
    folds when it does not divide the world size; each rank batches its
    block by ``fit_batch`` as above, and every rank returns all folds.
    """
    fold_fn = _STRATEGIES[strategy]

    def score_local(tar, cross, inner_tr, inner_te, hp_table):
        cross = tuple(cross)
        n_outer, n_inner = inner_tr.shape[:2]
        n_points = next(iter(hp_table.values())).shape[1]
        bs = max(1, fit_batch // max(1, n_points * n_inner))
        out = [
            _scores(fold_fn, cfg, tar, cross, inner_tr[o:o + bs],
                    inner_te[o:o + bs],
                    {k: v[o:o + bs] for k, v in hp_table.items()})
            for o in range(0, n_outer, bs)]
        return torch.cat(out)

    def final_local(tar, cross, train_masks, test_masks, hp_best):
        cross = tuple(cross)
        n = train_masks.shape[0]
        bs = min(n, max(1, fit_batch))
        accs, preds = [], []
        for o in range(0, n, bs):
            a, p = fold_fn(tar, cross, train_masks[o:o + bs],
                           test_masks[o:o + bs], cfg,
                           hp={k: v[o:o + bs] for k, v in hp_best.items()})
            accs.append(a)
            preds.append(p)
        return torch.cat(accs), torch.cat(preds)

    if mesh is None:
        return score_local, final_local

    def score(tar, cross, inner_tr, inner_te, hp_table):
        return map_fold_blocks(
            lambda *folds: score_local(tar, cross, *folds), mesh, inner_tr,
            inner_te, hp_table)

    def final_eval(tar, cross, train_masks, test_masks, hp_best):
        return map_fold_blocks(
            lambda *folds: final_local(tar, cross, *folds), mesh,
            train_masks, test_masks, hp_best)

    return score, final_eval


def _cached_scorer(strategy: str, cfg: DecodeConfig, fit_batch: int,
                   mesh=None):
    """The scorer pair of :func:`make_candidate_scorer`. The JAX package
    caches one jitted pair per configuration to avoid retracing every
    iteration; the port runs eagerly and has nothing to cache, so this
    builds the pair each call under the same name."""
    return make_candidate_scorer(strategy, cfg, fit_batch, mesh=mesh)


def nested_cv_decode_bayes(
    tar: PatientArrays,
    cross: Sequence[PatientArrays],
    cfg: DecodeConfig,
    n_folds: int = 20,
    n_rounds: int = 5,
    n_points: int = 5,
    n_inner: int = 5,
    strategy: str = "sep_align",
    seed: int = 0,
    train_frac: float = 1.0,
    return_preds: bool = False,
    fit_batch: int = 100,
    mesh=None,
):
    """Nested CV with sequential TPE acquisition, the analog of the
    reference's ``BayesSearchCV(n_iter=25, n_points=5)``: ``n_rounds``
    rounds of ``n_points`` candidates per outer fold, each round proposed
    from that fold's inner-CV history (random in the first round). Every
    round scores the whole (n_folds x n_points) table in batches of
    ``fit_batch`` fits; the best candidate of each outer fold (the first
    best of its history) is refitted on its outer split.

    ``train_frac < 1`` subsamples the target's train split per outer fold,
    stratified, before the search (the reference's ``-tss``).

    With ``mesh`` the outer folds of the scoring and of the refit are
    sharded over its ranks (:func:`make_candidate_scorer`); the TPE
    proposals stay on the host, the same on every rank.

    Runs on the data's device. Returns (accs (n_folds,) numpy, best_hp
    dict of (n_folds,) float32 tensors), and with ``return_preds`` also
    preds (n_folds, N) numpy over all target rows and the test masks.
    """
    dev = tar.X.device
    space = {
        "n_comp": Float(0.5, 0.99),
        "lam": Float(1e-3, 1e2, log=True),
        "gamma_scale": Float(0.1, 10.0, log=True),
    }
    rng = np.random.default_rng(seed)
    y = tar.y.cpu().numpy()
    tr, te = stratified_kfold_masks(y, n_folds, rng)
    if train_frac < 1.0:
        tr = stratified_train_subsample_masks(tr, y, train_frac, rng)
    itr = np.zeros((n_folds, n_inner, len(y)))
    ite = np.zeros((n_folds, n_inner, len(y)))
    for k in range(n_folds):
        itr[k], ite[k] = inner_cv_masks(tr[k], y, n_inner, rng)

    score, final_eval = _cached_scorer(strategy, cfg, fit_batch, mesh=mesh)
    cross = tuple(cross)
    itr_d, ite_d = _on(itr, dev), _on(ite, dev)

    history = [[] for _ in range(n_folds)]  # per fold: [(cfg, -acc)]
    samplers = [TPESampler(space, seed=seed + 1 + k) for k in range(n_folds)]
    names = list(space)
    for rnd in range(n_rounds):
        round_cfgs = []
        for k in range(n_folds):
            if rnd == 0:
                round_cfgs.append(sample_random(space, n_points, rng))
            else:
                round_cfgs.append(
                    samplers[k].fit(history[k]).propose(n_points))
        hp_table = {
            name: _on([[c[name] for c in row] for row in round_cfgs], dev)
            for name in names
        }
        accs = score(tar, cross, itr_d, ite_d, hp_table).cpu().numpy()
        for k in range(n_folds):
            history[k].extend(
                (c, -float(a)) for c, a in zip(round_cfgs[k], accs[k]))

    best = [min(h, key=lambda cm: cm[1])[0] for h in history]
    hp_best = {name: _on([b[name] for b in best], dev) for name in names}
    accs, preds = final_eval(tar, cross, _on(tr, dev), _on(te, dev), hp_best)
    accs = accs.cpu().numpy()
    if return_preds:
        return accs, hp_best, preds.cpu().numpy(), te
    return accs, hp_best


def nested_cv_decode(
    tar: PatientArrays,
    cross: Sequence[PatientArrays],
    cfg: DecodeConfig,
    n_folds: int = 20,
    n_candidates: int = 25,
    n_inner: int = 5,
    strategy: str = "sep_align",
    seed: int = 0,
    mesh=None,
):
    """Masks, then nested CV over a random candidate table: (accs,
    best candidate index per outer fold, the candidates), the first two
    as numpy. With ``mesh`` the outer folds are sharded over its ranks as
    in :func:`make_candidate_scorer` (an extension: JAX's takes no
    mesh)."""
    rng = np.random.default_rng(seed)
    y = tar.y.cpu().numpy()
    tr, te = stratified_kfold_masks(y, n_folds, rng)
    itr = np.zeros((n_folds, n_inner, len(y)))
    ite = np.zeros((n_folds, n_inner, len(y)))
    for k in range(n_folds):
        itr[k], ite[k] = inner_cv_masks(tr[k], y, n_inner, rng)

    dev = tar.X.device
    run, cands = make_nested_cv_decoder(strategy, cfg, n_candidates,
                                        n_inner, seed=seed, device=dev)
    folds = (_on(tr, dev), _on(te, dev), _on(itr, dev), _on(ite, dev))
    if mesh is None:
        accs, best = run(tar, tuple(cross), *folds)
    else:
        accs, best = map_fold_blocks(
            lambda *f: run(tar, tuple(cross), *f), mesh, *folds)
    return accs.cpu().numpy(), best.cpu().numpy(), cands
