"""Cross-patient pooled decoding strategies as one batched fold program.

Port of ``cross_patient_speech_decoding_tpu/decoders/pooled.py``, the
analog of the reference's ``crossPtDecoder`` family:

- ``decode_fold_sep_dimred``: independent PCA per patient, truncated to
  the common latent width, pooled;
- ``decode_fold_sep_align``: independent PCA, then a CCA alignment of each
  source patient into the target's space, pooled (the paper's main path);
- ``decode_fold_joint_pca``: a joint-PCA (LFADS stitching) shared space;
- ``decode_fold_mcca``: a multiview CCA shared space.

Only the target patient is split; the sources give all their trials to
every fold's training pool. The classifier is the kernel ridge machine of
``ops/classifiers.py``.

Where the JAX package vmaps a fold over folds, the port carries folds as
a leading batch dim: a fold function takes (B, N0) train and test masks
and returns (B,) balanced accuracies and (B, N0) predictions over all
target rows. Hyperparameters (``hp``) are scalars or (B,) tensors, one
value per fit. What does not depend on the fold is computed once per
call: a source's PCA is fitted without a mask, so its latents are the same
for every fold, and they reach the batched CCA fit as an ``expand``ed
view. The target's PCA and the CCA fits run as one batch per source
(``fit_cca_aligner`` solves leading dims natively: one Jacobi launch per
source on the card). ``joint_pca_fit`` and ``fit_mcca_aligner`` take one
problem each, so those two strategies loop over the folds of a batch.
"""

from __future__ import annotations

import functools

from dataclasses import dataclass
from typing import NamedTuple, Sequence

import torch

from cross_patient_speech_decoding_tpu_torch.ops.cca import (
    fit_cca_aligner,
    transform_b_to_a,
)
from cross_patient_speech_decoding_tpu_torch.ops.classifiers import (
    bagged_classifier_fit,
    bagged_classifier_predict,
    kernel_classifier_fit,
    kernel_classifier_predict,
    scale_gamma,
)
from cross_patient_speech_decoding_tpu_torch.ops.joint_pca import (
    joint_pca_fit,
    joint_pca_transform,
)
from cross_patient_speech_decoding_tpu_torch.ops.mcca import (
    fit_mcca_aligner,
    mcca_transform,
)
from cross_patient_speech_decoding_tpu_torch.parallel.mesh import (
    map_fold_blocks,
)
from cross_patient_speech_decoding_tpu_torch.ops.metrics import (
    balanced_accuracy,
)
from cross_patient_speech_decoding_tpu_torch.ops.pca import (
    PCAState,
    pca_fit,
    pca_transform,
)


class PatientArrays(NamedTuple):
    """One patient's data on the device.

    X: (N, T, C) trials; y: (N,) decode class ids; y_align: (N,)
    alignment class ids (sequence classes).
    """

    X: torch.Tensor
    y: torch.Tensor
    y_align: torch.Tensor


@dataclass(frozen=True)
class DecodeConfig:
    """Configuration of the fold program.

    n_comp: PCA components (int) or variance fraction (float in (0,1)).
    max_k: latent width (all PCA/CCA widths are masked to this).
    n_classes: decode class-universe size.
    n_align_classes: alignment class-universe size.
    lam: kernel ridge regularisation.
    kernel: 'rbf' or 'linear'.
    tar_in_train: include target train rows in the pooled training set.
    bagging: bootstrap ensemble size of the classifier head (the
        reference's ``BaggingClassifier(SVC linear, 10)``); 0 = a single
        classifier.
    seed: seeds the bootstrap draws.
    """

    n_comp: float | int = 0.8
    max_k: int = 32
    n_classes: int = 9
    n_align_classes: int = 27
    lam: float = 1.0
    kernel: str = "rbf"
    tar_in_train: bool = True
    mcca_regs: float = 0.5
    mcca_pca_var: float = 1.0
    bagging: int = 0
    seed: int = 0


def _fit_pca_latents(X: torch.Tensor, n_comp, max_k: int,
                     sample_mask: torch.Tensor | None = None,
                     low_refit_k: int = 0) -> PCAState:
    """PCA over the flattened (N*T, C) rows of X (N, T, C), with an
    optional (..., N) per-trial mask: a (B, N) mask fits B problems.

    Uses the Gram path: N*T >> C in every caller, so the (C, C)
    covariance eigensolve replaces a tall SVD. ``low_refit_k`` enables the
    CTC datamodules' low-component artifact guard (see
    :func:`~cross_patient_speech_decoding_tpu_torch.ops.pca.pca_fit`).
    """
    N, T, C = X.shape[-3:]
    row_mask = None
    if sample_mask is not None:
        row_mask = torch.repeat_interleave(sample_mask, T, dim=-1)
    return pca_fit(X.reshape(X.shape[:-3] + (N * T, C)), n_comp,
                   max_components=max_k, sample_mask=row_mask, method="gram",
                   low_refit_k=low_refit_k)


def _transform_latents(st: PCAState, X: torch.Tensor,
                       max_k: int) -> torch.Tensor:
    """(N, T, C) trials -> (..., N, T, K) latents through the fitted PCA
    (the state's leading dims lead)."""
    N, T, C = X.shape[-3:]
    out = pca_transform(st, X.reshape(X.shape[:-3] + (N * T, C)))
    return out.reshape(out.shape[:-2] + (N, T, -1))


# public names, as in the JAX package
fit_pca_latents = _fit_pca_latents
transform_latents = _transform_latents


def _pca_latents(X: torch.Tensor, n_comp, max_k: int,
                 sample_mask: torch.Tensor | None = None,
                 low_refit_k: int = 0):
    """A per-patient PCA and its latents: (state, latents (..., N, T, K)),
    each component's sign fixed so that its largest loading is positive.

    A component's sign is free, and the card's and the CPU's eigensolvers
    choose it differently; sepDimRed pools the latents of independent
    PCAs, and a CTC run trains on them, so a flipped column is another
    input (sklearn's PCA fixes its signs too, by ``svd_flip``). The JAX
    package keeps its solver's signs. The fold program and the CTC driver
    (with ``low_refit_k``, see :func:`_fit_pca_latents`) both fit here.
    """
    st = _fit_pca_latents(X, n_comp, max_k, sample_mask, low_refit_k)
    comp = st.components
    lead = comp.gather(-2, comp.abs().argmax(-2, keepdim=True))
    st = st._replace(components=comp * torch.where(lead < 0, -1.0, 1.0))
    return st, _transform_latents(st, X, max_k)


def _lead(mask: torch.Tensor) -> tuple:
    return tuple(mask.shape[:-1])


def _rows(feats: torch.Tensor, lead: tuple) -> torch.Tensor:
    """(..., N, F) features broadcast to the fold batch (a view)."""
    return feats.expand(lead + feats.shape[-2:])


def _tile(mask: torch.Tensor, T: int) -> torch.Tensor:
    """``jnp.tile`` of a (..., K) mask to (..., T*K) along the last axis."""
    return mask.repeat((1,) * (mask.dim() - 1) + (T,))


def _pool_and_classify(tar_feats, tar_y, train_mask, test_mask, cross_feats,
                       cross_ys, cfg: DecodeConfig, feature_mask=None,
                       hp=None):
    """Pool flattened features, fit the classifier, score the target's
    rows. tar_feats (B, N0, F); cross_feats (B or none, Ni, F); masks
    (B, N0). Returns (accs (B,), preds (B, N0))."""
    lead = _lead(train_mask)
    dt = train_mask.dtype
    dev = train_mask.device
    ones = [torch.ones(lead + (f.shape[-2],), dtype=dt, device=dev)
            for f in cross_feats]
    if cfg.tar_in_train:
        X_pool = torch.cat([_rows(tar_feats, lead)]
                           + [_rows(f, lead) for f in cross_feats], dim=-2)
        y_pool = torch.cat([tar_y] + list(cross_ys))
        w_pool = torch.cat([train_mask] + ones, dim=-1)
    else:
        X_pool = torch.cat([_rows(f, lead) for f in cross_feats], dim=-2)
        y_pool = torch.cat(list(cross_ys))
        w_pool = torch.cat(ones, dim=-1)

    hp = hp or {}
    gamma = None
    if "gamma_scale" in hp and cfg.kernel == "rbf":
        gamma = hp["gamma_scale"] * scale_gamma(X_pool, w_pool, feature_mask)
    lam = hp.get("lam", cfg.lam)
    if cfg.bagging > 0:
        # the draw on the host's generator: the card and the CPU get the
        # same bootstrap from one seed
        gen = torch.Generator().manual_seed(cfg.seed)
        clf = bagged_classifier_fit(
            gen, X_pool, y_pool, cfg.n_classes, n_estimators=cfg.bagging,
            kernel=cfg.kernel, lam=lam, gamma=gamma, sample_mask=w_pool,
            feature_mask=feature_mask)
        preds = bagged_classifier_predict(clf, tar_feats, kernel=cfg.kernel)
    else:
        clf = kernel_classifier_fit(
            X_pool, y_pool, cfg.n_classes, gamma=gamma, lam=lam,
            sample_mask=w_pool, feature_mask=feature_mask,
            kernel=cfg.kernel)
        preds = kernel_classifier_predict(clf, tar_feats, kernel=cfg.kernel)
    acc = balanced_accuracy(tar_y, preds, cfg.n_classes, test_mask)
    return acc, preds


def decode_fold_sep_align(tar: PatientArrays, cross: Sequence[PatientArrays],
                          train_mask: torch.Tensor, test_mask: torch.Tensor,
                          cfg: DecodeConfig, hp=None):
    """Folds of the sepAlign strategy (PCA, then a CCA of each source into
    the target's space), batched over the masks' leading dim."""
    hp = hp or {}
    n_comp = hp.get("n_comp", cfg.n_comp)
    lead = _lead(train_mask)
    T = tar.X.shape[1]
    tar_pca, tar_lat = _pca_latents(tar.X, n_comp, cfg.max_k,
                                    train_mask)  # (B, N0, T, K)
    ids_a = tar.y_align.expand(lead + tar.y_align.shape)

    cross_feats, cross_ys = [], []
    for src in cross:
        # no mask: fitted once, the same for every fold (or one per
        # candidate n_comp)
        _, src_lat = _pca_latents(src.X, n_comp, cfg.max_k)
        Ni, _, K = src_lat.shape[-3:]
        aligner = fit_cca_aligner(
            tar_lat, src_lat.expand(lead + src_lat.shape[-3:]), ids_a,
            src.y_align.expand(lead + src.y_align.shape),
            cfg.n_align_classes, mask_a=train_mask)
        aligned = transform_b_to_a(
            aligner, src_lat.reshape(src_lat.shape[:-3] + (Ni * T, K)))
        cross_feats.append(aligned.reshape(lead + (Ni, -1)))
        cross_ys.append(src.y)

    tar_flat = tar_lat.reshape(lead + (tar.X.shape[0], -1))
    return _pool_and_classify(
        tar_flat, tar.y, train_mask, test_mask, cross_feats, cross_ys, cfg,
        feature_mask=_tile(tar_pca.mask, T), hp=hp)


def decode_fold_sep_dimred(tar: PatientArrays, cross: Sequence[PatientArrays],
                           train_mask: torch.Tensor, test_mask: torch.Tensor,
                           cfg: DecodeConfig, hp=None):
    """Folds of the sepDimRed strategy (independent PCA, common width)."""
    hp = hp or {}
    n_comp = hp.get("n_comp", cfg.n_comp)
    lead = _lead(train_mask)
    T = tar.X.shape[1]
    tar_pca, tar_lat = _pca_latents(tar.X, n_comp, cfg.max_k, train_mask)
    srcs = [_pca_latents(s.X, n_comp, cfg.max_k) for s in cross]
    common = tar_pca.n_active
    for p, _ in srcs:
        common = torch.minimum(common, p.n_active)
    cmask = (torch.arange(cfg.max_k, device=tar.X.device)
             < common[..., None]).to(tar.X.dtype)  # (B, K)
    cm = cmask[..., None, None, :]

    tar_lat = tar_lat * cm
    cross_feats, cross_ys = [], []
    for s, (_, lat) in zip(cross, srcs):
        lat = lat * cm
        cross_feats.append(lat.reshape(lat.shape[:-3] + (lat.shape[-3], -1)))
        cross_ys.append(s.y)

    tar_flat = tar_lat.reshape(lead + (tar.X.shape[0], -1))
    return _pool_and_classify(
        tar_flat, tar.y, train_mask, test_mask, cross_feats, cross_ys, cfg,
        feature_mask=_tile(cmask, T), hp=hp)


def _per_fold(fold_one, train_mask, test_mask, hp):
    """Run a one-problem fold function over a (B, N0) batch of masks, one
    fold at a time; ``hp`` values of shape (B,) are split per fold."""
    hp = hp or {}
    accs, preds = [], []
    for b in range(train_mask.shape[0]):
        hp_b = {k: (v[b] if torch.is_tensor(v) and v.dim() else v)
                for k, v in hp.items()}
        a, p = fold_one(train_mask[b:b + 1], test_mask[b:b + 1], hp_b)
        accs.append(a)
        preds.append(p)
    return torch.cat(accs), torch.cat(preds)


def decode_fold_joint_pca(tar: PatientArrays, cross: Sequence[PatientArrays],
                          train_mask: torch.Tensor, test_mask: torch.Tensor,
                          cfg: DecodeConfig, hp=None):
    """Folds of the jointDimRed strategy: the joint space is fitted on the
    target's train trials and all source trials; target rows are projected
    through the target's read-in. One fit per fold (``joint_pca_fit``
    takes one problem)."""
    T = tar.X.shape[1]
    Xs = [tar.X] + [s.X for s in cross]
    ids = [tar.y_align] + [s.y_align for s in cross]

    def one(tr, te, hp_b):
        n_comp = hp_b.get("n_comp", cfg.n_comp)
        st = joint_pca_fit(Xs, ids, cfg.n_align_classes, n_comp,
                           max_components=cfg.max_k,
                           sample_masks=[tr[0]] + [None] * len(cross))
        tar_lat = joint_pca_transform(st, tar.X, 0)
        cross_feats = [
            joint_pca_transform(st, s.X, i + 1).reshape(s.X.shape[0], -1)
            for i, s in enumerate(cross)]
        k_mask = (torch.arange(tar_lat.shape[-1], device=tar.X.device)
                  < st.n_active).to(tar.X.dtype)
        return _pool_and_classify(
            tar_lat.reshape(1, tar_lat.shape[0], -1), tar.y, tr, te,
            cross_feats, [s.y for s in cross], cfg,
            feature_mask=_tile(k_mask, T)[None], hp=_unsqueeze(hp_b))

    return _per_fold(one, train_mask, test_mask, hp)


def decode_fold_mcca(tar: PatientArrays, cross: Sequence[PatientArrays],
                     train_mask: torch.Tensor, test_mask: torch.Tensor,
                     cfg: DecodeConfig, hp=None):
    """Folds of the MCCA strategy: all views (target train and sources)
    aligned into the shared MCCA space; target rows projected through the
    target's loading. ``n_comp`` must be a count for MCCA (10 when the
    config gives a fraction). One fit per fold."""
    n_comp = (int(cfg.n_comp) if not isinstance(cfg.n_comp, float)
              or cfg.n_comp >= 1 else 10)
    Xs = [tar.X] + [s.X for s in cross]
    ids = [tar.y_align] + [s.y_align for s in cross]

    def one(tr, te, hp_b):
        st = fit_mcca_aligner(
            Xs, ids, cfg.n_align_classes, n_comp, regs=cfg.mcca_regs,
            pca_var=cfg.mcca_pca_var,
            sample_masks=[tr[0]] + [None] * len(cross))
        tar_lat = mcca_transform(st, tar.X, 0)
        cross_feats = [
            mcca_transform(st, s.X, i + 1).reshape(s.X.shape[0], -1)
            for i, s in enumerate(cross)]
        return _pool_and_classify(
            tar_lat.reshape(1, tar_lat.shape[0], -1), tar.y, tr, te,
            cross_feats, [s.y for s in cross], cfg, hp=_unsqueeze(hp_b))

    return _per_fold(one, train_mask, test_mask, hp)


def _unsqueeze(hp: dict) -> dict:
    """One fold's hyperparameters as a batch of one."""
    return {k: (v.reshape(1) if torch.is_tensor(v) else v)
            for k, v in hp.items()}


_STRATEGIES = {
    "sep_align": decode_fold_sep_align,
    "sep_dimred": decode_fold_sep_dimred,
    "joint_pca": decode_fold_joint_pca,
    "mcca": decode_fold_mcca,
}


def make_cv_decoder(strategy: str, cfg: DecodeConfig, fold_batch: int = 0,
                    mesh=None, fold_axis: str = "data",
                    return_preds: bool = False):
    """A CV decoder: (tar, cross, train_masks, test_masks) -> accs.

    ``train_masks``/``test_masks`` are (n_folds, N0) tensors on the data's
    device. The folds run as one batch, or, with ``fold_batch > 0``, in
    chunks of that many (each fold solves an (N_pool, N_pool) system).
    With ``return_preds=True`` the decoder returns ``(accs, preds)``,
    ``preds`` (n_folds, N0) labels over all target rows (the caller picks
    the test rows with its masks).

    With ``mesh`` (``parallel.make_mesh``) the fold axis is sharded over
    its ranks (``fold_axis`` is the mesh's one axis): the folds are padded
    to a multiple of the world size by repeating leading folds (JAX pads
    zero masks; either pad is sliced away), each rank decodes its
    contiguous block of folds in ``fold_batch`` chunks, and the
    accuracies (and predictions) are gathered, so every rank returns all
    of them. Folds are independent, so nothing else crosses ranks.
    """
    fold_fn = _STRATEGIES[strategy]

    def run_local(tar, cross, train_masks, test_masks):
        n = train_masks.shape[0]
        step = fold_batch if fold_batch and n > fold_batch else n
        accs, preds = [], []
        for i in range(0, n, step):
            a, p = fold_fn(tar, tuple(cross), train_masks[i:i + step],
                           test_masks[i:i + step], cfg)
            accs.append(a)
            preds.append(p)
        return torch.cat(accs), torch.cat(preds)

    def run(tar, cross, train_masks, test_masks):
        if mesh is None:
            accs, preds = run_local(tar, cross, train_masks, test_masks)
        else:
            accs, preds = map_fold_blocks(
                functools.partial(run_local, tar, cross), mesh, train_masks,
                test_masks)
        return (accs, preds) if return_preds else accs

    return run
