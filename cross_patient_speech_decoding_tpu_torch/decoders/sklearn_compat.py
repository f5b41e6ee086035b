"""sklearn-surface compatibility estimators backed by the port's ops.

Port of ``cross_patient_speech_decoding_tpu/decoders/sklearn_compat.py``.
The reference exposes its decoders as ``sklearn.base.BaseEstimator``
subclasses so that they compose with Pipelines and ``BayesSearchCV``;
these classes keep that surface (constructor signatures, ``fit(X, y,
y_align=...)``, ``predict``/``score``, ``get_params``/``set_params`` paths
such as ``dimredreshape__n_components``) while the math runs through the
port's PCA, CCA, MCCA and joint PCA.

They are the compatibility rim: one decoder fit per call, numpy at the
boundary. The fast path is ``decoders.pooled.make_cv_decoder``. Each
estimator takes one more constructor argument than the JAX package's,
``device`` (the first CUDA card when None), which ``get_params`` lists.
This is the only module of the port that imports scikit-learn;
``decoders/__init__.py`` exports its classes lazily.
"""

from __future__ import annotations

import numpy as np
import torch
from sklearn.base import BaseEstimator

from cross_patient_speech_decoding_tpu_torch.ops.cca import (
    fit_cca_aligner,
    transform_b_to_a,
)
from cross_patient_speech_decoding_tpu_torch.ops.joint_pca import (
    joint_pca_fit,
    joint_pca_transform,
)
from cross_patient_speech_decoding_tpu_torch.ops.mcca import (
    fit_mcca_aligner,
    mcca_transform,
)
from cross_patient_speech_decoding_tpu_torch.ops.pca import (
    pca_fit,
    pca_transform,
)
from cross_patient_speech_decoding_tpu_torch.utils.device import (
    resolve_device,
)
from cross_patient_speech_decoding_tpu_torch.utils.labels import (
    encode_label_sequences,
    to_class_ids,
)


def _t(a, dev, dtype=torch.float32):
    """numpy (or array-like) -> tensor on ``dev``."""
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)


def _np(t) -> np.ndarray:
    return t.cpu().numpy()


def _align_ids(*label_arrays):
    """Common compact id space across datasets' alignment labels."""
    encoded = [encode_label_sequences(np.asarray(y)) for y in label_arrays]
    universe = np.unique(np.concatenate(encoded))
    return [to_class_ids(e, universe)[0] for e in encoded], len(universe)


class NoCenterPCA(BaseEstimator):
    """sklearn-style PCA without mean centering (reference NoCenterPCA)."""

    def __init__(self, n_components=None, device=None):
        self.n_components = n_components
        self.device = device

    def fit(self, X, y=None):
        dev = resolve_device(self.device)
        self._state = pca_fit(_t(X, dev), self.n_components, center=False)
        self.n_components_ = int(self._state.n_active)
        self.components_ = _np(
            self._state.components[:, : self.n_components_]).T
        return self

    def transform(self, X):
        t = pca_transform(self._state, _t(X, self._state.mean.device))
        return _np(t[:, : self.n_components_])

    def fit_transform(self, X, y=None):
        return self.fit(X).transform(X)


class JaxPCA(BaseEstimator):
    """sklearn.decomposition.PCA drop-in backed by ``ops.pca`` (the JAX
    package's name, kept so that scripts swap the import only)."""

    def __init__(self, n_components=None, device=None):
        self.n_components = n_components
        self.device = device

    def fit(self, X, y=None):
        dev = resolve_device(self.device)
        self._state = pca_fit(_t(X, dev), self.n_components)
        self.n_components_ = int(self._state.n_active)
        self.mean_ = _np(self._state.mean)
        self.components_ = _np(
            self._state.components[:, : self.n_components_]).T
        return self

    def transform(self, X):
        t = pca_transform(self._state, _t(X, self._state.mean.device))
        return _np(t[:, : self.n_components_])

    def fit_transform(self, X, y=None):
        return self.fit(X).transform(X)



class DimRedReshape(BaseEstimator):
    """Flatten (N, ...) -> (N, -1) around any reducer (reference
    DimRedReshape) so 3-D trial tensors work inside sklearn Pipelines."""

    def __init__(self, dim_red=None, n_components=None, device=None):
        self.dim_red = dim_red
        self.n_components = n_components
        self.device = device

    def _reducer(self):
        if self.dim_red is None:
            return JaxPCA(n_components=self.n_components,
                          device=self.device)
        return self.dim_red(n_components=self.n_components)

    def fit(self, X, y=None):
        X = np.asarray(X)
        self._fitted = self._reducer().fit(X.reshape(X.shape[0], -1))
        return self

    def transform(self, X):
        X = np.asarray(X)
        return self._fitted.transform(X.reshape(X.shape[0], -1))

    def fit_transform(self, X, y=None):
        return self.fit(X).transform(X)


class AlignCCA(BaseEstimator):
    """Reference ``AlignCCA`` surface (fit(X_a, X_b, y_a, y_b) /
    transform(X)) backed by ``ops.cca``: type='class' (the mode every
    reference pipeline uses), return_space='b_to_a', the rank-robust
    'gram' route for user data of unknown rank."""

    def __init__(self, type="class", return_space="b_to_a", device=None):
        self.type = type
        self.return_space = return_space
        self.device = device

    def fit(self, X_a, X_b, y_a, y_b):
        dev = resolve_device(self.device)
        (ids_a, ids_b), n_cls = _align_ids(y_a, y_b)
        self._aligner = fit_cca_aligner(
            _t(X_a, dev), _t(X_b, dev), _t(ids_a, dev, torch.int64),
            _t(ids_b, dev, torch.int64), n_cls, method="gram")
        al = self._aligner.alignment
        self.canon_corrs = _np(al.canon_corrs)[: int(al.d)]
        return self

    def transform(self, X):
        dev = self._aligner.shared_mask.device
        return _np(transform_b_to_a(self._aligner, _t(X, dev)))


class _CrossPtBase(BaseEstimator):
    """fit/predict/score contract of the reference crossPtDecoder base."""

    def fit(self, X, y, **kwargs):
        X_p, y_p = self.preprocess_train(np.asarray(X), np.asarray(y),
                                         **kwargs)
        return self.decoder.fit(X_p, y_p)

    def predict(self, X):
        return self.decoder.predict(self.preprocess_test(np.asarray(X)))

    def score(self, X, y, **kwargs):
        return self.decoder.score(self.preprocess_test(np.asarray(X)), y,
                                  **kwargs)


def _pca_lat(X, n_comp, dev):
    """Per-patient PCA over flattened (N*T, C) -> (state, (N, T, K))."""
    flat = _t(X.reshape(-1, X.shape[-1]), dev)
    st = pca_fit(flat, n_comp)
    return st, _np(pca_transform(st, flat)).reshape(X.shape[0],
                                                    X.shape[1], -1)


class CrossPtDecoderSepAlign(_CrossPtBase):
    """crossPtDecoder_sepAlign: per-patient PCA + CCA alignment to target."""

    def __init__(self, cross_pt_data, decoder, aligner=None, dim_red=None,
                 n_comp=0.8, tar_in_train=True, device=None):
        self.cross_pt_data = cross_pt_data
        self.decoder = decoder
        self.aligner = aligner
        self.dim_red = dim_red
        self.n_comp = n_comp
        self.tar_in_train = tar_in_train
        self.device = device

    def preprocess_train(self, X, y, y_align=None):
        dev = resolve_device(self.device)
        if y_align is None:
            y_align = y
        self._tar_pca, tar_lat = _pca_lat(X, self.n_comp, dev)

        align_labels = [y_align] + [ya for _, _, ya in self.cross_pt_data]
        ids, n_cls = _align_ids(*align_labels)

        feats, ys = [], []
        for i, (Xc, yc, _) in enumerate(self.cross_pt_data):
            _, src_lat = _pca_lat(np.asarray(Xc), self.n_comp, dev)
            # the b->a transform lands source data in the target's width
            aligner = fit_cca_aligner(
                _t(tar_lat, dev), _t(src_lat, dev),
                _t(ids[0], dev, torch.int64),
                _t(ids[i + 1], dev, torch.int64), n_cls)
            aligned = _np(transform_b_to_a(aligner, _t(src_lat, dev)))
            feats.append(aligned.reshape(aligned.shape[0], -1))
            ys.append(np.asarray(yc))

        tar_flat = tar_lat.reshape(tar_lat.shape[0], -1)
        if self.tar_in_train:
            return np.vstack([tar_flat] + feats), np.concatenate([y] + ys)
        return np.vstack(feats), np.concatenate(ys)

    def preprocess_test(self, X):
        flat = _t(X.reshape(-1, X.shape[-1]), self._tar_pca.mean.device)
        lat = _np(pca_transform(self._tar_pca, flat))
        return lat.reshape(X.shape[0], -1)


class CrossPtDecoderJointPCA(_CrossPtBase):
    """crossPtDecoder_jointDimRed: joint-PCA shared space."""

    def __init__(self, cross_pt_data, decoder, joint_dr_method=None,
                 n_comp=0.8, tar_in_train=True, device=None):
        self.cross_pt_data = cross_pt_data
        self.decoder = decoder
        self.joint_dr_method = joint_dr_method
        self.n_comp = n_comp
        self.tar_in_train = tar_in_train
        self.device = device

    def preprocess_train(self, X, y, y_align=None):
        dev = resolve_device(self.device)
        if y_align is None:
            y_align = y
        align_labels = [y_align] + [ya for _, _, ya in self.cross_pt_data]
        ids, n_cls = _align_ids(*align_labels)
        Xs = [_t(X, dev)] + [_t(x, dev) for x, _, _ in self.cross_pt_data]
        self._state = joint_pca_fit(
            Xs, [_t(i, dev, torch.int64) for i in ids], n_cls, self.n_comp)
        feats = [_np(joint_pca_transform(self._state, x, i)).reshape(
            x.shape[0], -1) for i, x in enumerate(Xs)]
        ys = [np.asarray(yc) for _, yc, _ in self.cross_pt_data]
        if self.tar_in_train:
            return np.vstack(feats), np.concatenate([y] + ys)
        return np.vstack(feats[1:]), np.concatenate(ys)

    def preprocess_test(self, X):
        dev = self._state.shared_mask.device
        t = joint_pca_transform(self._state, _t(X, dev), 0)
        return _np(t).reshape(X.shape[0], -1)


class CrossPtDecoderMCCA(_CrossPtBase):
    """crossPtDecoder_mcca: multiview CCA shared space."""

    def __init__(self, cross_pt_data, decoder, aligner=None, n_comp=10,
                 regs=0.5, pca_var=1, tar_in_train=True, device=None):
        self.cross_pt_data = cross_pt_data
        self.decoder = decoder
        self.aligner = aligner
        self.n_comp = n_comp
        self.regs = regs
        self.pca_var = pca_var
        self.tar_in_train = tar_in_train
        self.device = device

    def preprocess_train(self, X, y, y_align=None):
        dev = resolve_device(self.device)
        if y_align is None:
            y_align = y
        align_labels = [y_align] + [ya for _, _, ya in self.cross_pt_data]
        ids, n_cls = _align_ids(*align_labels)
        Xs = [_t(X, dev)] + [_t(x, dev) for x, _, _ in self.cross_pt_data]
        self._state = fit_mcca_aligner(
            Xs, [_t(i, dev, torch.int64) for i in ids], n_cls,
            int(self.n_comp), self.regs, self.pca_var)
        feats = [_np(mcca_transform(self._state, x, i)).reshape(
            x.shape[0], -1) for i, x in enumerate(Xs)]
        ys = [np.asarray(yc) for _, yc, _ in self.cross_pt_data]
        if self.tar_in_train:
            return np.vstack(feats), np.concatenate([y] + ys)
        return np.vstack(feats[1:]), np.concatenate(ys)

    def preprocess_test(self, X):
        dev = self._state.shared_mask.device
        t = mcca_transform(self._state, _t(X, dev), 0)
        return _np(t).reshape(X.shape[0], -1)


class CrossPtDecoderSepDimRed(_CrossPtBase):
    """crossPtDecoder_sepDimRed: independent PCA, common latent width."""

    def __init__(self, cross_pt_data, decoder, dim_red=None, n_comp=0.8,
                 tar_in_train=True, device=None):
        self.cross_pt_data = cross_pt_data
        self.decoder = decoder
        self.dim_red = dim_red
        self.n_comp = n_comp
        self.tar_in_train = tar_in_train
        self.device = device

    def preprocess_train(self, X, y, **kwargs):
        dev = resolve_device(self.device)
        tar_pca, tar_lat = _pca_lat(X, self.n_comp, dev)
        lat, widths, ys = [tar_lat], [int(tar_pca.n_active)], []
        for Xc, yc, _ in self.cross_pt_data:
            p, l_c = _pca_lat(np.asarray(Xc), self.n_comp, dev)
            lat.append(l_c)
            widths.append(int(p.n_active))
            ys.append(np.asarray(yc))
        self._tar_pca = tar_pca
        self.common_dim = min(widths)
        flats = [la[..., : self.common_dim].reshape(la.shape[0], -1)
                 for la in lat]
        if self.tar_in_train:
            return np.vstack(flats), np.concatenate([y] + ys)
        return np.vstack(flats[1:]), np.concatenate(ys)

    def preprocess_test(self, X):
        flat = _t(X.reshape(-1, X.shape[-1]), self._tar_pca.mean.device)
        lat = _np(pca_transform(self._tar_pca, flat)).reshape(
            X.shape[0], X.shape[1], -1)[..., : self.common_dim]
        return lat.reshape(X.shape[0], -1)
