"""The port's alignment core (PCA, CCA, MCCA, joint PCA) against the JAX
package's, on the same numpy inputs made from a seed.

Both sides compute in float32 (JAX at Precision.HIGHEST, the port with
TF32 off); their LAPACK calls and sums differ in rounding only. Singular
and eigenvector signs are free in both, so the comparisons use what does
not depend on them: eigen- and singular values, canonical correlations,
``d``, the composite projections, transforms, reconstructions, products
such as L L^T, and components up to column sign. Tolerances, relative to
the largest reference magnitude: PCA 2e-4 (LAPACK SVD vs eigh rounding
over a 60 x 12 matrix), CCA projections 1e-3 and correlations 1e-4 (the
pinv of the manifold directions amplifies rounding by their condition),
MCCA and joint PCA 1e-3.

The last tests run a natively batched fit down the Jacobi kernel's route:
the port's route hook sends ``batched_eigh`` to the kernel's plain
version, and the JAX side's ``batched_eigh`` is replaced by its Pallas
kernel in interpret mode.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_patient_speech_decoding_tpu.ops import cca as jcca
from cross_patient_speech_decoding_tpu.ops import jacobi as jjac
from cross_patient_speech_decoding_tpu.ops import joint_pca as jjoint
from cross_patient_speech_decoding_tpu.ops import mcca as jmcca
from cross_patient_speech_decoding_tpu.ops import pca as jpca
from cross_patient_speech_decoding_tpu.ops import precision as jprec
from cross_patient_speech_decoding_tpu_torch.ops import (
    cca,
    jacobi,
    joint_pca,
    mcca,
    pca,
    precision,
)
from cross_patient_speech_decoding_tpu_torch.ops.convert import state_from_numpy

torch.set_num_threads(2)

PCA_RTOL = 2e-4
PROJ_RTOL = 1e-3
CORR_ATOL = 1e-4
MCCA_RTOL = 1e-3


def _t(*arrs):
    out = tuple(None if a is None else torch.from_numpy(np.asarray(a))
                for a in arrs)
    return out if len(out) > 1 else out[0]


def _j(*arrs):
    out = tuple(None if a is None else jnp.asarray(a) for a in arrs)
    return out if len(out) > 1 else out[0]


def _close(got, want, rtol, what=""):
    """max |got - want| <= rtol * max |want| (plus a floor for zeros)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = rtol * max(np.abs(want).max(initial=0.0), 1e-6)
    err = np.abs(got - want).max(initial=0.0)
    assert err <= tol, f"{what}: {err} > {tol}"


def _rand(seed, n, f):
    # tests/test_pca.py:_rand: low rank plus noise
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 5)) @ rng.normal(size=(5, f))
            + 0.1 * rng.normal(size=(n, f))).astype(np.float32)


def _latents(seed, R=120, ka=7, kb=9, rank=5):
    """tests/test_cca.py:_latents: pairs with distinct canonical
    correlations."""
    rng = np.random.default_rng(seed)
    shared = rng.normal(size=(R, rank))

    def make(k):
        cols = [shared[:, i] + 0.15 * (i + 1) * rng.normal(size=R)
                for i in range(rank)]
        cols += [2.0 * rng.normal(size=R) for _ in range(k - rank)]
        q, _ = np.linalg.qr(rng.normal(size=(k, k)))
        return np.stack(cols, 1) @ (q * np.linspace(1.0, 3.0, k)[None, :])

    return make(ka).astype(np.float32), make(kb).astype(np.float32)


def _trials(seed, lead=(), N=40, T=10, ks=(6, 8), C=5, lat=4, noise=0.3):
    """Trials (lead..., N, T, k) of each view: class trajectories of a
    shared latent, mixed per view, plus noise; ids (lead..., N)."""
    rng = np.random.default_rng(seed)
    latent = rng.normal(size=(C, T, lat))
    ids = np.broadcast_to(np.arange(N) % C, lead + (N,)).astype(np.int32)
    views = []
    for k in ks:
        mix = rng.normal(size=lead + (lat, k))
        x = np.einsum("...ntl,...lk->...ntk", latent[ids], mix)
        views.append((x + noise * rng.normal(size=x.shape)).astype(np.float32))
    return views, ids


# ---------------------------------------------------------------------------
# precision
# ---------------------------------------------------------------------------


_CALLERS = {
    "legacy_allow_tf32": lambda: setattr(torch.backends.cuda.matmul,
                                         "allow_tf32", True),
    "legacy_precision_high": lambda: torch.set_float32_matmul_precision(
        "high"),
    "new_api_tf32": lambda: setattr(torch.backends.cuda.matmul,
                                    "fp32_precision", "tf32"),
    "default": lambda: None,
}


@pytest.mark.parametrize("caller", sorted(_CALLERS))
def test_hdot_pins_float32_and_restores_caller_settings(caller, monkeypatch):
    """Inside hdot both views of the cuBLAS setting say full float32; the
    caller's settings, set through either API, come back after it."""
    seen = []
    matmul = torch.matmul

    def spy(a, b):
        seen.append(precision._matmul_settings())
        return matmul(a, b)

    saved = precision._matmul_settings()
    monkeypatch.setattr(torch, "matmul", spy)
    try:
        _CALLERS[caller]()
        before = precision._matmul_settings()
        a = torch.randn(3, 4, generator=torch.Generator().manual_seed(0))
        precision.hdot(a, a.T)
        assert seen[0][0] == "highest" and seen[0][1] in ("ieee", "none")
        assert precision._matmul_settings() == before
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cuda.matmul.fp32_precision = saved[1]


def test_hpinv_matches_jax():
    M = _rand(1, 9, 4)
    M[:, 3] = 0.0  # exact for a zero column: a zero row
    got = precision.hpinv(_t(M)).numpy()
    _close(got, np.asarray(jprec.hpinv(_j(M))), 1e-5, "hpinv")
    np.testing.assert_array_equal(got[3], 0.0)


# ---------------------------------------------------------------------------
# PCA
# ---------------------------------------------------------------------------


def _check_pca(st, st_j, X, rtol=PCA_RTOL):
    assert int(st.n_active) == int(st_j.n_active)
    np.testing.assert_array_equal(st.mask.numpy(), np.asarray(st_j.mask))
    for name in ("mean", "singular_values", "explained_variance_ratio"):
        _close(getattr(st, name).numpy(), np.asarray(getattr(st_j, name)),
               rtol, name)
    # a component is defined up to sign only where its singular value
    # stands apart from its neighbours (1 % of the largest); the 'gram'
    # method squares the condition, so near-equal noise directions turn
    # within their span
    s = np.asarray(st_j.singular_values, np.float64)
    apart = np.abs(np.diff(s)) > 1e-2 * s[0]
    sep = np.asarray(st_j.mask) > 0
    sep[:-1] &= apart
    sep[1:] &= apart
    comp, comp_j = st.components.numpy(), np.asarray(st_j.components)
    signs = np.where((comp * comp_j).sum(0) < 0, -1.0, 1.0)
    _close((comp * signs)[:, sep], comp_j[:, sep], rtol,
           "components up to sign")
    z = pca.pca_transform(st, _t(X)).numpy()
    z_j = np.asarray(jpca.pca_transform(st_j, _j(X)))
    _close((z * signs)[:, sep], z_j[:, sep], rtol, "transform up to sign")
    # reconstruction: independent of signs and of turns within the span
    rec = pca.pca_inverse_transform(st, pca.pca_transform(st, _t(X)))
    rec_j = jpca.pca_inverse_transform(st_j, jpca.pca_transform(st_j, _j(X)))
    _close(rec.numpy(), np.asarray(rec_j), rtol, "reconstruction")


@pytest.mark.parametrize("method", ["svd", "gram"])
@pytest.mark.parametrize("n_components,max_components",
                         [(4, 8), (0.8, 8), (None, None)])
def test_pca_fit_matches_jax(method, n_components, max_components):
    X = _rand(0, 60, 12)
    kw = dict(max_components=max_components, method=method)
    st = pca.pca_fit(_t(X), n_components, **kw)
    st_j = jpca.pca_fit(_j(X), n_components, **kw)
    _check_pca(st, st_j, X)


def test_pca_sample_mask_center_and_variants():
    X = _rand(2, 50, 10)
    mask = (np.arange(50) % 3 != 0).astype(np.float32)
    st = pca.pca_fit(_t(X), 5, sample_mask=_t(mask))
    st_j = jpca.pca_fit(_j(X), 5, sample_mask=_j(mask))
    _check_pca(st, st_j, X)
    st = pca.nocenter_pca_fit(_t(X), 0.9, max_components=6)
    st_j = jpca.nocenter_pca_fit(_j(X), 0.9, max_components=6)
    assert not st.mean.any()
    _check_pca(st, st_j, X)
    st, z = pca.pca_fit_transform(_t(X), 3, center=False)
    st_j, z_j = jpca.pca_fit_transform(_j(X), 3, center=False)
    _check_pca(st, st_j, X)
    # a variance fraction handed over as a floating tensor
    st = pca.pca_fit(_t(X), torch.tensor(0.7))
    st_j = jpca.pca_fit(_j(X), jnp.asarray(0.7, jnp.float32))
    _check_pca(st, st_j, X)


def test_pca_low_refit_k_and_counts():
    # tests/test_pca.py:139: one direction carries ~99.9 % of the variance
    rng = np.random.default_rng(3)
    u = rng.normal(size=(300, 1)) * 100.0
    X = (u @ rng.normal(size=(1, 12)) + rng.normal(size=(300, 12))).astype(
        np.float32)
    for kw in (dict(), dict(low_refit_k=30), dict(low_refit_k=4)):
        st = pca.pca_fit(_t(X), 0.9, **kw)
        st_j = jpca.pca_fit(_j(X), 0.9, **kw)
        _check_pca(st, st_j, X)
    assert int(pca.pca_fit(_t(X), 0.9, low_refit_k=30).n_active) == 12
    assert int(pca.pca_fit(_t(X), 5.0, max_components=8).n_active) == 5
    for bad in (1.0, 5.5):
        with pytest.raises(ValueError, match="n_components"):
            pca.pca_fit(_t(X), bad)


@pytest.mark.parametrize("var", [0.3, 0.8, 0.95, 0.999])
def test_n_components_for_variance_matches_jax(var):
    """The reference's argmax(cumsum > var) quirk: an index, not a count."""
    X = _rand(4, 80, 15)
    got = pca.n_components_for_variance(_t(X), var)
    assert got.dtype == torch.int32
    assert int(got) == int(jpca.n_components_for_variance(_j(X), var))


# ---------------------------------------------------------------------------
# CCA
# ---------------------------------------------------------------------------


def test_cnd_avg_with_leading_batch_dims():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(2, 3, 40, 10, 6)).astype(np.float32)
    y = rng.integers(0, 5, (2, 3, 40)).astype(np.int32)
    y[0, 0, :3] = 7  # outside the class range: counted for no class
    m = (rng.uniform(size=(2, 3, 40)) > 0.2).astype(np.float32)
    for mask in (None, m):
        avg, cnt = cca.cnd_avg(_t(X), _t(y), 5, _t(mask))
        avg_j, cnt_j = jcca.cnd_avg(_j(X), _j(y), 5, _j(mask))
        assert avg.shape == (2, 3, 5, 10, 6)
        _close(avg.numpy(), np.asarray(avg_j), 1e-6, "avg")
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(cnt_j))


def _check_alignment(res, res_j, corr_atol=CORR_ATOL, rtol=PROJ_RTOL):
    np.testing.assert_array_equal(res.d.numpy(), np.asarray(res_j.d))
    assert res.d.dtype == torch.int32
    np.testing.assert_allclose(res.canon_corrs.numpy(),
                               np.asarray(res_j.canon_corrs), atol=corr_atol,
                               rtol=0)
    for name in ("proj_b_to_a", "proj_a_to_b"):
        _close(getattr(res, name).numpy(), np.asarray(getattr(res_j, name)),
               rtol, name)
    # masked manifold columns are exact zeros on both sides
    for name in ("m_a", "m_b"):
        cols = (np.asarray(getattr(res_j, name)) == 0).all(-2)
        assert (np.swapaxes(getattr(res, name).numpy(), -1, -2)[cols]
                == 0).all()


def _cca_cases():
    La, Lb = _latents(1)
    Lc, Ld = _latents(4, ka=6, kb=8, rank=4)
    # PCA-style masked trailing dims (exact zero columns)
    Lc[:, 4:] = 0.0
    Ld[:, 5:] = 0.0
    row_mask = np.zeros(120, np.float32)
    row_mask[:80] = 1.0
    pairs = [_latents(30 + i, ka=8, kb=8, rank=6) for i in range(4)]
    Le, Lf = (np.stack([p[i] for p in pairs]) for i in (0, 1))
    return {"full": (La, Lb, None), "row_mask": (La, Lb, row_mask),
            "masked_dims": (Lc, Ld, None), "batched": (Le, Lf, None)}


@pytest.mark.parametrize("method", ["svd", "gram", "chol"])
@pytest.mark.parametrize("case", ["full", "row_mask", "masked_dims",
                                  "batched"])
def test_cca_align_matches_jax(method, case):
    La, Lb, mask = _cca_cases()[case]
    res = cca.cca_align(_t(La), _t(Lb), _t(mask), method=method)
    res_j = jcca.cca_align(_j(La), _j(Lb), _j(mask), method=method)
    _check_alignment(res, res_j)


def test_cca_rank_deficient_and_duplicated_columns():
    """A column of b duplicated (rank deficiency in a rotated direction):
    svd and gram find the true rank as JAX does (test_cca.py:267)."""
    La, Lb = _latents(40, ka=6, kb=7, rank=4)
    Lb_dup = np.concatenate([Lb, Lb[:, 2:3]], axis=1)
    for method in ("svd", "gram"):
        res = cca.cca_align(_t(La), _t(Lb_dup), method=method)
        res_j = jcca.cca_align(_j(La), _j(Lb_dup), method=method)
        assert int(res.d) == int(res_j.d) == 6
        np.testing.assert_allclose(res.canon_corrs.numpy(),
                                   np.asarray(res_j.canon_corrs),
                                   atol=CORR_ATOL, rtol=0)


def test_fast_masked_pinv_degenerate_column():
    """test_cca.py:319: a zero column inside the mask gives a zero row,
    not NaN."""
    M = np.random.default_rng(7).normal(size=(9, 4)).astype(np.float32)
    M[:, 2] = 0.0
    mask = np.ones(4, np.float32)
    p = cca._fast_masked_pinv(_t(M), _t(mask)).numpy()
    p_j = np.asarray(jcca._fast_masked_pinv(_j(M), _j(mask)))
    assert np.isfinite(p).all()
    _close(p, p_j, 1e-5, "pinv")
    np.testing.assert_allclose(p, np.linalg.pinv(M), atol=2e-5)
    np.testing.assert_array_equal(p[2], 0.0)


def test_gram_route_zero_correlation_direction():
    """test_cca.py:340, both packages on the Gram route (force_gram): an
    exactly uncorrelated pair of directions is dropped, not NaN."""

    def spike(r, a):
        c = np.zeros(r, np.float32)
        c[a], c[a + 1] = 1.0, -1.0
        return c

    shared = [spike(64, 4 * j) for j in range(3)]
    La = np.stack(shared + [spike(64, 20)], axis=1)
    Lb = np.stack(shared + [spike(64, 30)], axis=1)
    for chol in (False, True):
        res = cca._cca_align_gram(_t(La), _t(Lb), chol=chol, force_gram=True)
        res_j = jcca._cca_align_gram(_j(La), _j(Lb), chol=chol,
                                     force_gram=True)
        _check_alignment(res, res_j)
        assert int(res.d) == 3 and float(res.canon_corrs[3]) == 0.0
        assert (res.m_a[:, 3] == 0).all()


@pytest.mark.parametrize("method", ["chol", "gram", "svd"])
@pytest.mark.parametrize("flat", [False, True])
def test_fit_cca_aligner_and_transforms_match_jax(method, flat):
    (Xa, Xb), ids = _trials(11)
    ids_b = ids.copy()
    ids_b[ids_b == 2] = 3  # class 2 absent from b: not shared
    T = Xa.shape[1]
    mask_a = (np.arange(40) % 7 != 0).astype(np.float32)
    if flat:
        xa, xb = Xa.reshape(40, -1), Xb.reshape(40, -1)
        kw = dict(t_len=T)
    else:
        xa, xb, kw = Xa, Xb, {}
    fit = cca.fit_cca_aligner(*_t(xa, xb, ids, ids_b), 5, mask_a=_t(mask_a),
                              method=method, **kw)
    fit_j = jcca.fit_cca_aligner(*_j(xa, xb, ids, ids_b), 5,
                                 mask_a=_j(mask_a), method=method, **kw)
    np.testing.assert_array_equal(fit.shared_mask.numpy(),
                                  np.asarray(fit_j.shared_mask))
    _check_alignment(fit.alignment, fit_j.alignment)
    _close(cca.transform_b_to_a(fit, _t(Xb)).numpy(),
           np.asarray(jcca.transform_b_to_a(fit_j, _j(Xb))), PROJ_RTOL,
           "b_to_a")
    _close(cca.transform_a_to_b(fit, _t(Xa)).numpy(),
           np.asarray(jcca.transform_a_to_b(fit_j, _j(Xa))), PROJ_RTOL,
           "a_to_b")
    # shared space: a direction's two columns flip sign together, so
    # their product is free of the sign
    za, zb = cca.transform_shared(fit, _t(Xa), _t(Xb))
    za_j, zb_j = jcca.transform_shared(fit_j, _j(Xa), _j(Xb))
    d = int(fit.alignment.d)
    _close((za * zb).numpy()[..., :d],
           (np.asarray(za_j) * np.asarray(zb_j))[..., :d], PROJ_RTOL,
           "shared")


def test_fit_cca_aligner_trial_matches_jax():
    (Xa, Xb), ids = _trials(12, N=30)
    ids_b = (ids + 1) % 6  # class 5 only in b, class 0 only in a
    idx = cca.shared_trial_subselect_indices(ids, ids_b,
                                             np.random.default_rng(5))
    idx_j = jcca.shared_trial_subselect_indices(ids, ids_b,
                                                np.random.default_rng(5))
    for a, b in zip(idx, idx_j):
        np.testing.assert_array_equal(a, b)
    for method in ("gram", "svd"):
        fit = cca.fit_cca_aligner_trial(_t(Xa), _t(Xb), *idx, method=method)
        fit_j = jcca.fit_cca_aligner_trial(_j(Xa), _j(Xb), *idx_j,
                                           method=method)
        _check_alignment(fit.alignment, fit_j.alignment)
        assert fit.shared_mask.shape == (1,)
    with pytest.raises(ValueError, match="no shared classes"):
        cca.shared_trial_subselect_indices(np.array([0, 0, 1]),
                                           np.array([2, 3, 3]),
                                           np.random.default_rng(0))


def test_inputs_on_mixed_devices_raise():
    La, Lb = _latents(1)
    with pytest.raises(ValueError, match="mixed devices"):
        cca.cca_align(_t(La), torch.empty(Lb.shape, device="meta"))
    with pytest.raises(ValueError, match="mixed devices"):
        pca.pca_fit(_t(La), 3, sample_mask=torch.ones(120, device="meta"))


# ---------------------------------------------------------------------------
# MCCA and joint PCA
# ---------------------------------------------------------------------------


def _outer(L):
    return L @ L.T


def _check_mcca(st, st_j, views, rtol=MCCA_RTOL):
    _close(st.evals.numpy(), np.asarray(st_j.evals), rtol, "evals")
    for i, X in enumerate(views):
        _close(st.means[i].numpy(), np.asarray(st_j.means[i]), rtol, "mean")
        # eigenvector signs are free: L L^T and the transforms' Grams are not
        _close(_outer(st.loadings[i].numpy()),
               _outer(np.asarray(st_j.loadings[i])), rtol, "L L^T")
        z = mcca.mcca_transform(st, _t(X), i).numpy()
        z_j = np.asarray(jmcca.mcca_transform(st_j, _j(X), i))
        _close(_outer(z), _outer(z_j), rtol, "transform")


def _views(seed=0, R=200, ps=(6, 8, 5), rank=3):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(R, rank))
    return [(z @ rng.normal(size=(rank, p)) + 0.2 * rng.normal(size=(R, p)))
            .astype(np.float32) for p in ps]


@pytest.mark.parametrize("regs", [0.1, 0.5, 0.9])
def test_mcca_fit_matches_jax(regs):
    views = _views()
    mask = (np.arange(200) % 5 != 0).astype(np.float32)
    # 3 components, the views' shared rank: the top eigenvalues stand
    # apart from the noise ones, so L L^T is well defined
    st = mcca.mcca_fit(_t(*views), 3, regs=regs, row_mask=_t(mask))
    st_j = jmcca.mcca_fit(_j(*views), 3, regs=regs, row_mask=_j(mask))
    assert st.shared_mask is None
    _check_mcca(st, st_j, views)


def test_mcca_signal_ranks_match_jax():
    views = _views(1)
    ranks = [2, torch.tensor(3), 4]
    st = mcca.mcca_fit(_t(*views), 3, regs=0.5, signal_ranks=ranks)
    st_j = jmcca.mcca_fit(_j(*views), 3, regs=0.5,
                          signal_ranks=[2, jnp.asarray(3), 4])
    _check_mcca(st, st_j, views)


@pytest.mark.parametrize("pca_var", [1.0, 0.8])
def test_fit_mcca_aligner_matches_jax(pca_var):
    views, ids = _trials(13, ks=(6, 8, 7))
    masks = [(np.arange(40) % 4 != k).astype(np.float32) for k in range(3)]
    st = mcca.fit_mcca_aligner(_t(*views), [_t(ids)] * 3, 5, 4, regs=0.5,
                               pca_var=pca_var, sample_masks=_t(*masks))
    st_j = jmcca.fit_mcca_aligner(_j(*views), [_j(ids)] * 3, 5, 4, regs=0.5,
                                  pca_var=pca_var, sample_masks=_j(*masks))
    np.testing.assert_array_equal(st.shared_mask.numpy(),
                                  np.asarray(st_j.shared_mask))
    _check_mcca(st, st_j, [v.reshape(-1, v.shape[-1]) for v in views])


def test_joint_pca_matches_jax():
    views, ids = _trials(14, ks=(6, 8, 7))
    ids_c = ids.copy()
    ids_c[ids_c == 4] = 0  # class 4 absent from the third patient
    all_ids = [ids, ids, ids_c]
    masks = [None, (np.arange(40) % 9 != 0).astype(np.float32), None]
    for n_comp in (4, 0.9):
        st = joint_pca.joint_pca_fit(_t(*views), _t(*all_ids), 5, n_comp,
                                     max_components=6,
                                     sample_masks=[_t(m) for m in masks])
        st_j = jjoint.joint_pca_fit(_j(*views), _j(*all_ids), 5, n_comp,
                                    max_components=6,
                                    sample_masks=[_j(m) for m in masks])
        assert int(st.n_active) == int(st_j.n_active)
        np.testing.assert_array_equal(st.shared_mask.numpy(),
                                      np.asarray(st_j.shared_mask))
        for i, X in enumerate(views):
            _close(_outer(st.read_ins[i].numpy()),
                   _outer(np.asarray(st_j.read_ins[i])), MCCA_RTOL, "R R^T")
            z = joint_pca.joint_pca_transform(st, _t(X), i).numpy()
            z_j = np.asarray(jjoint.joint_pca_transform(st_j, _j(X), i))
            zz = np.einsum("...k,...k->...", z, z)  # row norms: sign-free
            zz_j = np.einsum("...k,...k->...", z_j, z_j)
            _close(zz, zz_j, MCCA_RTOL, "transform")


# ---------------------------------------------------------------------------
# fitted states carried across
# ---------------------------------------------------------------------------


def _np_state(state):
    """A JAX NamedTuple with numpy leaves (tuples kept)."""
    def conv(v):
        if v is None:
            return None
        if isinstance(v, tuple) and not hasattr(v, "_fields"):
            return tuple(conv(x) for x in v)
        if hasattr(v, "_fields"):
            return type(v)(*(conv(x) for x in v))
        return np.asarray(v)
    return conv(state)


def test_state_from_numpy_applies_jax_fits():
    """A state fitted by the JAX package, handed over as numpy arrays,
    gives the port's transforms JAX's own results (float32 matmuls of the
    same numbers: 1e-6)."""
    (Xa, Xb), ids = _trials(15)
    fit_j = jcca.fit_cca_aligner(*_j(Xa, Xb, ids, ids), 5, method="gram")
    fit = state_from_numpy(cca.FittedAligner, _np_state(fit_j), "cpu")
    assert isinstance(fit.alignment, cca.CCAAlignment)
    assert fit.alignment.d.dtype == torch.int32
    _close(cca.transform_b_to_a(fit, _t(Xb)).numpy(),
           np.asarray(jcca.transform_b_to_a(fit_j, _j(Xb))), 1e-6, "b_to_a")
    za, zb = cca.transform_shared(fit, _t(Xa), _t(Xb))
    za_j, zb_j = jcca.transform_shared(fit_j, _j(Xa), _j(Xb))
    _close(za.numpy(), np.asarray(za_j), 1e-6, "shared a")
    _close(zb.numpy(), np.asarray(zb_j), 1e-6, "shared b")
    # a mapping of the fields works as well
    al = state_from_numpy(cca.CCAAlignment,
                          _np_state(fit_j.alignment)._asdict(), "cpu")
    assert torch.equal(al.proj_a_to_b, fit.alignment.proj_a_to_b)

    X = _rand(0, 60, 12)
    st_j = jpca.pca_fit(_j(X), 4, max_components=6)
    st = state_from_numpy(pca.PCAState, _np_state(st_j), "cpu")
    _close(pca.pca_transform(st, _t(X)).numpy(),
           np.asarray(jpca.pca_transform(st_j, _j(X))), 1e-6, "pca")

    views = _views()
    m_j = jmcca.mcca_fit(_j(*views), 3)
    m = state_from_numpy(mcca.MCCAState, _np_state(m_j), "cpu")
    assert m.shared_mask is None and len(m.loadings) == 3
    _close(mcca.mcca_transform(m, _t(views[1]), 1).numpy(),
           np.asarray(jmcca.mcca_transform(m_j, _j(views[1]), 1)), 1e-6,
           "mcca")

    vs, ids3 = _trials(16, ks=(6, 8))
    jp_j = jjoint.joint_pca_fit(_j(*vs), [_j(ids3)] * 2, 5, 3)
    jp = state_from_numpy(joint_pca.JointPCAState, _np_state(jp_j), "cpu")
    _close(joint_pca.joint_pca_transform(jp, _t(vs[0]), 0).numpy(),
           np.asarray(jjoint.joint_pca_transform(jp_j, _j(vs[0]), 0)), 1e-6,
           "joint")
    with pytest.raises(ValueError, match="fields"):
        state_from_numpy(pca.PCAState, {"mean": np.zeros(3)}, "cpu")


# ---------------------------------------------------------------------------
# the slice on the kernel's route
# ---------------------------------------------------------------------------


def _fit_gram_route(ops, Xa, Xb, ids, n_classes, T, chol):
    """fit_cca_aligner (flat layout) with the Gram-route SVD forced, as
    on the card: cnd_avg, shared rows, centering, _cca_align_gram."""
    lead = ids.shape[:-1]
    avg_a, cnt_a = ops.cnd_avg(Xa, ids, n_classes)
    avg_b, cnt_b = ops.cnd_avg(Xb, ids, n_classes)
    shared = (cnt_a > 0) & (cnt_b > 0)
    ka, kb = Xa.shape[-1] // T, Xb.shape[-1] // T
    La = avg_a.reshape(lead + (n_classes * T, ka))
    Lb = avg_b.reshape(lead + (n_classes * T, kb))
    if ops is cca:
        mask = torch.repeat_interleave(shared.float(), T, dim=-1)
    else:
        mask = jnp.repeat(shared.astype(jnp.float32), T, axis=-1)
    La = ops._masked_center_cols(La, mask)
    Lb = ops._masked_center_cols(Lb, mask)
    return ops._cca_align_gram(La, Lb, chol=chol, force_gram=True)


@pytest.mark.parametrize("method", ["chol", "gram"])
def test_batched_fit_on_kernel_route_matches_jax_pallas(method, monkeypatch):
    """16 pairs, N=30, T=10, K=8, 5 classes, natively batched. The port's
    batched_eigh takes the kernel's route to its plain version; the JAX
    package's runs its Pallas kernel in interpret mode (cca.py imports
    batched_eigh at call time). 'chol' solves one eigh batch (16), 'gram'
    two (32 stacked whitening matrices, then 16)."""
    B, N, T, K, C = 16, 30, 10, 8, 5
    # every direction shared (lat = K): with a canonical correlation near
    # zero, U = g V / s of the Gram route is ill-conditioned in any
    # precision and the projections differ far above rounding
    (Xa, Xb), ids = _trials(17, lead=(B,), N=N, T=T, ks=(K, K), C=C, lat=K)
    xa, xb = Xa.reshape(B, N, T * K), Xb.reshape(B, N, T * K)

    shapes = []
    plain = jacobi.jacobi_eigh_plain

    def counted(A, pairs, sweeps=8):
        shapes.append(tuple(A.shape))
        return plain(A, pairs, sweeps)

    monkeypatch.setattr(jacobi, "_route", lambda A: "plain")
    # the card's route takes K = 8 from MIN_BATCH matrices; these 16 pairs
    # take it as the JAX dispatch's batch of 16 does
    monkeypatch.setattr(jacobi, "MIN_BATCH", B)
    monkeypatch.setattr(jacobi, "jacobi_eigh_plain", counted)
    monkeypatch.setattr(jjac, "batched_eigh", functools.partial(
        jjac.jacobi_eigh_pallas, block=16, interpret=True))

    chol = method == "chol"
    res = _fit_gram_route(cca, *_t(xa, xb, ids), C, T, chol)
    res_j = _fit_gram_route(jcca, *_j(xa, xb, ids), C, T, chol)
    assert shapes == ([(16, 8, 8)] if chol else [(32, 8, 8), (16, 8, 8)])
    assert res.d.shape == (B,) and (res.d.numpy() > 0).all()
    _check_alignment(res, res_j)
