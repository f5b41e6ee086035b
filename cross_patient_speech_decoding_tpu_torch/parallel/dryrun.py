"""Multi-rank dry run: every sharded surface of the port once, on N ranks,
each held against the one-device run on the same rank.

The port's counterpart of ``__graft_entry__.py:dryrun_multichip``, whose
six surfaces it drives: the data-parallel CTC train step, the
fold-sharded decode, an alignment-fit batch sharded over the ranks, the
seq2seq fold-parallel trainer, the data-parallel classifier step and the
nested-CV scorer with an outer-fold count that does not divide the ranks.
JAX's first surface also column-shards the weights over a second
``model`` axis; that layout is XLA's partitioner at work, with no code of
the JAX package behind it, and the port leaves it out.

Sizes are small (a few layers, narrow widths): the dry run shows that
the collectives, the padding and the gathers are right, not speed.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from cross_patient_speech_decoding_tpu_torch.parallel import mesh as pm

# data-parallel steps against the one-device step: the loss relative, the
# reduced gradients relative to the largest (chip_smoke's ctc_train
# tolerances: the GRU kernels sum in another order at another batch size;
# AdamW's first step, about lr * sign(g), would magnify the rounding of
# near-zero gradients)
DP_LOSS_RTOL = 1e-4
DP_GRAD_RTOL = 1e-3
DRYRUN_TIMEOUT_S = 600.0


def dryrun_multichip(n_devices: int, device=None, backend: str | None = None,
                     verbose: bool = True) -> dict:
    """Run the six surfaces on ``n_devices`` ranks and return rank 0's
    report (one dict a surface). Inside a process group of that size they
    run in it; otherwise the ranks are launched here (``device`` and
    ``backend`` as ``parallel.launch`` reads them; the default is one
    CUDA card a rank, and no card raises unless ``device='cpu'``). Any
    check that fails raises."""
    if dist.is_initialized():
        return _surfaces(n_devices, device, verbose)
    return pm.launch(_surfaces, n_devices, (n_devices, None, verbose),
                     devices=device, backend=backend,
                     timeout=DRYRUN_TIMEOUT_S)


def _say(verbose: bool, mesh, msg: str) -> None:
    if verbose and mesh.rank == 0:
        print(f"dryrun_multichip({mesh.size}): {msg}", flush=True)


def _surfaces(n_devices: int, device, verbose: bool) -> dict:
    mesh = pm.make_mesh(n_devices, device=device)
    rng = np.random.default_rng(0)
    out = {"world_size": mesh.size,
           "backend": (dist.get_backend(mesh.group) if mesh.group is not None
                       else None)}
    out["ctc_step"] = _ctc_step(mesh, rng)
    _say(verbose, mesh, f"ctc train step ok, {out['ctc_step']}")
    pts, dcfg = _patients(mesh.device)
    out["fold_decode"] = _fold_decode(mesh, pts, dcfg)
    _say(verbose, mesh, f"fold-sharded decode ok, {out['fold_decode']}")
    out["alignment_fits"] = _alignment_fits(mesh, rng)
    _say(verbose, mesh, f"alignment-fit batch ok, {out['alignment_fits']}")
    out["seq2seq_folds"] = _seq2seq_folds(mesh)
    _say(verbose, mesh, f"seq2seq fold trainer ok, {out['seq2seq_folds']}")
    out["classifier_step"] = _classifier_step(mesh, rng)
    _say(verbose, mesh, f"classifier DP step ok, {out['classifier_step']}")
    out["nested_scorer"] = _nested_scorer(mesh, pts, dcfg)
    _say(verbose, mesh, f"nested-CV scorer ok, {out['nested_scorer']}")
    return out


def grad_err(model_a, model_b) -> float:
    """max |grad a - grad b| over the parameters, over max |grad b|: the
    gradients a step left behind (the reduced ones of a sharded step)."""
    diff = top = 0.0
    for a, b in zip(model_a.parameters(), model_b.parameters()):
        diff = max(diff, float((a.grad - b.grad).abs().max()))
        top = max(top, float(b.grad.abs().max()))
    return diff / max(top, 1e-30)


def _check_step(name: str, loss, loss_1, err: float) -> dict:
    loss, loss_1 = float(loss), float(loss_1)
    rel = abs(loss - loss_1) / max(abs(loss_1), 1e-30)
    if not (np.isfinite(loss) and rel <= DP_LOSS_RTOL
            and err <= DP_GRAD_RTOL):
        raise RuntimeError(f"{name}: loss {loss} vs one device {loss_1} "
                           f"(rel {rel}), gradient rel err {err}")
    return {"loss": loss, "loss_rel_err": rel, "grad_rel_err": err}


def _ctc_step(mesh, rng) -> dict:
    """Surface 1: the padded data-parallel CTC step on 2 n + 1 rows
    against the one-device step from the same state (dropout 0)."""
    import copy

    from cross_patient_speech_decoding_tpu_torch.models import RealtimeRNN
    from cross_patient_speech_decoding_tpu_torch.train import (
        create_train_state,
        make_ctc_train_step,
        make_optimizer,
    )

    dev = mesh.device
    B, T, C, L = 2 * mesh.size + 1, 60, 12, 3
    x = torch.as_tensor(rng.normal(size=(B, T, C)), dtype=torch.float32,
                        device=dev)
    y = torch.as_tensor(rng.integers(1, 11, (B, L)), device=dev)
    il = torch.full((B,), T, device=dev)
    ll = torch.full((B,), L, device=dev)
    batch = (x, y, il, ll)
    tx = make_optimizer(1e-3, 1e-5, 100)
    m0 = RealtimeRNN(C, 32, 2, 11, dropout=0.0, win_size=4, stride=2,
                     seed=0, device=dev)
    m_dp, m_1 = copy.deepcopy(m0), copy.deepcopy(m0)
    gen = torch.Generator(device=dev).manual_seed(1)
    _, met = pm.make_padded_sharded_ctc_train_step(m_dp, tx, mesh)(
        create_train_state(m_dp, tx), batch, gen)
    _, met_1 = make_ctc_train_step(m_1, tx)(create_train_state(m_1, tx),
                                           batch, gen)
    res = _check_step("ctc step", met["loss"], met_1["loss"],
                      grad_err(m_dp, m_1))
    return {"rows": B, **res}


def _patients(dev):
    from cross_patient_speech_decoding_tpu_torch.data import (
        make_synthetic_patients_device,
    )
    from cross_patient_speech_decoding_tpu_torch.decoders import (
        DecodeConfig,
        PatientArrays,
    )

    ds = make_synthetic_patients_device(
        seed=0, n_patients=3, n_classes=5, trials_per_class=8, T=10,
        channels=(12, 10, 14), latent_dim=4, noise=0.3, device=dev)
    pts = [PatientArrays(X=ds.X[p],
                         y=torch.as_tensor(ds.class_ids[p], device=dev),
                         y_align=torch.as_tensor(ds.class_ids[p],
                                                 device=dev))
           for p in range(3)]
    dcfg = DecodeConfig(n_comp=0.9, max_k=6, n_classes=ds.n_classes,
                        n_align_classes=ds.n_classes, lam=1.0,
                        kernel="linear", tar_in_train=True, bagging=0,
                        seed=0)
    return pts, dcfg


def _fold_decode(mesh, pts, dcfg) -> dict:
    """Surface 2: the fixed-parameter decode with one fold a rank, against
    the same folds decoded in one batch on this rank."""
    from cross_patient_speech_decoding_tpu_torch.data.splits import (
        stratified_kfold_masks,
    )
    from cross_patient_speech_decoding_tpu_torch.decoders.pooled import (
        make_cv_decoder,
    )

    dev = mesh.device
    n_folds = max(2, mesh.size)
    tr, te = stratified_kfold_masks(pts[0].y.cpu().numpy(), n_folds,
                                    np.random.default_rng(0))
    tr, te = (torch.as_tensor(a, dtype=torch.float32, device=dev)
              for a in (tr, te))
    accs = make_cv_decoder("sep_align", dcfg, mesh=mesh)(
        pts[0], tuple(pts[1:]), tr, te)
    accs_1 = make_cv_decoder("sep_align", dcfg)(pts[0], tuple(pts[1:]), tr,
                                                te)
    if accs.shape != (n_folds,) or not bool(torch.isfinite(accs).all()):
        raise RuntimeError(f"fold-sharded decode gave {accs}")
    return {"folds": n_folds, "acc": float(accs.mean()),
            "max_acc_diff_vs_one_device": float((accs - accs_1).abs().max())}


def _alignment_fits(mesh, rng) -> dict:
    """Surface 3: a batch of 2 n chol CCA fits, each rank fitting its
    block, the canonical correlations gathered, against the whole batch
    fitted on this rank."""
    from cross_patient_speech_decoding_tpu_torch.ops.cca import (
        fit_cca_aligner,
    )

    dev = mesh.device
    BF, N, T, K, C = 2 * mesh.size, 20, 6, 5, 4
    xa = torch.as_tensor(rng.normal(size=(BF, N, T * K)),
                         dtype=torch.float32, device=dev)
    xb = torch.as_tensor(rng.normal(size=(BF, N, T * K)),
                         dtype=torch.float32, device=dev)
    ids = torch.as_tensor(np.tile(rng.integers(0, C, N), (BF, 1)),
                          device=dev)
    part = pm.shard_batch((xa, xb, ids), mesh)
    fit = fit_cca_aligner(part[0], part[1], part[2], part[2], C, t_len=T)
    corrs = pm.all_gather_rows(fit.alignment.canon_corrs, mesh)
    corrs_1 = fit_cca_aligner(xa, xb, ids, ids, C,
                              t_len=T).alignment.canon_corrs
    if not bool(torch.isfinite(corrs).all()):
        raise RuntimeError(f"alignment fits gave {corrs}")
    return {"fits": BF, "top_corr": float(corrs[:, 0].mean()),
            "max_corr_diff_vs_one_device":
                float((corrs - corrs_1).abs().max())}


def _seq2seq_folds(mesh) -> dict:
    """Surface 4: the seq2seq fold trainer with its folds sharded, bit for
    bit the unsharded trainer on this rank (same folds, seeds and
    device)."""
    import functools

    from cross_patient_speech_decoding_tpu_torch.data import (
        make_synthetic_patients_device,
    )
    from cross_patient_speech_decoding_tpu_torch.data.splits import (
        stratified_kfold_masks,
    )
    from cross_patient_speech_decoding_tpu_torch.models import Seq2SeqRNN
    from cross_patient_speech_decoding_tpu_torch.train.fold_parallel import (
        make_seq2seq_fold_trainer,
        pooled_fold_arrays,
    )

    dev = mesh.device
    n_folds = max(2, mesh.size)
    ds = make_synthetic_patients_device(
        seed=1, n_patients=1, n_classes=4, trials_per_class=4 * n_folds,
        T=12, channels=(6,), latent_dim=3, noise=0.3, seq_len=2, device=dev)
    ys = torch.as_tensor(np.asarray(ds.y_seq[0]) - 1, device=dev)
    tr, te = stratified_kfold_masks(np.asarray(ds.class_ids[0]), n_folds,
                                    np.random.default_rng(1))
    arrays = pooled_fold_arrays(ds.X[0], ys, [], [], tr, test_masks=te)
    model = functools.partial(Seq2SeqRNN, n_filters=4, hidden=8,
                              num_classes=9, kernel_size=3, seq_length=2)
    accs, _ = make_seq2seq_fold_trainer(model, *arrays, lr=1e-3, seed=1,
                                        mesh=mesh)(2)
    accs_1, _ = make_seq2seq_fold_trainer(model, *arrays, lr=1e-3,
                                          seed=1)(2)
    if accs.shape != (n_folds,) or not torch.equal(accs, accs_1):
        raise RuntimeError(f"fold-sharded trainer {accs} vs one device "
                           f"{accs_1}")
    return {"folds": n_folds, "acc": float(accs.mean()),
            "equal_to_one_device": True}


def _classifier_step(mesh, rng) -> dict:
    """Surface 5: the data-parallel classifier step on 3 n + 1 rows (a
    transformer, dropout 0) against the one-device step."""
    import copy

    from cross_patient_speech_decoding_tpu_torch.models import (
        TransformerClassifier,
    )
    from cross_patient_speech_decoding_tpu_torch.train import (
        create_train_state,
        make_classifier_train_step,
        make_optimizer,
    )

    dev = mesh.device
    B = 3 * mesh.size + 1
    x = torch.as_tensor(rng.normal(size=(B, 10, 6)), dtype=torch.float32,
                        device=dev)
    y = torch.as_tensor(rng.integers(0, 4, (B,)), device=dev)
    tx = make_optimizer(1e-3, 1e-5, 100)
    m0 = TransformerClassifier(6, 8, 4, n_heads=2, n_layers=1, dim_ff=16,
                               dropout=0.0, seed=5, device=dev)
    m_dp, m_1 = copy.deepcopy(m0), copy.deepcopy(m0)
    gen = torch.Generator(device=dev).manual_seed(6)
    _, met = pm.make_sharded_classifier_train_step(m_dp, tx, mesh)(
        create_train_state(m_dp, tx), (x, y), gen)
    _, met_1 = make_classifier_train_step(m_1, tx)(
        create_train_state(m_1, tx), (x, y), gen)
    res = _check_step("classifier step", met["loss"], met_1["loss"],
                      grad_err(m_dp, m_1))
    return {"rows": B, "acc": float(met["acc"]), **res}


def _nested_scorer(mesh, pts, dcfg) -> dict:
    """Surface 6: the nested-CV scorer and refit with n + 1 outer folds
    (padded to a multiple of the ranks), against the unsharded pair."""
    from cross_patient_speech_decoding_tpu_torch.data.splits import (
        stratified_kfold_masks,
    )
    from cross_patient_speech_decoding_tpu_torch.decoders.nested_cv import (
        inner_cv_masks,
        make_candidate_scorer,
    )

    dev = mesh.device
    y0 = pts[0].y.cpu().numpy()
    n_outer, n_inner, n_points = mesh.size + 1, 2, 2
    rng = np.random.default_rng(7)
    tr, te = stratified_kfold_masks(y0, n_outer, rng)
    itr = np.zeros((n_outer, n_inner, len(y0)))
    ite = np.zeros((n_outer, n_inner, len(y0)))
    for k in range(n_outer):
        itr[k], ite[k] = inner_cv_masks(tr[k], y0, n_inner, rng)

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    hp = {"n_comp": f32(rng.uniform(0.6, 0.95, (n_outer, n_points))),
          "lam": f32(rng.uniform(0.01, 1.0, (n_outer, n_points))),
          "gamma_scale": torch.ones((n_outer, n_points), device=dev)}
    args = (pts[0], tuple(pts[1:]), f32(itr), f32(ite), hp)
    score, final = make_candidate_scorer("sep_align", dcfg, mesh=mesh)
    score_1, final_1 = make_candidate_scorer("sep_align", dcfg)
    s, s_1 = score(*args), score_1(*args)
    best = s.argmax(dim=1)
    hp_best = {k: v[torch.arange(n_outer, device=dev), best]
               for k, v in hp.items()}
    fin = (pts[0], tuple(pts[1:]), f32(tr), f32(te), hp_best)
    accs, _ = final(*fin)
    accs_1, _ = final_1(*fin)
    if s.shape != (n_outer, n_points) or not bool(torch.isfinite(s).all()) \
            or accs.shape != (n_outer,):
        raise RuntimeError(f"nested scorer gave {s}, {accs}")
    return {"outer_folds": n_outer, "acc": float(accs.mean()),
            "max_score_diff_vs_one_device": float((s - s_1).abs().max()),
            "max_acc_diff_vs_one_device": float((accs - accs_1).abs().max())}
