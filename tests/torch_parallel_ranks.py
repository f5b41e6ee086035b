"""Rank bodies of the port's multi-rank tests.

``parallel.launch`` starts each rank with ``spawn`` and finds its function
by name, so the bodies live in a module of their own. It imports no JAX
(the ranks report whether anything did); the tests hold the results
against the JAX package and the one-device port in the test process.
"""

import contextlib
import os
import sys
import time

import numpy as np
import torch

from cross_patient_speech_decoding_tpu_torch import models, parallel
from cross_patient_speech_decoding_tpu_torch.parallel import mesh as pm
from cross_patient_speech_decoding_tpu_torch.train import (
    create_train_state,
    make_optimizer,
)


@contextlib.contextmanager
def threads(n: int):
    """torch's intra-op threads set to ``n`` within the block: a rank of a
    two-rank CPU launch from a test module at 2 threads runs at 1, and a
    one-device run compared bit for bit with it must too."""
    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def _np(tree):
    return {k: v.detach().numpy().copy() for k, v in tree.items()}


def _state_dict(sd):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}


def _step_result(mesh, model, metrics) -> dict:
    """One step's metrics, parameters and reduced gradients, and whether
    every rank holds the same parameters afterwards."""
    state = _np(model.state_dict())
    states = pm.gather_objects(state, mesh)
    return {
        "metrics": {k: float(v) for k, v in metrics.items()},
        "state": state,
        "grads": {n: p.grad.numpy().copy()
                  for n, p in model.named_parameters()},
        "replicas_equal": all(np.array_equal(s[k], state[k])
                              for s in states for k in state),
    }


def step_checks(spec: dict) -> dict:
    """The data-parallel steps on two CPU ranks: the padded CTC step and
    each classifier of ``spec`` from the given weights and batch (numpy),
    one step each; the rank generators' dropout draws; make_mesh's
    world-size refusal; whether a rank imported JAX."""
    mesh = parallel.make_mesh(2, device="cpu")
    res = {"mesh": (mesh.size, mesh.rank, str(mesh.device),
                    mesh.shape["data"])}
    try:
        parallel.make_mesh(3)
        res["mesh3"] = None
    except ValueError as e:
        res["mesh3"] = str(e)

    c = spec["ctc"]
    m = models.RealtimeRNN(**c["model"], device="cpu")
    m.load_state_dict(_state_dict(c["state"]))
    tx = make_optimizer(**c["tx"])
    step = parallel.make_padded_sharded_ctc_train_step(m, tx, mesh)
    _, met = step(create_train_state(m, tx),
                  tuple(torch.from_numpy(a) for a in c["batch"]), None)
    res["ctc"] = _step_result(mesh, m, met)

    for name, cs in spec["classifiers"].items():
        m = getattr(models, cs["cls"])(*cs["args"], **cs["kw"],
                                       device="cpu")
        m.load_state_dict(_state_dict(cs["state"]))
        tx = make_optimizer(**cs["tx"])
        step = parallel.make_sharded_classifier_train_step(m, tx, mesh)
        _, met = step(create_train_state(m, tx),
                      tuple(torch.from_numpy(a) for a in cs["batch"]),
                      torch.Generator().manual_seed(0))
        res[name] = _step_result(mesh, m, met)

    # dropout: each rank's generator for one step generator, 20000 draws
    gen = torch.Generator().manual_seed(11)
    rank_gen = pm._RankGenerator(mesh.rank)(gen)
    mask = torch.rand(20000, generator=rank_gen) < 0.3
    res["masks"] = pm.gather_objects(mask.numpy(), mesh)
    res["dropout"] = dropout_step(spec)
    res["jax_imported"] = pm.gather_objects("jax" in sys.modules, mesh)
    return res


def dropout_step(spec: dict) -> dict:
    """Two CTC steps at dropout 0.3 on two ranks: the losses, and whether
    the replicas stay equal."""
    mesh = parallel.make_mesh(2, device="cpu")
    c = spec["ctc"]
    m = models.RealtimeRNN(**{**c["model"], "dropout": 0.3}, device="cpu")
    m.load_state_dict(_state_dict(c["state"]))
    tx = make_optimizer(**c["tx"])
    step = parallel.make_padded_sharded_ctc_train_step(m, tx, mesh)
    state = create_train_state(m, tx)
    gen = torch.Generator().manual_seed(5)
    batch = tuple(torch.from_numpy(a) for a in c["batch"])
    losses = []
    for _ in range(2):
        state, met = step(state, batch, gen)
        losses.append(float(met["loss"]))
    return {"losses": losses, **_step_result(mesh, m, met)}


def _write_pid(pid_dir: str, rank: int) -> None:
    """This process's pid in ``pid_dir``/<rank>.pid, whole or not at all:
    the launcher may kill the rank at any point."""
    tmp = os.path.join(pid_dir, f"{rank}.tmp")
    with open(tmp, "w") as f:
        f.write(str(os.getpid()))
    os.replace(tmp, os.path.join(pid_dir, f"{rank}.pid"))


def fail_on_rank(which: int, pid_dir: str) -> None:
    """Rank ``which`` raises; the others wait in an all-reduce that never
    completes. Each rank writes its pid to ``pid_dir`` first."""
    mesh = parallel.make_mesh(2, device="cpu")
    _write_pid(pid_dir, mesh.rank)
    if mesh.rank == which:
        raise ValueError(f"injected failure on rank {which}")
    pm.all_reduce_sum(torch.ones(1), mesh)


def hang_on_rank(which: int, pid_dir: str) -> None:
    """Rank ``which`` sleeps past any deadline; the others return."""
    mesh = parallel.make_mesh(2, device="cpu")
    _write_pid(pid_dir, mesh.rank)
    if mesh.rank == which:
        time.sleep(600)


def decode_checks(spec: dict) -> dict:
    """The fold-sharded decoders on two CPU ranks from numpy patients:
    ``make_cv_decoder(mesh=)`` (accuracies and predictions), the nested
    scorer pair, ``nested_cv_decode_bayes(mesh=)`` and
    ``nested_cv_decode(mesh=)``."""
    from cross_patient_speech_decoding_tpu_torch.decoders import (
        nested_cv as nest,
    )
    from cross_patient_speech_decoding_tpu_torch.decoders import (
        pooled,
    )

    mesh = parallel.make_mesh(2, device="cpu")
    pts = [pooled.PatientArrays(*(torch.from_numpy(a) for a in p))
           for p in spec["pts"]]
    cfg = pooled.DecodeConfig(**spec["cfg"])
    fits = []  # the fits of each fold-program call the scorer makes
    fold_fn = nest._STRATEGIES["sep_align"]

    def counted(tar, cross, tr, te, cfg, hp=None):
        fits.append(tr.shape[0])
        return fold_fn(tar, cross, tr, te, cfg, hp=hp)

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32)

    accs, preds = pooled.make_cv_decoder(
        "sep_align", cfg, fold_batch=spec["fold_batch"], mesh=mesh,
        return_preds=True)(pts[0], tuple(pts[1:]), f32(spec["tr"]),
                           f32(spec["te"]))
    nest._STRATEGIES["sep_align"] = counted
    try:
        score, final = nest.make_candidate_scorer(
            "sep_align", cfg, fit_batch=spec["fit_batch"], mesh=mesh)
    finally:
        nest._STRATEGIES["sep_align"] = fold_fn
    hp = {k: f32(v) for k, v in spec["hp"].items()}
    scores = score(pts[0], tuple(pts[1:]), f32(spec["itr"]),
                   f32(spec["ite"]), hp)
    score_fits = list(fits)
    f_accs, f_preds = final(pts[0], tuple(pts[1:]), f32(spec["tr3"]),
                            f32(spec["te3"]),
                            {k: v[:, 0] for k, v in hp.items()})
    b_accs, _ = nest.nested_cv_decode_bayes(
        pts[0], tuple(pts[1:]), cfg, mesh=mesh, **spec["bayes"])
    r_accs, r_best, _ = nest.nested_cv_decode(
        pts[0], tuple(pts[1:]), cfg, mesh=mesh, **spec["random"])
    return {"random_accs": r_accs, "random_best": r_best,
            "accs": accs.numpy(), "preds": preds.numpy(),
            "scores": scores.numpy(), "score_fits": score_fits,
            "final_accs": f_accs.numpy(),
            "final_preds": f_preds.numpy(), "bayes_accs": b_accs}


def fold_trainer_checks(spec: dict) -> dict:
    """The seq2seq fold trainer with a mesh of two CPU ranks: its folds
    sharded (per-fold accuracies, how many models this rank trained), and
    a fold count that does not divide the ranks (it warns and trains every
    fold on every rank)."""
    import functools
    import warnings

    from cross_patient_speech_decoding_tpu_torch.train import (
        fold_parallel as tfp,
    )

    mesh = parallel.make_mesh(2, device="cpu")
    model = functools.partial(models.Seq2SeqRNN, **spec["model"])
    fn = tfp.make_seq2seq_fold_trainer_fn(model, teacher_forcing=0.5,
                                          mesh=mesh)
    out = {}
    for name in ("arrays", "arrays_odd"):
        args = [torch.from_numpy(a) for a in spec[name]]
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            accs, local = fn(*args, spec["seed"], spec["epochs"])
        out[name] = {"accs": accs.numpy(), "n_local": len(local),
                     "warned": [str(w.message) for w in caught]}
    return out


def bucket_checks(spec: dict) -> dict:
    """The CTC bucket trainers with a mesh on two CPU ranks: a CV bucket
    whose trials x folds divide the ranks, one that does not (it warns),
    and the holdout bucket."""
    import warnings

    from cross_patient_speech_decoding_tpu_torch.sweep import ctc

    mesh = parallel.make_mesh(2, device="cpu")
    batch = tuple(torch.from_numpy(a) for a in spec["batch"])
    kw = spec["kw"]
    cv = ctc.make_ctc_cv_bucket_trainer(batch, spec["w_tr"], spec["w_va"],
                                        mesh=mesh, **kw)
    out = {"cv": cv(spec["cfgs"], spec["epochs"])}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out["cv_odd"] = cv(spec["cfgs"][:1], spec["epochs"])
    out["warned"] = [str(w.message) for w in caught]
    hold = ctc.make_ctc_bucket_trainer(batch, batch, mesh=mesh, **kw)
    out["holdout"] = hold(spec["cfgs"], spec["epochs"])
    return out


def tune_small(cfg):
    """``run_tune_ctc`` on the CPU with the random search's space narrowed
    to hidden 8, 2 layers and dropout 0 (tests/test_torch_tune_driver.py's
    ``small_space``), in this process: inside a launch, the ranks' run."""
    import functools

    from cross_patient_speech_decoding_tpu_torch import sweep
    from cross_patient_speech_decoding_tpu_torch.cli import experiments

    orig = sweep.SweepSpace
    sweep.SweepSpace = functools.partial(orig, hidden=(8,), n_layers=(2,),
                                         dropout=(0.0,))
    try:
        return experiments.run_tune_ctc(cfg, verbose=False, device="cpu")
    finally:
        sweep.SweepSpace = orig
