"""Fold-parallel seq2seq training: the CV folds of an iteration through one
trainer.

Port of ``cross_patient_speech_decoding_tpu/train/fold_parallel.py``.
Folds differ only in which target trials train, so every fold trains on
the same pooled array with a per-fold sample weight in the loss (target
train rows 1, its held-out rows 0, cross rows 1): one full-batch step an
epoch, then one evaluation on the fold's held-out target rows.

The JAX package vmaps the folds over stacked parameters inside one jitted
scan. The port's GRU kernels are ctypes launches with no vmap, so it
trains the F folds' models in turn: one ``Seq2SeqRNN``, one AdamW state
and one ``torch.Generator`` per fold, one launch of each kernel per fold
and step. The rows of weight 0 still go through the forward, so they enter
the training-mode BatchNorm's batch statistics, as in JAX.

Two levels, as in JAX: :func:`make_seq2seq_fold_trainer_fn` builds
``train(X_pool, y_pool, train_weights, test_masks, seed, epochs)``, which
the driver calls once per fold chunk; :func:`make_seq2seq_fold_trainer`
closes over the arrays.

With a ``mesh`` (``parallel.make_mesh``) the folds are sharded over its
ranks: each rank trains the contiguous block of folds it owns, in turn,
from the same per-fold seeds, and the accuracies are gathered, so the
result equals the one-device run's bit for bit on the same device.
"""

from __future__ import annotations

import functools
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from cross_patient_speech_decoding_tpu_torch.ops.metrics import cmat_acc
from cross_patient_speech_decoding_tpu_torch.parallel.mesh import (
    all_gather_rows,
    block_range,
)
from cross_patient_speech_decoding_tpu_torch.train.loops import make_optimizer
from cross_patient_speech_decoding_tpu_torch.train.state import (
    create_train_state,
)
from cross_patient_speech_decoding_tpu_torch.train.steps import (
    _backward,
    _update,
)
from cross_patient_speech_decoding_tpu_torch.utils.profiling import annotate

# a fold's dropout masks and teacher-forcing coins come from a generator
# seeded seed + DROPOUT_SEED_OFFSET + fold, its weights from seed + fold
DROPOUT_SEED_OFFSET = 1000


def _weighted_token_loss(logits, y, w):
    """Token cross-entropy weighted by the trials' sample weights:
    ``sum(ce * w_tok) / max(sum(w_tok), 1)``, w_tok each trial's weight
    repeated over its ``seq_length`` tokens. logits (B, L, n_classes),
    y (B, L), w (B,)."""
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         y.reshape(-1), reduction="none")
    w_tok = w.repeat_interleave(y.shape[1])
    return (ce * w_tok).sum() / w_tok.sum().clamp(min=1.0)


def _fold_epoch(state, tx, x, y, w, teacher_forcing: float, generator):
    """One full-batch training step of one fold's model (dropout on,
    teacher forcing at ``teacher_forcing``, the BatchNorm's running
    averages moved by the whole batch); returns the 0-d loss, before the
    update."""
    with annotate("train_step", root=True, rows=int(x.shape[0])):
        m = state.model
        m.train()
        state.optimizer.zero_grad(set_to_none=True)
        with annotate("forward"):
            logits = m(x, y, teacher_forcing, generator=generator)
        with annotate("loss"):
            loss = _weighted_token_loss(logits, y, w)
        _backward(loss)
        _update(state, tx)
    return loss.detach()


def _fold_eval(model, x, y, test_mask):
    """The fold's test accuracy: eval mode, no teacher forcing,
    ``cmat_acc`` over the tokens of the rows in ``test_mask``."""
    model.eval()
    with torch.no_grad():
        logits = model(x, None, 0.0)
    preds = logits.argmax(dim=-1).reshape(-1)
    mask = test_mask.repeat_interleave(y.shape[1])
    return cmat_acc(y.reshape(-1), preds, model.num_classes, mask)


def make_seq2seq_fold_trainer_fn(
    model,
    *,
    lr: float = 1e-3,
    weight_decay: float = 1e-5,
    decay_iters: int = 20,
    end_factor: float = 0.01,
    clip: float = 0.5,
    teacher_forcing: float = 0.5,
    mesh=None,
    fold_axis: str = "data",
    rnn_impl: str = "scan",
):
    """Build the fold trainer.

    Args:
        model: ``model(in_channels, seed=..., device=...)`` returns a fresh
            ``Seq2SeqRNN`` (``functools.partial`` of the class with its
            widths), its weights drawn from ``seed`` on the host.
        lr, weight_decay, decay_iters, end_factor, clip: the optimizer,
            ``train.loops.make_optimizer``: global-norm clipping, then
            AdamW on ``linear_schedule(lr, lr * end_factor, decay_iters)``,
            stepped once an epoch.
        teacher_forcing: the training forward's teacher-forcing ratio.
        mesh, fold_axis: the folds sharded over the mesh's ranks, each
            rank training its contiguous block (``fold_axis`` is the
            mesh's one axis). A fold count that does not divide the world
            size warns and trains every fold on every rank, as JAX runs it
            unsharded.
        rnn_impl: 'scan' or 'pallas', anything else raises; 'pallas' with
            a mesh raises, as in JAX. The JAX package picks its scan GRU
            or its Pallas kernels with it; the port has one GRU route per
            device, so both values run the kernels on a CUDA tensor and
            their plain versions on a CPU one.

    Returns ``train(X_pool, y_pool, train_weights, test_masks, seed,
    epochs, init_states=None) -> (accs (F,), models)``:

        X_pool: (N, T, C) pooled features shared by every fold, or
            (F, N, T, C) per-fold features, on the run's device.
        y_pool: (N, L) pooled sequence labels.
        train_weights: (F, N) per-fold sample weights of the loss.
        test_masks: (F, N) per-fold evaluation masks.
        seed: fold f's weights from ``seed + f`` (as ``Seq2SeqRNN(seed=)``),
            its dropout and coins from a generator on the device seeded
            ``seed + DROPOUT_SEED_OFFSET + f``.
        init_states: optional per-fold state dicts loaded over the fresh
            weights (the tests start from the JAX package's initial
            weights with them).

    ``models`` are the F trained ``Seq2SeqRNN`` (the JAX trainer returns
    the stacked parameters); with a sharding mesh, this rank's block of
    them. ``accs`` holds every fold on every rank.
    """
    if rnn_impl not in ("scan", "pallas"):
        raise ValueError(
            f"rnn_impl must be 'scan' or 'pallas', got {rnn_impl!r}")
    if rnn_impl == "pallas" and mesh is not None:
        # JAX's refusal (its fold axis is both the mesh axis and the
        # Pallas kernel's grid dimension); kept for the same interface
        raise ValueError(
            "rnn_impl='pallas' cannot be combined with a mesh: the "
            "sharded fold axis is the Pallas kernel's grid dimension")
    tx = make_optimizer(lr, weight_decay, decay_iters, end_factor=end_factor,
                        clip=clip)

    def train_folds(X_pool, y_pool, train_weights, test_masks, seed: int,
                    epochs: int, init_states=None):
        dev = X_pool.device
        n_folds = train_weights.shape[0]
        per_fold_x = X_pool.dim() == 4
        y = torch.as_tensor(y_pool, device=dev).long()
        w = torch.as_tensor(train_weights, dtype=torch.float32, device=dev)
        te = torch.as_tensor(test_masks, dtype=torch.float32, device=dev)
        folds, sharded = range(n_folds), False
        if mesh is not None:
            width = mesh.shape[fold_axis]
            if n_folds % width:
                warnings.warn(
                    f"{n_folds} folds do not divide the {width}-rank mesh; "
                    "this fold chunk runs UNSHARDED on every rank",
                    stacklevel=2)
            else:
                folds, sharded = range(*block_range(n_folds, mesh)), True
        accs, models = [], []
        for f in folds:
            x = X_pool[f] if per_fold_x else X_pool
            m = model(x.shape[-1], seed=seed + f, device=dev)
            if init_states is not None:
                m.load_state_dict(init_states[f])
            state = create_train_state(m, tx)
            gen = torch.Generator(device=dev).manual_seed(
                seed + DROPOUT_SEED_OFFSET + f)
            for epoch in range(epochs):
                with annotate("epoch", epoch=epoch, fold=f):
                    _fold_epoch(state, tx, x, y, w[f], teacher_forcing, gen)
            state.optimizer.zero_grad(set_to_none=True)
            with annotate("validation", fold=f):
                accs.append(_fold_eval(m, x, y, te[f]))
            models.append(m)
        accs = torch.stack(accs)
        if sharded:
            accs = all_gather_rows(accs, mesh)
        return accs, models

    return train_folds


def make_seq2seq_fold_trainer(
    model,
    X_pool: torch.Tensor,
    y_pool: torch.Tensor,
    train_weights: torch.Tensor,
    test_masks: torch.Tensor,
    *,
    lr: float = 1e-3,
    weight_decay: float = 1e-5,
    decay_iters: int = 20,
    end_factor: float = 0.01,
    clip: float = 0.5,
    teacher_forcing: float = 0.5,
    seed: int = 0,
    mesh=None,
    fold_axis: str = "data",
    rnn_impl: str = "scan",
):
    """``train_folds(epochs) -> (accs (F,), models)`` for F folds: the
    trainer of :func:`make_seq2seq_fold_trainer_fn` closed over the fold
    arrays and the seed. (The JAX wrapper's ``.lower`` fills a compile
    cache, which the port does not have.)"""
    fn = make_seq2seq_fold_trainer_fn(
        model, lr=lr, weight_decay=weight_decay, decay_iters=decay_iters,
        end_factor=end_factor, clip=clip, teacher_forcing=teacher_forcing,
        mesh=mesh, fold_axis=fold_axis, rnn_impl=rnn_impl)
    return functools.partial(fn, X_pool, y_pool, train_weights, test_masks,
                             seed)


def pooled_fold_arrays(tar_feats, tar_y, cross_feats, cross_ys,
                       train_masks: np.ndarray,
                       test_masks: np.ndarray | None = None):
    """(X_pool, y_pool, train_weights, test_masks) from per-fold target
    masks and the always-in-train cross data.

    ``tar_feats`` is (N0, T, K) shared by every fold or (F, N0, T, K) per
    fold (then the trial axis is 1, and each cross feature is (F, Ni, T,
    K)). ``train_masks`` is (F, N0) numpy. ``test_masks`` defaults to the
    train complement over the target rows; pass it when some target rows
    belong to neither set (augmented copies of test rows). Weights and
    masks come back as float32 tensors on the features' device.
    """
    dev = tar_feats.device
    trial_dim = 1 if tar_feats.dim() == 4 else 0
    X_pool = torch.cat([tar_feats] + list(cross_feats), dim=trial_dim)
    y_pool = torch.cat([torch.as_tensor(y, device=dev)
                        for y in [tar_y] + list(cross_ys)])
    train_masks = np.asarray(train_masks)
    n_folds, n0 = train_masks.shape
    n_cross = X_pool.shape[trial_dim] - n0
    if test_masks is None:
        test_masks = 1.0 - train_masks
    w = np.concatenate(
        [train_masks, np.ones((n_folds, n_cross), train_masks.dtype)], axis=1)
    te = np.concatenate(
        [np.asarray(test_masks, train_masks.dtype),
         np.zeros((n_folds, n_cross), train_masks.dtype)], axis=1)
    return (X_pool, y_pool,
            torch.as_tensor(w, dtype=torch.float32, device=dev),
            torch.as_tensor(te, dtype=torch.float32, device=dev))
