"""CTC-RNN trial buckets: the ``train_bucket`` of :func:`sweep.search.
run_sweep` and :func:`sweep.bayes.run_bohb` for the realtime CTC RNN.

Port of ``cross_patient_speech_decoding_tpu/sweep/ctc.py``. Trials that
share an architecture (hidden, layers, dropout) form a bucket; each trial
has its own learning rate and weight decay. Each model trains full-batch,
one step an epoch, with AdamW and the learning rate
``lr * (1 - min(count / decay_steps, 1))``, then is scored by greedy
decoding and PER on its validation rows.

:func:`make_ctc_cv_bucket_trainer` is the reference's per-trial k-fold
CV (``train_func_cv``, tune_ctc_rnn.py:550-634): every trial trains one
model per fold, fold membership enters as per-sample loss weights, and the
trial's metric is the fold-mean validation PER.

The JAX package vmaps a bucket's (trial x fold) models over stacked
parameters (``optax.inject_hyperparams`` carries the per-model
hyperparameters). The port's GRU kernels are ctypes launches with no vmap,
so it trains the models in turn, as ``train/fold_parallel.py`` does for
folds: one ``RealtimeRNN``, one AdamW and one ``torch.Generator`` per
model, so every model launches the four unidirectional GRU kernels on a
card. Model i of a bucket (fold-fastest over trials x folds) draws its
weights from ``seed + i`` (``RealtimeRNN``'s host generator) and its
dropout masks from a generator on the device seeded
``seed + DROPOUT_SEED_OFFSET + i``; ``train_bucket(..., init_params=)``
loads given weights instead (the tests start from the JAX package's).

With a ``mesh`` (``parallel.make_mesh``) a bucket's models are sharded
over its ranks: each rank trains its contiguous block of the (trial x
fold) models from the same per-model seeds, and the PERs are gathered, so
the result is the one-device run's. A bucket whose model count does not
divide the world size trains every model on every rank (JAX runs it
unsharded; its CV trainer warns).

``CPSD_EPOCH_SEG`` keeps its JAX meaning: the epochs run in segments of
that many, with a one-element host read after each, and each model's
generator runs on across the segments, so the segment length changes no
result.
"""

from __future__ import annotations

import os
import warnings
from typing import Sequence

import numpy as np
import torch

from cross_patient_speech_decoding_tpu_torch.models.realtime_rnn import (
    RealtimeRNN,
    adjusted_input_lengths,
)
from cross_patient_speech_decoding_tpu_torch.ops.ctc import (
    ctc_loss_mean,
    greedy_decode,
)
from cross_patient_speech_decoding_tpu_torch.ops.metrics import edit_distance
from cross_patient_speech_decoding_tpu_torch.parallel.mesh import (
    all_gather_rows,
    block_range,
)
from cross_patient_speech_decoding_tpu_torch.train.loops import make_optimizer
from cross_patient_speech_decoding_tpu_torch.train.state import (
    create_train_state,
)
from cross_patient_speech_decoding_tpu_torch.train.steps import _update
from cross_patient_speech_decoding_tpu_torch.utils.device import (
    resolve_device,
)

# epochs a segment: a host read of one parameter element after each
EPOCH_SEG = int(os.environ.get("CPSD_EPOCH_SEG", "100"))

# model i's dropout generator is seeded seed + DROPOUT_SEED_OFFSET + i,
# its weights seed + i
DROPOUT_SEED_OFFSET = 1000


def _sync_tiny(model) -> None:
    """Wait for the segment's queued work: read one element of the model's
    first parameter on the host."""
    float(next(model.parameters()).detach().reshape(-1)[0])


def _weighted_ctc_loss(model, x, y, in_adj, ll, w, blank, generator):
    """Fold-masked CTC loss: the same ``ctc_loss_mean`` as the train steps,
    reduced with sample weights (``w`` None: the plain mean)."""
    logits = model(x, generator=generator)
    return ctc_loss_mean(logits, in_adj, y, ll, blank, weights=w)


def _val_per(model, x, y, ll, in_adj, blank, w=None) -> float:
    """Validation PER (%) of ``model`` in eval mode: greedy decoding under
    the valid-window mask, summed edit distances over summed label
    lengths, each row weighted by ``w`` (None: every row once)."""
    model.eval()
    with torch.no_grad():
        logits = model(x)
    lp = torch.log_softmax(logits, dim=-1)
    mask = (torch.arange(logits.shape[1], device=lp.device)[None, :]
            < in_adj[:, None])
    dec, lens = greedy_decode(lp, blank, mask)
    dists = edit_distance(dec, lens, y, ll)
    if w is None:
        w = torch.ones_like(dists)
    per = (dists * w).sum() / (ll.to(w.dtype) * w).sum().clamp(min=1.0)
    return float(per * 100.0)


def _as_tensor(a, dev, dtype=None):
    if torch.is_tensor(a):
        return a.to(device=dev, dtype=dtype or a.dtype)
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)


def _model_block(n_models: int, mesh, axis: str, warn: str | None):
    """(models this rank trains, whether they are a shard): the rank's
    contiguous block of the bucket's ``n_models`` when the mesh divides
    them, else all of them (with the warning ``warn``, if given)."""
    if mesh is None:
        return range(n_models), False
    width = mesh.shape[axis]
    if n_models % width:
        if warn:
            warnings.warn(f"{warn} does not divide the {width}-rank mesh; "
                          "running UNSHARDED on every rank", stacklevel=3)
        return range(n_models), False
    return range(*block_range(n_models, mesh)), True


def _gathered(pers: torch.Tensor, mesh, sharded: bool) -> np.ndarray:
    """Every model's PER on every rank: this rank's block gathered when
    the models are a shard."""
    if sharded:
        pers = all_gather_rows(pers, mesh)
    return pers.cpu().numpy()


class _Bucket:
    """What one bucket's models share: the architecture, the window
    geometry and the optimizer recipe."""

    def __init__(self, arch: dict, in_channels: int, n_classes: int,
                 win_size: int, stride: int, blank: int, decay_steps: int,
                 seed: int, dev):
        self.arch, self.in_channels, self.n_classes = (arch, in_channels,
                                                       n_classes)
        self.win_size, self.stride, self.blank = win_size, stride, blank
        self.decay_steps, self.seed, self.dev = decay_steps, seed, dev

    def train(self, i: int, lr: float, wd: float, epochs: int, x, y, in_adj,
              ll, w, init_state=None):
        """Model i of the bucket: built, trained ``epochs`` full-batch steps
        in segments of ``EPOCH_SEG``, left in eval mode."""
        a = self.arch
        model = RealtimeRNN(
            self.in_channels, a["hidden"], a["n_layers"], self.n_classes,
            dropout=a["dropout"], win_size=self.win_size, stride=self.stride,
            blank=self.blank, seed=self.seed + i, device=self.dev)
        if init_state is not None:
            model.load_state_dict(init_state)
        tx = make_optimizer(lr, wd, self.decay_steps)
        state = create_train_state(model, tx)
        gen = torch.Generator(device=self.dev).manual_seed(
            self.seed + DROPOUT_SEED_OFFSET + i)
        model.train()
        for s0 in range(0, epochs, EPOCH_SEG):
            for _ in range(s0, min(s0 + EPOCH_SEG, epochs)):
                state.optimizer.zero_grad(set_to_none=True)
                loss = _weighted_ctc_loss(model, x, y, in_adj, ll, w,
                                          self.blank, gen)
                loss.backward()
                _update(state, tx)
            _sync_tiny(model)
        state.optimizer.zero_grad(set_to_none=True)
        model.eval()
        return model


def make_ctc_cv_bucket_trainer(
    data_batch,
    fold_train_masks,
    fold_val_masks,
    n_classes: int,
    *,
    win_size: int = 14,
    stride: int = 4,
    blank: int = 0,
    decay_steps: int = 100,
    seed: int = 0,
    mesh=None,
    trial_axis: str = "data",
    model_chunk: int = 0,
):
    """CV variant: ``train_bucket(configs, epochs, init_params=None)`` ->
    the fold-mean validation PER of each trial.

    Args:
        data_batch: (x, labels, input_lens, label_lens). ``x`` is (N, T, C),
            one array shared by every fold (precomputed transforms, no
            fitting), or (F, N, T, C), per-fold features for the leak-free
            on-the-fly PCA and CCA contexts, each fold's transforms fitted
            on its own train rows. Labels and lengths are fold-invariant.
            The models train on ``x``'s device (numpy: the first CUDA
            card).
        fold_train_masks, fold_val_masks: (F, N) per-fold membership, the
            loss's sample weights and the validation PER's.
        n_classes, win_size, stride, blank: the RealtimeRNN's.
        decay_steps: the learning rate decays linearly to 0 over this many
            updates.
        seed: model i's weights from ``seed + i``, its dropout from
            ``seed + DROPOUT_SEED_OFFSET + i`` (i fold-fastest over the
            bucket's trials x folds).
        mesh, trial_axis: the bucket's B x F models sharded over the
            mesh's ranks (``trial_axis`` is its one axis) when B * F
            divides the world size; else a warning, and every rank trains
            all of them.
        model_chunk: how many fold models train concurrently in the JAX
            package (a single-device memory bound, so it cannot go with a
            mesh). The port trains one model at a time whatever its value.

    ``train_bucket``'s ``init_params``: optional list of per-model state
    dicts (fold-fastest), loaded over the fresh weights.
    """
    x, y, il, ll = data_batch
    F = np.shape(fold_train_masks)[0]
    per_fold_x = x.ndim == 4
    if per_fold_x and x.shape[0] != F:
        raise ValueError(
            f"per-fold x has {x.shape[0]} folds, masks have {F}"
        )
    if model_chunk and mesh is not None:
        raise ValueError(
            "model_chunk is a single-device memory bound; with a mesh the "
            "model axis is already sharded — drop one of the two"
        )
    dev = x.device if torch.is_tensor(x) else resolve_device(None)
    x = _as_tensor(x, dev, torch.float32)
    y = _as_tensor(y, dev, torch.long)
    ll = _as_tensor(ll, dev, torch.long)
    in_adj = adjusted_input_lengths(_as_tensor(il, dev, torch.long),
                                    win_size, stride)
    w_tr = _as_tensor(fold_train_masks, dev, torch.float32)
    w_va = _as_tensor(fold_val_masks, dev, torch.float32)

    def train_bucket(cfgs: Sequence[dict], epochs: int, init_params=None):
        bucket = _Bucket(cfgs[0], x.shape[-1], n_classes, win_size, stride,
                         blank, decay_steps, seed, dev)
        models, sharded = _model_block(
            len(cfgs) * F, mesh, trial_axis,
            f"CV bucket of {len(cfgs)} trials x {F} folds")
        pers = []
        for i in models:
            c, f = cfgs[i // F], i % F
            xf = x[f] if per_fold_x else x
            model = bucket.train(
                i, c["lr"], c["weight_decay"], epochs, xf, y, in_adj, ll,
                w_tr[f], None if init_params is None else init_params[i])
            pers.append(_val_per(model, xf, y, ll, in_adj, blank, w_va[f]))
            del model
        pers = _gathered(torch.tensor(pers, dtype=torch.float64, device=dev),
                         mesh, sharded).reshape(len(cfgs), F)
        return [float(p) for p in pers.mean(axis=1)]

    return train_bucket


def make_ctc_bucket_trainer(
    train_batch,
    val_batch,
    n_classes: int,
    *,
    win_size: int = 14,
    stride: int = 4,
    blank: int = 0,
    decay_steps: int = 100,
    seed: int = 0,
    mesh=None,
    trial_axis: str = "data",
):
    """``train_bucket(configs, epochs, init_params=None)`` -> the validation
    PER of each trial.

    ``train_batch``, ``val_batch``: (x (N, T, C), labels, input_lens,
    label_lens), shared by every trial (the reference trains its trials on
    the same fold data, tune_ctc_rnn.py:664-674); the models train on the
    train ``x``'s device. Model i of a bucket (i its trial's position)
    draws its weights from ``seed + i`` and its dropout from
    ``seed + DROPOUT_SEED_OFFSET + i``; ``init_params`` (one state dict per
    trial) replaces the weights. With ``mesh`` the trials are sharded over
    its ranks (``trial_axis`` is its one axis) when their count divides
    the world size, else every rank trains all of them (JAX's silent
    fallback).
    """
    x_tr = train_batch[0]
    dev = x_tr.device if torch.is_tensor(x_tr) else resolve_device(None)

    def prepared(batch):
        x, y, il, ll = batch
        il = _as_tensor(il, dev, torch.long)
        return (_as_tensor(x, dev, torch.float32),
                _as_tensor(y, dev, torch.long),
                adjusted_input_lengths(il, win_size, stride),
                _as_tensor(ll, dev, torch.long))

    x_tr, y_tr, ia_tr, ll_tr = prepared(train_batch)
    x_v, y_v, ia_v, ll_v = prepared(val_batch)

    def train_bucket(cfgs: Sequence[dict], epochs: int, init_params=None):
        bucket = _Bucket(cfgs[0], x_tr.shape[-1], n_classes, win_size,
                         stride, blank, decay_steps, seed, dev)
        models, sharded = _model_block(len(cfgs), mesh, trial_axis, None)
        pers = []
        for i in models:
            c = cfgs[i]
            model = bucket.train(
                i, c["lr"], c["weight_decay"], epochs, x_tr, y_tr, ia_tr,
                ll_tr, None, None if init_params is None else init_params[i])
            pers.append(_val_per(model, x_v, y_v, ll_v, ia_v, blank))
            del model
        return [float(p) for p in _gathered(
            torch.tensor(pers, dtype=torch.float64, device=dev), mesh,
            sharded)]

    return train_bucket
