"""Train and eval steps of the CTC and the seq2seq models and of the
classifiers.

Port of ``make_ctc_train_step``, ``make_ctc_eval_step``,
``make_seq2seq_train_step``, ``make_seq2seq_eval_step``,
``make_classifier_train_step`` and ``make_classifier_eval_step``
(``cross_patient_speech_decoding_tpu/train/steps.py:44-185``).
CTC: forward, CTC loss on window-adjusted lengths; in training, dropout
on, the loss's gradient through the GRU backward kernels and one AdamW
update; in evaluation, greedy decoding under the valid-window mask, and
PER. Seq2seq: mean cross-entropy over the B * seq_length tokens and
confusion-matrix accuracy; in training, dropout, teacher forcing, the
BatchNorm's running averages moved and one AdamW update; in evaluation,
no teacher forcing and the running averages. Classifiers (the TCN,
transformer and GRU families): mean cross-entropy and confusion-matrix
accuracy; in training, dropout, any BatchNorm's running averages moved
and one AdamW update; in evaluation, no dropout and the running averages.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cross_patient_speech_decoding_tpu_torch.models.realtime_rnn import (
    adjusted_input_lengths,
)
from cross_patient_speech_decoding_tpu_torch.ops.ctc import (
    ctc_loss_mean,
    greedy_decode,
)
from cross_patient_speech_decoding_tpu_torch.ops.metrics import (
    cmat_acc,
    per_batch,
)
from cross_patient_speech_decoding_tpu_torch.train.loops import (
    clip_by_global_norm_,
)
from cross_patient_speech_decoding_tpu_torch.utils.profiling import annotate


def _update(state, tx) -> None:
    """Clip (when ``tx`` clips), step the optimizer and the schedule, count
    the step: the span ``update``."""
    with annotate("update"):
        if tx.clip is not None:
            clip_by_global_norm_([p.grad for p in state.model.parameters()],
                                 tx.clip)
        state.optimizer.step()
        state.schedule.step()
    state.step += 1


def _backward(loss) -> None:
    with annotate("backward"):
        loss.backward()


def _days(batch) -> dict:
    """The model's ``days`` keyword of a batch that carries each row's day
    as its fifth entry, left where it is (on the host it costs the step no
    device read); none for a four-entry batch."""
    return {"days": batch[4]} if len(batch) == 5 else {}


def _augment(x, augment, generator):
    """The Brain-to-Text '24 trainer's noise on a batch x (B, T, C): white
    noise of sd ``augment[0]`` over (B, T, C) drawn first, then a constant
    offset of sd ``augment[1]`` a row and channel, (B, 1, C), both from
    ``generator``; an ``augment`` span (attrs ``rows``, ``T``, ``C``; device
    ms on a card)."""
    white, offset = augment
    B, T, C = x.shape
    with annotate("augment", device=x.device, rows=B, T=T, C=C):
        x = x + torch.randn(x.shape, generator=generator,
                            device=x.device) * white
        return x + torch.randn((B, 1, C), generator=generator,
                               device=x.device) * offset


def make_ctc_train_step(model, tx, augment: tuple | None = None):
    """Build ``step(state, batch, generator) -> (state, {"loss"})``.

    ``model`` gives the window geometry and the blank id; the step trains
    ``state.model`` (a :class:`~cross_patient_speech_decoding_tpu_torch.
    train.state.TrainState` made with the optimizer ``tx`` of
    ``make_optimizer``) in place and returns the state with its step
    count advanced. ``batch`` is (x (B, T, C), labels (B, L), input_lens
    (B,), label_lens (B,)), moved to the model's device, and for a model
    with day layers (``BrainToTextGRU``) a fifth entry, each row's day
    (B,), passed to the model as ``days`` where it is, with the root span's
    counter ``frames`` (B x T); ``generator`` draws the dropout
    masks (the JAX step's ``key``). With ``augment=(white_sd, offset_sd)``
    the step first adds the '24 baseline trainer's noise to x from the
    same generator (:func:`_augment`), before the forward draws its masks.
    The loss is the 0-d tensor of the forward, before the update.
    """
    win, stride, blank = model.win_size, model.stride, model.blank

    def step(state, batch, generator: torch.Generator | None = None):
        days = _days(batch)
        B, T = (int(n) for n in batch[0].shape[:2])
        frames = {"frames": B * T} if days else {}
        with annotate("train_step", root=True, rows=B, **frames):
            m = state.model
            x, labels, input_lens, label_lens = (t.to(m.device)
                                                 for t in batch[:4])
            in_adj = adjusted_input_lengths(input_lens, win, stride)
            m.train()
            state.optimizer.zero_grad(set_to_none=True)
            if augment is not None:
                x = _augment(x, augment, generator)
            with annotate("forward"):
                logits = m(x, generator=generator, **days)
            with annotate("loss"):
                loss = ctc_loss_mean(logits, in_adj, labels, label_lens,
                                     blank)
            _backward(loss)
            _update(state, tx)
        return state, {"loss": loss.detach()}

    return step


def make_ctc_eval_step(model):
    """Build ``step(batch) -> {"loss", "per"}`` for a RealtimeRNN (or a
    ``BrainToTextGRU``).

    ``batch`` is (x (B, T, C), labels (B, L), input_lens (B,),
    label_lens (B,)), and each row's day as a fifth entry for a model with
    day layers; the tensors are moved to the model's device (the days are
    passed as they are) and the results are 0-d tensors there.
    """

    def step(batch):
        dev = model.device
        was_training = model.training
        model.eval()
        try:
            with annotate("eval_step", root=True,
                          rows=int(batch[0].shape[0])), torch.no_grad():
                x, labels, input_lens, label_lens = (t.to(dev)
                                                     for t in batch[:4])
                in_adj = adjusted_input_lengths(input_lens, model.win_size,
                                                model.stride)
                with annotate("forward"):
                    logits = model(x, **_days(batch))
                with annotate("loss"):
                    loss = ctc_loss_mean(logits, in_adj, labels, label_lens,
                                         model.blank)
                with annotate("decode"):
                    log_probs = torch.log_softmax(logits, dim=-1)
                    n_win = logits.shape[1]
                    frame_mask = (torch.arange(n_win, device=dev)[None, :]
                                  < in_adj[:, None])
                    decoded, dec_lens = greedy_decode(log_probs, model.blank,
                                                      frame_mask)
                with annotate("per"):
                    per = per_batch(decoded, dec_lens, labels, label_lens)
        finally:
            model.train(was_training)
        return {"loss": loss, "per": per}

    return step


def _seq2seq_metrics(logits, y, n_classes: int):
    """(mean cross-entropy over the B * seq_length tokens, cmat accuracy
    of the argmax), both 0-d."""
    flat = logits.reshape(-1, logits.shape[-1])
    labels = y.reshape(-1).long()
    loss = F.cross_entropy(flat, labels)
    acc = cmat_acc(labels, flat.detach().argmax(dim=-1), n_classes)
    return loss, acc


def make_seq2seq_train_step(model, tx, teacher_forcing: float = 0.5):
    """Build ``step(state, batch, generator) -> (state, {"loss", "acc"})``.

    ``model`` gives the class count; the step trains ``state.model`` (a
    Seq2SeqRNN in a state made with the optimizer ``tx`` of
    ``make_optimizer``) in place, in training mode: dropout on, teacher
    forcing at ``teacher_forcing``, the BatchNorm's running averages moved
    by this batch. ``batch`` is (x (B, T, C), y (B, seq_length)), moved to
    the model's device; ``generator`` draws the dropout masks and the
    teacher-forcing coins (the JAX step's key; order in
    ``models/seq2seq.py``). Loss and accuracy are those of the forward,
    before the update.
    """
    n_classes = model.num_classes

    def step(state, batch, generator: torch.Generator | None = None):
        with annotate("train_step", root=True, rows=int(batch[0].shape[0])):
            m = state.model
            x, y = (t.to(m.device) for t in batch)
            m.train()
            state.optimizer.zero_grad(set_to_none=True)
            with annotate("forward"):
                logits = m(x, y, teacher_forcing, generator=generator)
            with annotate("loss"):
                loss, acc = _seq2seq_metrics(logits, y, n_classes)
            _backward(loss)
            _update(state, tx)
        return state, {"loss": loss.detach(), "acc": acc}

    return step


def make_seq2seq_eval_step(model):
    """Build ``step(batch) -> {"loss", "acc"}`` for a Seq2SeqRNN.

    The model runs in eval mode (no dropout, no teacher forcing, the
    BatchNorm's running averages), and is left in the mode it was in.
    ``batch`` is (x (B, T, C), y (B, seq_length)); the tensors are moved to
    the model's device and the results are 0-d tensors there.
    """

    def step(batch):
        was_training = model.training
        model.eval()
        try:
            with annotate("eval_step", root=True,
                          rows=int(batch[0].shape[0])), torch.no_grad():
                x, y = (t.to(model.device) for t in batch)
                with annotate("forward"):
                    logits = model(x, None, 0.0)
                with annotate("loss"):
                    loss, acc = _seq2seq_metrics(logits, y,
                                                 model.num_classes)
        finally:
            model.train(was_training)
        return {"loss": loss, "acc": acc}

    return step


def _param_device(model) -> torch.device:
    return next(model.parameters()).device


def _classifier_metrics(logits, y, n_classes: int):
    """(mean cross-entropy, cmat accuracy of the argmax), both 0-d."""
    y = y.long()
    loss = F.cross_entropy(logits, y)
    acc = cmat_acc(y, logits.detach().argmax(dim=-1), n_classes)
    return loss, acc


def make_classifier_train_step(model, tx):
    """Build ``step(state, batch, generator) -> (state, {"loss", "acc"})``
    for a classifier (the reference's ``BaseLightningModel.training_step``,
    nn_models/models.py:15-108).

    ``model`` gives the class count; the step trains ``state.model`` (made
    with the optimizer ``tx`` of ``make_optimizer``) in place, in training
    mode: dropout on, the running averages of a model that has a BatchNorm
    moved by this batch (a model without one has none to move). ``batch``
    is (x (B, T, C), y (B,)), moved to the model's device; ``generator``
    draws the dropout masks (the JAX step's key). Loss and accuracy are
    those of the forward, before the update.
    """
    n_classes = model.num_classes

    def step(state, batch, generator: torch.Generator | None = None):
        with annotate("train_step", root=True, rows=int(batch[0].shape[0])):
            m = state.model
            x, y = (t.to(_param_device(m)) for t in batch)
            m.train()
            state.optimizer.zero_grad(set_to_none=True)
            with annotate("forward"):
                logits = m(x, generator=generator)
            with annotate("loss"):
                loss, acc = _classifier_metrics(logits, y, n_classes)
            _backward(loss)
            _update(state, tx)
        return state, {"loss": loss.detach(), "acc": acc}

    return step


def make_classifier_eval_step(model):
    """Build ``step(batch) -> {"loss", "acc"}`` for a classifier.

    The model runs in eval mode (no dropout, the BatchNorm's running
    averages), and is left in the mode it was in. ``batch`` is (x, y);
    the tensors are moved to the model's device and the results are 0-d
    tensors there.
    """

    def step(batch):
        was_training = model.training
        model.eval()
        try:
            with annotate("eval_step", root=True,
                          rows=int(batch[0].shape[0])), torch.no_grad():
                x, y = (t.to(_param_device(model)) for t in batch)
                with annotate("forward"):
                    logits = model(x)
                with annotate("loss"):
                    loss, acc = _classifier_metrics(logits, y,
                                                    model.num_classes)
        finally:
            model.train(was_training)
        return {"loss": loss, "acc": acc}

    return step
