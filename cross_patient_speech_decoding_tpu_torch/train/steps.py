"""Train and eval steps of the CTC model.

Port of ``make_ctc_train_step`` and ``make_ctc_eval_step``
(``cross_patient_speech_decoding_tpu/train/steps.py:150-185``): forward,
CTC loss on window-adjusted lengths; in training, dropout on, the loss's
gradient through the GRU backward kernels and one AdamW update; in
evaluation, greedy decoding under the valid-window mask, and PER.
"""

from __future__ import annotations

import torch

from cross_patient_speech_decoding_tpu_torch.models.realtime_rnn import (
    adjusted_input_lengths,
)
from cross_patient_speech_decoding_tpu_torch.ops.ctc import (
    ctc_loss_mean,
    greedy_decode,
)
from cross_patient_speech_decoding_tpu_torch.ops.metrics import per_batch
from cross_patient_speech_decoding_tpu_torch.train.loops import (
    clip_by_global_norm_,
)


def make_ctc_train_step(model, tx):
    """Build ``step(state, batch, generator) -> (state, {"loss"})``.

    ``model`` gives the window geometry and the blank id; the step trains
    ``state.model`` (a :class:`~cross_patient_speech_decoding_tpu_torch.
    train.state.TrainState` made with the optimizer ``tx`` of
    ``make_optimizer``) in place and returns the state with its step
    count advanced. ``batch`` is (x (B, T, C), labels (B, L), input_lens
    (B,), label_lens (B,)), moved to the model's device; ``generator``
    draws the dropout masks (the JAX step's ``key``). The loss is the
    0-d tensor of the forward, before the update.
    """
    win, stride, blank = model.win_size, model.stride, model.blank

    def step(state, batch, generator: torch.Generator | None = None):
        m = state.model
        x, labels, input_lens, label_lens = (t.to(m.device) for t in batch)
        in_adj = adjusted_input_lengths(input_lens, win, stride)
        m.train()
        state.optimizer.zero_grad(set_to_none=True)
        logits = m(x, generator=generator)
        loss = ctc_loss_mean(logits, in_adj, labels, label_lens, blank)
        loss.backward()
        if tx.clip is not None:
            clip_by_global_norm_([p.grad for p in m.parameters()], tx.clip)
        state.optimizer.step()
        state.schedule.step()
        state.step += 1
        return state, {"loss": loss.detach()}

    return step


def make_ctc_eval_step(model):
    """Build ``step(batch) -> {"loss", "per"}`` for a RealtimeRNN.

    ``batch`` is (x (B, T, C), labels (B, L), input_lens (B,),
    label_lens (B,)); the tensors are moved to the model's device and the
    results are 0-d tensors there.
    """

    def step(batch):
        dev = model.device
        x, labels, input_lens, label_lens = (t.to(dev) for t in batch)
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                in_adj = adjusted_input_lengths(input_lens, model.win_size,
                                                model.stride)
                logits = model(x)
                loss = ctc_loss_mean(logits, in_adj, labels, label_lens,
                                     model.blank)
                log_probs = torch.log_softmax(logits, dim=-1)
                n_win = logits.shape[1]
                frame_mask = (torch.arange(n_win, device=dev)[None, :]
                              < in_adj[:, None])
                decoded, dec_lens = greedy_decode(log_probs, model.blank,
                                                  frame_mask)
                per = per_batch(decoded, dec_lens, labels, label_lens)
        finally:
            model.train(was_training)
        return {"loss": loss, "per": per}

    return step
