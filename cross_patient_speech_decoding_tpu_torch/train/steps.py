"""Evaluation step of the CTC model.

Port of ``make_ctc_eval_step`` (``cross_patient_speech_decoding_tpu/
train/steps.py:172-185``): forward, CTC loss on window-adjusted lengths,
greedy decoding under the valid-window mask, and PER. The training step
waits for the GRU backward kernels.
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
