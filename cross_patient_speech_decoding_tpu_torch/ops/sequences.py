"""Sequence-label utilities of the seq2seq decoders.

Port of ``cross_patient_speech_decoding_tpu/ops/sequences.py``:
teacher-forcing preparation, one-hot sequences, batched autoregressive
seq2seq inference and ragged fold prediction flattening. The functions
that are numpy in the JAX package stay numpy here. The two that run a
model take the port's module where the JAX functions take (model,
variables).
"""

from __future__ import annotations

import numpy as np
import torch


def pad_sequence_teacher_forcing(y: np.ndarray, n_classes: int):
    """Decoder inputs and targets for teacher forcing: the targets shifted
    right by one with the start token ``n_classes`` in front.

    Returns (decoder_inputs (N, L), targets (N, L)) as int arrays.
    """
    y = np.asarray(y)
    start = np.full((y.shape[0], 1), n_classes, y.dtype)
    dec_in = np.concatenate([start, y[:, :-1]], axis=1)
    return dec_in, y


def one_hot_seq(y: np.ndarray, n_classes: int) -> np.ndarray:
    """(N, L) int labels -> (N, L, n_classes+1) float32 one-hot, the start
    token included."""
    return np.eye(n_classes + 1, dtype=np.float32)[np.asarray(y)]


def seq2seq_predict_batch(model, X) -> torch.Tensor:
    """Greedy autoregressive decode of a batch with a ``Seq2SeqRNN``: eval
    mode (running BatchNorm statistics, no dropout), no teacher forcing,
    each step's argmax fed back. ``X`` (N, T, C), a tensor or an array, is
    moved to the model's device. Returns (N, seq_length) int32 class ids
    there; the model's training flag is restored."""
    X = torch.as_tensor(X, dtype=torch.float32, device=model.device)
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            logits = model(X, None, 0.0)
    finally:
        model.train(was_training)
    return logits.argmax(dim=-1).to(torch.int32)


def flatten_fold_preds(fold_preds) -> np.ndarray:
    """Ragged per-fold prediction lists -> one flat array."""
    return np.concatenate([np.asarray(p).reshape(-1) for p in fold_preds])


def one_hot_decode_batch(probs) -> np.ndarray:
    """(B, L, n_classes) prediction probabilities -> (B, L) int labels."""
    return np.argmax(np.asarray(probs), axis=-1)


def decode_seq2seq(model, X_test, y_test):
    """Predict with a trained seq2seq model: flat (pred, true) label arrays
    on the host, the reference's ``decode_seq2seq`` contract."""
    preds = seq2seq_predict_batch(model, X_test)
    return preds.cpu().numpy().ravel(), np.asarray(y_test).ravel()
