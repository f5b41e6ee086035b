"""Train state: the model with its optimizer, schedule and step count.

Port of ``cross_patient_speech_decoding_tpu/train/state.py``. JAX keeps
parameters and optimizer state as one immutable pytree; here the model,
the optimizer and the learning-rate schedule are PyTorch objects that a
train step updates in place, and the state holds them together so that a
step, ``fit`` and the checkpoints handle one value.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn


@dataclass
class TrainState:
    """Everything a train step updates.

    Attributes:
        step: updates taken so far.
        model: the module whose parameters train.
        optimizer: ``torch.optim.AdamW`` over ``model``'s parameters.
        schedule: the learning-rate schedule stepping ``optimizer``.
    """

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: torch.optim.lr_scheduler.LRScheduler


def create_train_state(model: nn.Module, tx) -> TrainState:
    """A fresh state for ``model`` with the optimizer ``tx`` (from
    ``train.loops.make_optimizer``)."""
    names, params = zip(*model.named_parameters())
    optimizer, schedule = tx.init(params, names)
    return TrainState(0, model, optimizer, schedule)
