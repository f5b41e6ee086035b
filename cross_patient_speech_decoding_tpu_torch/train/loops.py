"""Optimizer, training loop, metrics logs and checkpoints.

Port of ``cross_patient_speech_decoding_tpu/train/loops.py``:
``make_optimizer`` with optax's AdamW, linear decay and global-norm
clipping; ``fit`` with the same mini-batches as the JAX loop and
best-state tracking; csv and jsonl metric logs; checkpoints with
``torch.save``.
"""

from __future__ import annotations

import copy
import csv
import json
import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from cross_patient_speech_decoding_tpu_torch.train.state import TrainState
from cross_patient_speech_decoding_tpu_torch.utils.profiling import annotate


@dataclass
class FitResult:
    best_state: TrainState
    best_metric: float
    best_epoch: int
    history: list = field(default_factory=list)


@dataclass(frozen=True)
class OptimizerConfig:
    """AdamW + linear learning-rate decay + optional global-norm clipping,
    with the semantics of the JAX package's optax chain
    (``optax.chain(clip_by_global_norm(clip), adamw(linear_schedule(...)))``):

    - AdamW (b1 0.9, b2 0.999, eps 1e-8 outside the square root, bias
      correction on the incremented count), weight decay decoupled and
      scaled by the scheduled learning rate: ``torch.optim.AdamW``;
    - the learning rate of update k (counting from 0) is
      ``lr * ((1 - end_factor) * (1 - min(k, decay_steps)/decay_steps) +
      end_factor)``, held at ``lr * end_factor`` after ``decay_steps``:
      a ``LambdaLR`` stepped after each update;
    - clipping before AdamW: g * clip / ||g|| when ||g|| >= clip
      (:func:`clip_by_global_norm_`).

    The brain-to-text decoder's recipe (its trainer's
    ``create_cosine_lr_scheduler``) adds, each off by default: ``eps``;
    ``warmup_steps``, over which the factor rises as k / warmup_steps from
    0; ``schedule="cosine"``, after the warm-up the factor
    ``r + (1 - r) (1 + cos(pi p)) / 2``, r = min_lr / lr and p the share of
    ``decay_steps - warmup_steps`` done, held at r from ``decay_steps`` on;
    and ``no_decay``, the prefixes of the parameter names (``day.`` for
    the day layers) that take no weight decay. The Brain-to-Text '24
    baseline's (``torch.optim.Adam(weight_decay=...)`` under a constant
    ``LinearLR``) is ``decoupled=False``: the weight decay is added to the
    gradient before the moments (coupled L2, ``torch.optim.Adam``), at
    ``end_factor`` 1.
    """

    lr: float
    weight_decay: float
    decay_steps: int
    end_factor: float = 0.0
    clip: float | None = None
    eps: float = 1e-8
    warmup_steps: int = 0
    schedule: str = "linear"
    min_lr: float = 0.0
    no_decay: tuple = ()
    decoupled: bool = True

    def factor(self, count: int) -> float:
        """Schedule factor of update ``count`` (optax linear_schedule, or
        the warm-up and cosine decay)."""
        count = max(count, 0)
        if count < self.warmup_steps:
            return count / self.warmup_steps
        if self.schedule == "cosine":
            r = self.min_lr / self.lr
            if count >= self.decay_steps:
                return r
            span = max(1, self.decay_steps - self.warmup_steps)
            p = (count - self.warmup_steps) / span
            return max(r, r + (1.0 - r) * 0.5 * (1.0 + math.cos(math.pi * p)))
        if self.decay_steps <= 0:
            return 1.0
        frac = 1.0 - min(count, self.decay_steps) / self.decay_steps
        return (1.0 - self.end_factor) * frac + self.end_factor

    def init(self, params, names=None):
        """(optimizer, schedule) over ``params``; with ``no_decay``, their
        ``names`` (in the same order) put the parameters under those
        prefixes in a second group without weight decay."""
        params = list(params)
        if self.no_decay:
            if names is None:
                raise ValueError("no_decay needs the parameters' names")
            off = [n.startswith(tuple(self.no_decay)) for n in names]
            groups = [{"params": [p for p, o in zip(params, off) if not o]},
                      {"params": [p for p, o in zip(params, off) if o],
                       "weight_decay": 0.0}]
            params = [g for g in groups if g["params"]]
        adam = torch.optim.AdamW if self.decoupled else torch.optim.Adam
        opt = adam(params, lr=self.lr, betas=(0.9, 0.999), eps=self.eps,
                   weight_decay=self.weight_decay)
        # a plain function: LambdaLR leaves it out of its state dict
        sched = torch.optim.lr_scheduler.LambdaLR(
            opt, lambda count: self.factor(count))
        return opt, sched


def make_optimizer(lr: float, weight_decay: float, decay_steps: int,
                   end_factor: float = 0.0,
                   clip: float | None = None, *, eps: float = 1e-8,
                   warmup_steps: int = 0, schedule: str = "linear",
                   min_lr: float = 0.0,
                   no_decay=(), decoupled: bool = True) -> OptimizerConfig:
    """AdamW + linear LR decay (+ optional grad clipping), the reference's
    optimizer recipe (realtime_nn_model.py:287-304, models.py:368-383,
    Trainer(gradient_clip_val=0.5)); the keywords give the brain-to-text
    decoders' (``OptimizerConfig``)."""
    if schedule not in ("linear", "cosine"):
        raise ValueError(f"schedule must be 'linear' or 'cosine', got "
                         f"{schedule!r}")
    return OptimizerConfig(lr, weight_decay, decay_steps, end_factor, clip,
                           eps, warmup_steps, schedule, min_lr,
                           tuple(no_decay), decoupled)


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm: float) -> None:
    """optax ``clip_by_global_norm`` in place: where the global norm
    ``sqrt(sum g^2)`` is at least ``max_norm``, g <- (g / norm) * max_norm.
    (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm and is not
    the same function.) No host synchronisation."""
    grads = [g for g in grads if g is not None]
    if not grads:
        return
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm) * max_norm))


def _batches(n: int, batch_size: int | None, rng: np.random.Generator):
    """The JAX loop's mini-batches: a permutation per epoch, the last
    batch padded from the start of the same permutation."""
    if batch_size is None or batch_size >= n:
        yield np.arange(n)
        return
    perm = rng.permutation(n)
    for i in range(0, n, batch_size):
        chunk = perm[i: i + batch_size]
        if len(chunk) < batch_size:
            chunk = np.concatenate([chunk, perm[: batch_size - len(chunk)]])
        yield chunk


def fit(
    state: TrainState,
    train_step: Callable,
    eval_step: Callable,
    train_batch,
    val_batch,
    *,
    epochs: int,
    generator: torch.Generator | None = None,
    monitor: str = "loss",
    mode: str = "min",
    batch_size: int | None = None,
    eval_every: int = 1,
    seed: int = 0,
    verbose: bool = False,
    log_path: str | None = None,
    log_format: str = "csv",
) -> FitResult:
    """Train with best-state tracking on the monitored val metric.

    ``train_step(state, batch, generator)`` is a step of
    :mod:`~cross_patient_speech_decoding_tpu_torch.train.steps`; every step
    draws its dropout masks from ``generator`` (the JAX loop splits a key
    per step). ``eval_step(batch)`` evaluates ``state.model`` (build it
    with ``make_ctc_eval_step(state.model)``). train_batch/val_batch are
    tuples of tensors with dim 0 = samples; mini-batches are gathered by
    the same permutations as the JAX loop (numpy, ``seed``). The best state
    is a deep copy taken when the metric improves.
    """
    sign = 1.0 if mode == "min" else -1.0
    best = math.inf
    best_state = state
    best_epoch = -1
    history = []
    host_rng = np.random.default_rng(seed)
    n = int(train_batch[0].shape[0])
    mini = batch_size is not None and batch_size < n

    for epoch in range(epochs):
        with annotate("epoch", epoch=epoch):
            for idx in _batches(n, batch_size, host_rng):
                with annotate("gather"):
                    if mini:
                        mb = tuple(a[torch.as_tensor(idx, device=a.device)]
                                   for a in train_batch)
                    else:
                        mb = train_batch
                state, _ = train_step(state, mb, generator)

            if (epoch + 1) % eval_every == 0 or epoch == epochs - 1:
                with annotate("validation"):
                    val_metrics = eval_step(val_batch)
                    m = float(val_metrics[monitor])
                    rec = {"epoch": epoch,
                           **{k: float(v) for k, v in val_metrics.items()}}
                    history.append(rec)
                    if log_path:
                        append_metrics(log_path, rec, log_format)
                    if sign * m < best:
                        best = sign * m
                        best_state = copy.deepcopy(state)
                        best_epoch = epoch
                if verbose:
                    print(f"epoch {epoch}: " + ", ".join(
                        f"{k}={float(v):.4f}" for k, v in val_metrics.items()
                    ), flush=True)

    return FitResult(best_state, sign * best, best_epoch, history)


def append_metrics(path: str, rec: dict, fmt: str = "csv") -> None:
    """Append one per-epoch metrics record: ``csv`` (header on the first
    write), ``jsonl`` (one JSON object per line, flushed) or ``tb``
    (TensorBoard event files: ``path`` is the run DIRECTORY, the record's
    ``epoch`` the step and its other numbers the scalars)."""
    p = Path(path)
    if fmt == "csv":
        p.parent.mkdir(parents=True, exist_ok=True)
        new = not p.exists()
        with open(p, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rec.keys()))
            if new:
                w.writeheader()
            w.writerow(rec)
    elif fmt == "jsonl":
        p.parent.mkdir(parents=True, exist_ok=True)
        with open(p, "a") as f:
            f.write(json.dumps(rec) + "\n")
            f.flush()
    elif fmt == "tb":
        from cross_patient_speech_decoding_tpu_torch.utils.tb_events import (
            tb_writer,
        )

        step = int(rec.get("epoch", 0))
        scalars = {k: v for k, v in rec.items()
                   if k != "epoch" and isinstance(v, (int, float))}
        tb_writer(path).add_scalars(step, scalars)
    else:
        raise ValueError(f"unknown log_format {fmt!r} (csv|jsonl|tb)")


def save_checkpoint(path: str, state: TrainState,
                    metadata: dict | None = None) -> None:
    """Save model, optimizer and schedule state and the step count with
    ``torch.save``; ``metadata`` goes to a ``<path>.meta.json`` sidecar."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    torch.save({
        "step": state.step,
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "schedule": state.schedule.state_dict(),
    }, path)
    if metadata:
        Path(str(path) + ".meta.json").write_text(json.dumps(metadata))


def load_checkpoint(path: str, template: TrainState) -> TrainState:
    """Load a checkpoint into ``template`` (a state of the same model and
    optimizer, e.g. from ``create_train_state``) and return it."""
    ck = torch.load(path, map_location=next(
        template.model.parameters()).device, weights_only=True)
    template.model.load_state_dict(ck["model"])
    template.optimizer.load_state_dict(ck["optimizer"])
    template.schedule.load_state_dict(ck["schedule"])
    template.step = int(ck["step"])
    return template
