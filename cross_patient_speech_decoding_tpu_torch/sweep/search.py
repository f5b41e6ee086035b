"""Hyperparameter search: the sweep space, random trials, the resumable
manifest and successive halving.

Port of ``cross_patient_speech_decoding_tpu/sweep/search.py``, numpy on the
host, copied whole: the same seed draws the same trials bit for bit, and a
manifest key is the same SHA-1 of the same JSON, so a manifest written by
either package resumes in the other.

The reference tunes the CTC RNN with Ray Tune actors (10 concurrent trials
at 0.1 GPU each, tune_ctc_rnn.py:43,664-676; random search space
:212-222). Here trials that share static shapes (hidden size, layers,
dropout) form a bucket handed to one ``train_bucket`` call
(``sweep/ctc.py``); successive halving keeps the best 1/eta of each rung;
every finished trial is appended to a JSON-lines manifest keyed by its
config, so a restarted sweep skips completed trials.
"""

from __future__ import annotations

import hashlib
import json
import pathlib
from dataclasses import dataclass
from typing import Callable

import numpy as np


@dataclass
class SweepSpace:
    """Search space: log-uniform continuous params + categorical arch params.

    Defaults mirror the reference's CTC search space
    (tune_ctc_rnn.py:212-222 / tune_ctc_rnn_config.yaml). Two deliberate
    deviations: the reference also samples ``batch_size`` (128/256) —
    here every trial trains full-batch, one step an epoch, so a
    per-trial minibatch size is not a knob of the bucket trainer (and the
    production trainer exposes ``TrainCTCConfig.batch_size`` separately);
    and ``gclip_val`` is a single-value categorical {5.0} in both
    reference spaces, i.e. never actually searched, so it stays a fixed
    trainer setting.
    """

    lr: tuple = (1e-4, 1e-2)  # log-uniform (reference choices 1e-4..5e-3)
    weight_decay: tuple = (1e-6, 1e-3)  # log-uniform (reference l2_reg)
    hidden: tuple = (128, 256, 512)  # tune_ctc_rnn.py:213
    n_layers: tuple = (2, 3, 4, 5)  # tune_ctc_rnn.py:214
    dropout: tuple = (0.2, 0.3, 0.4)


def sample_trials(space: SweepSpace, n: int, seed: int = 0):
    """n random configs; arch params categorical, lr/wd log-uniform."""
    rng = np.random.default_rng(seed)
    trials = []
    for _ in range(n):
        trials.append(
            {
                "lr": float(np.exp(rng.uniform(*np.log(space.lr)))),
                "weight_decay": float(
                    np.exp(rng.uniform(*np.log(space.weight_decay)))
                ),
                "hidden": int(rng.choice(space.hidden)),
                "n_layers": int(rng.choice(space.n_layers)),
                "dropout": float(rng.choice(space.dropout)),
            }
        )
    return trials


def _config_key(cfg: dict) -> str:
    return hashlib.sha1(
        json.dumps(cfg, sort_keys=True).encode()
    ).hexdigest()[:16]


class Manifest:
    """Append-only JSON-lines record of finished trials (resume support)."""

    def __init__(self, path: str | pathlib.Path | None):
        self.path = pathlib.Path(path) if path else None
        self.done: dict[str, dict] = {}
        if self.path and self.path.exists():
            for line in self.path.read_text().splitlines():
                rec = json.loads(line)
                self.done[rec["key"]] = rec

    def completed(self, cfg: dict):
        return self.done.get(_config_key(cfg))

    def record(self, cfg: dict, metric: float, extra: dict | None = None):
        rec = {"key": _config_key(cfg), "config": cfg, "metric": metric}
        if extra:
            rec.update(extra)
        self.done[rec["key"]] = rec
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        return rec


_CTC_ARCH_KEYS = ("hidden", "n_layers", "dropout")


def _bucket(trials, bucket_keys=None):
    """Group trials by their static (architecture) params.

    Default: the CTC arch keys when present (hidden/layers/dropout fix the
    compiled program's shapes), else every non-float param — continuous
    params are traced scalars and can share one program.
    """
    buckets: dict[tuple, list] = {}
    for t in trials:
        if bucket_keys is not None:
            k = tuple((name, t[name]) for name in bucket_keys)
        elif all(name in t for name in _CTC_ARCH_KEYS):
            k = tuple((name, t[name]) for name in _CTC_ARCH_KEYS)
        else:
            k = tuple(
                sorted((n, v) for n, v in t.items() if not isinstance(v, float))
            )
        buckets.setdefault(k, []).append(t)
    return buckets


def run_sweep(
    trials: list[dict],
    train_bucket: Callable,
    *,
    manifest: Manifest | None = None,
    rungs: tuple = (1,),
    eta: int = 3,
) -> list[dict]:
    """Run a sweep with optional successive halving.

    Args:
        trials: list of config dicts (see sample_trials).
        train_bucket: callable(configs: list[dict], epochs: int) ->
            list[float] — trains all same-architecture configs for
            ``epochs`` and returns the monitored metric per trial (lower
            is better); see sweep.ctc for the CTC RNN's.
        manifest: resume/record store.
        rungs: epochs per successive-halving rung; a single rung means
            plain random search at that budget.
        eta: keep top 1/eta fraction between rungs.

    Returns:
        one {"config", "metric", "epochs"} record per trial — trials
        eliminated at an intermediate rung are included with the metric
        and budget they were last evaluated at. Full-budget results sort
        first (by metric), then eliminated trials by descending budget,
        so ``results[0]`` is always the sweep winner and no trial is
        silently dropped. Eliminated trials are recorded in the manifest
        too (with ``eliminated_at_rung``), so a resumed sweep neither
        re-trains them through rungs they already lost nor loses their
        evaluations.
    """
    manifest = manifest or Manifest(None)
    live = []
    results = []
    for t in trials:
        rec = manifest.completed(t)
        if rec is not None:
            results.append({
                "config": t,
                "metric": rec["metric"],
                "epochs": int(rec.get("epochs", rungs[-1])),
            })
        else:
            live.append(t)
    # fixed SHA cohort schedule from the FULL trial count: a resumed run
    # whose cheap-rung eliminations are already in the manifest must not
    # shrink the keep count for the surviving cohort
    n0 = len(trials)

    import time as _time

    for i, epochs in enumerate(rungs):
        if not live:
            break
        scores = []
        for arch_key, cfgs in _bucket(live).items():
            t0 = _time.monotonic()
            metrics = train_bucket(cfgs, int(epochs))
            # amortized per-trial wall seconds (trials/hour accounting:
            # the reference HPO workload's only published figure is its
            # actor topology, tune_ctc_rnn.py:43,675 — wall time per
            # trial is the comparable quantity)
            wall = (_time.monotonic() - t0) / max(1, len(cfgs))
            scores.extend(
                (c, m, wall) for c, m in zip(cfgs, metrics)
            )
        scores.sort(key=lambda cm: cm[1])
        if i == len(rungs) - 1:
            for cfg, m, wall in scores:
                results.append(
                    {"config": cfg, "metric": float(m), "epochs": int(epochs)}
                )
                manifest.record(cfg, float(m), {
                    "epochs": int(epochs), "wall_s": round(wall, 2),
                    "done_at": round(_time.time(), 1),
                })
            live = []
        else:
            keep = max(1, n0 // (eta ** (i + 1)))
            live = [cfg for cfg, _, _ in scores[:keep]]
            for cfg, m, wall in scores[keep:]:
                results.append(
                    {"config": cfg, "metric": float(m), "epochs": int(epochs)}
                )
                manifest.record(
                    cfg, float(m),
                    {"epochs": int(epochs), "eliminated_at_rung": i,
                     "wall_s": round(wall, 2),
                     "done_at": round(_time.time(), 1)},
                )

    results.sort(key=lambda r: (-r["epochs"], r["metric"]))
    return results
