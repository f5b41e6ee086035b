"""The port's hyperparameter search (``sweep/search.py``, ``run_bohb`` of
``sweep/bayes.py``) against the JAX package's, on the host.

Both modules are numpy on the host, so trials, buckets, results and
manifest records are held equal, bit for bit, with a deterministic host
``train_bucket`` standing in for the device trainer; only a record's
``wall_s`` and ``done_at`` (clock readings) are left out. Manifests
written by either package resume in the other.
"""

import json
import math

import numpy as np
import pytest

from cross_patient_speech_decoding_tpu import sweep as jsweep
from cross_patient_speech_decoding_tpu.sweep import search as jsearch
from cross_patient_speech_decoding_tpu_torch import sweep
from cross_patient_speech_decoding_tpu_torch.sweep import search

CLOCK_KEYS = ("wall_s", "done_at")


def _metric(cfg: dict, epochs: int) -> float:
    """A deterministic stand-in for a trial's validation PER: smooth in
    the learning rate, with architecture terms and a budget term."""
    return (float((math.log10(cfg["lr"]) + 3.0) ** 2)
            + cfg["hidden"] / 512 + 0.1 * cfg["n_layers"] + cfg["dropout"]
            + 0.5 * math.log10(cfg["weight_decay"]) ** 2 / 36
            - 0.01 * epochs)


class _Trainer:
    """A host ``train_bucket`` that records each call."""

    def __init__(self):
        self.calls = []

    def __call__(self, cfgs, epochs):
        self.calls.append(([dict(c) for c in cfgs], epochs))
        return [_metric(c, epochs) for c in cfgs]


def _no_training(cfgs, epochs):
    raise AssertionError(f"trained {len(cfgs)} configs for {epochs}")


def _records(path):
    recs = [json.loads(line) for line in open(path).read().splitlines()]
    return [{k: v for k, v in r.items() if k not in CLOCK_KEYS}
            for r in recs]


def test_exports_match_jax():
    """``sweep`` exports what the JAX package's does, with the same
    search-space defaults."""
    for name in ("SweepSpace", "sample_trials", "run_sweep", "Manifest",
                 "Categorical", "Float", "TPESampler", "default_ctc_space",
                 "run_bohb", "sample_random"):
        assert hasattr(sweep, name), name
    assert sweep.SweepSpace() == sweep.SweepSpace(**vars(jsweep.SweepSpace()))


@pytest.mark.parametrize("seed,n", [(0, 30), (7, 5), (123, 64)])
def test_sample_trials_bitwise(seed, n):
    """The same seed draws the same trials, floats bit for bit, and the
    same manifest keys (SHA-1 of the same JSON)."""
    got = search.sample_trials(search.SweepSpace(), n, seed=seed)
    want = jsearch.sample_trials(jsearch.SweepSpace(), n, seed=seed)
    assert got == want
    assert [search._config_key(c) for c in got] == [
        jsearch._config_key(c) for c in want]


def test_bucket_matches_jax():
    """Trials group by the CTC architecture keys, by given keys, or by
    every non-float value, in JAX's order."""
    trials = search.sample_trials(search.SweepSpace(), 40, seed=3)
    assert list(search._bucket(trials).items()) == list(
        jsearch._bucket(trials).items())
    assert list(search._bucket(trials, ("hidden",)).items()) == list(
        jsearch._bucket(trials, ("hidden",)).items())
    other = [{"k": i % 3, "c": 0.5 * i, "s": "ab"[i % 2]} for i in range(9)]
    assert list(search._bucket(other).items()) == list(
        jsearch._bucket(other).items())


@pytest.mark.parametrize("rungs,eta", [((4,), 3), ((1, 3, 9), 3),
                                       ((2, 5), 2)])
def test_run_sweep_matches_jax(tmp_path, rungs, eta):
    """Successive halving over 11 trials: the same bucket calls, results
    and manifest records."""
    trials = search.sample_trials(search.SweepSpace(), 11, seed=5)
    tt, tj = _Trainer(), _Trainer()
    got = search.run_sweep(trials, tt, manifest=search.Manifest(
        tmp_path / "t.jsonl"), rungs=rungs, eta=eta)
    want = jsearch.run_sweep(trials, tj, manifest=jsearch.Manifest(
        tmp_path / "j.jsonl"), rungs=rungs, eta=eta)
    assert got == want
    assert tt.calls == tj.calls
    assert _records(tmp_path / "t.jsonl") == _records(tmp_path / "j.jsonl")
    recs = [json.loads(x) for x in open(tmp_path / "t.jsonl")]
    assert all(set(CLOCK_KEYS) <= set(r) for r in recs)


def test_manifest_resumes_across_packages(tmp_path):
    """A manifest written by JAX's run_sweep resumes in the port's with no
    train_bucket call and JAX's results, and the other way round; a half
    manifest resumes to JAX's full result."""
    trials = search.sample_trials(search.SweepSpace(), 9, seed=2)
    path_j, path_t = tmp_path / "j.jsonl", tmp_path / "t.jsonl"
    want = jsearch.run_sweep(trials, _Trainer(), manifest=jsearch.Manifest(
        path_j), rungs=(1, 3), eta=3)
    got = search.run_sweep(trials, _no_training, manifest=search.Manifest(
        path_j), rungs=(1, 3), eta=3)
    assert got == want
    search.run_sweep(trials, _Trainer(), manifest=search.Manifest(path_t),
                     rungs=(1, 3), eta=3)
    assert jsearch.run_sweep(trials, _no_training, manifest=jsearch.Manifest(
        path_t), rungs=(1, 3), eta=3) == want
    # a manifest holding JAX's first 4 records: the port trains the rest
    half = tmp_path / "half.jsonl"
    half.write_text("".join(open(path_j).readlines()[:4]))
    tt = _Trainer()
    got = search.run_sweep(trials, tt, manifest=search.Manifest(half),
                           rungs=(1, 3), eta=3)
    done = {search._config_key(c) for cs, _ in tt.calls for c in cs}
    assert not done & {json.loads(x)["key"]
                       for x in open(path_j).readlines()[:4]}
    assert sorted(r["metric"] for r in got) == sorted(
        r["metric"] for r in want)


@pytest.mark.parametrize("n_trials,batch,rungs,eta,init", [
    (14, 4, (1, 3), 2, None), (10, 6, (2,), 3, 3), (4, 4, (1, 2), 3, None)])
def test_run_bohb_matches_jax(tmp_path, n_trials, batch, rungs, eta, init):
    """BOHB brackets (random, then TPE proposals) through the rungs: the
    same bucket calls, results and manifest records."""
    space_t = sweep.default_ctc_space()
    space_j = jsweep.default_ctc_space()
    tt, tj = _Trainer(), _Trainer()
    got = sweep.run_bohb(space_t, tt, n_trials=n_trials, batch=batch,
                         rungs=rungs, eta=eta, n_random_init=init,
                         manifest=sweep.Manifest(tmp_path / "t.jsonl"),
                         seed=4)
    want = jsweep.run_bohb(space_j, tj, n_trials=n_trials, batch=batch,
                           rungs=rungs, eta=eta, n_random_init=init,
                           manifest=jsweep.Manifest(tmp_path / "j.jsonl"),
                           seed=4)
    assert got == want
    assert tt.calls == tj.calls
    assert _records(tmp_path / "t.jsonl") == _records(tmp_path / "j.jsonl")


def test_run_bohb_resumes_a_jax_manifest(tmp_path):
    """A finished JAX BOHB manifest: the port proposes nothing new, trains
    nothing and returns what JAX's own resume returns (the manifest's
    records, each at its last budget; the first run also listed the
    lower-rung evaluations of the trials that went on)."""
    path = tmp_path / "j.jsonl"
    kw = dict(n_trials=8, batch=4, rungs=(1, 2), eta=2, seed=1)
    first = jsweep.run_bohb(jsweep.default_ctc_space(), _Trainer(),
                            manifest=jsweep.Manifest(path), **kw)
    want = jsweep.run_bohb(jsweep.default_ctc_space(), _no_training,
                           manifest=jsweep.Manifest(path), **kw)
    got = sweep.run_bohb(sweep.default_ctc_space(), _no_training,
                         manifest=sweep.Manifest(path), **kw)
    assert got == want
    assert len(got) == 8 < len(first)
    assert np.isfinite([r["metric"] for r in got]).all()
