"""The port's ``cpsd reproduce`` (``cli/reproduce.py``) against the JAX
package's: the JAX package's own cases (tests/test_reproduce.py) run on
the port, the expansion equal to JAX's on every manifest here and on
``manifests/paper.yaml`` (86 jobs), a mini matrix end to end on the CPU
with its resume, a results file written by JAX's job counted complete by
the port, and the intended differences (the literal-brace fix, the device as an
argument), and ``n_devices`` forwarded to every job as in JAX.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from cross_patient_speech_decoding_tpu.cli import reproduce as jrep
from cross_patient_speech_decoding_tpu.utils.config import (
    ReproduceConfig as JaxReproduceConfig,
)
from cross_patient_speech_decoding_tpu_torch.cli import experiments as te
from cross_patient_speech_decoding_tpu_torch.cli import main as tmain
from cross_patient_speech_decoding_tpu_torch.cli.reproduce import (
    _already_complete,
    _job_config,
    expand_manifest,
    run_manifest,
    run_reproduce,
)
from cross_patient_speech_decoding_tpu_torch.cli.subsample_experiments \
    import SubsampleConfig
from cross_patient_speech_decoding_tpu_torch.data.loaders import (
    load_pkl,
    save_pkl,
)
from cross_patient_speech_decoding_tpu_torch.utils.config import (
    ReproduceConfig,
)

torch.set_num_threads(2)

PAPER = Path(__file__).resolve().parent.parent / "manifests" / "paper.yaml"


def _run(cfg, **kw):
    return run_reproduce(cfg, verbose=False, device="cpu", **kw)


def _manifests():
    """Every manifest of these tests and of tests/test_reproduce.py."""
    return {
        "matrix": {
            "defaults": {"data": "synthetic", "seed": 3},
            "jobs": [
                {"command": "svm-decode",
                 "matrix": {"target_pt": ["S14", "S26"],
                            "strategy": ["sep_align", "joint_pca"]},
                 "overrides": {"n_iter": 2,
                               "out": "r/{target_pt}_{strategy}.pkl"}},
                {"command": "realtime-sim"},
            ],
        },
        "chained": {
            "defaults": {"run_name": "{target_pt}_{strategy}",
                         "out": "r/{run_name}.pkl"},
            "jobs": [{"command": "svm-decode",
                      "matrix": {"target_pt": ["S14"],
                                 "strategy": ["sep_align"]}}],
        },
        "mini": _mini_manifest(Path("/tmp/x")),
        "named": {"jobs": [{"command": "train-nn", "name": "nn",
                            "matrix": {"model": ["tcn", "conv_rnn"],
                                       "epochs": [2]},
                            "overrides": {"out": "{model}/{epochs}.pkl",
                                          "n_folds": 4}}]},
        "paper": yaml.safe_load(PAPER.read_text()),
    }


def _mini_manifest(tmp_path, n_iter=1):
    return {
        "defaults": {"data": "synthetic", "seed": 0},
        "jobs": [
            {
                "command": "svm-decode",
                "matrix": {"target_pt": ["S14", "S26"],
                           "strategy": ["sep_align", "joint_pca"]},
                "overrides": {
                    "n_iter": n_iter, "n_folds": 2, "synth_patients": 2,
                    "synth_T": 12, "synth_trials": 6, "max_k": 8,
                    "save_preds": False,
                    "out": str(tmp_path) + "/{target_pt}_{strategy}.pkl",
                },
            },
        ],
    }


def _write(tmp_path, manifest, name="m.yaml"):
    m = tmp_path / name
    m.write_text(yaml.safe_dump(manifest))
    return m


# ------------------------------------------------ expansion, JAX's cases --


@pytest.mark.parametrize("name", ["matrix", "chained", "mini", "named",
                                  "paper"])
def test_expand_manifest_equals_jax(name):
    manifest = _manifests()[name]
    got, want = expand_manifest(manifest), jrep.expand_manifest(manifest)
    assert got == want
    if name == "paper":
        assert len(got) == 86


def test_expand_manifest_cross_product_and_templates():
    jobs = expand_manifest(_manifests()["matrix"])
    assert len(jobs) == 5  # 2x2 matrix + 1 bare job
    assert jobs[0]["values"]["out"] == "r/S14_sep_align.pkl"
    assert jobs[0]["values"]["seed"] == 3  # defaults merged
    assert jobs[3]["values"]["out"] == "r/S26_joint_pca.pkl"
    assert jobs[4]["command"] == "realtime-sim"
    # matrix order: later keys vary fastest (itertools.product)
    assert [j["values"]["target_pt"] for j in jobs[:4]] == [
        "S14", "S14", "S26", "S26"]
    (job,) = expand_manifest(_manifests()["chained"])
    assert job["values"]["out"] == "r/S14_sep_align.pkl"


def test_expand_manifest_cyclic_templates_fail_loudly():
    manifest = {"defaults": {"a": "{b}x", "b": "{a}y"},
                "jobs": [{"command": "svm-decode"}]}
    for expand in (expand_manifest, jrep.expand_manifest):
        with pytest.raises(ValueError, match="converge"):
            expand(manifest)


def test_expand_manifest_rejects_bad_shapes():
    for bad in ({"jobs": []}, {"jobs": [{"matrix": {}}]},
                {"jobs": [{"command": "svm-decode",
                           "matrix": {"target_pt": "S14"}}]}):
        with pytest.raises(ValueError):
            expand_manifest(bad)
    # a template naming no key fails, as in JAX
    with pytest.raises(KeyError):
        expand_manifest({"jobs": [{"command": "svm-decode",
                                   "overrides": {"out": "{nokey}.pkl"}}]})


def test_literal_braces_are_formatted_once():
    """Intended difference: ``{{...}}`` is a literal ``{...}`` in the
    expanded value. The JAX loop formats the result again: it raises when
    the literal names no key, and substitutes it when it names one."""
    manifest = {"jobs": [{"command": "svm-decode",
                          "matrix": {"target_pt": ["S14"]},
                          "overrides": {"out": "r/{{lit}}_{target_pt}.pkl",
                                        "strategy": "{{target_pt}}"}}]}
    (job,) = expand_manifest(manifest)
    assert job["values"]["out"] == "r/{lit}_S14.pkl"
    assert job["values"]["strategy"] == "{target_pt}"
    with pytest.raises(KeyError, match="lit"):
        jrep.expand_manifest(manifest)
    manifest["jobs"][0]["overrides"]["out"] = "r.pkl"
    (jax_job,) = jrep.expand_manifest(manifest)
    assert jax_job["values"]["strategy"] == "S14"


def test_unknown_config_key_fails_before_any_run(tmp_path):
    m = _write(tmp_path, {"jobs": [{"command": "svm-decode",
                                    "overrides": {"not_a_field": 1}}]})
    with pytest.raises(KeyError):
        _run(ReproduceConfig(manifest=str(m), dry_run=True))


def test_unknown_command_fails(tmp_path):
    for cmd in ("no-such", "reproduce"):
        m = _write(tmp_path, {"jobs": [{"command": cmd}]})
        with pytest.raises(KeyError):
            _run(ReproduceConfig(manifest=str(m), dry_run=True))


def test_strict_override_key_still_raises_with_soft_defaults():
    _, _, cfg = _job_config("realtime-sim", {"data": "synthetic"},
                            soft_keys={"data"})
    assert not hasattr(cfg, "data")
    with pytest.raises(KeyError):
        _job_config("realtime-sim", {"data": "synthetic"}, soft_keys=())


def test_paper_manifest_builds_every_config():
    """Every job of paper.yaml builds the port's config, with the fields
    JAX builds for it."""
    import dataclasses

    jobs = expand_manifest(yaml.safe_load(PAPER.read_text()))
    cmds = set()
    for job in jobs:
        _, fn, cfg = _job_config(job["command"], job["values"],
                                 job["soft_keys"])
        _, _, jcfg = jrep._job_config(job["command"], job["values"],
                                      job["soft_keys"])
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert fn.__module__.startswith("cross_patient_speech_decoding_"
                                        "tpu_torch.")
        cmds.add(job["command"])
    assert cmds == {"svm-decode", "train-seq2seq", "train-nn", "train-ctc",
                    "tune-ctc", "realtime-sim", "subsample-trials",
                    "subsample-grid", "subsample-spatial", "subsample-pitch"}


def test_paper_dry_run_lists_jax_jobs(tmp_path, monkeypatch, capsys):
    """``cpsd reproduce manifest=manifests/paper.yaml dry_run=true
    device=cpu`` lists the 86 jobs JAX's dry run lists, writing nothing."""
    monkeypatch.chdir(tmp_path)
    assert tmain.main(["reproduce", f"manifest={PAPER}", "dry_run=true",
                       "device=cpu"]) == 0
    got = [ln for ln in capsys.readouterr().out.splitlines()
           if ": would run" in ln]
    s = jrep.run_reproduce(JaxReproduceConfig(manifest=str(PAPER),
                                              dry_run=True))
    want = [ln for ln in capsys.readouterr().out.splitlines()
            if ": would run" in ln]
    assert got == want and len(got) == 86 and s["ran"] == 86
    assert not list(tmp_path.iterdir())


# ----------------------------------------------------- runs on the CPU --


def test_dry_run_and_only_filter(tmp_path):
    m = _write(tmp_path, _mini_manifest(tmp_path))
    s = _run(ReproduceConfig(manifest=str(m), dry_run=True))
    assert s["ran"] == 4 and s["skipped"] == 0 and not s["failed"]
    s = _run(ReproduceConfig(manifest=str(m), dry_run=True, only="S26"))
    assert s["ran"] == 2 and s["filtered"] == 2


def test_mini_matrix_end_to_end_with_resume(tmp_path, monkeypatch):
    """2 patients x 2 strategies run on the CPU; every job gets the run's
    device; a second call skips everything."""
    m = _write(tmp_path, _mini_manifest(tmp_path))
    seen = []
    orig = te.run_svm_decode

    def spy(cfg, verbose=True, device=None):
        seen.append(device)
        return orig(cfg, verbose=verbose, device=device)

    monkeypatch.setattr(te, "run_svm_decode", spy)
    cfg = ReproduceConfig(manifest=str(m))
    s = _run(cfg)
    assert s["ran"] == 4 and not s["failed"]
    assert seen == [torch.device("cpu")] * 4
    for pt in ("S14", "S26"):
        for st in ("sep_align", "joint_pca"):
            store = load_pkl(tmp_path / f"{pt}_{st}.pkl")
            assert len(store["accs"]) == 1
            assert store["params"]["strategy"] == st
    s2 = _run(cfg)
    assert s2["skipped"] == 4 and s2["ran"] == 0 and len(seen) == 4
    # a larger n_iter resumes each job from its file
    m2 = _write(tmp_path, _mini_manifest(tmp_path, n_iter=2), "m2.yaml")
    s3 = _run(ReproduceConfig(manifest=str(m2), only="S14_sep"))
    assert s3["ran"] == 1 and s3["filtered"] == 3
    assert len(load_pkl(tmp_path / "S14_sep_align.pkl")["accs"]) == 2


def test_run_manifest_takes_the_dict(tmp_path):
    """``run_manifest`` runs a manifest given as a dict; the config's
    ``manifest`` path is not read."""
    s = run_manifest(_mini_manifest(tmp_path),
                     ReproduceConfig(manifest="/no/such.yaml", only="S14"),
                     verbose=False, device="cpu")
    assert s["ran"] == 2 and s["filtered"] == 2
    with pytest.raises(ValueError, match="manifest="):
        _run(ReproduceConfig())


def test_keep_going_collects_failures(tmp_path, monkeypatch):
    m = _write(tmp_path, _mini_manifest(tmp_path))

    def boom(cfg, verbose=True, device=None):
        raise RuntimeError("injected")

    monkeypatch.setattr(te, "run_svm_decode", boom)
    s = _run(ReproduceConfig(manifest=str(m), keep_going=True))
    assert len(s["failed"]) == 4 and s["ran"] == 0
    # without keep_going the first failure propagates
    with pytest.raises(RuntimeError, match="injected"):
        _run(ReproduceConfig(manifest=str(m)))


def test_dry_run_is_read_only_on_mismatched_results(tmp_path):
    """A dry run never sets a results file aside, and leaves every file's
    bytes and mtime as they were."""
    m = _write(tmp_path, _mini_manifest(tmp_path))
    out = tmp_path / "S14_sep_align.pkl"
    # a result file from a DIFFERENT config (different seed)
    save_pkl({"params": {"seed": 999, "target_pt": "S14"},
              "accs": [np.ones(2)]}, out)
    before = {p: (p.read_bytes(), p.stat().st_mtime_ns)
              for p in tmp_path.iterdir()}
    s = _run(ReproduceConfig(manifest=str(m), dry_run=True))
    assert s["ran"] == 4
    assert {p: (p.read_bytes(), p.stat().st_mtime_ns)
            for p in tmp_path.iterdir()} == before
    assert not (tmp_path / "_stale").exists()


def test_n_devices_refused_before_any_job(tmp_path, monkeypatch):
    """``n_devices > 0`` of the run is forwarded to every job config that
    has the field, as JAX's cli/reproduce.py:185-187 does (each such
    driver launches its own ranks); 0 leaves a job's own value; a dry run
    calls no driver. A job with ``n_devices > 0`` gets the caller's
    device as given (None: its ranks take cuda:0 .. cuda:n-1), the others
    the resolved device. The drivers are spies here:
    tests/test_torch_driver_mesh.py runs a job on two ranks."""
    calls = []

    def spy(cfg, verbose=True, device=None):
        calls.append((type(cfg).__name__, cfg.n_devices, device))
        return np.zeros((1, 1))

    monkeypatch.setattr(te, "run_svm_decode", spy)
    monkeypatch.setattr(te, "run_train_nn", spy)
    m = _write(tmp_path, _mini_manifest(tmp_path))
    s = _run(ReproduceConfig(manifest=str(m), n_devices=2, dry_run=True))
    assert s["ran"] == 4 and calls == []
    s = _run(ReproduceConfig(manifest=str(m), n_devices=2))
    assert s["ran"] == 4
    assert calls == [("SVMDecodeConfig", 2, "cpu")] * 4
    calls.clear()
    man = _mini_manifest(tmp_path)
    man["jobs"].append({"command": "train-nn",
                        "overrides": {"n_devices": 4,
                                      "out": str(tmp_path / "nn.pkl")}})
    run_manifest(man, ReproduceConfig(), verbose=False, device="cpu")
    assert [c[:2] for c in calls] == [("SVMDecodeConfig", 0)] * 4 + [
        ("TrainNNConfig", 4)]
    # a job of several ranks gets the caller's device as given
    assert calls[-1][2] == "cpu" and calls[0][2] == torch.device("cpu")
    assert not list(tmp_path.glob("*.pkl"))


def test_n_devices_not_part_of_resume_identity():
    assert te._same_run_config({"target_pt": "S14", "n_devices": 0},
                               {"target_pt": "S14", "n_devices": 4})


def test_sweep_store_completion_detected(tmp_path):
    """Subsample drivers write {'params','sweep','results'} once at the
    end; reproduce detects those as complete."""
    out = tmp_path / "sweep.pkl"
    cfg = SubsampleConfig(n_iter=3, out=str(out))
    assert not _already_complete(cfg)
    save_pkl({"params": vars(cfg), "sweep": "trials",
              "results": {10: [0.5, 0.6, 0.7]}}, out)
    assert _already_complete(cfg)
    # different n_iter: a sweep is NOT resumable mid-way -> not complete
    assert not _already_complete(
        SubsampleConfig(n_iter=5, out=str(out)), mutate=False)


def test_jax_results_count_as_complete(tmp_path):
    """A results pickle written by the JAX package's svm-decode job (its
    own ``reproduce``) is complete for the port's: nothing runs."""
    man = _mini_manifest(tmp_path)
    man["jobs"][0]["matrix"] = {"target_pt": ["S14"],
                                "strategy": ["sep_align"]}
    m = _write(tmp_path, man)
    s = jrep.run_reproduce(JaxReproduceConfig(manifest=str(m)),
                           verbose=False)
    assert s["ran"] == 1
    s = _run(ReproduceConfig(manifest=str(m)))
    assert s["skipped"] == 1 and s["ran"] == 0


def test_device_is_an_argument(tmp_path, monkeypatch):
    """A real run resolves its device up front: without a card and without
    ``device='cpu'`` it raises before any job; a dry run touches no
    device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = _write(tmp_path, _mini_manifest(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_reproduce(ReproduceConfig(manifest=str(m)), verbose=False)
    s = run_reproduce(ReproduceConfig(manifest=str(m), dry_run=True),
                      verbose=False)
    assert s["ran"] == 4 and not list(tmp_path.glob("*.pkl"))
    assert "device" not in vars(ReproduceConfig())


def test_seq2seq_job_resumes_from_its_progress_pickle(tmp_path):
    """A finished ``train-seq2seq`` job is skipped: its completion is read
    from ``<out stem>.progress.pkl``, because its ``out`` is a CSV. The
    JAX package reads that CSV as a pickle and fails on the rerun
    (ROADMAP §3)."""
    import pickle

    from cross_patient_speech_decoding_tpu.utils.config import (
        TrainSeq2SeqConfig as JaxCfg,
    )

    values = dict(synth_patients=3, synth_T=16, synth_trials=4, n_folds=4,
                  n_iter=1, epochs=2, hidden=8, n_filters=4, kernel_size=4,
                  out=str(tmp_path / "s2s.pkl"))
    man = {"jobs": [{"command": "train-seq2seq", "overrides": values}]}
    s = run_manifest(man, ReproduceConfig(), verbose=False, device="cpu")
    assert s["ran"] == 1
    assert (tmp_path / "s2s.progress.pkl").exists()
    assert np.loadtxt(tmp_path / "s2s.pkl", delimiter=",").shape == (4,)
    s = run_manifest(man, ReproduceConfig(), verbose=False, device="cpu")
    assert s["skipped"] == 1 and s["ran"] == 0
    with pytest.raises(pickle.UnpicklingError):
        jrep._already_complete(JaxCfg(**values))
