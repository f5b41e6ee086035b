"""``cpsd reproduce``: manifest-driven full-matrix orchestration.

Port of ``cross_patient_speech_decoding_tpu/cli/reproduce.py``. The
reference runs its paper as a SLURM job array over patients x strategies x
contexts (the reference repository's `README.md:27`: one sbatch per script, each
parameterized by ``-pt``/``-a``/... flags, e.g.
`aligned_decode_svm_ncv.py:114-120`). Here one manifest expands into a
sequenced list of driver invocations on one device, with cross-matrix
resume: jobs whose results files already hold ``n_iter`` iterations are
skipped outright, partially complete jobs resume through each driver's
``_completed_results``, so the whole matrix can be killed and relaunched
at any point. ``manifests/paper.yaml`` encodes the reference's grid, and
a results file written by either package counts in the other.

Where the port differs from the JAX package, on purpose:

- the device is an argument of the run (``run_reproduce(cfg,
  device=...)``), handed to every driver, not a config field;
- the YAML read is split from the run: :func:`run_manifest` takes the
  manifest as a dict;
- a formatted value is never formatted again: ``{{...}}`` in a template
  is a literal ``{...}`` whatever it names (the JAX loop formats it a
  second time, and raises or substitutes a key);
- ``n_devices > 0`` is forwarded to every job config that has the field,
  as in JAX; such a job gets the caller's device as given, so that its
  driver launches its ranks on ``cuda:0`` .. ``cuda:n-1`` by default;
- a ``train-seq2seq`` job's completion is read from its progress pickle
  (``<out stem>.progress.pkl``): its ``out`` is a CSV, which the JAX
  package reads as a pickle and fails on once the job has run.
"""

from __future__ import annotations

import itertools
import string
import time
from collections.abc import Mapping
from dataclasses import fields, replace as dataclasses_replace
from pathlib import Path

from cross_patient_speech_decoding_tpu_torch.utils.config import (
    ReproduceConfig,
    config_from_values,
)
from cross_patient_speech_decoding_tpu_torch.utils.device import (
    resolve_device,
)


def _resolve_command(command: str):
    """(cfg_cls, driver_fn, whether it takes ``device=``) for a manifest
    job's command name (``cli.main.resolve_command``; a job cannot be
    ``reproduce``)."""
    from cross_patient_speech_decoding_tpu_torch.cli.main import (
        _COMMANDS,
        resolve_command,
    )

    if command not in _COMMANDS or command == "reproduce":
        raise KeyError(
            f"unknown manifest command {command!r}; "
            f"available: {sorted(c for c in _COMMANDS if c != 'reproduce')}"
        )
    return resolve_command(command)


class _Templates(Mapping):
    """A job's merged values with every string that holds ``{`` formatted
    once, on first lookup, against the others' formatted values: a chain
    of templates resolves, a cycle raises, and what a format produced
    (the literal of a ``{{...}}``) is never parsed again."""

    _FMT = string.Formatter()

    def __init__(self, values: dict, job: int):
        self.values, self.job = values, job
        self.done: dict = {}
        self.active: list = []

    def __getitem__(self, key):
        if key in self.done:
            return self.done[key]
        v = self.values[key]
        if isinstance(v, str) and "{" in v:
            if key in self.active:
                cyclic = {k: self.values[k] for k in self.active}
                raise ValueError(
                    f"job #{self.job}: template expansion did not converge "
                    f"(cyclic references?): {cyclic}")
            self.active.append(key)
            v = self._FMT.vformat(v, (), self)
            self.active.pop()
        self.done[key] = v
        return v

    def __iter__(self):
        return iter(self.values)

    def __len__(self):
        return len(self.values)


def expand_manifest(manifest: dict) -> list[dict]:
    """Expand a manifest dict into a flat job list.

    Each entry: ``{"command", "values", "soft_keys", "label"}`` with
    ``values`` the fully-merged (defaults <- job overrides <- matrix
    point) dict and every string value ``str.format``-ed with the merged
    dict, so ``out: results/{target_pt}_{strategy}.pkl`` templates
    resolve, through chains of templates. ``soft_keys`` are the keys that
    came ONLY from ``defaults``: those are dropped for commands whose
    config lacks the field (a shared ``data: synthetic`` default must not
    crash ``realtime-sim``), while job-level ``overrides``/``matrix`` keys
    stay strict (typos in a 50-job matrix must fail loudly, before any
    device time is spent).
    """
    defaults = dict(manifest.get("defaults") or {})
    jobs = manifest.get("jobs")
    if not jobs:
        raise ValueError("manifest has no jobs")
    out = []
    for j, job in enumerate(jobs):
        if "command" not in job:
            raise ValueError(f"job #{j} missing 'command'")
        command = job["command"]
        overrides = dict(job.get("overrides") or {})
        matrix = dict(job.get("matrix") or {})
        for k, vs in matrix.items():
            if not isinstance(vs, (list, tuple)):
                raise ValueError(
                    f"job #{j} matrix key {k!r} must be a list, got {vs!r}")
        keys = list(matrix)
        for combo in itertools.product(*(matrix[k] for k in keys)) if keys \
                else [()]:
            point = dict(zip(keys, combo))
            merged = {**defaults, **overrides, **point}
            soft = set(defaults) - set(overrides) - set(point)
            templates = _Templates(merged, j)
            values = {k: templates[k] for k in merged}
            label = job.get("name", command)
            if point:
                label += "[" + ",".join(f"{k}={v}" for k, v in point.items()) + "]"
            out.append({"command": command, "values": values,
                        "soft_keys": soft, "label": label})
    return out


def _job_config(command: str, values: dict, soft_keys=()):
    """Build the job's config. ``soft_keys`` (defaults-only keys) are
    dropped when the target config class lacks the field; every other
    unknown key raises."""
    cfg_cls, fn, _ = _resolve_command(command)
    names = {f.name for f in fields(cfg_cls)}
    vals = {k: v for k, v in values.items()
            if k in names or k not in soft_keys}
    return cfg_cls, fn, config_from_values(cfg_cls, vals)


def _results_store(job_cfg) -> str:
    """The file that holds a job's per-iteration results: ``out``, but for
    the seq2seq driver, whose ``out`` is a CSV of the flat accuracies, its
    progress pickle."""
    from cross_patient_speech_decoding_tpu_torch.utils.config import (
        TrainSeq2SeqConfig,
    )

    out = getattr(job_cfg, "out", "")
    if out and isinstance(job_cfg, TrainSeq2SeqConfig):
        return str(Path(out).with_suffix(".progress.pkl"))
    return out


def _already_complete(job_cfg, mutate: bool = True) -> bool:
    """True when the job's results file already holds a complete run for
    THIS config (the driver-level resume identity, including the
    stale-file set-aside, suppressed with ``mutate=False`` for dry-run
    previews, which must be read-only).

    Two store layouts exist: the incremental per-iteration pickles of the
    decode/train drivers (complete when >= n_iter iterations), and the
    write-once sweep pickles of the subsample drivers
    ({'params','sweep','results'}: complete when params match exactly,
    INCLUDING n_iter, and results are non-empty). Jobs without an
    ``out``/``n_iter`` (e.g. realtime-sim) always re-run. The seq2seq
    driver's store is its progress pickle (:func:`_results_store`).
    """
    out = _results_store(job_cfg)
    n_iter = getattr(job_cfg, "n_iter", None)
    if not out or n_iter is None or not Path(out).exists():
        return False
    from cross_patient_speech_decoding_tpu_torch.cli.experiments import (
        _completed_results,
        _same_run_config,
    )

    done = _completed_results(out, vars(job_cfg), scalar=False,
                              set_aside=mutate)
    if len(done) >= n_iter:
        return True
    if done:
        return False  # partially complete incremental run: resume it
    if not Path(out).exists():
        return False  # a config-mismatched file was just set aside
    from cross_patient_speech_decoding_tpu_torch.data.loaders import load_pkl

    store = load_pkl(Path(out))
    if "results" in store and "sweep" in store:
        stored = store.get("params", {})
        return (_same_run_config(stored, vars(job_cfg))
                and stored.get("n_iter") == n_iter
                and bool(store["results"]))
    return False


def run_manifest(manifest: dict, cfg: ReproduceConfig, verbose: bool = True,
                 device=None):
    """Expand ``manifest`` (a dict, as read from the YAML) and run or
    resume every job in sequence on ``device`` (default: the first CUDA
    card; raises without one unless ``device='cpu'``; a dry run touches
    no device). ``cfg.manifest`` is not read.

    Returns a summary dict: ``{"ran", "skipped", "filtered", "failed"}``.
    """
    jobs = expand_manifest(manifest)
    filters = [s for s in cfg.only.split(",") if s]
    summary = {"ran": 0, "skipped": 0, "filtered": 0, "failed": []}
    plan = []
    for job in jobs:
        cfg_cls, fn, job_cfg = _job_config(
            job["command"], job["values"], job.get("soft_keys", ()))
        if cfg.n_devices and any(
                f.name == "n_devices" for f in fields(cfg_cls)):
            job_cfg = dataclasses_replace(job_cfg, n_devices=cfg.n_devices)
        if filters and not any(
                s in job["label"] or s in getattr(job_cfg, "out", "")
                for s in filters):
            summary["filtered"] += 1
            continue
        plan.append((job, fn, job_cfg, _resolve_command(job["command"])[2]))
    dev = None if cfg.dry_run else resolve_device(device)

    width = len(str(len(plan)))
    for i, (job, fn, job_cfg, on_device) in enumerate(plan):
        tag = f"[{i + 1:>{width}}/{len(plan)}] {job['label']}"
        # dry-run previews are READ-ONLY: no stale-file set-asides
        if _already_complete(job_cfg, mutate=not cfg.dry_run):
            summary["skipped"] += 1
            if verbose:
                print(f"{tag}: complete, skipping", flush=True)
            continue
        if cfg.dry_run:
            summary["ran"] += 1
            if verbose:
                out = getattr(job_cfg, "out", "")
                print(f"{tag}: would run" + (f" -> {out}" if out else ""),
                      flush=True)
            continue
        t0 = time.time()
        if verbose:
            print(f"{tag}: running...", flush=True)
        kw = {"device": dev} if on_device else {}
        if on_device and getattr(job_cfg, "n_devices", 0) > 0:
            # the caller's device as given: None puts rank r on cuda:r
            kw["device"] = device
        try:
            fn(job_cfg, verbose=verbose, **kw)
        except Exception as e:  # keep the matrix going when asked to
            summary["failed"].append(job["label"])
            if verbose:
                print(f"{tag}: FAILED {type(e).__name__}: {e}", flush=True)
            if not cfg.keep_going:
                raise
        else:
            summary["ran"] += 1
            if verbose:
                print(f"{tag}: done in {time.time() - t0:.1f}s", flush=True)
    if verbose:
        print(f"reproduce: {summary['ran']} ran, {summary['skipped']} "
              f"already complete, {summary['filtered']} filtered, "
              f"{len(summary['failed'])} failed", flush=True)
    return summary


def run_reproduce(cfg: ReproduceConfig, verbose: bool = True, device=None):
    """Read the manifest YAML ``cfg.manifest`` (PyYAML) and run it
    (:func:`run_manifest`)."""
    import yaml

    if not cfg.manifest:
        raise ValueError("reproduce requires manifest=<path to YAML>")
    manifest = yaml.safe_load(Path(cfg.manifest).read_text())
    return run_manifest(manifest, cfg, verbose=verbose, device=device)
