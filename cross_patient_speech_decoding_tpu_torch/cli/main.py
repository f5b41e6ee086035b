"""``cpsd`` command line of the port.

Port of ``cross_patient_speech_decoding_tpu/cli/main.py``, with all
fifteen of its commands: a subcommand takes an optional ``--config
file.yaml`` and Hydra-style ``key=value`` overrides. ``device=cpu`` (or
``device=cuda:1``) picks the device; the default is the first CUDA card.
``analyze`` runs on the host and takes no ``device=``; ``reproduce``
hands its device to every job of the manifest.

``n_devices=N`` runs a driver on N ranks, one process a device
(``parallel/``): the driver starts them itself, on ``cuda:0`` ..
``cuda:N-1`` (``device=cpu``: N CPU ranks over gloo). Under ``torchrun
--nproc_per_node=N`` each process joins torchrun's process group instead
and the driver runs in it.

Example::

    python -m cross_patient_speech_decoding_tpu_torch.cli.main train-ctc \\
        context=aligned n_iter=5 epochs=100 device=cpu
    python -m cross_patient_speech_decoding_tpu_torch.cli.main svm-decode \\
        synth_patients=3 synth_T=20 n_iter=2 n_folds=4 device=cpu
    python -m cross_patient_speech_decoding_tpu_torch.cli.main \\
        train-seq2seq synth_patients=3 synth_T=40 synth_trials=4 n_iter=2 \\
        n_folds=4 epochs=3 hidden=16 n_filters=8 device=cpu
    python -m cross_patient_speech_decoding_tpu_torch.cli.main train-nn \\
        model=conv_rnn n_iter=2 n_folds=4 epochs=3 hidden=16 n_filters=8 \\
        device=cpu
    python -m cross_patient_speech_decoding_tpu_torch.cli.main \\
        subsample-trials n_iter=2 k_step=40 device=cpu
    python -m cross_patient_speech_decoding_tpu_torch.cli.main tune-ctc \\
        n_trials=2 rungs=2 synth_T=60 manifest=/tmp/x/m.jsonl device=cpu
    python -m cross_patient_speech_decoding_tpu_torch.cli.main reproduce \\
        manifest=manifests/paper.yaml dry_run=true
    python -m cross_patient_speech_decoding_tpu_torch.cli.main analyze \\
        inputs=a=results/a.pkl,b=results/b.pkl
"""

from __future__ import annotations

import argparse
import dataclasses
import inspect
import sys

from cross_patient_speech_decoding_tpu_torch.cli.subsample_experiments \
    import SubsampleConfig
from cross_patient_speech_decoding_tpu_torch.utils.config import (
    REQUIRED,
    AnalyzeConfig,
    MakeXformsConfig,
    RealtimeSimConfig,
    ReproduceConfig,
    SVMDecodeConfig,
    TrainCTCConfig,
    TrainNNConfig,
    TrainSeq2SeqConfig,
    TuneCTCConfig,
    load_config,
)

_COMMANDS = {
    "train-ctc": (TrainCTCConfig, "run_train_ctc"),
    "svm-decode": (SVMDecodeConfig, "run_svm_decode"),
    "train-seq2seq": (TrainSeq2SeqConfig, "run_train_seq2seq"),
    "train-nn": (TrainNNConfig, "run_train_nn"),
    "prewarm-ctc": (TrainCTCConfig, "run_prewarm_ctc"),
    "prewarm-seq2seq": (TrainSeq2SeqConfig, "run_prewarm_seq2seq"),
    "subsample-trials": (SubsampleConfig, "run_trial_subsample"),
    "subsample-grid": (SubsampleConfig, "run_grid_subsample"),
    "subsample-spatial": (SubsampleConfig, "run_spatial_avg"),
    "subsample-pitch": (SubsampleConfig, "run_pitch_subsample"),
    "tune-ctc": (TuneCTCConfig, "run_tune_ctc"),
    "make-xforms": (MakeXformsConfig, "run_make_xforms"),
    "realtime-sim": (RealtimeSimConfig, "run_realtime_sim"),
    "analyze": (AnalyzeConfig, "run_analyze"),
    # manifest-driven full-matrix orchestration (the reference's SLURM
    # job-array workflow, README.md:27, as one resumable command)
    "reproduce": (ReproduceConfig, "run_reproduce"),
}


def _config_epilog(cfg_cls) -> str:
    """Field table for ``<cmd> --help``: every key=value override with its
    default."""
    lines = ["overridable keys (key=value):", "  device=(first CUDA card)"]
    for f in dataclasses.fields(cfg_cls):
        if f.default is dataclasses.MISSING or f.default is REQUIRED:
            lines.append(f"  {f.name}=(required)")
        else:
            lines.append(f"  {f.name}={f.default!r}")
    return "\n".join(lines)


def _split_device(overrides):
    """(``device=`` value or None, the other overrides): the device is an
    argument of the run, not a field of the experiment's config, so it
    does not enter the results file's config and a run resumes across
    devices."""
    device, rest = None, []
    for ov in overrides:
        if ov.startswith("device="):
            device = ov.split("=", 1)[1]
        else:
            rest.append(ov)
    return device, rest


def resolve_command(command: str):
    """(config class, driver function, whether the driver takes
    ``device=``) of a command. ``analyze`` runs on the host and takes no
    device."""
    from cross_patient_speech_decoding_tpu_torch.cli import (
        experiments,
        reproduce,
        subsample_experiments,
    )

    cfg_cls, fn_name = _COMMANDS[command]
    for mod in (experiments, subsample_experiments, reproduce):
        if hasattr(mod, fn_name):
            fn = getattr(mod, fn_name)
            return cfg_cls, fn, "device" in inspect.signature(fn).parameters
    raise AttributeError(fn_name)  # pragma: no cover - table/module drift


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="cpsd",
        description="Cross-patient speech decoding, PyTorch port",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    for name, (cfg_cls, _) in _COMMANDS.items():
        doc = (cfg_cls.__doc__ or "").strip()
        p = sub.add_parser(
            name,
            help=doc.splitlines()[0] if doc else None,
            description=doc or None,
            epilog=_config_epilog(cfg_cls),
            formatter_class=argparse.RawDescriptionHelpFormatter,
        )
        p.add_argument("--config", default=None, help="YAML config file")
        p.add_argument("overrides", nargs="*", help="key=value overrides")

    args = parser.parse_args(argv)
    cfg_cls, fn, on_device = resolve_command(args.command)
    device, overrides = _split_device(args.overrides)
    cfg = load_config(cfg_cls, args.config, overrides)
    if on_device:
        from cross_patient_speech_decoding_tpu_torch.parallel.mesh import (
            init_from_env,
        )

        joined = init_from_env(device)
        try:
            result = fn(cfg, device=device)
        finally:
            if joined:
                import torch.distributed as dist

                dist.destroy_process_group()
    elif device is not None:
        raise ValueError(f"{args.command} runs on the host: it takes no "
                         f"device= (got {device!r})")
    else:
        result = fn(cfg)
    return 0 if result is not None else 1


if __name__ == "__main__":
    sys.exit(main())
