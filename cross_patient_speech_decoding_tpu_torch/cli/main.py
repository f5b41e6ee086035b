"""``cpsd`` command line of the port.

Port of ``cross_patient_speech_decoding_tpu/cli/main.py``: a subcommand
takes an optional ``--config file.yaml`` and Hydra-style ``key=value``
overrides. ``train-ctc``, ``svm-decode``, ``train-seq2seq``, ``train-nn``,
``prewarm-ctc``, ``prewarm-seq2seq``, the four subsample sweeps
(``subsample-trials``, ``subsample-grid``, ``subsample-spatial``,
``subsample-pitch``), ``tune-ctc``, ``make-xforms`` and ``realtime-sim``
are ported so far; every other command of the JAX package is listed and
refused with the ROADMAP item that ports it.
``device=cpu`` (or ``device=cuda:1``) picks the device; the default is
the first CUDA card.

Example::

    python -m cross_patient_speech_decoding_tpu_torch.cli.main train-ctc \\
        context=aligned n_iter=5 epochs=100 device=cpu
    python -m cross_patient_speech_decoding_tpu_torch.cli.main svm-decode \\
        synth_patients=3 synth_T=20 n_iter=2 n_folds=4 device=cpu
    python -m cross_patient_speech_decoding_tpu_torch.cli.main \\
        train-seq2seq synth_patients=3 synth_T=40 synth_trials=4 n_iter=2 \\
        n_folds=4 epochs=3 hidden=16 n_filters=8 device=cpu
    python -m cross_patient_speech_decoding_tpu_torch.cli.main train-nn \
        model=conv_rnn n_iter=2 n_folds=4 epochs=3 hidden=16 n_filters=8 \
        device=cpu
    python -m cross_patient_speech_decoding_tpu_torch.cli.main \\
        subsample-trials n_iter=2 k_step=40 device=cpu
    python -m cross_patient_speech_decoding_tpu_torch.cli.main tune-ctc \\
        n_trials=2 rungs=2 synth_T=60 manifest=/tmp/x/m.jsonl device=cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from cross_patient_speech_decoding_tpu_torch.cli.subsample_experiments \
    import SubsampleConfig
from cross_patient_speech_decoding_tpu_torch.utils.config import (
    REQUIRED,
    MakeXformsConfig,
    RealtimeSimConfig,
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
}

# the JAX package's other commands -> the ROADMAP queue 1 item that ports
# them
_NOT_PORTED = {
    "analyze": "10b",
    "reproduce": "10b",
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
    for name, item in _NOT_PORTED.items():
        p = sub.add_parser(name, help=f"not ported yet (ROADMAP queue 1, "
                                      f"item {item})")
        p.add_argument("rest", nargs=argparse.REMAINDER)

    args = parser.parse_args(argv)
    if args.command in _NOT_PORTED:
        raise NotImplementedError(
            f"{args.command}: not ported yet (ROADMAP queue 1, item "
            f"{_NOT_PORTED[args.command]})")
    cfg_cls, fn_name = _COMMANDS[args.command]
    device, overrides = _split_device(args.overrides)
    cfg = load_config(cfg_cls, args.config, overrides)

    from cross_patient_speech_decoding_tpu_torch.cli import (
        experiments,
        subsample_experiments,
    )

    mod = (subsample_experiments if cfg_cls is SubsampleConfig
           else experiments)
    result = getattr(mod, fn_name)(cfg, device=device)
    return 0 if result is not None else 1


if __name__ == "__main__":
    sys.exit(main())
