"""Hyperparameter search of the port: random trials and successive halving
(``search``), the TPE sampler and BOHB brackets (``bayes``), and the CTC
bucket trainers (``ctc``)."""

from cross_patient_speech_decoding_tpu_torch.sweep.bayes import (
    Categorical,
    Float,
    TPESampler,
    default_ctc_space,
    run_bohb,
    sample_random,
)
from cross_patient_speech_decoding_tpu_torch.sweep.search import (
    Manifest,
    SweepSpace,
    run_sweep,
    sample_trials,
)

__all__ = [
    "Categorical",
    "Float",
    "Manifest",
    "SweepSpace",
    "TPESampler",
    "default_ctc_space",
    "run_bohb",
    "run_sweep",
    "sample_random",
    "sample_trials",
]
