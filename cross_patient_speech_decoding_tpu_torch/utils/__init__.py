"""Utilities of the PyTorch port: label encoding, timers, tracing, the
data-scaling fit and device selection (the JAX package's
``utils/__init__`` names, and ``resolve_device``)."""

from cross_patient_speech_decoding_tpu_torch.utils.device import resolve_device
from cross_patient_speech_decoding_tpu_torch.utils.labels import (
    PHON_TO_ARTIC,
    encode_label_sequences,
    phon_to_artic,
    to_class_ids,
)
from cross_patient_speech_decoding_tpu_torch.utils.profiling import (
    StageTimer,
    annotate,
    trace,
)
from cross_patient_speech_decoding_tpu_torch.utils.scaling import (
    log_linear_fit,
    trials_to_target_per,
)
from cross_patient_speech_decoding_tpu_torch.utils.timers import (
    Timer,
    median_ms,
)

__all__ = [
    "PHON_TO_ARTIC",
    "StageTimer",
    "Timer",
    "annotate",
    "encode_label_sequences",
    "log_linear_fit",
    "median_ms",
    "phon_to_artic",
    "resolve_device",
    "to_class_ids",
    "trace",
    "trials_to_target_per",
]
