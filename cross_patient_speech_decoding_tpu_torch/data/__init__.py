"""Data layer of the port: synthetic generators, file loaders, splits."""

from cross_patient_speech_decoding_tpu_torch.data.synthetic import (
    SyntheticDataset,
    make_synthetic_patients,
    make_synthetic_patients_device,
)

__all__ = [
    "SyntheticDataset",
    "make_synthetic_patients",
    "make_synthetic_patients_device",
]
