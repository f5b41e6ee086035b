"""Utilities of the PyTorch port."""

from cross_patient_speech_decoding_tpu_torch.utils.device import resolve_device

__all__ = ["resolve_device"]
