"""Command line of the port: ``python -m
cross_patient_speech_decoding_tpu_torch.cli.main <command> key=value ...``."""
