"""Hyperparameter search of the port: the TPE sampler of the nested
classical decoder (the CTC sweeps are ROADMAP queue 1, item 8)."""
