"""Ops of the port: GRU kernels, CTC, metrics, streaming DSP."""
