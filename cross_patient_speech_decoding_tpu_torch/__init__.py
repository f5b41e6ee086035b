"""PyTorch and CUDA port of cross_patient_speech_decoding_tpu.

The JAX package beside this one is the reference. This package mirrors its
layout (``ops/``, ``models/``, ``train/``, ``realtime/``); the GRU layers
run as hand-written CUDA kernels for Hopper (``ops/csrc``) on CUDA tensors
and as plain PyTorch on CPU tensors. Entry points run on the first CUDA
card unless the caller passes ``device="cpu"``.
"""
