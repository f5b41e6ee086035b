"""Streaming decode of the port: DSP -> windowed GRU -> greedy CTC."""

from cross_patient_speech_decoding_tpu_torch.realtime.simulator import (
    RealtimeConfig,
    RealtimeState,
    init_realtime_state,
    make_realtime_step,
    simulate_stream,
)

__all__ = [
    "RealtimeConfig",
    "RealtimeState",
    "init_realtime_state",
    "make_realtime_step",
    "simulate_stream",
]
