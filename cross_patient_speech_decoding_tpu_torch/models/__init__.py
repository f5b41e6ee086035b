"""Model families of the port: the realtime CTC RNN and its layers."""

from cross_patient_speech_decoding_tpu_torch.models.convert import (
    realtime_rnn_params_from_flax,
)
from cross_patient_speech_decoding_tpu_torch.models.layers import (
    FusedGRU,
    StackedRNN,
    reformat_time_windows,
)
from cross_patient_speech_decoding_tpu_torch.models.realtime_rnn import (
    RealtimeRNN,
    adjusted_input_lengths,
)

__all__ = [
    "FusedGRU",
    "RealtimeRNN",
    "StackedRNN",
    "adjusted_input_lengths",
    "realtime_rnn_params_from_flax",
    "reformat_time_windows",
]
