"""Model families of the port: the realtime CTC RNN, the seq2seq RNN and
their layers."""

from cross_patient_speech_decoding_tpu_torch.models.convert import (
    realtime_rnn_params_from_flax,
    seq2seq_params_from_flax,
)
from cross_patient_speech_decoding_tpu_torch.models.layers import (
    BatchNorm,
    Dense,
    FusedGRU,
    StackedRNN,
    TemporalConv,
    reformat_time_windows,
)
from cross_patient_speech_decoding_tpu_torch.models.realtime_rnn import (
    RealtimeRNN,
    adjusted_input_lengths,
)
from cross_patient_speech_decoding_tpu_torch.models.seq2seq import (
    DecoderRNN,
    EncoderRNN,
    Seq2SeqRNN,
)

__all__ = [
    "BatchNorm",
    "DecoderRNN",
    "Dense",
    "EncoderRNN",
    "FusedGRU",
    "RealtimeRNN",
    "Seq2SeqRNN",
    "StackedRNN",
    "TemporalConv",
    "adjusted_input_lengths",
    "realtime_rnn_params_from_flax",
    "reformat_time_windows",
    "seq2seq_params_from_flax",
]
