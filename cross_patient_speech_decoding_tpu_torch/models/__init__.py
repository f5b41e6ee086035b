"""Model families of the port: the realtime CTC RNN, the brain-to-text
GRU decoder, the seq2seq RNN, the GRU, TCN and transformer classifiers
and their layers (GRU and LSTM, the day-specific input layer)."""

from cross_patient_speech_decoding_tpu_torch.models.b2t_gru import (
    BrainToTextGRU,
)
from cross_patient_speech_decoding_tpu_torch.models.convert import (
    nn_classifier_params_from_flax,
    realtime_rnn_params_from_flax,
    seq2seq_params_from_flax,
)
from cross_patient_speech_decoding_tpu_torch.models.layers import (
    BatchNorm,
    DayAffine,
    Dense,
    FusedGRU,
    FusedLSTM,
    PositionalEncoding,
    StackedRNN,
    TemporalConv,
    cosine_warmup_schedule,
    linear_decay_schedule,
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
    SimpleGRU,
    TemporalConvRNN,
)
from cross_patient_speech_decoding_tpu_torch.models.tcn_transformer import (
    CNNTransformer,
    TCNClassifier,
    TransformerClassifier,
)

__all__ = [
    "BatchNorm",
    "BrainToTextGRU",
    "CNNTransformer",
    "DayAffine",
    "DecoderRNN",
    "Dense",
    "EncoderRNN",
    "FusedGRU",
    "FusedLSTM",
    "PositionalEncoding",
    "RealtimeRNN",
    "Seq2SeqRNN",
    "SimpleGRU",
    "StackedRNN",
    "TCNClassifier",
    "TemporalConv",
    "TemporalConvRNN",
    "TransformerClassifier",
    "adjusted_input_lengths",
    "cosine_warmup_schedule",
    "linear_decay_schedule",
    "nn_classifier_params_from_flax",
    "realtime_rnn_params_from_flax",
    "reformat_time_windows",
    "seq2seq_params_from_flax",
]
