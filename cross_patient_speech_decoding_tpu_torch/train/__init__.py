"""Train state, optimizer, loop, checkpoints and the CTC and seq2seq
steps."""

from cross_patient_speech_decoding_tpu_torch.train.loops import (
    FitResult,
    append_metrics,
    fit,
    load_checkpoint,
    make_optimizer,
    save_checkpoint,
)
from cross_patient_speech_decoding_tpu_torch.train.state import (
    TrainState,
    create_train_state,
)
from cross_patient_speech_decoding_tpu_torch.train.steps import (
    make_ctc_eval_step,
    make_ctc_train_step,
    make_seq2seq_eval_step,
    make_seq2seq_train_step,
)

__all__ = [
    "FitResult",
    "TrainState",
    "append_metrics",
    "create_train_state",
    "fit",
    "load_checkpoint",
    "make_ctc_eval_step",
    "make_ctc_train_step",
    "make_optimizer",
    "make_seq2seq_eval_step",
    "make_seq2seq_train_step",
    "save_checkpoint",
]
