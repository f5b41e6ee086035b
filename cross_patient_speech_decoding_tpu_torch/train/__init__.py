"""Train state, optimizer, loop, checkpoints, the CTC, seq2seq and
classifier steps and the fold-parallel seq2seq trainer."""

from cross_patient_speech_decoding_tpu_torch.train.fold_parallel import (
    make_seq2seq_fold_trainer,
    make_seq2seq_fold_trainer_fn,
    pooled_fold_arrays,
)
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
    make_classifier_eval_step,
    make_classifier_train_step,
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
    "make_classifier_eval_step",
    "make_classifier_train_step",
    "make_ctc_eval_step",
    "make_ctc_train_step",
    "make_optimizer",
    "make_seq2seq_fold_trainer",
    "make_seq2seq_fold_trainer_fn",
    "make_seq2seq_eval_step",
    "make_seq2seq_train_step",
    "pooled_fold_arrays",
    "save_checkpoint",
]
