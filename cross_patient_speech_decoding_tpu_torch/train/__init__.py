"""Train and eval steps of the port."""

from cross_patient_speech_decoding_tpu_torch.train.steps import (
    make_ctc_eval_step,
)

__all__ = ["make_ctc_eval_step"]
