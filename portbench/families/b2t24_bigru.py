"""The port's BrainToTextGRU in the Brain-to-Text '24 baseline's form
(Gaussian smoothing, day layers, a bidirectional windowed GRU stack from a
zero state, CTC head) behind the loops, through the port's public entry
points: the model, the CTC train step with the trainer's noise, Adam with
coupled L2. The pool, its lengths and its labels are ``b2t_gru``'s, made
by the benchmark on the device from generators it seeds.
"""

from __future__ import annotations

from portbench.core.weights import load_into
from portbench.families.b2t_gru import (  # noqa: F401  (the same pool)
    make_pool,
    span_work,
    train_flops,
)
from portbench.families.realtime_rnn import (  # noqa: F401  (the GRU counts)
    launch_counts,
    reset_launch_counts,
)


def build(cfg: dict, weights: dict, device):
    from cross_patient_speech_decoding_tpu_torch.models import BrainToTextGRU

    model = BrainToTextGRU(
        cfg["in_channels"], cfg["hidden"], cfg["n_layers"],
        cfg["n_classes"], n_days=cfg["n_days"], input_dropout=0.0,
        dropout=cfg["dropout"], win_size=cfg["win_size"],
        stride=cfg["stride"], blank=cfg["blank"], seed=0, device=device,
        bidirectional=cfg["bidirectional"], learned_h0=False,
        smooth_sigma=cfg["smooth_sigma"])
    load_into(model, weights)
    return model


def train_step(cfg: dict, model):
    """(state, step) of the port's CTC trainer with the noise."""
    from cross_patient_speech_decoding_tpu_torch.train import (
        create_train_state,
        make_ctc_train_step,
        make_optimizer,
    )

    if tuple(cfg["betas"]) != (0.9, 0.999):
        raise ValueError("the port's Adam takes betas (0.9, 0.999)")
    tx = make_optimizer(**cfg["optimizer"])
    aug = cfg["augment"]
    return create_train_state(model, tx), make_ctc_train_step(
        model, tx, augment=(aug["white_sd"], aug["offset_sd"]))
