"""The port's RealtimeRNN (the streaming CTC decoder) behind the loops.

Everything here calls the port's public entry points: the model, the
CTC train and eval steps with the port's optimizer, the realtime step.
Inputs are made by the benchmark, on the device, from generators it
seeds.
"""

from __future__ import annotations

from portbench.core.flops import ctc_train_flops, gru_layer_work
from portbench.core.weights import load_into


def build(cfg: dict, weights: dict, device):
    from cross_patient_speech_decoding_tpu_torch.models import RealtimeRNN

    model = RealtimeRNN(
        cfg["in_channels"], cfg["hidden"], cfg["n_layers"],
        cfg["n_classes"], dropout=cfg["dropout"], win_size=cfg["win_size"],
        stride=cfg["stride"], bidirectional=cfg["bidirectional"],
        blank=cfg["blank"], seed=0, device=device)
    load_into(model, weights)
    return model


def make_pool(cfg: dict, traffic: dict, rows: int, gen, device):
    """(x (rows, T, C) standard normal frames, labels (rows, L) int32,
    input lengths (rows,) all T, label lengths (rows,) all L): each label
    row is silence, phonemes drawn uniformly, silence."""
    import torch

    T, C = traffic["T"], cfg["in_channels"]
    lab = traffic["labels"]
    x = torch.randn((rows, T, C), generator=gen, device=device)
    sil = torch.full((rows, lab["n_sil"]), cfg["silence"], dtype=torch.int32,
                     device=device)
    phon = torch.randint(lab["phon_lo"], lab["phon_hi"] + 1,
                         (rows, lab["n_phon"]), generator=gen, device=device,
                         dtype=torch.int32)
    labels = torch.cat([sil, phon, sil], dim=1)
    il = torch.full((rows,), T, dtype=torch.int32, device=device)
    ll = torch.full((rows,), labels.shape[1], dtype=torch.int32,
                    device=device)
    return x, labels, il, ll


def train_step(cfg: dict, model):
    """(state, step) of the port's CTC trainer."""
    from cross_patient_speech_decoding_tpu_torch.train import (
        create_train_state,
        make_ctc_train_step,
        make_optimizer,
    )

    tx = make_optimizer(**cfg["optimizer"])
    return create_train_state(model, tx), make_ctc_train_step(model, tx)


def eval_step(cfg: dict, model):
    from cross_patient_speech_decoding_tpu_torch.train import (
        make_ctc_eval_step,
    )

    return make_ctc_eval_step(model)


def stream_parts(cfg: dict, model, b_np, a_np):
    """(step, fresh-state factory) of the port's realtime loop."""
    from cross_patient_speech_decoding_tpu_torch.realtime import (
        init_realtime_state,
        make_realtime_step,
    )

    def fresh():
        return init_realtime_state(model, b_np, a_np, cfg["in_channels"])

    return make_realtime_step(model), fresh


def launch_counts() -> dict:
    from cross_patient_speech_decoding_tpu_torch.ops import gru

    return dict(gru.LAUNCHES)


def reset_launch_counts() -> None:
    from cross_patient_speech_decoding_tpu_torch.ops import gru

    gru.reset_launch_counts()


LOGITS_MODULE = "head"


def train_flops(cfg: dict, traffic: dict, rows: int) -> float:
    return ctc_train_flops(rows, traffic["T"], cfg["in_channels"],
                           cfg["hidden"], cfg["n_layers"], cfg["n_classes"],
                           cfg["win_size"], cfg["stride"])


def span_work(cfg: dict, traffic: dict, rows: int, stream: bool = False):
    """{(module, phase): (flops, bytes)} of one call of the stack ``rnn``:
    offline, layer 0 reads the raw bf16 frames through its windows and
    forms no dx; streaming, one step of B=1 reads one float32 window."""
    H, C, w = cfg["hidden"], cfg["in_channels"], cfg["win_size"]
    if stream:
        T, B, x0_bytes = 1, 1, w * C * 4
    else:
        T = (traffic["T"] - w) // cfg["stride"] + 1
        B = rows
        x0_bytes = rows * traffic["T"] * C * 2
    tot = [0.0, 0.0, 0.0, 0.0]
    for layer in range(cfg["n_layers"]):
        F = w * C if layer == 0 else H
        work = gru_layer_work(T, B, F, H, need_dx=layer > 0 or stream)
        if layer == 0:
            adj = x0_bytes - T * B * F * 4
            work = (work[0], work[1] + adj, work[2], work[3] + adj)
        tot = [a + b for a, b in zip(tot, work)]
    return {("rnn", "fwd"): (tot[0], tot[1]), ("rnn", "bwd"): (tot[2],
                                                               tot[3])}
