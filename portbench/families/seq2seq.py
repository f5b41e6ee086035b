"""The port's Seq2SeqRNN behind the loops: the fold trainer's per-fold
step, full-batch, through the port's public entry points."""

from __future__ import annotations

from portbench.core.flops import gru_layer_work, seq2seq_train_flops
from portbench.core.weights import load_into


def build(cfg: dict, weights: dict, device):
    from cross_patient_speech_decoding_tpu_torch.models import Seq2SeqRNN

    model = Seq2SeqRNN(
        cfg["in_channels"], cfg["n_filters"], cfg["hidden"],
        cfg["n_classes"], n_enc_layers=cfg["n_enc_layers"],
        n_dec_layers=cfg["n_dec_layers"], kernel_size=cfg["kernel_size"],
        cnn_dropout=cfg["cnn_dropout"], rnn_dropout=cfg["rnn_dropout"],
        seq_length=cfg["seq_length"], seed=0, device=device)
    load_into(model, weights)
    return model


def make_pool(cfg: dict, traffic: dict, rows: int, gen, device):
    """(x (rows, T, C) standard normal latents, y (rows, seq_length)
    classes drawn uniformly)."""
    import torch

    x = torch.randn((rows, traffic["T"], cfg["in_channels"]), generator=gen,
                    device=device)
    y = torch.randint(0, cfg["n_classes"], (rows, cfg["seq_length"]),
                      generator=gen, device=device)
    return x, y


def train_step(cfg: dict, model):
    from cross_patient_speech_decoding_tpu_torch.train import (
        create_train_state,
        make_optimizer,
        make_seq2seq_train_step,
    )

    tx = make_optimizer(**cfg["optimizer"])
    return (create_train_state(model, tx),
            make_seq2seq_train_step(model, tx, cfg["teacher_forcing"]))


def launch_counts() -> dict:
    from cross_patient_speech_decoding_tpu_torch.ops import gru

    return dict(gru.LAUNCHES)


def reset_launch_counts() -> None:
    from cross_patient_speech_decoding_tpu_torch.ops import gru

    gru.reset_launch_counts()


def train_flops(cfg: dict, traffic: dict, rows: int) -> float:
    return seq2seq_train_flops(rows, traffic["T"], cfg["in_channels"],
                               cfg["n_filters"], cfg["hidden"],
                               cfg["kernel_size"], cfg["seq_length"],
                               cfg["n_classes"])


def span_work(cfg: dict, traffic: dict, rows: int):
    """{(module, phase): (flops, bytes)} of one call of each stack: the
    bidirectional encoder over the conv's T - K + 1 steps, one decoder
    step (T = 1); every input trains, so every backward forms dx."""
    H, F = cfg["hidden"], cfg["n_filters"]
    Tc = traffic["T"] - cfg["kernel_size"] + 1
    enc = [2 * v for v in gru_layer_work(Tc, rows, F, H)]
    dec = gru_layer_work(1, rows, H, H)
    return {("encoder.rnn", "fwd"): (enc[0], enc[1]),
            ("encoder.rnn", "bwd"): (enc[2], enc[3]),
            ("decoder.rnn", "fwd"): (dec[0], dec[1]),
            ("decoder.rnn", "bwd"): (dec[2], dec[3])}
