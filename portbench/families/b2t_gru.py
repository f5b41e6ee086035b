"""The port's BrainToTextGRU (day layers, windowed GRU stack, CTC head)
behind the loops, through the port's public entry points: the model, the
CTC train step and the optimizer ``rnn_fig5`` trains with. Inputs are made
by the benchmark, on the device, from generators it seeds.
"""

from __future__ import annotations

from portbench.core.weights import load_into
from portbench.families import b2t_gru_flops
from portbench.families.realtime_rnn import (  # noqa: F401  (the GRU counts)
    launch_counts,
    reset_launch_counts,
)


def build(cfg: dict, weights: dict, device):
    from cross_patient_speech_decoding_tpu_torch.models import BrainToTextGRU

    model = BrainToTextGRU(
        cfg["in_channels"], cfg["hidden"], cfg["n_layers"],
        cfg["n_classes"], n_days=cfg["n_days"],
        input_dropout=cfg["input_dropout"], dropout=cfg["dropout"],
        win_size=cfg["win_size"], stride=cfg["stride"], blank=cfg["blank"],
        seed=0, device=device)
    load_into(model, weights)
    return model


def make_pool(cfg: dict, traffic: dict, gen, device):
    """The pool of ``n_days`` x ``trials_per_day`` trials, day-major:
    (x (rows, T, C) standard normal features, 0 past each trial's length,
    labels (rows, L) int32, 0-padded, input lengths (rows,) int32, label
    lengths (rows,) int32). A trial's length is uniform in [len_lo,
    len_hi] frames; it holds round(label_rate x its windows) tokens drawn
    uniformly from [label_lo, label_hi]."""
    import torch

    rows = cfg["n_days"] * traffic["trials_per_day"]
    T, C = traffic["T"], cfg["in_channels"]
    w, s = cfg["win_size"], cfg["stride"]
    lab = traffic["labels"]
    il = torch.randint(traffic["len_lo"], traffic["len_hi"] + 1, (rows,),
                       generator=gen, device=device, dtype=torch.int32)
    x = torch.randn((rows, T, C), generator=gen, device=device)
    pad = torch.arange(T, device=device)[None, :] >= il[:, None]
    x.masked_fill_(pad[:, :, None], 0.0)
    n_win = torch.div(il - w, s, rounding_mode="floor") + 1
    ll = torch.round(lab["rate"] * n_win.double()).to(torch.int32)
    L = int(round(lab["rate"] * b2t_gru_flops.n_windows(traffic["len_hi"],
                                                        w, s)))
    labels = torch.randint(lab["lo"], lab["hi"] + 1, (rows, L),
                           generator=gen, device=device, dtype=torch.int32)
    labels.masked_fill_(torch.arange(L, device=device)[None, :]
                        >= ll[:, None], 0)
    return x, labels, il, ll


def train_step(cfg: dict, model):
    """(state, step) of the port's CTC trainer."""
    from cross_patient_speech_decoding_tpu_torch.train import (
        create_train_state,
        make_ctc_train_step,
        make_optimizer,
    )

    if tuple(cfg["betas"]) != (0.9, 0.999):
        raise ValueError("the port's AdamW takes betas (0.9, 0.999)")
    tx = make_optimizer(**cfg["optimizer"])
    return create_train_state(model, tx), make_ctc_train_step(model, tx)


def train_flops(cfg: dict, traffic: dict, rows: int):
    """None: a step's work follows its batch's longest trial, which varies
    from step to step, so no count from the traffic's parameters stands
    for the traced steps (no ``mfu`` metric reads this cell)."""
    return None


def span_work(cfg: dict, traffic: dict, rows: int, stream: bool = False):
    """None, for the reason of :func:`train_flops` (no ``rnn_roofline``
    metric reads this cell)."""
    return None
