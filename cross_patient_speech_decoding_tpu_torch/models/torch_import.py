"""The reference's Lightning checkpoints as the port's models.

Port of the GRU half of ``cross_patient_speech_decoding_tpu/models/
torch_import.py``. The reference trains its streaming model as a
Lightning module (``RealtimeRNNModel``, realtime_nn_model.py:122-147):
a ``torch.nn.GRU`` under ``rnn.rnn.*``, a trainable initial state ``h0``
and a linear head ``classifier.fc.*``. This module reads such a
checkpoint into the port's :class:`RealtimeRNN`, so a model trained by
the reference streams or fine-tunes here, and writes the port's weights
back in the reference's layout.

Layouts: ``weight_ih_l{k}`` is (3H, F) with the gate rows in reset,
update, new order, the order of the port's (F, 3H) ``wi`` columns, so the
map is a transpose; the two biases stay separate (the new gate needs
``r * (h Wh_n + b_hn)``); ``nn.Linear`` (out, in) becomes the head's
(in, out) kernel.

Checkpoints are read with ``torch.load(weights_only=False)``, because
Lightning pickles the hyperparameter dict: load only checkpoints you
trust. Not ported yet: the bidirectional model and the LSTM and seq2seq
imports (ROADMAP queue 1, item 7c).
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

__all__ = [
    "load_lightning_ckpt",
    "gru_params_from_torch",
    "lstm_params_from_torch",
    "stacked_rnn_params_from_torch",
    "realtime_rnn_from_ckpt",
    "seq2seq_from_ckpt",
    "realtime_rnn_to_state_dict",
]


def _np(t) -> np.ndarray:
    """A tensor or an array as contiguous numpy on the host."""
    if torch.is_tensor(t):
        t = t.detach().cpu().numpy()
    return np.ascontiguousarray(t)


def load_lightning_ckpt(path) -> tuple[dict, dict]:
    """Read a Lightning ``.ckpt`` -> (state dict as numpy, hyperparameters).

    Takes a full Lightning checkpoint (a dict with ``state_dict`` and
    ``hyper_parameters``) or a bare ``torch.save``d state dict.
    """
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, Mapping) and "state_dict" in ckpt:
        sd = ckpt["state_dict"]
        hparams = dict(ckpt.get("hyper_parameters", {}))
    else:
        sd, hparams = ckpt, {}
    return {k: _np(v) for k, v in sd.items()}, hparams


# the port's per-layer GRU weights -> the reference's torch names, with
# whether the map transposes: the one key table of both directions
_GRU_KEYS = (("wi", "weight_ih", True), ("wh", "weight_hh", True),
             ("bi", "bias_ih", False), ("bh", "bias_hh", False))
_HEAD_KEYS = (("head.kernel", "classifier.fc.weight", True),
              ("head.bias", "classifier.fc.bias", False))


def _move(a: np.ndarray, transpose: bool, dtype=None) -> np.ndarray:
    """A C-ordered copy of ``a``, transposed where the table says so."""
    return np.array(a.T if transpose else a, dtype=dtype, order="C")


def gru_params_from_torch(sd: Mapping[str, np.ndarray], prefix: str,
                          layer: int, reverse: bool = False) -> dict:
    """One torch GRU layer -> the port's layer weights {wi, wh, bi, bh}
    (numpy, (in, 3H) and (H, 3H) kernels)."""
    sfx = f"_l{layer}" + ("_reverse" if reverse else "")
    return {ours: _move(sd[f"{prefix}.{theirs}{sfx}"], t)
            for ours, theirs, t in _GRU_KEYS}


def _realtime_keys(n_layers: int, bidirectional: bool = False):
    """(the port's RealtimeRNN state-dict name, the reference's name,
    transposed) for every weight of the model."""
    yield "h0", "h0", False
    dirs = (("fwd", ""), ("bwd", "_reverse"))[:1 + bidirectional]
    for k in range(n_layers):
        for d, sfx in dirs:
            for ours, theirs, t in _GRU_KEYS:
                yield f"rnn.{d}{k}.{ours}", f"rnn.rnn.{theirs}_l{k}{sfx}", t
    yield from _HEAD_KEYS


def lstm_params_from_torch(sd, prefix: str, layer: int,
                           reverse: bool = False) -> dict:
    """Not ported yet: the port has no LSTM layer (ROADMAP queue 1, item
    7c)."""
    raise NotImplementedError(
        "lstm_params_from_torch: LSTM checkpoints are not ported yet "
        "(ROADMAP queue 1, item 7c)")


def stacked_rnn_params_from_torch(sd: Mapping[str, np.ndarray], prefix: str,
                                  n_layers: int, bidirectional: bool = False,
                                  cell: str = "gru") -> dict:
    """Torch ``nn.GRU`` stack -> the ``StackedRNN`` weights
    ({fwd0, bwd0, fwd1, ...}, each {wi, wh, bi, bh})."""
    per_layer = (gru_params_from_torch if cell == "gru"
                 else lstm_params_from_torch)
    out = {}
    for k in range(n_layers):
        out[f"fwd{k}"] = per_layer(sd, prefix, k, reverse=False)
        if bidirectional:
            out[f"bwd{k}"] = per_layer(sd, prefix, k, reverse=True)
    return out


def _infer_gru_stack(sd: Mapping[str, np.ndarray], prefix: str):
    """(n_layers, bidirectional, cell, hidden) of a torch RNN under
    ``prefix``."""
    n_layers = 0
    while f"{prefix}.weight_ih_l{n_layers}" in sd:
        n_layers += 1
    if n_layers == 0:
        raise KeyError(f"no RNN weights under '{prefix}.' in checkpoint")
    bidirectional = f"{prefix}.weight_ih_l0_reverse" in sd
    gates = sd[f"{prefix}.weight_ih_l0"].shape[0]
    hidden = sd[f"{prefix}.weight_hh_l0"].shape[1]
    cell = "gru" if gates == 3 * hidden else "lstm"
    return n_layers, bidirectional, cell, hidden


def realtime_rnn_from_ckpt(path, device=None):
    """The reference's ``RealtimeRNNModel`` checkpoint -> the port's
    :class:`RealtimeRNN` on ``device`` (default: the first CUDA card;
    raises without one) with the checkpoint's weights loaded.

    The architecture comes from the checkpoint's ``save_hyperparameters``
    dict, falling back to the state dict's shapes; the channel count is
    layer 0's input width over the window size. A bidirectional
    checkpoint raises (ROADMAP queue 1, item 7c), an LSTM one raises
    ``ValueError`` (the reference's model is GRU-based).
    """
    from cross_patient_speech_decoding_tpu_torch.models.realtime_rnn import (
        RealtimeRNN,
    )

    sd, hp = load_lightning_ckpt(path)
    n_layers, bidir, cell, hidden = _infer_gru_stack(sd, "rnn.rnn")
    if cell != "gru":
        raise ValueError("reference RealtimeRNNModel is GRU-based")
    if bool(hp.get("bidirectional", bidir)):
        raise NotImplementedError(
            "bidirectional RealtimeRNN checkpoints: the bidirectional model "
            "is not ported yet (ROADMAP queue 1, item 7c)")
    win = int(hp.get("win_size", 14))
    in_size = sd["rnn.rnn.weight_ih_l0"].shape[1]
    if in_size % win:
        raise ValueError(f"layer 0's input width {in_size} is not a "
                         f"multiple of the window size {win}")
    model = RealtimeRNN(
        in_size // win,
        hidden=int(hp.get("hidden_size", hidden)),
        n_layers=int(hp.get("n_layers", n_layers)),
        n_classes=int(hp.get("n_classes",
                             sd["classifier.fc.bias"].shape[0])),
        dropout=float(hp.get("dropout", 0.3)),
        win_size=win,
        stride=int(hp.get("stride", 4)),
        blank=int(hp.get("blank", 0)),
        device=device,
    )
    model.load_state_dict({
        ours: torch.from_numpy(_move(sd[theirs], t, np.float32))
        for ours, theirs, t in _realtime_keys(n_layers)})
    return model


def seq2seq_from_ckpt(path, device=None):
    """Not ported yet (ROADMAP queue 1, item 7c: it needs 7c's LSTM)."""
    raise NotImplementedError(
        "seq2seq_from_ckpt: Seq2SeqRNN checkpoints are not ported yet "
        "(ROADMAP queue 1, item 7c)")


def realtime_rnn_to_state_dict(model) -> dict:
    """The inverse map: a :class:`RealtimeRNN` (or its ``state_dict()``)
    -> a state dict in the reference's layout (numpy values,
    ``h0``, ``rnn.rnn.*``, ``classifier.fc.*``), so a model trained here
    goes back to the reference's tools."""
    p = model.state_dict() if hasattr(model, "state_dict") else model
    p = {k: _np(v) for k, v in p.items()}
    n_layers = sum(k.startswith("rnn.fwd") and k.endswith(".wi") for k in p)
    return {theirs: _move(p[ours], t) for ours, theirs, t in
            _realtime_keys(n_layers, "rnn.bwd0.wi" in p)}
