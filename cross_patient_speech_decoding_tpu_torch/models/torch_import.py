"""The reference's Lightning checkpoints as the port's models.

Port of ``cross_patient_speech_decoding_tpu/models/torch_import.py``. The
reference trains its streaming model as a Lightning module
(``RealtimeRNNModel``, realtime_nn_model.py:122-147): a ``torch.nn.GRU``
under ``rnn.rnn.*``, a trainable initial state ``h0`` and a linear head
``classifier.fc.*``; and its seq2seq model as another
(``Seq2SeqRNN``, models.py:235-251): ``temporal_conv.{conv,bn}``, a
bidirectional ``encoder.rnn`` and ``decoder.{embedding,rnn,fc_out}``, the
RNNs GRUs or LSTMs. This module reads such checkpoints into the port's
:class:`RealtimeRNN` and :class:`Seq2SeqRNN`, so a model trained by the
reference streams, decodes or fine-tunes here, and writes the port's
streaming weights back in the reference's layout.

Layouts: ``weight_ih_l{k}`` is (3H, F) with the gate rows in reset,
update, new order, the order of the port's (F, 3H) ``wi`` columns, so the
map is a transpose; the two biases stay separate (the new gate needs
``r * (h Wh_n + b_hn)``). An ``nn.LSTM``'s (4H, F) rows are in input,
forget, cell, output order, ``FusedLSTM``'s, and its two biases fold into
the one ``b = b_ih + b_hh``. ``nn.Linear`` (out, in) becomes a dense
(in, out) kernel; ``nn.Conv1d``'s (out, in, k) weight is the port's
layout as it is; ``nn.BatchNorm1d``'s weight, bias and running statistics
become ``BatchNorm``'s scale, bias, mean and var.

Checkpoints are read with ``torch.load(weights_only=False)``, because
Lightning pickles the hyperparameter dict: load only checkpoints you
trust. Where the JAX functions return (model, variables), these return
the port's model with the weights loaded.
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


def lstm_params_from_torch(sd: Mapping[str, np.ndarray], prefix: str,
                           layer: int, reverse: bool = False) -> dict:
    """One torch LSTM layer -> the port's ``FusedLSTM`` weights {wi, wh,
    b} (numpy, (in, 4H) and (H, 4H) kernels, the two biases summed)."""
    sfx = f"_l{layer}" + ("_reverse" if reverse else "")
    return {"wi": _move(sd[f"{prefix}.weight_ih{sfx}"], True),
            "wh": _move(sd[f"{prefix}.weight_hh{sfx}"], True),
            "b": sd[f"{prefix}.bias_ih{sfx}"] + sd[f"{prefix}.bias_hh{sfx}"]}


def stacked_rnn_params_from_torch(sd: Mapping[str, np.ndarray], prefix: str,
                                  n_layers: int, bidirectional: bool = False,
                                  cell: str = "gru") -> dict:
    """Torch ``nn.GRU`` / ``nn.LSTM`` stack -> the ``StackedRNN`` weights
    ({fwd0, bwd0, fwd1, ...}, each {wi, wh, bi, bh} or {wi, wh, b})."""
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
    layer 0's input width over the window size. An LSTM checkpoint raises
    ``ValueError`` (the reference's model is GRU-based).
    """
    from cross_patient_speech_decoding_tpu_torch.models.realtime_rnn import (
        RealtimeRNN,
    )

    sd, hp = load_lightning_ckpt(path)
    n_layers, bidir, cell, hidden = _infer_gru_stack(sd, "rnn.rnn")
    if cell != "gru":
        raise ValueError("reference RealtimeRNNModel is GRU-based")
    bidir = bool(hp.get("bidirectional", bidir))
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
        bidirectional=bidir,
        blank=int(hp.get("blank", 0)),
        device=device,
    )
    model.load_state_dict({
        ours: torch.from_numpy(_move(sd[theirs], t, np.float32))
        for ours, theirs, t in _realtime_keys(n_layers, bidir)})
    return model


def _stack_state(name: str, sd, prefix: str, n_layers: int,
                 bidirectional: bool, cell: str) -> dict:
    """A torch RNN stack as the port's ``{name}.fwd0.wi``, ... entries."""
    layers = stacked_rnn_params_from_torch(sd, prefix, n_layers,
                                           bidirectional, cell)
    return {f"{name}.{layer}.{k}": v for layer, p in layers.items()
            for k, v in p.items()}


def seq2seq_from_ckpt(path, device=None):
    """The reference's ``Seq2SeqRNN`` checkpoint -> the port's
    :class:`Seq2SeqRNN` on ``device`` (default: the first CUDA card;
    raises without one) with the checkpoint's weights and the BatchNorm's
    running statistics loaded, so its eval-mode outputs are the torch
    model's.

    The architecture comes from the hyperparameters, falling back to the
    state dict's shapes; the cell (GRU or LSTM) from the encoder's gate
    rows. A unidirectional encoder or a conv padding other than 0 raises
    ``ValueError``, as in the JAX package.
    """
    from cross_patient_speech_decoding_tpu_torch.models.seq2seq import (
        Seq2SeqRNN,
    )

    sd, hp = load_lightning_ckpt(path)
    n_enc, enc_bidir, cell, hidden = _infer_gru_stack(sd, "encoder.rnn")
    if not enc_bidir:
        raise ValueError("reference Seq2SeqRNN encoder is bidirectional")
    n_dec, _, _, _ = _infer_gru_stack(sd, "decoder.rnn")
    conv_w = sd["temporal_conv.conv.weight"]  # (out, in, k)
    n_filters, in_ch, kernel_size = conv_w.shape
    num_classes = sd["decoder.fc_out.bias"].shape[0]
    if int(hp.get("padding", 0)) != 0:
        raise ValueError(
            "nonzero conv padding is not used by the reference drivers and "
            "is not supported by the importer"
        )
    cell = str(hp.get("model_type", cell))
    n_enc = int(hp.get("n_enc_layers", n_enc))
    n_dec = int(hp.get("n_dec_layers", n_dec))
    model = Seq2SeqRNN(
        in_ch,
        n_filters=int(hp.get("n_filters", n_filters)),
        hidden=int(hp.get("hidden_size", hidden)),
        num_classes=int(hp.get("num_classes", num_classes)),
        n_enc_layers=n_enc,
        n_dec_layers=n_dec,
        kernel_size=int(hp.get("kernel_size", kernel_size)),
        stride=int(hp.get("stride", 1)),
        cnn_dropout=float(hp.get("cnn_dropout", 0.3)),
        rnn_dropout=float(hp.get("rnn_dropout", 0.3)),
        cell=cell,
        seq_length=int(hp.get("seq_length", 3)),
        activation=bool(hp.get("activation", True)),
        device=device,
    )
    state = {
        "conv.weight": conv_w,
        "conv.bias": sd["temporal_conv.conv.bias"],
        "conv.norm.scale": sd["temporal_conv.bn.weight"],
        "conv.norm.bias": sd["temporal_conv.bn.bias"],
        "conv.norm.mean": sd["temporal_conv.bn.running_mean"],
        "conv.norm.var": sd["temporal_conv.bn.running_var"],
        **_stack_state("encoder.rnn", sd, "encoder.rnn", n_enc, True, cell),
        "decoder.embed.embedding": sd["decoder.embedding.weight"],
        **_stack_state("decoder.rnn", sd, "decoder.rnn", n_dec, False, cell),
        "decoder.head.kernel": _move(sd["decoder.fc_out.weight"], True),
        "decoder.head.bias": sd["decoder.fc_out.bias"],
    }
    model.load_state_dict({k: torch.from_numpy(_move(v, False, np.float32))
                           for k, v in state.items()})
    return model


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
