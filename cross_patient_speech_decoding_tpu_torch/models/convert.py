"""Weights of the JAX package's models as the port's state dicts.

The port keeps the flax parameter names and (in, out) layouts, so the
RealtimeRNN conversion only flattens the nested tree with ``.`` and makes
tensors; the Seq2SeqRNN conversion also renames flax's automatic module
names and transposes the conv kernel.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


def _flatten(tree, prefix: str = ""):
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            yield from _flatten(val, name + ".")
        else:
            yield name, val


def realtime_rnn_params_from_flax(params_np) -> dict:
    """Flax RealtimeRNN parameters -> ``RealtimeRNN.state_dict()``.

    Args:
        params_np: the flax ``params`` collection as nested dicts of numpy
            arrays (a top-level ``{"params": ...}`` wrapper is accepted):
            ``h0`` (n_layers, 1, H), ``rnn/fwd{l}/{wi, wh, bi, bh}``,
            ``head/{kernel, bias}``.

    Returns:
        A state dict of float32 CPU tensors for ``load_state_dict``.
    """
    if set(params_np) == {"params"}:
        params_np = params_np["params"]
    return {
        name: torch.from_numpy(np.array(val, dtype=np.float32))
        for name, val in _flatten(params_np)
    }


# flax Seq2SeqRNN module paths -> the port's
_SEQ2SEQ_PREFIXES = (
    ("TemporalConv_0.Conv_0.kernel", "conv.weight"),
    ("TemporalConv_0.Conv_0.", "conv."),
    ("TemporalConv_0.BatchNorm_0.", "conv.norm."),
    ("EncoderRNN_0.StackedRNN_0.", "encoder.rnn."),
    ("DecoderRNN_0.", "decoder."),
)


def _seq2seq_name(name: str) -> str:
    for old, new in _SEQ2SEQ_PREFIXES:
        if name.startswith(old):
            return new + name[len(old):]
    raise KeyError(f"no port name for flax variable {name!r}")


def seq2seq_params_from_flax(params_np, batch_stats_np) -> dict:
    """Flax Seq2SeqRNN variables -> ``Seq2SeqRNN.state_dict()``.

    Args:
        params_np: the ``params`` collection as nested dicts of numpy
            arrays (a top-level ``{"params": ...}`` wrapper is accepted):
            ``TemporalConv_0/{Conv_0, BatchNorm_0}``,
            ``EncoderRNN_0/StackedRNN_0/{fwd0, bwd0, ...}``,
            ``DecoderRNN_0/{embed, rnn, head}``.
        batch_stats_np: the ``batch_stats`` collection (wrapper accepted):
            ``TemporalConv_0/BatchNorm_0/{mean, var}``, the BatchNorm's
            running averages, which become its buffers.

    Returns:
        A state dict of float32 CPU tensors for ``load_state_dict``. The
        conv kernel goes from flax's (kernel_size, C_in, n_filters) to
        ``F.conv1d``'s (n_filters, C_in, kernel_size); every other array
        keeps its layout.
    """
    if set(params_np) == {"params"}:
        params_np = params_np["params"]
    if set(batch_stats_np) == {"batch_stats"}:
        batch_stats_np = batch_stats_np["batch_stats"]
    out = {}
    for name, val in (*_flatten(params_np), *_flatten(batch_stats_np)):
        val = np.array(val, dtype=np.float32)
        if name == "TemporalConv_0.Conv_0.kernel":
            val = np.ascontiguousarray(val.transpose(2, 1, 0))
        out[_seq2seq_name(name)] = torch.from_numpy(val)
    return out
