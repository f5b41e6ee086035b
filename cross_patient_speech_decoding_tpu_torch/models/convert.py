"""Weights of the JAX package's models as the port's state dicts.

The port keeps the flax parameter names and (in, out) layouts, so the
RealtimeRNN conversion only flattens the nested tree with ``.`` and makes
tensors; the Seq2SeqRNN and classifier conversions also rename flax's
automatic module names and transpose the conv kernel.
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
    return _converted(*_unwrap(params_np, batch_stats_np), _seq2seq_name)


def _unwrap(params_np, batch_stats_np):
    """The two collections without their ``{"params": ...}`` /
    ``{"batch_stats": ...}`` wrappers."""
    if set(params_np) == {"params"}:
        params_np = params_np["params"]
    if set(batch_stats_np) == {"batch_stats"}:
        batch_stats_np = batch_stats_np["batch_stats"]
    return params_np, batch_stats_np


def _converted(params_np, batch_stats_np, rename) -> dict:
    """Flattened, renamed float32 tensors; the conv kernel goes from flax's
    (kernel_size, C_in, n_filters) to ``F.conv1d``'s (n_filters, C_in,
    kernel_size)."""
    out = {}
    for name, val in (*_flatten(params_np), *_flatten(batch_stats_np)):
        val = np.array(val, dtype=np.float32)
        if name == "TemporalConv_0.Conv_0.kernel":
            val = np.ascontiguousarray(val.transpose(2, 1, 0))
        out[rename(name)] = torch.from_numpy(val)
    return out


# flax EncoderBlock module paths -> the port's
_BLOCK_PARTS = {"LayerNorm_0": "norm1",
                "MultiHeadDotProductAttention_0": "attn",
                "LayerNorm_1": "norm2", "Dense_0": "ff1", "Dense_1": "ff2"}


def nn_classifier_params_from_flax(params_np, batch_stats_np) -> dict:
    """Flax classifier variables -> the port model's ``state_dict()``, for
    ``TCNClassifier``, ``TransformerClassifier``, ``CNNTransformer``,
    ``TemporalConvRNN`` and ``SimpleGRU``; the family is read from the
    top-level module names.

    Args:
        params_np: the ``params`` collection as nested dicts of numpy
            arrays (a top-level ``{"params": ...}`` wrapper is accepted):
            ``TemporalConv_0/{Conv_0, BatchNorm_0}``, ``StackedRNN_0/fwd{l}``,
            ``EncoderBlock_{i}/{LayerNorm_0, MultiHeadDotProductAttention_0/
            {query, key, value, out}, LayerNorm_1, Dense_0, Dense_1}``,
            ``Dense_{j}``.
        batch_stats_np: the ``batch_stats`` collection (wrapper accepted;
            empty for the transformer and ``SimpleGRU``):
            ``TemporalConv_0/BatchNorm_0/{mean, var}``.

    Returns:
        A state dict of float32 CPU tensors for ``load_state_dict``. The
        attention's ``DenseGeneral`` kernels keep their layouts, (D, heads,
        head_dim) and (heads, head_dim, D). The last ``Dense`` is the
        ``head``; before it, the transformer's one ``Dense`` is its input
        ``proj``, the TCN's and TemporalConvRNN's are the ``fc`` layers.
    """
    params_np, batch_stats_np = _unwrap(params_np, batch_stats_np)
    dense = sorted((k for k in params_np if k.startswith("Dense_")),
                   key=lambda k: int(k.split("_")[1]))
    top = {"TemporalConv_0": "conv", "StackedRNN_0": "rnn"}
    proj = "EncoderBlock_0" in params_np and "TemporalConv_0" not in params_np
    for i, name in enumerate(dense):
        top[name] = ("head" if i == len(dense) - 1 else "proj" if proj
                     else f"fc.{i}")

    def rename(name: str) -> str:
        mod, rest = name.split(".", 1)
        if mod.startswith("EncoderBlock_"):
            part, rest = rest.split(".", 1)
            return f"blocks.{mod.split('_')[1]}.{_BLOCK_PARTS[part]}.{rest}"
        if name == "TemporalConv_0.Conv_0.kernel":
            return "conv.weight"
        rest = rest.replace("Conv_0.", "").replace("BatchNorm_0.", "norm.")
        return f"{top[mod]}.{rest}"

    return _converted(params_np, batch_stats_np, rename)
