"""Weights of the JAX package's RealtimeRNN as the port's state dict.

The port keeps the flax parameter names and (in, out) layouts, so the
conversion only flattens the nested tree with ``.`` and makes tensors.
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
