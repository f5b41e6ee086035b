"""Fitted states of the JAX package as the port's NamedTuples.

The alignment and the classifiers have no trained weights: their state is
fitted from data. A state fitted by the JAX package (``CCAAlignment``,
``FittedAligner``, ``PCAState``, ``MCCAState``, ``JointPCAState``,
``KernelClassifier``), handed over as numpy arrays, becomes the port's
NamedTuple of the same name and field order, so that the port's
transforms and predictions apply it.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from cross_patient_speech_decoding_tpu_torch.ops.cca import CCAAlignment
from cross_patient_speech_decoding_tpu_torch.utils.device import resolve_device

# fields that hold a state of their own
_NESTED = {("FittedAligner", "alignment"): CCAAlignment}


def _leaf(val, device):
    if val is None:
        return None
    if isinstance(val, (tuple, list)):
        return tuple(_leaf(v, device) for v in val)
    return torch.from_numpy(np.array(val)).to(device)


def state_from_numpy(cls, state, device=None):
    """A fitted state of the JAX package -> the port's ``cls``.

    Args:
        cls: the port's NamedTuple class (``ops.cca.FittedAligner``, ...).
        state: the JAX package's NamedTuple of the same name, with numpy
            (or array-like) leaves, or a mapping of its fields. Tuples of
            arrays (MCCA loadings, joint-PCA read-ins) stay tuples.
        device: where the tensors go; the first CUDA card by default.

    Returns:
        ``cls`` with tensors of the arrays' dtypes on ``device``.
    """
    dev = resolve_device(device)
    fields = dict(state) if isinstance(state, Mapping) else state._asdict()
    if set(fields) != set(cls._fields):
        raise ValueError(f"{cls.__name__} has fields {cls._fields}, got "
                         f"{tuple(fields)}")
    out = {}
    for name in cls._fields:
        sub = _NESTED.get((cls.__name__, name))
        val = fields[name]
        out[name] = (state_from_numpy(sub, val, dev) if sub is not None
                     else _leaf(val, dev))
    return cls(**out)
