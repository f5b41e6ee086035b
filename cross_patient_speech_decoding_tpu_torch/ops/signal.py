"""Streaming DSP: CAR, stateful IIR and stateless FIR band filtering, RMS
bin power.

Port of ``cross_patient_speech_decoding_tpu/ops/signal.py`` (:29-198):
the reference's realtime chain CAR -> per-band filter -> RMS power, with
the IIR in transposed direct form II and scipy's ``zi`` convention, the
FIR as one convolution, and ``filter_hg_bin`` routing a bin to either by
the shape of its coefficients.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from cross_patient_speech_decoding_tpu_torch.ops.precision import conv_f32
from cross_patient_speech_decoding_tpu_torch.utils.device import (
    resolve_device,
)


def car(data, good_mask=None):
    """Common-average reference. data (C, T); good_mask (C,) 1 = use in
    the average."""
    if good_mask is None:
        avg = data.mean(dim=0, keepdim=True)
    else:
        w = good_mask.to(data.dtype)[:, None]
        avg = (data * w).sum(dim=0, keepdim=True) / w.sum().clamp(min=1.0)
    return data - avg


def lfilter_zi(b: np.ndarray, a: np.ndarray) -> np.ndarray:
    """Steady-state initial conditions for a step input (scipy's
    ``lfilter_zi``). Host-side, float64: solves (I - A) zi = B with A the
    transposed direct-form II transition matrix."""
    b = np.asarray(b, np.float64)
    a = np.asarray(a, np.float64)
    a0 = a[0]
    a = a / a0
    b = b / a0
    n = max(len(a), len(b))
    a = np.pad(a, (0, n - len(a)))
    b = np.pad(b, (0, n - len(b)))
    A = np.zeros((n - 1, n - 1))
    A[:, 0] = -a[1:]
    A[:-1, 1:] = np.eye(n - 2)
    B = b[1:] - a[1:] * b[0]
    return np.linalg.solve(np.eye(n - 1) - A, B)


def iir_filter_stateful(data, b, a, zi):
    """Multi-band stateful IIR over a chunk (scipy ``lfilter`` parity).

    Transposed direct form II, a loop over the chunk's samples, vectorised
    over (bands, channels):

        y[t] = b0 x[t] + z0
        z_i  = b_{i+1} x[t] + z_{i+1} - a_{i+1} y[t]

    Args:
        data: (C, T) chunk.
        b, a: (n_bands, taps) coefficients, a[:, 0] == 1.
        zi: (n_bands, C, order) carried state, order = taps - 1.

    Returns:
        (filtered (C, T, n_bands), zf (n_bands, C, order)).
    """
    b0 = b[:, 0:1]  # (bands, 1)
    b_rest = b[:, None, 1:]  # (bands, 1, order)
    a_rest = a[:, None, 1:]
    z = zi
    ys = []
    for t in range(data.shape[1]):
        xb = data[None, :, t]  # (1, C)
        y = b0 * xb + z[..., 0]  # (bands, C)
        z_shift = torch.cat([z[..., 1:], torch.zeros_like(z[..., :1])], -1)
        z = z_shift + b_rest * xb[..., None] - a_rest * y[..., None]
        ys.append(y)
    return torch.stack(ys, dim=0).permute(2, 0, 1), z  # (C, T, bands)


def fir_filter(data, coefs):
    """Stateless causal FIR per band. data (C, T), coefs (n_bands, taps)
    -> (C, T, n_bands).

    One convolution with the channels as its batch and the bands as its
    output features, in float32 whatever the caller set for cuDNN's TF32
    (the JAX package pins ``Precision.HIGHEST``)."""
    taps = coefs.shape[1]
    padded = F.pad(data, (taps - 1, 0))[:, None, :]  # (C, 1, T+taps-1)
    weight = coefs.flip(-1)[:, None, :].to(data.dtype)  # conv1d correlates
    with conv_f32():
        out = F.conv1d(padded, weight)  # (C, bands, T)
    return out.transpose(1, 2)


def filter_hg_bin(data, coefs, band_ics=None):
    """Route a bin through IIR or FIR bandpass filtering by coefficient
    shape (the reference ``filter_HG_bin``).

    Args:
        data: (C, T) chunk.
        coefs: IIR as a ``(b, a)`` pair of (n_bands, taps) rows or a
            stacked (n_bands, taps, 2) array ([..., 0] = a, [..., 1] = b,
            the reference layout); FIR as a single (n_bands, taps) array.
            numpy arrays or tensors.
        band_ics: carried IIR state (n_bands, C, order), or None to start
            from each channel's ``lfilter_zi`` steady state.

    Returns:
        (filtered (C, T, n_bands), new state, or None for the FIR).
    """
    def on_data(a):
        return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a)
                               else a, dtype=data.dtype, device=data.device)

    if isinstance(coefs, (tuple, list)):
        b, a = coefs
    else:
        coefs = on_data(coefs)
        if coefs.dim() == 2:  # FIR
            return fir_filter(data, coefs), None
        if coefs.dim() != 3:
            raise ValueError("coefs must be 2-D (FIR) or 3-D / (b, a) (IIR)")
        a, b = coefs[..., 0], coefs[..., 1]
    if band_ics is None:
        host = [np.asarray(v.cpu() if torch.is_tensor(v) else v, np.float64)
                for v in (b, a)]
        band_ics = init_stream_state(*host, data.shape[0],
                                     device=data.device).zi.to(data.dtype)
    return iir_filter_stateful(data, on_data(b), on_data(a), band_ics)


def compute_bin_power(filtered):
    """RMS power per channel over (time, bands). (C, T, bands) -> (C,)."""
    return filtered.square().mean(dim=(1, 2)).sqrt()


class StreamState(NamedTuple):
    """Carried streaming-DSP state: IIR memory per band and channel."""

    zi: torch.Tensor  # (n_bands, C, order)


def init_stream_state(bandpass_b: np.ndarray, bandpass_a: np.ndarray,
                      n_channels: int, device=None) -> StreamState:
    """Per-channel steady-state zi for every band (reference :121-128),
    float32 on ``device`` (default: the first CUDA card)."""
    zis = [np.tile(lfilter_zi(b, a), (n_channels, 1))
           for b, a in zip(bandpass_b, bandpass_a)]
    return StreamState(zi=torch.as_tensor(
        np.stack(zis), dtype=torch.float32, device=resolve_device(device)))


def process_hg_chunk(chunk, b, a, state: StreamState, good_mask=None):
    """One streaming step: CAR -> stateful IIR -> RMS power.

    chunk (C, T_bin) -> (power (C,), new_state).
    """
    ref = car(chunk, good_mask)
    filtered, zf = iir_filter_stateful(ref, b, a, state.zi)
    return compute_bin_power(filtered), StreamState(zi=zf)
