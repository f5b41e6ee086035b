"""Closed-loop streaming decode: one step per incoming data bin.

Port of ``cross_patient_speech_decoding_tpu/realtime/simulator.py``. Each
raw chunk goes through CAR -> stateful IIR -> RMS power, joins a ring of
the last ``win`` feature bins, and every ``stride`` bins (once the ring is
full) one GRU step + dense head + greedy CTC emission runs. The bin count
and the run/skip decision live on the host; the DSP memory, the ring, the
GRU state and the last symbol stay in tensors on the model's device, so a
bin costs no device-to-host copy. On a card, each GRU step goes through
the ``gru_fwd`` kernel with T=1 and B=1.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from cross_patient_speech_decoding_tpu_torch.models.realtime_rnn import (
    RealtimeRNN,
)
from cross_patient_speech_decoding_tpu_torch.ops.signal import (
    StreamState,
    init_stream_state,
    process_hg_chunk,
)
from cross_patient_speech_decoding_tpu_torch.utils.profiling import annotate


@dataclass(frozen=True)
class RealtimeConfig:
    """Static configuration of the streaming loop."""

    win_size: int = 14
    stride: int = 4
    blank: int = 0


class RealtimeState(NamedTuple):
    """Everything carried between streaming steps."""

    dsp: StreamState  # IIR filter memories
    ring: torch.Tensor  # (win, C) last win feature bins
    n_bins: int  # total bins seen
    hidden: torch.Tensor  # (n_layers, 1, H) GRU state
    prev_sym: torch.Tensor  # last argmax symbol, 0-d int64 (-1 at start)


def init_realtime_state(model: RealtimeRNN, bandpass_b: np.ndarray,
                        bandpass_a: np.ndarray,
                        n_channels: int) -> RealtimeState:
    """Fresh streaming state on the model's device."""
    dev = model.device
    with torch.no_grad():
        hidden = model.initial_hidden(1).clone()
    return RealtimeState(
        dsp=init_stream_state(bandpass_b, bandpass_a, n_channels, dev),
        ring=torch.zeros((model.win_size, n_channels), dtype=torch.float32,
                         device=dev),
        n_bins=0,
        hidden=hidden,
        prev_sym=torch.full((), -1, dtype=torch.int64, device=dev),
    )


def make_realtime_step(model: RealtimeRNN,
                       cfg: RealtimeConfig | None = None):
    """Build ``step(state, chunk (C, T_bin), b, a) -> (state, (emitted,
    logits, did_run))``.

    ``emitted`` is a 0-d tensor, -1 when no new symbol (blank, repeat, or
    no GRU step this bin), else the class id. ``did_run`` is a Python bool.
    ``cfg`` defaults to the model's geometry (win_size, stride, blank).
    """
    if cfg is None:
        cfg = RealtimeConfig(model.win_size, model.stride, model.blank)

    def step(state: RealtimeState, chunk, b, a):
        n_bins = state.n_bins + 1
        with annotate("realtime_step", root=True, bin=n_bins), \
                torch.no_grad():
            with annotate("dsp"):
                power, dsp = process_hg_chunk(chunk, b, a, state.dsp)
            with annotate("ring"):
                ring = torch.cat([state.ring[1:], power[None, :]], dim=0)
            do_run = (n_bins >= cfg.win_size
                      and (n_bins - cfg.win_size) % cfg.stride == 0)
            if do_run:
                with annotate("gru_step"):
                    window = ring.reshape(1, -1)  # (1, win*C), time-major
                    logits, hidden = model.single_step(window, state.hidden)
                    logits = logits[0]
                    sym = logits.argmax()
                    emitted = torch.where(
                        (sym != cfg.blank) & (sym != state.prev_sym), sym,
                        torch.full_like(sym, -1))
                prev = sym
            else:
                logits = torch.zeros(model.n_classes, dtype=torch.float32,
                                     device=ring.device)
                hidden = state.hidden
                emitted = torch.full_like(state.prev_sym, -1)
                prev = state.prev_sym
        new_state = RealtimeState(dsp, ring, n_bins, hidden, prev)
        return new_state, (emitted, logits, do_run)

    return step


def simulate_stream(model: RealtimeRNN, state: RealtimeState, chunks, b, a,
                    cfg: RealtimeConfig | None = None):
    """Run the streaming step over (n_chunks, C, T_bin) chunks.

    Returns (final_state, (emitted (n_chunks,), logits (n_chunks, V),
    did_run (n_chunks,) bool)), all on the model's device.
    """
    step = make_realtime_step(model, cfg)
    emitted, logits, did_run = [], [], []
    for chunk in chunks:
        state, (e, lg, ran) = step(state, chunk, b, a)
        emitted.append(e)
        logits.append(lg)
        did_run.append(ran)
    return state, (
        torch.stack(emitted),
        torch.stack(logits),
        torch.tensor(did_run, dtype=torch.bool, device=state.ring.device),
    )
