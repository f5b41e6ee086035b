"""Faults planted in the port's timed path, to show that ``correct``
catches them: a step that returns its state unchanged, half of the batch
left out (the mean taken over the rest), an answer altered where it is
produced. Used by the tests (on the CPU) and by ``readings.py --fault``
(on the card, at the cell's own size). One chip: no exchange between
chips to leave out.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

# the faults each kind of loop can have
KINDS = {"train": ("unchanged", "half", "answer"),
         "eval": ("half", "answer"),
         "stream": ("unchanged", "answer")}


def _half(batch):
    return tuple(a[: a.shape[0] // 2] for a in batch)


def _train(fam, fault):
    real = fam.train_step

    def train_step(cfg, model):
        state, step = real(cfg, model)

        def broken(state, batch, gen):
            if fault == "half":
                batch = _half(batch)
            if fault == "unchanged":
                keep = [p.detach().clone() for p in state.model.parameters()]
            state, m = step(state, batch, gen)
            if fault == "unchanged":
                with torch.no_grad():
                    for p, k in zip(state.model.parameters(), keep):
                        p.copy_(k)
            if fault == "answer":
                m = dict(m, loss=m["loss"] * 1.001)
            return state, m

        return state, broken

    return "train_step", train_step


def _eval(fam, fault):
    real = fam.eval_step

    def eval_step(cfg, model):
        step = real(cfg, model)

        def broken(batch):
            out = step(_half(batch) if fault == "half" else batch)
            if fault == "answer":
                out = dict(out, per=out["per"] + 1.0)
            return out

        return broken

    return "eval_step", eval_step


def _stream(fam, fault):
    real = fam.stream_parts

    def stream_parts(cfg, model, b, a):
        step, fresh = real(cfg, model, b, a)

        def broken(state, chunk, bb, aa):
            new, (e, lg, ran) = step(state, chunk, bb, aa)
            if fault == "unchanged":
                new = new._replace(dsp=state.dsp, ring=state.ring)
            if fault == "answer" and ran:
                e = (lg.argmax() + 1) % cfg["n_classes"]
            return new, (e, lg, ran)

        return broken, fresh

    return "stream_parts", stream_parts


@contextmanager
def planted(fam, kind: str, fault: str):
    """Within the block, ``fam``'s entry for a ``kind`` loop carries
    ``fault``."""
    if fault not in KINDS[kind]:
        raise ValueError(f"a {kind} loop has no fault {fault!r}")
    name, broken = {"train": _train, "eval": _eval,
                    "stream": _stream}[kind](fam, fault)
    real = getattr(fam, name)
    setattr(fam, name, broken)
    try:
        yield
    finally:
        setattr(fam, name, real)
