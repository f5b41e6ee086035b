"""The numbers that decide ``correct``: gaps between what the port
produced and what the plain reference works out from the same inputs."""

from __future__ import annotations

import statistics

# a leaf whose reference gradient norm is under this share of the median
# leaf's is nought to rounding (as a bias before a normalisation is): it
# moves under Adam by round-off alone and is left out of the norms
NOUGHT_SHARE = 1e-3
# an argmax counts as decided where the reference's two best logits lie
# this many logits limits (times the largest logit) apart: a port within
# its logits limit cannot turn it over
DECIDED = 4.0


def rel_gap(got: float, want: float) -> float:
    """|got - want| / |want|; inf when got is not finite."""
    got, want = float(got), float(want)
    if got != got or abs(got) == float("inf"):
        return float("inf")
    return abs(got - want) / max(abs(want), 1e-30)


def max_rel(got, want) -> float:
    """max |got - want| / max |want| over two tensors of one shape."""
    import torch

    got, want = got.double(), want.double()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        return float("inf")
    return float((got - want).abs().max() / want.abs().max().clamp(
        min=1e-30))


def leaf_norms(tensors: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def counted_leaves(ref_grads: dict) -> list:
    """The leaves whose reference gradient norm is at least
    ``NOUGHT_SHARE`` of the median leaf's."""
    norms = leaf_norms(ref_grads)
    med = statistics.median(norms.values())
    return [k for k, v in norms.items() if v >= NOUGHT_SHARE * med]


def norm_gaps(got: dict, want: dict, leaves) -> dict:
    """Each leaf's |norm(got) - norm(want)| over the larger of norm(want)
    of that leaf and of the median leaf."""
    g, w = leaf_norms({k: got[k] for k in leaves}), \
        leaf_norms({k: want[k] for k in leaves})
    med = statistics.median(w.values())
    return {k: abs(g[k] - w[k]) / max(w[k], med, 1e-30) for k in leaves}


def worst(gaps: dict) -> tuple:
    """(gap, leaf) of the worst leaf; a NaN is the worst."""
    out, where = 0.0, None
    for k, gap in gaps.items():
        if not gap <= out:
            out, where = gap, k
    return out, where


def decided(logits, logits_limit: float):
    """(..., V) reference logits -> (...) bool: the argmax is decided."""
    top2 = logits.double().topk(2, dim=-1).values
    scale = float(logits.abs().max()) if logits.numel() else 1.0
    return (top2[..., 0] - top2[..., 1]) > DECIDED * logits_limit * scale
