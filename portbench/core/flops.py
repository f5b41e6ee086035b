"""Operations and bytes of the work, from shapes alone.

The two model counts are the JAX package's analytic ones (its
``bench.py:_ctc_flops_per_step`` and ``_seq2seq_flops_per_step``, also in
``chip_smoke.py``), copied so that model FLOP/s read the same across the
two packages: forward plus about twice that for the backward. The GRU
layer's work counts what a layer needs: its products, each input byte
read once and each output byte written once, whatever an implementation
recomputes or reads again.
"""

from __future__ import annotations


def ctc_train_flops(B, T, C, H, NL, n_cls, win, stride) -> float:
    """One RealtimeRNN train step: windowed layer-0 input projection,
    stacked recurrences and the head; the CTC loss left out."""
    n_win = (T - win) // stride + 1
    l0 = 2 * B * n_win * (win * C) * 3 * H
    rest = (NL - 1) * 2 * B * n_win * H * 3 * H
    rec = NL * 2 * B * n_win * H * 3 * H
    head = 2 * B * n_win * H * n_cls
    return 3 * (l0 + rest + rec + head)


def seq2seq_train_flops(B, T, C, F, H, K, L, n_cls) -> float:
    """One Seq2SeqRNN train step: the VALID conv, the bidirectional
    encoder, L decoder steps with their heads."""
    Tc = T - K + 1
    conv = 2 * B * Tc * K * C * F
    enc = 2 * (2 * B * Tc * F * 3 * H + 2 * B * Tc * H * 3 * H)
    dec = L * (2 * B * H * 3 * H * 2 + 2 * B * H * n_cls)
    return 3 * (conv + enc + dec)


def gru_layer_work(T, B, F, H, x_bytes: int = 4, need_dx: bool = True):
    """(forward flops, forward bytes, backward flops, backward bytes) of
    one GRU direction over T steps of B rows of F features.

    Forward: the input and recurrent products, 2 T B 3H (F + H); reads x,
    h0 and the weights, writes hs. Backward: the weight gradients of both
    products, dh through the recurrent one and, where the input trains, dx
    through the input one, 2 T B 3H (F (1 + dx) + 2H); reads x, the states,
    their gradient and the weights, writes dx, dh0 and the weight
    gradients.
    """
    w = ((F + H) * 3 * H + 2 * 3 * H) * 4
    x = T * B * F * x_bytes
    hs = T * B * H * 4
    h0 = B * H * 4
    fwd_flops = 2 * T * B * 3 * H * (F + H)
    fwd_bytes = x + h0 + w + hs
    bwd_flops = 2 * T * B * 3 * H * (F * (2 if need_dx else 1) + 2 * H)
    bwd_bytes = (x + h0 + w + 2 * hs
                 + (T * B * F * 4 if need_dx else 0) + h0 + w)
    return fwd_flops, fwd_bytes, bwd_flops, bwd_bytes
