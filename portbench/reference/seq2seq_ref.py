"""Plain reference of ``seq2seq_ref``: the seq2seq phoneme decoder,
float32.

A VALID temporal convolution over time, batch normalisation over (batch,
time) with the batch's mean and biased variance E[x^2] - E[x]^2 (clipped
at 0, eps 1e-5), ReLU, dropout; a bidirectional GRU encoder from zero
states whose forward last state and reverse state at t = 0 are summed;
a GRU decoder of ``seq_length`` steps from the start token ``n_classes``
through an embedding, a dense head, and, at step i, the label fed back
where the step's teacher-forcing coin is under the ratio, else the argmax
(first index on ties). Mean cross-entropy over the batch's tokens.
Random draws in training, in order: the conv's dropout mask, then the
``seq_length`` coins in one draw.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.common import dropout, gru, precision, train


def leaves(cfg: dict) -> dict:
    """name -> (shape, scale, offset) of every weight (conv weight as
    (filters, in, kernel); dense kernels (in, out))."""
    C, Fn, K, H, V = (cfg["in_channels"], cfg["n_filters"],
                      cfg["kernel_size"], cfg["hidden"], cfg["n_classes"])
    out = {
        "conv.weight": ((Fn, C, K), 1 / math.sqrt(C * K), 0.0),
        "conv.bias": ((Fn,), 0.1, 0.0),
        "conv.norm.scale": ((Fn,), 0.1, 1.0),
        "conv.norm.bias": ((Fn,), 0.1, 0.0),
    }
    for d in ("fwd0", "bwd0"):
        p = f"encoder.rnn.{d}."
        out[p + "wi"] = ((Fn, 3 * H), 1 / math.sqrt(Fn), 0.0)
        out[p + "wh"] = ((H, 3 * H), 1 / math.sqrt(H), 0.0)
        out[p + "bi"] = ((3 * H,), 0.1, 0.0)
        out[p + "bh"] = ((3 * H,), 0.1, 0.0)
    out["decoder.embed.embedding"] = ((V + 1, H), 1 / math.sqrt(H), 0.0)
    p = "decoder.rnn.fwd0."
    out[p + "wi"] = ((H, 3 * H), 1 / math.sqrt(H), 0.0)
    out[p + "wh"] = ((H, 3 * H), 1 / math.sqrt(H), 0.0)
    out[p + "bi"] = ((3 * H,), 0.1, 0.0)
    out[p + "bh"] = ((3 * H,), 0.1, 0.0)
    out["decoder.head.kernel"] = ((H, V), 1 / math.sqrt(H), 0.0)
    out["decoder.head.bias"] = ((V,), 0.1, 0.0)
    return out


def forward(cfg, p, x, y, gen):
    """Logits (B, seq_length, V) in training (dropout, teacher forcing)."""
    if cfg["n_enc_layers"] != 1 or cfg["n_dec_layers"] != 1:
        raise ValueError("the reference holds one encoder and one decoder "
                         "layer")
    B = x.shape[0]
    h = F.conv1d(x.transpose(1, 2), p["conv.weight"], p["conv.bias"])
    h = h.transpose(1, 2)  # (B, T', F)
    mean = h.mean((0, 1))
    var = torch.clamp((h * h).mean((0, 1)) - mean * mean, min=0.0)
    h = (h - mean) * (torch.rsqrt(var + 1e-5) * p["conv.norm.scale"]) \
        + p["conv.norm.bias"]
    h = dropout(torch.relu(h), cfg["cnn_dropout"], gen)
    xt = h.transpose(0, 1)  # (T', B, F)
    H = cfg["hidden"]
    z = torch.zeros((B, H), device=x.device)
    e = "encoder.rnn."
    hf = gru(xt, z, p[e + "fwd0.wi"], p[e + "fwd0.bi"], p[e + "fwd0.wh"],
             p[e + "fwd0.bh"])
    hb = gru(xt, z, p[e + "bwd0.wi"], p[e + "bwd0.bi"], p[e + "bwd0.wh"],
             p[e + "bwd0.bh"], reverse=True)
    hidden = hf[-1] + hb[0]
    V = cfg["n_classes"]
    token = torch.full((B,), V, dtype=torch.long, device=x.device)
    coins = torch.rand(cfg["seq_length"], generator=gen, device=x.device)
    d = "decoder.rnn.fwd0."
    outs = []
    for i in range(cfg["seq_length"]):
        emb = p["decoder.embed.embedding"][token]
        hidden = gru(emb[None], hidden, p[d + "wi"], p[d + "bi"],
                     p[d + "wh"], p[d + "bh"])[0]
        logits = hidden @ p["decoder.head.kernel"] + p["decoder.head.bias"]
        outs.append(logits)
        pred = logits.argmax(dim=-1)
        token = torch.where(coins[i] < cfg["teacher_forcing"], y[:, i].long(),
                            pred)
    return torch.stack(outs, dim=1)


def train_steps(cfg: dict, weights: dict, batches, dropout_seed: int,
                lower: bool = False) -> dict:
    """As ``rnn_fig5.train_steps``."""
    dev = next(iter(weights.values())).device
    gen = torch.Generator(device=dev).manual_seed(dropout_seed)

    def loss_fn(p, batch, g):
        x, y = batch
        logits = forward(cfg, p, x, y, g)
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               y.reshape(-1).long())

    with precision(lower):
        return train(weights, loss_fn, batches, cfg["optimizer"], gen)
