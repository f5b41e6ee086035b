"""Plain reference of ``rnn_fig5``: the realtime CTC RNN, float32.

Sliding windows of ``win_size`` frames every ``stride`` frames, flattened
time-major ([t0 c0..cC, t1 c0..cC, ...]), the layer-0 frames rounded to
bf16; a stack of unidirectional GRU layers from the trainable initial
state ``h0``, dropout between layers in training; a dense head per
window. CTC loss per sequence (blank 0, infinite or above 1e4 taken as
0) over its label length, averaged; greedy decoding (argmax, repeats
collapsed, blanks dropped) and the phoneme error rate. The streaming
chain: common-average reference, a causal IIR filter per band carried
across bins from each channel's step steady state, RMS power over the
bin's samples and bands, a ring of the last ``win_size`` bins, a GRU step
every ``stride`` bins once the ring is full, a symbol emitted when the
argmax is neither blank nor the previous GRU step's argmax.

Leaves carry the names of the published (flax) tree, kernels (in, out).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.common import dropout, gru, precision, train


def leaves(cfg: dict) -> dict:
    """name -> (shape, scale, offset) of every weight."""
    C, H, L, V = (cfg["in_channels"], cfg["hidden"], cfg["n_layers"],
                  cfg["n_classes"])
    out = {"h0": ((L, 1, H), 0.1, 0.0)}
    for layer in range(L):
        Fi = cfg["win_size"] * C if layer == 0 else H
        p = f"rnn.fwd{layer}."
        out[p + "wi"] = ((Fi, 3 * H), 1 / math.sqrt(Fi), 0.0)
        out[p + "wh"] = ((H, 3 * H), 1 / math.sqrt(H), 0.0)
        out[p + "bi"] = ((3 * H,), 0.1, 0.0)
        out[p + "bh"] = ((3 * H,), 0.1, 0.0)
    out["head.kernel"] = ((H, V), 1 / math.sqrt(H), 0.0)
    out["head.bias"] = ((V,), 0.1, 0.0)
    return out


def windows(cfg, x):
    """(B, T, C) frames -> (B, n_win, win*C), bf16-rounded."""
    w, s = cfg["win_size"], cfg["stride"]
    n_win = (x.shape[1] - w) // s + 1
    xb = x.to(torch.bfloat16).float()
    xw = xb.unfold(1, w, s)[:, :n_win]  # (B, n_win, C, win)
    return xw.transpose(2, 3).reshape(x.shape[0], n_win, -1)


def forward(cfg, p, x, gen=None):
    """Logits (B, n_win, V); dropout between layers when ``gen`` is
    given (training)."""
    B = x.shape[0]
    out = windows(cfg, x).transpose(0, 1)  # (T, B, F)
    L = cfg["n_layers"]
    for layer in range(L):
        q = f"rnn.fwd{layer}."
        h0 = p["h0"][layer].expand(B, cfg["hidden"])
        out = gru(out, h0, p[q + "wi"], p[q + "bi"], p[q + "wh"],
                  p[q + "bh"])
        if gen is not None and layer < L - 1:
            out = dropout(out.transpose(0, 1), cfg["dropout"],
                          gen).transpose(0, 1)
    return out.transpose(0, 1) @ p["head.kernel"] + p["head.bias"]


def adjusted_lengths(cfg, il):
    return torch.div(il.long() - cfg["win_size"], cfg["stride"],
                     rounding_mode="floor") + 1


def ctc_loss(cfg, logits, labels, il, ll):
    lp = F.log_softmax(logits, dim=-1).transpose(0, 1)
    T = logits.shape[1]
    per = F.ctc_loss(lp, labels.long(),
                     adjusted_lengths(cfg, il).clamp(0, T), ll.long(),
                     blank=cfg["blank"], reduction="none",
                     zero_infinity=True)
    per = torch.where(torch.isfinite(per) & (per <= 1e4), per,
                      torch.zeros_like(per))
    return (per / ll.long().clamp(min=1)).mean()


def train_steps(cfg: dict, weights: dict, batches, dropout_seed: int,
                lower: bool = False) -> dict:
    """The first len(batches) train steps from ``weights``: losses, the
    first gradients as the optimizer takes them, the parameters after."""
    dev = next(iter(weights.values())).device
    gen = torch.Generator(device=dev).manual_seed(dropout_seed)

    def loss_fn(p, batch, g):
        x, labels, il, ll = batch
        return ctc_loss(cfg, forward(cfg, p, x, g), labels, il, ll)

    with precision(lower):
        return train(weights, loss_fn, batches, cfg["optimizer"], gen)


def greedy(cfg, logits, il):
    """[decoded symbols of each row] over its valid windows."""
    best = logits.argmax(-1).cpu().numpy()
    n = adjusted_lengths(cfg, il).clamp(0, logits.shape[1]).cpu().numpy()
    prev = np.concatenate([np.full((best.shape[0], 1), -1), best[:, :-1]],
                          axis=1)
    keep = (best != cfg["blank"]) & (best != prev)
    keep &= np.arange(best.shape[1])[None, :] < n[:, None]
    return [row[k].tolist() for row, k in zip(best, keep)]


def edit_distances(preds, targets) -> np.ndarray:
    """Levenshtein distance of each (pred, target) pair: the DP rows over
    the predictions, vectorised over the batch."""
    B = len(preds)
    P = max((len(s) for s in preds), default=0)
    L = max(len(t) for t in targets)
    pl = np.array([len(s) for s in preds])
    tl = np.array([len(t) for t in targets])
    pa = np.full((B, max(P, 1)), -1)
    ta = np.full((B, L), -2)
    for i, s in enumerate(preds):
        pa[i, :len(s)] = s
    for i, t in enumerate(targets):
        ta[i, :len(t)] = t
    row = np.tile(np.arange(L + 1, dtype=np.int64), (B, 1))
    for i in range(P):
        new = np.empty_like(row)
        new[:, 0] = i + 1
        for j in range(1, L + 1):
            cost = (pa[:, i] != ta[:, j - 1]).astype(np.int64)
            new[:, j] = np.minimum(np.minimum(row[:, j] + 1,
                                              new[:, j - 1] + 1),
                                   row[:, j - 1] + cost)
        row = np.where((i < pl)[:, None], new, row)
    return row[np.arange(B), tl].astype(np.float64)


def eval_batch(cfg: dict, weights: dict, batch, lower: bool = False) -> dict:
    """Logits, loss, PER (%), its edits and label total, and which
    windows each row's decode reads (``valid``), of one batch in
    evaluation."""
    x, labels, il, ll = batch
    with precision(lower), torch.no_grad():
        logits = forward(cfg, weights, x)
        loss = float(ctc_loss(cfg, logits, labels, il, ll))
    preds = greedy(cfg, logits, il)
    lab, lens = labels.cpu().numpy(), ll.cpu().numpy()
    targets = [r[:n].tolist() for r, n in zip(lab, lens)]
    edits = edit_distances(preds, targets).sum()
    total = max(int(lens.sum()), 1)
    n = adjusted_lengths(cfg, il).clamp(0, logits.shape[1])
    valid = torch.arange(logits.shape[1], device=n.device)[None] < n[:, None]
    return {"logits": logits, "loss": loss, "per": float(edits / total * 100),
            "edits": float(edits), "labels": total, "valid": valid}


def hg_power(chunks: np.ndarray, b: np.ndarray, a: np.ndarray,
             lower: bool = False) -> np.ndarray:
    """(N, C, S) raw bins -> (N, C) RMS band power, the filters carried
    across bins from each channel's step steady state (scipy's
    ``lfilter_zi``), in float64; ``lower``: one precision below the
    configuration's element-wise float32, the samples and the powers in
    bfloat16 and the filters in float32."""
    from scipy.signal import lfilter, lfilter_zi

    N, C, S = chunks.shape
    dtype = np.float32 if lower else np.float64
    x = chunks.transpose(1, 0, 2).reshape(C, N * S)
    x = (_bf16(x) if lower else x).astype(dtype)
    x = x - x.mean(axis=0, keepdims=True)
    sq = np.zeros((C, N * S), dtype)
    for bb, aa in zip(b, a):
        zi = np.tile(lfilter_zi(bb, aa).astype(dtype), (C, 1))
        y, _ = lfilter(bb.astype(dtype), aa.astype(dtype), x, axis=1, zi=zi)
        sq += y * y
    sq = sq.reshape(C, N, S).transpose(1, 0, 2)
    power = np.sqrt(sq.sum(axis=2) / (S * len(b)))
    return _bf16(power) if lower else power


def _bf16(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def stream(cfg: dict, weights: dict, chunks: np.ndarray, b: np.ndarray,
           a: np.ndarray, lower: bool = False) -> dict:
    """The streaming chain over every bin: power (N, C), the bins at which
    a GRU step runs, their logits (S, V), and each bin's emission (-1 for
    none). ``lower``: the control, its products in TF32 and its DSP in
    bfloat16 (``hg_power``)."""
    dev = next(iter(weights.values())).device
    power = hg_power(chunks, b, a, lower)
    w, s = cfg["win_size"], cfg["stride"]
    N = power.shape[0]
    runs = [k for k in range(N) if k + 1 >= w and (k + 1 - w) % s == 0]
    win = np.stack([power[k + 1 - w:k + 1].reshape(-1) for k in runs]) \
        if runs else np.zeros((0, w * power.shape[1]))
    out = torch.as_tensor(win, dtype=torch.float32, device=dev)[:, None]
    with precision(lower), torch.no_grad():
        for layer in range(cfg["n_layers"]):
            q = f"rnn.fwd{layer}."
            out = gru(out, weights["h0"][layer], weights[q + "wi"],
                      weights[q + "bi"], weights[q + "wh"], weights[q + "bh"])
        logits = (out[:, 0] @ weights["head.kernel"]
                  + weights["head.bias"])
    best = logits.argmax(-1).cpu().tolist()
    emits = np.full(N, -1, dtype=np.int64)
    prev = -1
    for k, sym in zip(runs, best):
        if sym != cfg["blank"] and sym != prev:
            emits[k] = sym
        prev = sym
    return {"power": power, "runs": runs, "logits": logits, "emits": emits}
