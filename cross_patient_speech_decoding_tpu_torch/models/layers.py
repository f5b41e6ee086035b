"""Building blocks: window reformat, GRU layers and stacks, temporal conv,
positional encoding, learning-rate schedules.

Port of ``cross_patient_speech_decoding_tpu/models/layers.py``
(``reformat_time_windows``, ``FusedGRU``, ``FusedLSTM``, ``StackedRNN``,
``TemporalConv``, ``PositionalEncoding``, ``linear_decay_schedule``,
``cosine_warmup_schedule``), and the day-specific input layer
(``DayAffine``) and the Gaussian smoothing over time (``smooth_time``) of
the brain-to-text decoders, which the JAX package has not. Parameters keep
the flax names and the (in, out) layout: ``wi`` (F, 3H), ``wh`` (H, 3H),
``bi`` and ``bh`` (3H,), gate order
(r, z, n); ``FusedLSTM``'s ``wi`` (F, 4H), ``wh`` (H, 4H) and one bias ``b``
(4H,), gate order (i, f, g, o); a dense layer's ``kernel`` (in, out).
Initialisation follows flax, not torch's defaults: xavier-uniform ``wi``,
orthogonal ``wh``, zero biases, lecun-normal dense and conv kernels.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from cross_patient_speech_decoding_tpu_torch.ops.gru import (
    gru_layer,
    gru_layer_bidir,
    gru_layer_bidir_windowed,
    gru_layer_windowed,
    reformat_time_windows,
)
from cross_patient_speech_decoding_tpu_torch.ops.precision import conv_f32
from cross_patient_speech_decoding_tpu_torch.utils.profiling import annotate

__all__ = ["BatchNorm", "Conv1dF32", "DayAffine", "Dense", "FusedGRU",
           "FusedLSTM", "PositionalEncoding",
           "StackedRNN", "TemporalConv", "conv_f32", "cosine_warmup_schedule",
           "gaussian_kernel", "linear_decay_schedule",
           "reformat_time_windows", "smooth_time"]

# flax lecun_normal draws from a normal truncated at +-2 and rescales by
# this constant (the truncated unit normal's standard deviation)
TRUNC_STD = 0.87962566103423978


def lecun_normal_(t, fan_in: int, generator: torch.Generator | None = None):
    """flax ``lecun_normal``: truncated at +-2 std, std sqrt(1/fan_in)."""
    std = math.sqrt(1.0 / fan_in) / TRUNC_STD
    return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                 generator=generator)


class Dense(nn.Module):
    """``x @ kernel + bias`` with flax's (in, out) kernel layout; the kernel
    starts lecun-normal, the bias at 0."""

    def __init__(self, in_features: int, out_features: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        lecun_normal_(self.kernel, in_features, generator)

    def forward(self, x):
        return x @ self.kernel + self.bias


class FusedGRU(nn.Module):
    """One GRU layer. (B, T, F) -> (outputs (B, T, H), h_last (B, H)).

    With ``window=(win, stride)`` the input is raw frames (B, T, C), read
    as overlapping windows of width win*C by the windowed op, which never
    builds the window stream. The frames are read in bf16, on every
    device, as the JAX package's kernel path reads them
    (models/layers.py:98-100), so the plain path and the kernel compute
    the same function. Frames that require a gradient (the output of a
    trainable layer) go to the op as they are: it rounds them itself and
    returns their gradient unrounded. Other frames are data, cast here.
    """

    def __init__(self, in_features: int, hidden: int, reverse: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.hidden = hidden
        self.reverse = reverse
        H = hidden
        self.wi = nn.Parameter(torch.empty(in_features, 3 * H))
        self.wh = nn.Parameter(torch.empty(H, 3 * H))
        self.bi = nn.Parameter(torch.zeros(3 * H))
        self.bh = nn.Parameter(torch.zeros(3 * H))
        # torch's xavier fans of a 2-D (F, 3H) tensor equal flax's
        nn.init.xavier_uniform_(self.wi, generator=generator)
        nn.init.orthogonal_(self.wh, generator=generator)

    def forward(self, x, h0=None, window: tuple | None = None):
        B = x.shape[0]
        H = self.hidden
        if h0 is None:
            h0 = torch.zeros((B, H), dtype=torch.float32, device=x.device)
        h0 = h0.float().contiguous()
        if window is not None:
            frames = x if x.requires_grad else x.to(torch.bfloat16)
            hs = gru_layer_windowed(frames.transpose(0, 1), h0, self.wi,
                                    self.bi, self.wh, self.bh, *window)
        else:
            hs = gru_layer(x.transpose(0, 1), h0, self.wi, self.bi,
                           self.wh, self.bh, self.reverse)
        h_last = hs[0] if self.reverse else hs[-1]
        return hs.transpose(0, 1), h_last


class FusedLSTM(nn.Module):
    """One LSTM layer (the JAX ``FusedLSTM``, models/layers.py:167-199).
    (B, T, F) -> (outputs (B, T, H), (h_last, c_last) each (B, H)).

    The input projection of every step is one matmul, then a loop over
    time runs the recurrent product and the gates, in the order input,
    forget, cell, output (torch's ``nn.LSTM`` order):

        i, f, g, o = x W_i + b + h W_h  (split in four)
        c' = sigmoid(f) * c + sigmoid(i) * tanh(g)
        h' = sigmoid(o) * tanh(c')

    Parameters keep the flax names: ``wi`` (F, 4H) xavier-uniform, ``wh``
    (H, 4H) orthogonal and one bias ``b`` (4H,) at zero (torch's two
    biases summed). The JAX package has no Pallas kernel for it, so this is
    plain torch ops on every device.
    """

    def __init__(self, in_features: int, hidden: int, reverse: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.hidden = hidden
        self.reverse = reverse
        H = hidden
        self.wi = nn.Parameter(torch.empty(in_features, 4 * H))
        self.wh = nn.Parameter(torch.empty(H, 4 * H))
        self.b = nn.Parameter(torch.zeros(4 * H))
        nn.init.xavier_uniform_(self.wi, generator=generator)
        nn.init.orthogonal_(self.wh, generator=generator)

    def forward(self, x, carry0=None):
        B, T, F = x.shape
        H = self.hidden
        xi = (x.reshape(B * T, F) @ self.wi + self.b).reshape(B, T, 4 * H)
        if carry0 is None:
            z = torch.zeros((B, H), dtype=x.dtype, device=x.device)
            carry0 = (z, z)
        h, c = carry0
        hs = [None] * T
        for t in (reversed(range(T)) if self.reverse else range(T)):
            g = xi[:, t] + h @ self.wh
            i = torch.sigmoid(g[:, :H])
            f = torch.sigmoid(g[:, H:2 * H])
            gg = torch.tanh(g[:, 2 * H:3 * H])
            o = torch.sigmoid(g[:, 3 * H:])
            c = f * c + i * gg
            h = o * torch.tanh(c)
            hs[t] = h
        if T == 0:
            return xi.new_zeros((B, 0, H)), (h, c)
        return torch.stack(hs, dim=1), (h, c)


class StackedRNN(nn.Module):
    """Multi-layer, optionally bidirectional GRU or LSTM stack
    (``nn.GRU`` / ``nn.LSTM(num_layers, bidirectional)``).

    Layer modules are ``fwd0``, ``fwd1``, ... and, when bidirectional,
    ``bwd0``, ``bwd1``, ... as in the flax tree; a bidirectional layer
    above the first reads the 2H features of the one below. Each
    bidirectional GRU layer runs both directions through the fused op
    ``gru_layer_bidir`` (one kernel launch a step on the card). Returns
    (out (B, T, H * n_dir), last states (n_layers * n_dir, B, H)), the last
    states per layer forward then reverse (the reverse direction's is its
    state at t = 0). ``h0`` is laid out as the last states. Inter-layer
    dropout applies in training mode only, with flax's semantics (keep with
    probability 1 - p, scale kept values by 1/(1 - p)); its mask is drawn
    from ``generator``, the counterpart of the JAX step's dropout key
    (torch's default generator when None).

    ``cell="lstm"`` stacks :class:`FusedLSTM` layers: ``h0`` may then be an
    (h, c) pair of (n_layers * n_dir, B, H) stacks, a bare ``h0`` meaning h
    with a zero c, and the last states come back as such a pair, so an
    autoregressive caller carries the cell state too.

    ``input_grad=False`` marks the stack's input as data (``SimpleGRU``):
    a GRU's layer 0 reads it cast to bf16 on every device, as the JAX
    package's kernel path streams such an input (models/layers.py:136-142),
    and, since data needs no gradient, its backward forms no dx.

    ``window=(win, stride)`` reads raw frames (B, T, C) as overlapping
    windows of width win*C. A GRU stack leaves that to a windowed op when
    ``input_grad`` is set and the frames require a gradient (the output of
    a trainable layer below, as in ``BrainToTextGRU``): the op reads the
    frames in bf16 and gives them a gradient, a unidirectional layer 0
    through ``gru_layer_windowed``, a bidirectional one through
    ``gru_layer_bidir_windowed`` (both directions' window gradients folded
    onto the frames). A unidirectional GRU stack also leaves data frames
    (the raw frames of ``RealtimeRNN``) to ``gru_layer_windowed``. Other
    bidirectional stacks, and LSTM stacks, materialise the windows once
    for both directions (the JAX package's models/layers.py:234-240) from
    detached frames: those windows are data, a GRU's read in bf16, so on
    the card such a bidirectional layer 0 is ``gru_bifwd`` forward and
    ``gru_bwd`` without dx in each direction.
    """

    def __init__(self, in_features: int, hidden: int, n_layers: int = 1,
                 dropout: float = 0.0, bidirectional: bool = False,
                 cell: str = "gru", input_grad: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        if cell not in ("gru", "lstm"):
            raise ValueError(f"cell must be 'gru' or 'lstm', got {cell!r}")
        self.hidden = hidden
        self.n_layers = n_layers
        self.dropout = dropout
        self.bidirectional = bidirectional
        self.cell = cell
        self.input_grad = input_grad
        Cell = FusedGRU if cell == "gru" else FusedLSTM
        n_dir = 2 if bidirectional else 1
        for layer in range(n_layers):
            F = in_features if layer == 0 else hidden * n_dir
            self.add_module(f"fwd{layer}", Cell(F, hidden,
                                                generator=generator))
            if bidirectional:
                self.add_module(f"bwd{layer}", Cell(
                    F, hidden, reverse=True, generator=generator))

    def layer(self, i: int, direction: str = "fwd") -> nn.Module:
        return getattr(self, f"{direction}{i}")

    def forward(self, x, h0=None, window: tuple | None = None,
                generator: torch.Generator | None = None):
        gru = self.cell == "gru"
        out = x
        # the window of a bidirectional GRU layer 0 whose frames train
        win0 = None
        if (window is not None and gru and self.bidirectional
                and self.input_grad and x.requires_grad):
            win0, window = window, None
        elif window is not None and (self.bidirectional or not gru):
            if gru:
                out = x.detach().to(torch.bfloat16)
            out = reformat_time_windows(out, *window)
            window = None
        elif gru and not self.input_grad:
            out = x.detach().to(torch.bfloat16)
        lasts = []
        n_dir = 2 if self.bidirectional else 1
        for i in range(self.n_layers):
            h0_i = [_initial(h0, i * n_dir + d, gru) for d in range(n_dir)]
            if self.bidirectional and gru:
                out, *last = self._bidir_layer(
                    i, out, *h0_i, window=win0 if i == 0 else None)
                lasts += last
            elif self.bidirectional:
                f, last_f = self.layer(i)(out, h0_i[0])
                b, last_b = self.layer(i, "bwd")(out, h0_i[1])
                out = torch.cat([f, b], dim=-1)
                lasts += [last_f, last_b]
            else:
                kw = {"window": window} if gru and i == 0 else {}
                out, last = self.layer(i)(out, *h0_i, **kw)
                lasts.append(last)
            if self.training and self.dropout > 0 and i < self.n_layers - 1:
                out = _dropout(out, self.dropout, generator)
        if gru:
            return out, torch.stack(lasts)
        return out, (torch.stack([h for h, _ in lasts]),
                     torch.stack([c for _, c in lasts]))

    def _bidir_layer(self, i: int, x, h0_f, h0_b, window=None):
        """(out (B, T, 2H), forward last state, reverse last state); with
        ``window``, x is frames that train, read as its windows."""
        f, b = self.layer(i), self.layer(i, "bwd")
        z = torch.zeros((x.shape[0], self.hidden), dtype=torch.float32,
                        device=x.device)
        h0_f, h0_b = ((z if h is None else h).float().contiguous()
                      for h in (h0_f, h0_b))
        args = (x.transpose(0, 1), h0_f, h0_b, f.wi, f.bi, f.wh, f.bh, b.wi,
                b.bi, b.wh, b.bh)
        if window is None:
            hs_f, hs_b = gru_layer_bidir(*args)
        else:
            hs_f, hs_b = gru_layer_bidir_windowed(*args, *window)
        fwd, bwd = hs_f.transpose(0, 1), hs_b.transpose(0, 1)
        return torch.cat([fwd, bwd], dim=-1), hs_f[-1], hs_b[0]


def _initial(h0, k: int, gru: bool):
    """Row k of a stack's initial state: h0[k] for a GRU; for an LSTM the
    (h, c) pair of row k, with c zero where h0 is a bare h (or None)."""
    if h0 is None:
        return None
    if gru:
        return h0[k]
    if isinstance(h0, tuple):
        return h0[0][k], h0[1][k]
    return h0[k], torch.zeros_like(h0[k])


def _dropout(x, rate: float, generator: torch.Generator | None):
    """flax ``nn.Dropout``: where(mask, x / keep, 0), mask ~
    Bernoulli(keep)."""
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), device=x.device))


def day_groups(days, n_rows: int):
    """The rows of each day in a batch: [(day, rows)] in the order the days
    first appear, ``rows`` a slice where that day's rows are contiguous
    (as a batch drawn day by day has them), else a list of row indices.
    ``days`` (B,) int: a host tensor or list keeps the step free of a
    device read; a device tensor is read back."""
    ids = days.tolist() if torch.is_tensor(days) else list(days)
    if len(ids) != n_rows:
        raise ValueError(f"{len(ids)} day ids for {n_rows} rows")
    rows = {}
    for i, d in enumerate(ids):
        rows.setdefault(int(d), []).append(i)
    out = []
    for d, r in rows.items():
        contiguous = r[-1] - r[0] + 1 == len(r)
        out.append((d, slice(r[0], r[-1] + 1) if contiguous else r))
    return out


def _sorted_groups(groups):
    """The rows of :func:`day_groups` brought together day by day, each
    day's in batch order: (order, [(day, slice of the reordered rows)]),
    row k of the reordered batch being row ``order[k]`` of the batch."""
    order, out = [], []
    for d, r in groups:
        rows = list(range(r.start, r.stop)) if isinstance(r, slice) else r
        out.append((d, slice(len(order), len(order) + len(rows))))
        order += rows
    return order, out


def _rows_index(rows, device):
    """A list of row indices as an index tensor on ``device``, copied from
    pinned memory without waiting for the device."""
    idx = torch.tensor(rows, dtype=torch.long)
    if device.type == "cuda":
        return idx.pin_memory().to(device, non_blocking=True)
    return idx


class DayAffineFn(torch.autograd.Function):
    """``y = softsign(x_b W_{d(b)} + b_{d(b)})`` over (B, T, C) frames, one
    product over the rows of each day ``d`` in ``groups`` [(d, slice)],
    never a (B, C, C) gather of the weights. Without ``order`` the slices
    are rows of x (a batch drawn day by day). With ``order`` (an index
    tensor on x's device, from :func:`_sorted_groups`) they are rows of
    x[order]: one gather brings the rows in day by day and one scatter
    takes the result out, in the forward and again in the backward. The
    backward forms the gradients of the frames and of the days present;
    the other days' are 0. Each pass is a ``day_layer`` span (attrs
    ``rows``, ``days``, ``T``, ``C``, ``path``: ``days`` or ``sorted``;
    device ms on a card)."""

    @staticmethod
    def forward(ctx, x, w, b, groups, order):
        B, T, C = x.shape
        with annotate("day_layer", device=x.device, rows=B, days=len(groups),
                      T=T, C=C, path="days" if order is None else "sorted"):
            xs = x if order is None else x.index_select(0, order)
            a = torch.empty_like(xs)
            for d, r in groups:
                a[r] = torch.addmm(b[d], xs[r].reshape(-1, C),
                                   w[d]).view(-1, T, C)
            y = _unsort(F.softsign(a), order)
        ctx.save_for_backward(xs, w, a, order)
        ctx.groups = groups
        return y

    @staticmethod
    def backward(ctx, dy):
        xs, w, a, order = ctx.saved_tensors
        B, T, C = xs.shape
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dx = torch.empty_like(xs) if need_x else None
        dw = torch.zeros_like(w) if need_w else None
        db = torch.zeros((w.shape[0], C), dtype=w.dtype, device=w.device) \
            if need_b else None
        with annotate("day_layer", device=xs.device, rows=B,
                      days=len(ctx.groups), T=T, C=C,
                      path="days" if order is None else "sorted"):
            dys = dy if order is None else dy.index_select(0, order)
            for d, r in ctx.groups:
                g = (dys[r] / (1.0 + a[r].abs()).square()).reshape(-1, C)
                if need_x:
                    dx[r] = (g @ w[d].t()).view(-1, T, C)
                if need_w:
                    dw[d] = xs[r].reshape(-1, C).t() @ g
                if need_b:
                    db[d] = g.sum(0)
            if need_x:
                dx = _unsort(dx, order)
        return dx, dw, db, None, None


def _unsort(ys, order):
    """Rows reordered by ``order`` (or None) put back in batch order."""
    return ys if order is None else torch.empty_like(ys).index_copy_(
        0, order, ys)


class DayAffine(nn.Module):
    """The day-specific input layer of the brain-to-text decoders (Card et
    al., NEJM 2024: ``GRUDecoder``'s day layers; Willett et al., Nature
    2023, the Brain-to-Text '24 baseline, alike): (B, T, C) frames and (B,)
    day ids -> softsign(x W_{d(b)} + b_{d(b)}), with ``w`` (n_days, C, C)
    starting at the identity and ``b`` (n_days, C) at 0, as published.
    Runs as :class:`DayAffineFn`, one product a day present: over slices of
    the batch where each day's rows are contiguous (a batch drawn day by
    day), else over slices of the rows sorted by day once (a shuffled
    batch: one index copy to the device a batch)."""

    def __init__(self, n_days: int, features: int):
        super().__init__()
        self.w = nn.Parameter(torch.eye(features).repeat(n_days, 1, 1))
        self.b = nn.Parameter(torch.zeros(n_days, features))

    def forward(self, x, days):
        groups = day_groups(days, x.shape[0])
        order = None
        if not all(isinstance(r, slice) for _, r in groups):
            rows, groups = _sorted_groups(groups)
            order = _rows_index(rows, x.device)
        return DayAffineFn.apply(x, self.w, self.b, groups, order)


class Conv1dF32(torch.autograd.Function):
    """``F.conv1d(x, w, b, stride)`` with its forward and its backward under
    :func:`conv_f32`: autograd runs a backward after the forward's block
    has closed, so a plain ``F.conv1d`` inside the block would still take
    its gradients in the caller's precision."""

    @staticmethod
    def forward(ctx, x, w, b, stride: int):
        ctx.save_for_backward(x, w)
        ctx.stride = stride
        with conv_f32():
            return F.conv1d(x, w, b, stride=stride)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        need_x, need_w, need_b, _ = ctx.needs_input_grad
        dx = dw = db = None
        with conv_f32():
            if need_x:
                dx = torch.nn.grad.conv1d_input(x.shape, w, g, ctx.stride)
            if need_w:
                dw = torch.nn.grad.conv1d_weight(x, w.shape, g, ctx.stride)
        if need_b:
            db = g.sum((0, 2))
        return dx, dw, db, None


# the Brain-to-Text '24 baseline's smoothing kernel length (neural_seq_decoder
# model.py: GaussianSmoothing(nInputFeatures, 20, gaussianSmoothWidth))
SMOOTH_TAPS = 20


def gaussian_kernel(sigma: float):
    """The Brain-to-Text '24 baseline's smoothing kernel (neural_seq_decoder
    ``augmentations.py:GaussianSmoothing``, one dimension): float32 k_j
    proportional to exp(-((j - (taps - 1)/2) / sigma)^2 / 2), j = 0 ..
    taps - 1 (``SMOOTH_TAPS``), normalised to sum 1, computed in the
    published order."""
    taps = SMOOTH_TAPS
    j = torch.arange(taps, dtype=torch.float32)
    k = 1 / (sigma * math.sqrt(2 * math.pi)) * torch.exp(
        -(((j - (taps - 1) / 2) / sigma) ** 2) / 2)
    return k / torch.sum(k)


def smooth_time(x, kernel):
    """(B, T, C) frames convolved over time with ``kernel`` (taps,), each
    channel alone, to (B, T, C) contiguous: the published
    ``F.conv1d(groups=C, padding="same")``, which pads an even kernel with
    (taps - 1) // 2 zero frames before and the rest after, in float32 with
    TF32 off (:func:`conv_f32`). The frames it smooths are data: a gradient
    through it would take the caller's precision. A ``smooth`` span (attrs
    ``rows``, ``T``, ``C``; device ms on a card)."""
    B, T, C = x.shape
    w = kernel.to(x.dtype).expand(C, 1, kernel.shape[0]).contiguous()
    with annotate("smooth", device=x.device, rows=B, T=T, C=C), conv_f32():
        y = F.conv1d(x.transpose(1, 2), w, padding="same", groups=C)
        return y.transpose(1, 2).contiguous()


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the last axis of (B, T, C): momentum 0.99,
    eps 1e-5, statistics over (B, T). In training mode it normalises with
    the batch's mean and biased variance, E[x^2] - E[x]^2 clipped at 0
    (flax's ``use_fast_variance``), and moves the running averages
    ``mean <- 0.99 mean + 0.01 batch_mean`` (likewise ``var``, biased); in
    eval mode it normalises with the running averages. The running
    averages are buffers, so they go with ``state_dict`` and checkpoints.
    (``nn.BatchNorm1d`` differs: momentum 0.1 on the new value, unbiased
    running variance, channels on axis 1.)"""

    MOMENTUM = 0.99
    EPS = 1e-5

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x):
        if self.training:
            dims = tuple(range(x.dim() - 1))
            mean = x.mean(dims)
            var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.MOMENTUM
                self.mean.mul_(m).add_((1.0 - m) * mean)
                self.var.mul_(m).add_((1.0 - m) * var)
        else:
            mean, var = self.mean, self.var
        return (x - mean) * (torch.rsqrt(var + self.EPS) * self.scale) \
            + self.bias


class TemporalConv(nn.Module):
    """Conv1d over time + BatchNorm + ReLU + Dropout (the JAX
    ``TemporalConv``, reference models.py:599-636). (B, T, C_in) ->
    (B, T', n_filters) with VALID padding, T' = (T - kernel_size) // stride
    + 1.

    The conv weight is stored as ``F.conv1d`` takes it, (n_filters, C_in,
    kernel_size) (flax keeps (kernel_size, C_in, n_filters);
    ``models.convert`` transposes), initialised as flax's: lecun-normal over
    fan_in C_in * kernel_size, zero bias. The conv and its gradients run
    in full float32 (:class:`Conv1dF32`). Dropout draws its mask from the
    ``generator`` given to ``forward``, in training mode only.
    """

    def __init__(self, in_channels: int, n_filters: int, kernel_size: int,
                 stride: int = 1, dropout: float = 0.3,
                 activation: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.stride = stride
        self.dropout = dropout
        self.activation = activation
        self.weight = nn.Parameter(
            torch.empty(n_filters, in_channels, kernel_size))
        self.bias = nn.Parameter(torch.zeros(n_filters))
        lecun_normal_(self.weight, in_channels * kernel_size, generator)
        self.norm = BatchNorm(n_filters)

    def forward(self, x, generator: torch.Generator | None = None):
        y = Conv1dF32.apply(x.transpose(1, 2), self.weight, self.bias,
                            self.stride)
        # (B, T', F) with the feature axis contiguous, as the GRU kernels
        # read it
        y = self.norm(y.transpose(1, 2).contiguous())
        if self.activation:
            y = torch.relu(y)
        if self.training and self.dropout > 0:
            y = _dropout(y, self.dropout, generator)
        return y


class PositionalEncoding(nn.Module):
    """Sinusoidal positional encoding (reference models.py:799-831): adds
    ``pe[:T]`` to (B, T, d_model). ``pe`` (max_len, d_model) holds sin in
    the even columns and cos in the odd ones; at an odd ``d_model`` the
    cos lane has one fewer column than the sin lane. It is computed once,
    in float32 on the host, as the JAX package computes it at every call,
    and is a buffer left out of the state dict (it has no parameters)."""

    def __init__(self, d_model: int, max_len: int = 5000):
        super().__init__()
        pos = torch.arange(max_len, dtype=torch.float32)[:, None]
        div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32)
                        * (-math.log(10000.0) / d_model))
        pe = torch.zeros(max_len, d_model)
        pe[:, 0::2] = torch.sin(pos * div)
        pe[:, 1::2] = torch.cos(pos * div[: d_model // 2])
        self.register_buffer("pe", pe, persistent=False)

    def forward(self, x):
        return x + self.pe[None, : x.shape[1]].to(x.dtype)


def linear_decay_schedule(lr: float, decay_steps: int,
                          end_factor: float = 0.0):
    """torch LinearLR(start=1.0, end=end_factor, total_iters=decay_steps):
    the learning rate at ``step``."""

    def sched(step):
        frac = min(step / decay_steps, 1.0)
        return lr * (1.0 + (end_factor - 1.0) * frac)

    return sched


def cosine_warmup_schedule(lr: float, warmup: int, max_iters: int):
    """Reference CosineWarmupScheduler (models.py:834-872): the learning
    rate at ``step``, lr * 0.5 (1 + cos(pi step / max_iters))
    * min(1, step / warmup)."""

    def sched(step):
        cos = 0.5 * (1.0 + math.cos(math.pi * step / max_iters))
        warm = min(1.0, step / max(warmup, 1))
        return lr * cos * warm

    return sched
