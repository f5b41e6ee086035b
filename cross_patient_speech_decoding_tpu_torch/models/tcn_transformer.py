"""TCN and transformer classifier families.

Port of ``cross_patient_speech_decoding_tpu/models/tcn_transformer.py``,
the reference's ``nn_models/models.py:393-596``:

- ``TCNClassifier``: TemporalConv -> max over time -> dense head;
- ``TransformerClassifier``: dense projection to d_model -> sinusoidal
  positions -> pre-LN encoder blocks -> mean over time -> dense head;
- ``CNNTransformer``: TemporalConv -> positions -> encoder blocks -> mean
  over time -> dense head.

Where flax's defaults are not PyTorch's, the port takes flax's: LayerNorm
with epsilon 1e-6 and E[x^2] - E[x]^2 as its variance, GELU's tanh
approximation, lecun-normal kernels with zero biases, and attention
dropout with one mask over (query, key) shared by every batch row and head
(``broadcast_dropout``). The attention is plain tensor products, as the
JAX package's is plain XLA: per-head query, key and value projections,
scores of the query scaled by 1/sqrt(head_dim), softmax, dropout on the
weights, the weighted values, the output projection. Parameters keep
flax's layouts (a projection's ``kernel`` (D, heads, head_dim), the
output's (heads, head_dim, D)); ``models.convert`` carries flax's
weights over. Weights are drawn from ``seed`` with a CPU
``torch.Generator`` (flax's initialisers, not flax's numbers), then moved
to ``device`` (default: the first CUDA card); dropout masks come from the
``generator`` given to ``forward``, in training mode only.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from cross_patient_speech_decoding_tpu_torch.models.layers import (
    Dense,
    PositionalEncoding,
    TemporalConv,
    _dropout,
    lecun_normal_,
)
from cross_patient_speech_decoding_tpu_torch.utils.device import (
    resolve_device,
)

__all__ = ["CNNTransformer", "EncoderBlock", "LayerNorm",
           "MultiHeadAttention", "TCNClassifier", "TransformerClassifier"]


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis: epsilon 1e-6 (torch's is
    1e-5), variance E[x^2] - E[x]^2 clipped at 0 (``use_fast_variance``),
    ``scale`` 1 and ``bias`` 0 at init."""

    EPS = 1e-6

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean,
                          min=0.0)
        return (x - mean) * (torch.rsqrt(var + self.EPS) * self.scale) \
            + self.bias


class DenseGeneral(nn.Module):
    """flax ``nn.DenseGeneral``: contracts the last ``len(in_shape)`` axes
    of x with ``kernel`` (*in_shape, *out_shape) and adds ``bias``
    (*out_shape); the kernel starts lecun-normal over the flattened fan-in,
    the bias at 0."""

    def __init__(self, in_shape: tuple, out_shape: tuple,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.in_shape, self.out_shape = tuple(in_shape), tuple(out_shape)
        self.kernel = nn.Parameter(torch.empty(self.in_shape
                                               + self.out_shape))
        self.bias = nn.Parameter(torch.zeros(self.out_shape))
        lecun_normal_(self.kernel, math.prod(self.in_shape), generator)

    def forward(self, x):
        lead = x.shape[: x.dim() - len(self.in_shape)]
        n_in, n_out = math.prod(self.in_shape), math.prod(self.out_shape)
        y = x.reshape(lead + (n_in,)) @ self.kernel.reshape(n_in, n_out)
        return (y + self.bias.reshape(n_out)).reshape(lead + self.out_shape)


def _broadcast_dropout(w, rate: float, generator):
    """flax's attention dropout with ``broadcast_dropout``: one keep mask
    over the last two axes (query, key), shared by the batch and the heads;
    kept weights are multiplied by 1/(1 - rate)."""
    keep = 1.0 - rate
    mask = torch.rand(w.shape[-2:], generator=generator,
                      device=w.device) < keep
    return w * (mask.to(w.dtype) / keep)


class MultiHeadAttention(nn.Module):
    """Self-attention of flax ``nn.MultiHeadDotProductAttention`` (qkv and
    output features = the input's): (B, T, D) -> (B, T, D)."""

    def __init__(self, features: int, n_heads: int, dropout: float = 0.0,
                 generator: torch.Generator | None = None):
        super().__init__()
        if features % n_heads:
            raise ValueError(f"features {features} must be divisible by "
                             f"n_heads {n_heads}")
        self.n_heads, self.head_dim = n_heads, features // n_heads
        self.dropout = dropout
        heads = (n_heads, self.head_dim)
        self.query = DenseGeneral((features,), heads, generator)
        self.key = DenseGeneral((features,), heads, generator)
        self.value = DenseGeneral((features,), heads, generator)
        self.out = DenseGeneral(heads, (features,), generator)

    def forward(self, x, generator: torch.Generator | None = None):
        # (B, T, h, d) -> (B, h, T, d)
        q, k, v = (p(x).transpose(1, 2)
                   for p in (self.query, self.key, self.value))
        q = q / math.sqrt(self.head_dim)
        w = torch.softmax(q @ k.transpose(-2, -1), dim=-1)  # (B, h, T, T)
        if self.training and self.dropout > 0:
            w = _broadcast_dropout(w, self.dropout, generator)
        return self.out((w @ v).transpose(1, 2))


class EncoderBlock(nn.Module):
    """Pre-LN transformer encoder block (``nn.TransformerEncoderLayer``
    analog): x + drop(attn(LN(x))), then + drop(W2 drop(gelu(W1 LN(x))))."""

    def __init__(self, d_model: int, n_heads: int, dim_ff: int,
                 dropout: float = 0.1,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dropout = dropout
        self.norm1 = LayerNorm(d_model)
        self.attn = MultiHeadAttention(d_model, n_heads, dropout, generator)
        self.norm2 = LayerNorm(d_model)
        self.ff1 = Dense(d_model, dim_ff, generator)
        self.ff2 = Dense(dim_ff, d_model, generator)

    def _drop(self, x, generator):
        if self.training and self.dropout > 0:
            return _dropout(x, self.dropout, generator)
        return x

    def forward(self, x, generator: torch.Generator | None = None):
        h = self.attn(self.norm1(x), generator)
        x = x + self._drop(h, generator)
        h = F.gelu(self.ff1(self.norm2(x)), approximate="tanh")
        h = self.ff2(self._drop(h, generator))
        return x + self._drop(h, generator)


class TCNClassifier(nn.Module):
    """TemporalConv -> max over time -> ReLU dense layers (``fc_dims``,
    each followed by dropout) -> dense head. (B, T, C) -> (B,
    num_classes)."""

    def __init__(self, in_channels: int, n_filters: int, num_classes: int,
                 kernel_size: int = 10, stride: int = 1,
                 dropout: float = 0.3, fc_dims: tuple = (), seed: int = 0,
                 device=None):
        super().__init__()
        dev = resolve_device(device)
        self.num_classes = num_classes
        self.dropout = dropout
        gen = torch.Generator().manual_seed(seed)
        self.conv = TemporalConv(in_channels, n_filters, kernel_size, stride,
                                 dropout=dropout, generator=gen)
        dims = (n_filters, *fc_dims)
        self.fc = nn.ModuleList(Dense(a, b, gen)
                                for a, b in zip(dims[:-1], dims[1:]))
        self.head = Dense(dims[-1], num_classes, gen)
        self.to(dev)

    def forward(self, x, generator: torch.Generator | None = None):
        # amax spreads the gradient evenly over tied maxima, as jnp.max
        h = self.conv(x, generator).amax(dim=1)
        for fc in self.fc:
            h = torch.relu(fc(h))
            if self.training and self.dropout > 0:
                h = _dropout(h, self.dropout, generator)
        return self.head(h)


class TransformerClassifier(nn.Module):
    """Dense projection of the F input features to ``d_model`` ->
    positions -> ``n_layers`` encoder blocks -> mean over time -> dense
    head. (B, T, F) -> (B, num_classes)."""

    def __init__(self, in_features: int, d_model: int, num_classes: int,
                 n_heads: int = 4, n_layers: int = 2, dim_ff: int = 256,
                 dropout: float = 0.1, seed: int = 0, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.num_classes = num_classes
        gen = torch.Generator().manual_seed(seed)
        self.proj = Dense(in_features, d_model, gen)
        self.pos = PositionalEncoding(d_model)
        self.blocks = nn.ModuleList(
            EncoderBlock(d_model, n_heads, dim_ff, dropout, gen)
            for _ in range(n_layers))
        self.head = Dense(d_model, num_classes, gen)
        self.to(dev)

    def forward(self, x, generator: torch.Generator | None = None):
        x = self.pos(self.proj(x))
        for block in self.blocks:
            x = block(x, generator)
        return self.head(x.mean(dim=1))


class CNNTransformer(nn.Module):
    """TemporalConv (``cnn_dropout``) -> positions -> ``n_layers`` encoder
    blocks of width ``n_filters`` (``dropout``) -> mean over time -> dense
    head. (B, T, C) -> (B, num_classes)."""

    def __init__(self, in_channels: int, n_filters: int, num_classes: int,
                 kernel_size: int = 10, stride: int = 1, n_heads: int = 4,
                 n_layers: int = 2, dim_ff: int = 256,
                 cnn_dropout: float = 0.3, dropout: float = 0.1,
                 seed: int = 0, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.num_classes = num_classes
        gen = torch.Generator().manual_seed(seed)
        self.conv = TemporalConv(in_channels, n_filters, kernel_size, stride,
                                 dropout=cnn_dropout, generator=gen)
        self.pos = PositionalEncoding(n_filters)
        self.blocks = nn.ModuleList(
            EncoderBlock(n_filters, n_heads, dim_ff, dropout, gen)
            for _ in range(n_layers))
        self.head = Dense(n_filters, num_classes, gen)
        self.to(dev)

    def forward(self, x, generator: torch.Generator | None = None):
        x = self.pos(self.conv(x, generator))
        for block in self.blocks:
            x = block(x, generator)
        return self.head(x.mean(dim=1))
