"""Weights and seeds made by the benchmark.

All weights come from one draw on the device from the seed, in their
served type (float32), cut into leaves: a leaf is ``offset + scale * u``
with u uniform in [-1, 1). The reference names the leaves and gives each
its shape, scale and offset; the same tensors go to the port and, copied,
to the reference.
"""

from __future__ import annotations

import hashlib
import math


def sub_seed(seed: int, tag: str) -> int:
    """A seed for one use (``tag``) of the run's seed, in [0, 2**62)."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 2


def draw(leaves: dict, seed: int, device) -> dict:
    """``leaves``: name -> (shape, scale, offset). Returns name -> float32
    tensor on ``device``."""
    import torch

    sizes = [math.prod(shape) for shape, _, _ in leaves.values()]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed,
                                                              "weights"))
    flat = torch.rand(sum(sizes), generator=gen, device=device)
    flat.mul_(2.0).sub_(1.0)
    out = {}
    pos = 0
    for (name, (shape, scale, offset)), n in zip(leaves.items(), sizes):
        out[name] = (flat[pos:pos + n].view(shape) * scale
                     + offset).contiguous()
        pos += n
    return out


def load_into(model, weights: dict) -> None:
    """Copy ``weights`` into the model's parameters, which must carry
    exactly those names and shapes."""
    import torch

    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise ValueError(
            f"parameters {sorted(set(params) ^ set(weights))} differ between "
            "the port's model and the reference's leaves")
    with torch.no_grad():
        for name, p in params.items():
            if tuple(p.shape) != tuple(weights[name].shape):
                raise ValueError(f"{name}: port {tuple(p.shape)}, reference "
                                 f"{tuple(weights[name].shape)}")
            p.copy_(weights[name])
