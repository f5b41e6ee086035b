"""Full float32 products for the alignment core.

Port of ``cross_patient_speech_decoding_tpu/ops/precision.py``. The JAX
package runs every alignment matmul at ``Precision.HIGHEST``, because a
masked pinv at reduced precision loses about 2e-2 against 1e-5. On the
card the counterpart of a reduced precision is TF32, which cuBLAS uses for
float32 products when ``torch.backends.cuda.matmul.allow_tf32`` is set or
the float32 matmul precision is below "highest". :func:`true_f32` switches
both off for a block and gives the caller's settings back after it, so the
alignment core computes in float32 whatever the caller chose.
:func:`conv_f32` does the same for cuDNN's convolutions (the temporal conv,
the FIR filter).
"""

from __future__ import annotations

import contextlib

import torch


def _matmul_settings():
    """(legacy float32 matmul precision or None, cuBLAS fp32_precision).

    PyTorch keeps two views of one setting: the legacy one
    (``allow_tf32``, ``set_float32_matmul_precision``) and
    ``torch.backends.cuda.matmul.fp32_precision``. A caller that set only
    the second makes the legacy getter raise; then it reads None."""
    try:
        legacy = torch.get_float32_matmul_precision()
    except RuntimeError:
        legacy = None
    return legacy, torch.backends.cuda.matmul.fp32_precision


@contextlib.contextmanager
def true_f32():
    """cuBLAS without TF32 inside the block (products, triangular solves);
    the caller's settings are restored on exit. Both views of the setting
    are set together, so they agree inside the block."""
    legacy, new = _matmul_settings()
    if legacy == "highest" and new in ("ieee", "none"):
        yield
        return
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        if legacy is not None:
            torch.set_float32_matmul_precision(legacy)
        torch.backends.cuda.matmul.fp32_precision = new


@contextlib.contextmanager
def conv_f32():
    """cuDNN convolutions in full float32 inside the block, whatever the
    caller set: PyTorch lets cuDNN run float32 convolutions in TF32 by
    default (about three decimal digits), where the JAX package's conv is
    float32. Only the convolution's own setting
    (``torch.backends.cudnn.conv.fp32_precision``) is touched, and it is
    restored on exit; setting it never makes the legacy getters raise."""
    conv = torch.backends.cudnn.conv
    before = conv.fp32_precision
    conv.fp32_precision = "ieee"
    try:
        yield
    finally:
        conv.fp32_precision = before


def hdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full-precision matmul (float32 products and sums, no TF32)."""
    with true_f32():
        return torch.matmul(a, b)


def hpinv(M: torch.Tensor, rtol: float | None = None) -> torch.Tensor:
    """Moore-Penrose pseudoinverse with a full-precision reconstruction.
    Exact for zero-masked trailing columns: pinv([A, 0]) == [pinv(A); 0]."""
    u, s, vt = torch.linalg.svd(M, full_matrices=False)
    eps = torch.finfo(M.dtype).eps
    if rtol is None:
        rtol = max(M.shape[-2], M.shape[-1]) * eps
    cutoff = rtol * s.amax(dim=-1, keepdim=True)
    keep = s > cutoff
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, 1.0), 0.0)
    return hdot(vt.mT * s_inv[..., None, :], u.mT)
