"""GRU layer forward: hand-written CUDA kernels and their plain versions.

Port of the forward half of ``cross_patient_speech_decoding_tpu/ops/
pallas_gru.py``. Gate math follows the torch convention, gate order
(r, z, n), with separate input and recurrent biases:

    r = sigmoid(x W_r + b_ir + h W_hr + b_hr)
    z = sigmoid(x W_z + b_iz + h W_hz + b_hz)
    n = tanh(x W_n + b_in + r * (h W_hn + b_hn))
    h' = (1 - z) * n + z * h

``gru_layer`` and ``gru_layer_windowed`` pick their implementation from
the device of ``x`` and nothing else: on a CUDA tensor they launch the
kernels of ``csrc/gru_fwd.cu`` (and raise if that fails), on a CPU tensor
they run ``gru_layer_plain`` / ``gru_layer_windowed_plain``. The TPU's
tiling constants (128-lane hidden padding, 256-row batch padding, the
``worthwhile`` size thresholds) have no counterpart here: any B and H go.

The kernels compute the forward only. Each op returns ``hs`` and takes
``(x, h0, wi, bi, wh, bh)`` as they are, which is all a recomputing
backward needs (h_{t-1} is h0 or a row of hs), so an autograd Function can
wrap them unchanged.
"""

from __future__ import annotations

import torch

# Launch counts of the kernel wrappers: one per layer call that launched
# the kernel (each call is one grid launch per time step or window).
LAUNCHES = {"gru_fwd": 0, "gru_wfwd": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def n_windows(T: int, win: int, stride: int) -> int:
    """Window count n_win = (T - win) // stride + 1, with the JAX
    package's errors for a bad geometry (pallas_gru.py:460-469)."""
    if win < 1 or stride < 1:
        raise ValueError(f"win={win} and stride={stride} must be >= 1")
    n_win = (T - win) // stride + 1
    if n_win < 1:
        raise ValueError(
            f"sequence too short for windowing: T={T} < win={win} "
            f"(stride={stride}) yields n_win={n_win}"
        )
    return n_win


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def gru_layer_plain(x, h0, wi, bi, wh, bh, reverse: bool = False):
    """Step loop with ``@`` matmuls in float32. x (T, B, F) float32 or
    bf16 (upcast per step); returns hs (T, B, H) float32."""
    T = x.shape[0]
    H = wh.shape[0]
    h = h0.float()
    hs = torch.empty((T, x.shape[1], H), dtype=torch.float32,
                     device=x.device)
    for s in range(T):
        t = T - 1 - s if reverse else s
        gi = x[t].float() @ wi + bi
        gh = h @ wh + bh
        r = torch.sigmoid(gi[:, :H] + gh[:, :H])
        z = torch.sigmoid(gi[:, H:2 * H] + gh[:, H:2 * H])
        n = torch.tanh(gi[:, 2 * H:] + r * gh[:, 2 * H:])
        h = (1.0 - z) * n + z * h
        hs[t] = h
    return hs


def reformat_time_windows(x, win: int, stride: int):
    """(B, T, C) -> (B, n_win, win*C) sliding windows, flattened time-major
    then channel ([t0 c0..cC, t1 c0..cC, ...], pallas_gru.py:254-260).
    Trailing frames that no window reaches are dropped."""
    B, T, C = x.shape
    n_win = n_windows(T, win, stride)
    xw = x.unfold(1, win, stride)[:, :n_win]  # (B, n_win, C, win)
    return xw.transpose(2, 3).reshape(B, n_win, win * C)


def gru_layer_windowed_plain(x, h0, wi, bi, wh, bh, win: int, stride: int):
    """Materialises the windows of the (T, B, C) frames, then runs
    :func:`gru_layer_plain`."""
    xw = reformat_time_windows(x.transpose(0, 1), win, stride)
    return gru_layer_plain(xw.transpose(0, 1), h0, wi, bi, wh, bh)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_args(x, h0, wi, bi, wh, bh, F: int):
    """Device, dtype, shape and layout checks shared by both kernels."""
    B = x.shape[1]
    H = wh.shape[0]
    params = {"h0": h0, "wi": wi, "bi": bi, "wh": wh, "bh": bh}
    for name, t in params.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 3 or x.stride(2) != 1:
        raise ValueError("x must be 3-D with a contiguous last axis, got "
                         f"shape {tuple(x.shape)} strides {x.stride()}")
    want = {"h0": (B, H), "wi": (F, 3 * H), "bi": (3 * H,),
            "wh": (H, 3 * H), "bh": (3 * H,)}
    for name, shape in want.items():
        if tuple(params[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(params[name].shape)}"
                             f", expected {shape}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, *params.values())):
        raise NotImplementedError(
            "the CUDA GRU kernels compute the forward only; run under "
            "torch.no_grad() (the backward kernels are not ported yet)"
        )


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def gru_fwd_cuda(x, h0, wi, bi, wh, bh, reverse: bool = False):
    """Launch the ``gru_fwd`` kernel (port of ``_fwd_kernel``)."""
    from cross_patient_speech_decoding_tpu_torch.ops import _ext

    T, B, F = x.shape
    H = wh.shape[0]
    _check_args(x, h0, wi, bi, wh, bh, F)
    hs = torch.empty((T, B, H), dtype=torch.float32, device=x.device)
    if T == 0:
        return hs
    name = "gru_fwd_bf16" if x.dtype == torch.bfloat16 else "gru_fwd_f32"
    with torch.cuda.device(x.device):
        err = getattr(_ext.lib(), name)(
            x.data_ptr(), x.stride(0), x.stride(1), h0.data_ptr(),
            wi.data_ptr(), bi.data_ptr(), wh.data_ptr(), bh.data_ptr(),
            hs.data_ptr(), T, B, F, H, int(reverse), _stream(),
        )
    _ext.check(err, name)
    LAUNCHES["gru_fwd"] += 1
    return hs


def gru_wfwd_cuda(x, h0, wi, bi, wh, bh, win: int, stride: int):
    """Launch the ``gru_wfwd`` kernel (port of ``_wfwd_kernel``)."""
    from cross_patient_speech_decoding_tpu_torch.ops import _ext

    T, B, C = x.shape
    H = wh.shape[0]
    n_win = n_windows(T, win, stride)
    _check_args(x, h0, wi, bi, wh, bh, win * C)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"gru_wfwd reads bfloat16 frames, got {x.dtype}")
    if x.stride(0) != C:
        # the kernel reads a window as one run of a batch row's frames
        x = x.transpose(0, 1).contiguous().transpose(0, 1)
    hs = torch.empty((n_win, B, H), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _ext.lib().gru_wfwd_bf16(
            x.data_ptr(), x.stride(1), C, win, stride, h0.data_ptr(),
            wi.data_ptr(), bi.data_ptr(), wh.data_ptr(), bh.data_ptr(),
            hs.data_ptr(), n_win, B, H, _stream(),
        )
    _ext.check(err, "gru_wfwd_bf16")
    LAUNCHES["gru_wfwd"] += 1
    return hs


# ---------------------------------------------------------------------------
# public ops
# ---------------------------------------------------------------------------


def _route(x) -> str:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type


def gru_layer(x, h0, wi, bi, wh, bh, reverse: bool = False):
    """GRU layer over time-major inputs.

    Args:
        x: (T, B, F) float32 or bfloat16, last axis contiguous.
        h0: (B, H) float32 initial state.
        wi: (F, 3H), bi: (3H,), wh: (H, 3H), bh: (3H,) float32.
        reverse: sweep time back to front; hs keeps the original order.

    Returns:
        hs: (T, B, H) float32 (h_last at T-1, or at 0 when ``reverse``).
    """
    if _route(x) == "cuda":
        return gru_fwd_cuda(x, h0, wi, bi, wh, bh, reverse)
    return gru_layer_plain(x, h0, wi, bi, wh, bh, reverse)


def gru_layer_windowed(x, h0, wi, bi, wh, bh, win: int, stride: int):
    """GRU layer over overlapping windows of raw frames.

    Args:
        x: (T, B, C) raw frames, channel axis contiguous. Window w is
            frames [w*stride, w*stride + win), flattened time-major then
            channel. On a CUDA tensor the frames must be bfloat16 and are
            read batch-major: a (T, B, C) view of a (B, T, C) tensor goes
            in as it is, other layouts are copied to it first. On the CPU,
            float32 or bfloat16.
        wi: (win*C, 3H); the other arguments as in :func:`gru_layer`.

    Returns:
        hs: (n_win, B, H) float32, n_win = (T - win)//stride + 1. Frames
        after the last window are never read.
    """
    n_windows(x.shape[0], win, stride)
    if _route(x) == "cuda":
        return gru_wfwd_cuda(x, h0, wi, bi, wh, bh, win, stride)
    return gru_layer_windowed_plain(x, h0, wi, bi, wh, bh, win, stride)
