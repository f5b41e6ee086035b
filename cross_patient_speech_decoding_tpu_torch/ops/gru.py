"""GRU layers: hand-written CUDA kernels, their plain versions, autograd.

Port of ``cross_patient_speech_decoding_tpu/ops/pallas_gru.py`` (the
unidirectional and the fused bidirectional forward, the backward). Gate
math follows the torch
convention, gate order (r, z, n), with separate input and recurrent
biases:

    r = sigmoid(x W_r + b_ir + h W_hr + b_hr)
    z = sigmoid(x W_z + b_iz + h W_hz + b_hz)
    n = tanh(x W_n + b_in + r * (h W_hn + b_hn))
    h' = (1 - z) * n + z * h

``gru_layer``, ``gru_layer_windowed`` and ``gru_layer_bidir`` are
differentiable and pick their implementation from the device of ``x`` and
nothing else: on a CUDA tensor the forward and the backward launch the
kernels of ``csrc/gru_fwd.cu`` and ``csrc/gru_bwd.cu`` (and raise if that
fails), on a CPU tensor they run the plain versions. The TPU's tiling
constants (128-lane hidden padding, 256-row batch padding, the
``worthwhile`` size thresholds) have no counterpart here: any B and H go.
Nor does the JAX package's ``BIDIR_FUSED`` switch, which keeps the fused
bidirectional kernel off for reasons of the TPU's VMEM: the port's
bidirectional layer always takes it.

The backward mirrors the JAX custom VJPs (``_gru_bwd_rule``,
``_gru_win_bwd_rule``, ``_gru_bidir_bwd_rule``): the forward keeps
``(x, h0, weights, hs)``, and the backward recomputes the gates from x_t
and h_{t-1} (h0 or a row of hs); the bidirectional layer's backward is the
unidirectional one per direction, with dx summed. The windowed op gives
its frames a gradient where they require one (the output of a trainable
layer below it, as the day layers of ``models/b2t_gru.py``): the windows'
gradient dgi Wi^T, folded back onto the frames; frames that require none
are data. The bidirectional windowed layer is the windowed op once
forward and once reversed, autograd adding the two folds.
"""

from __future__ import annotations

import ctypes

import torch

from cross_patient_speech_decoding_tpu_torch.utils.profiling import annotate

# Launch counts of the kernel wrappers: one per layer call that launched
# the kernel. On the device a gru_fwd or gru_wfwd call is 1 + T grids (the
# input projection, then one a step), a gru_bifwd call 2 + 2T (the same,
# forward, then reversed).
LAUNCHES = {"gru_fwd": 0, "gru_wfwd": 0, "gru_bifwd": 0, "gru_bwd": 0,
            "gru_wbwd": 0}
# The kernels of the products whose B is a weight (x Wi, the backward's
# gate recompute, dx; csrc/gru_mma.cuh): wgmma where a call has enough
# T B rows (GRU_WGMMA_MIN_ROWS), mma.sync below. The libraries count the
# products by route.
ROUTES = ("wgmma", "mma_sync")
# The sweeps' step kernels split a step's K over a cluster of S CTAs where
# the step's grid is small (csrc/gru_mma.cuh: step_split; K = H in the
# forward, 3H in the backward); each library counts its step launches by
# S.
STEP_SPLITS = (1, 2, 4, 8)
BWD_STEP_SPLITS = (1, 2, 4, 8, 16)
# the kernel calls whose sweep launches the backward's step kernel
_BWD_CALLS = ("gru_bwd", "gru_wbwd")


def _lib_counts(reset: bool = False):
    """The libraries' counters: the weight products by route (``ROUTES``,
    both libraries' summed), the forward step launches by cluster size
    (``STEP_SPLITS``) and the backward's (``BWD_STEP_SPLITS``); all 0
    before the kernels are first loaded."""
    from cross_patient_speech_decoding_tpu_torch.ops import _ext

    fwd = (ctypes.c_longlong * (len(ROUTES) + len(STEP_SPLITS)))()
    bwd = (ctypes.c_longlong * (len(ROUTES) + len(BWD_STEP_SPLITS)))()
    if _ext.loaded():
        lib = _ext.lib()
        _ext.check(lib.gru_fwd_counts(fwd, int(reset)), "gru_fwd_counts")
        _ext.check(lib.gru_bwd_counts(bwd, int(reset)), "gru_bwd_counts")
    routes = [a + b for a, b in zip(fwd, bwd)]
    return routes, list(fwd[len(ROUTES):]), list(bwd[len(ROUTES):])


def product_counts() -> dict:
    """The weight products launched since the last
    :func:`reset_launch_counts`, by route (``ROUTES``); all 0 before the
    kernels are first loaded."""
    return dict(zip(ROUTES, _lib_counts()[0]))


def step_counts() -> dict:
    """The forward step kernel's launches since the last
    :func:`reset_launch_counts`, by the cluster size S that split each
    step's K (``STEP_SPLITS``); all 0 before the kernels are first
    loaded."""
    return dict(zip(STEP_SPLITS, _lib_counts()[1]))


def bwd_step_counts() -> dict:
    """The backward sweep's step launches (one a step of every
    ``gru_bwd``/``gru_wbwd`` call) since the last
    :func:`reset_launch_counts`, by the cluster size S that split each
    step's K (``BWD_STEP_SPLITS``); all 0 before the kernels are first
    loaded."""
    return dict(zip(BWD_STEP_SPLITS, _lib_counts()[2]))


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    _lib_counts(reset=True)


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


def gru_layer_bidir_plain(x, h0_f, h0_b, wi_f, bi_f, wh_f, bh_f, wi_b, bi_b,
                          wh_b, bh_b):
    """Both directions of a bidirectional layer as two
    :func:`gru_layer_plain` sweeps, the second reversed; returns (hs_f,
    hs_b), each (T, B, H) float32 in the original time order."""
    return (gru_layer_plain(x, h0_f, wi_f, bi_f, wh_f, bh_f),
            gru_layer_plain(x, h0_b, wi_b, bi_b, wh_b, bh_b, reverse=True))


def reformat_time_windows(x, win: int, stride: int):
    """(B, T, C) -> (B, n_win, win*C) sliding windows, flattened time-major
    then channel ([t0 c0..cC, t1 c0..cC, ...], pallas_gru.py:254-260).
    Trailing frames that no window reaches are dropped."""
    B, T, C = x.shape
    n_win = n_windows(T, win, stride)
    xw = x.unfold(1, win, stride)[:, :n_win]  # (B, n_win, C, win)
    return xw.transpose(2, 3).reshape(B, n_win, win * C)


def gru_layer_windowed_plain(x, h0, wi, bi, wh, bh, win: int, stride: int,
                             reverse: bool = False):
    """Materialises the windows of the (T, B, C) frames, then runs
    :func:`gru_layer_plain` (with ``reverse``, over the windows from the
    last)."""
    xw = reformat_time_windows(x.transpose(0, 1), win, stride)
    return gru_layer_plain(xw.transpose(0, 1), h0, wi, bi, wh, bh, reverse)


def gru_backward_plain(x, hprev, dhs, wi, bi, wh, bh, reverse: bool = False,
                       need_dx: bool = True):
    """Backward of :func:`gru_layer_plain`, step by step in float32 with the
    gates recomputed (the math of ``_bwd_kernel``, pallas_gru.py:602-633).

    Args:
        x: (T, B, F) the forward's input; hprev: (T, B, H) the state each
            forward step read (h0 at the first step of the forward's sweep);
            dhs: (T, B, H) the gradient of hs.

    Returns:
        (dx (T, B, F) float32 or None when not ``need_dx``, dh0 (B, H),
        dwi (F, 3H), dwh (H, 3H), dbi (3H,), dbh (3H,)).
    """
    T, B, F = x.shape
    H = wh.shape[0]
    f32 = dict(dtype=torch.float32, device=x.device)
    dh = torch.zeros((B, H), **f32)
    dwi = torch.zeros((F, 3 * H), **f32)
    dwh = torch.zeros((H, 3 * H), **f32)
    dbi = torch.zeros(3 * H, **f32)
    dbh = torch.zeros(3 * H, **f32)
    dx = torch.empty((T, B, F), **f32) if need_dx else None
    for s in range(T):
        t = s if reverse else T - 1 - s  # the forward's sweep, backward
        xt = x[t].float()
        hp = hprev[t]
        gi = xt @ wi + bi
        gh = hp @ wh + bh
        ghn = gh[:, 2 * H:]
        r = torch.sigmoid(gi[:, :H] + gh[:, :H])
        z = torch.sigmoid(gi[:, H:2 * H] + gh[:, H:2 * H])
        n = torch.tanh(gi[:, 2 * H:] + r * ghn)
        d = dh + dhs[t]
        dz = d * (hp - n) * z * (1.0 - z)
        dn = d * (1.0 - z) * (1.0 - n * n)
        dr = dn * ghn * r * (1.0 - r)
        dgi = torch.cat([dr, dz, dn], dim=1)  # d(x Wi + bi)
        dgh = torch.cat([dr, dz, dn * r], dim=1)  # d(h Wh + bh)
        if need_dx:
            dx[t] = dgi @ wi.t()
        dh = d * z + dgh @ wh.t()
        dwi += xt.t() @ dgi
        dwh += hp.t() @ dgh
        dbi += dgi.sum(0)
        dbh += dgh.sum(0)
    return dx, dh, dwi, dwh, dbi, dbh


def fold_windows(dxw, T: int, win: int, stride: int):
    """(n_win, B, win*C) gradients of the windows -> (T, B, C) float32
    gradients of the frames: frame t sums row block t - k*stride of every
    window k that holds it, in the order k = 0, 1, ... (the kernel's
    order); frames that no window reaches get 0."""
    n_win, B, F = dxw.shape
    C = F // win
    dx = torch.zeros((T, B, C), dtype=torch.float32, device=dxw.device)
    rows = dxw.float().view(n_win, B, win, C)
    for k in range(n_win):
        dx[k * stride:k * stride + win] += rows[k].transpose(0, 1)
    return dx


def gru_win_backward_plain(x, hprev, dhs, wi, bi, wh, bh, win: int,
                           stride: int, need_dx: bool = False,
                           reverse: bool = False):
    """Backward of :func:`gru_layer_windowed_plain` (the math of
    ``_wbwd_kernel``; with ``reverse``, of the sweep from the last window):
    materialises the windows of the (T, B, C) frames, then runs
    :func:`gru_backward_plain`. Returns the same tuple, its first entry the
    frames' gradient (T, B, C) float32 when ``need_dx`` (the windows' dx
    folded by :func:`fold_windows`), else None."""
    xw = reformat_time_windows(x.transpose(0, 1), win, stride)
    dxw, *grads = gru_backward_plain(xw.transpose(0, 1), hprev, dhs, wi, bi,
                                     wh, bh, reverse, need_dx=need_dx)
    dx = fold_windows(dxw, x.shape[0], win, stride) if need_dx else None
    return (dx, *grads)


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


def _check_streams(x, n_steps: int, H: int, **streams):
    """The (n_steps, B, H) float32 contiguous streams of the backward."""
    want = (n_steps, x.shape[1], H)
    for name, t in streams.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != want:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{want}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _call(export: str, device, *args) -> None:
    """Run the library's ``export`` with ``args`` on the current stream of
    ``device``; raise on the CUDA error it reports."""
    from cross_patient_speech_decoding_tpu_torch.ops import _ext

    with torch.cuda.device(device):
        err = getattr(_ext.lib(), export)(*args, _stream())
    _ext.check(err, export)


def _sizes(query: str, *args, n: int = 1) -> list:
    """The ``n`` scratch sizes, in floats, that the library's ``query``
    gives for a call's shape ``args``: the library decides the splits and
    the routes that fill them."""
    from cross_patient_speech_decoding_tpu_torch.ops import _ext

    out = [ctypes.c_longlong() for _ in range(n)]
    _ext.check(getattr(_ext.lib(), query)(*args, *map(ctypes.byref, out)),
               query)
    return [v.value for v in out]


def _wimg(n: int, device):
    """The scratch of ``n`` floats in which a call writes the TF32 images
    of its weights (csrc/gru_mma.cuh: a few MB); None where the call's T B
    rows take mma.sync, which reads the weights as they are (n = 0)."""
    return torch.empty(n, dtype=torch.float32, device=device) if n else None


def _x_args(x) -> tuple:
    """How a launch names its input: the pointer, the strides of the time
    and batch axes, and whether it is bf16 (else float32)."""
    return (x.data_ptr(), x.stride(0), x.stride(1),
            int(x.dtype == torch.bfloat16))


def _forward(key: str, export: str, x, weights, *tail) -> list:
    """The launch body of the forward kernels, counted under
    ``LAUNCHES[key]``: ``weights`` holds one (h0, wi, bi, wh, bh) a
    direction, swept in that order; ``tail`` the export's arguments after
    the shape. Returns each direction's hs (T, B, H) float32.

    Before its sweep each direction writes the input projection x Wi + bi
    of every row into the gi scratch (T, B, 3H) float32 (1.8 GB at fig_5
    width), which the next direction reuses; freed when the call returns.
    """
    T, B, F = x.shape
    H = weights[0][3].shape[0]
    for w in weights:
        _check_args(x, *w, F)
        if w[3].shape[0] != H:
            raise ValueError(f"the directions' hidden sizes differ: {H} and "
                             f"{w[3].shape[0]}")
    f32 = dict(dtype=torch.float32, device=x.device)
    hs = [torch.empty((T, B, H), **f32) for _ in weights]
    if T == 0 or B == 0:
        return hs
    gi = torch.empty((T, B, 3 * H), **f32)
    wimg = _wimg(*_sizes("gru_fwd_wimg", T * B, F, H), x.device)
    _call(export, x.device, *_x_args(x),
          *map(_ptr, (*(t for w in weights for t in w), *hs, gi, wimg)),
          T, B, F, H, *tail)
    LAUNCHES[key] += 1
    return hs


def _backward(key: str, x, hprev, dhs, wi, bi, wh, bh, reverse: bool,
              need_dx: bool) -> tuple:
    """The launch body of the backward kernels (see run_backward,
    gru_bwd.cu), counted under ``LAUNCHES[key]``. Arguments and result as
    :func:`gru_backward_plain`. The gate-gradient stream g (T, B, 4H) is
    the large scratch (2.4 GB at fig_5 width), freed when the call
    returns; the bias gradients are the last rows of the weight
    gradients' buffers."""
    T, B, F = x.shape
    H = wh.shape[0]
    if T == 0:
        raise ValueError(f"{key} needs at least one time step")
    _check_args(x, hprev[0], wi, bi, wh, bh, F)
    _check_streams(x, T, H, hprev=hprev, dhs=dhs)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty((T, B, F), **f32) if need_dx else None
    n_part, n_wimg = _sizes("gru_bwd_sizes", T, B, F, H, int(need_dx), n=2)
    g = torch.empty((T, B, 4 * H), **f32)
    dhz = torch.empty((B, H), **f32)
    dh0 = torch.empty((B, H), **f32)
    part = torch.empty(n_part, **f32)
    dwi = torch.empty((F + 1, 3 * H), **f32)
    dwh = torch.empty((H + 1, 3 * H), **f32)
    wimg = _wimg(n_wimg, x.device)
    _call("gru_bwd", x.device, *_x_args(x),
          *map(_ptr, (hprev, dhs, wi, bi, wh, bh, g, dhz, dh0, dx, part, dwi,
                      dwh, wimg)),
          T, B, F, H, int(reverse))
    LAUNCHES[key] += 1
    return dx, dh0, dwi[:F], dwh[:H], dwi[F], dwh[H]


def gru_fwd_cuda(x, h0, wi, bi, wh, bh, reverse: bool = False):
    """Launch the ``gru_fwd`` kernel (port of ``_fwd_kernel``)."""
    (hs,) = _forward("gru_fwd", "gru_fwd", x, [(h0, wi, bi, wh, bh)],
                     int(reverse))
    return hs


def gru_bifwd_cuda(x, h0_f, h0_b, wi_f, bi_f, wh_f, bh_f, wi_b, bi_b, wh_b,
                   bh_b):
    """Launch the ``gru_bifwd`` kernels (port of ``_bifwd_kernel``): the
    forward direction's projection and sweep, then the reversed one's, on
    one gi scratch. Arguments and result as :func:`gru_layer_bidir_plain`."""
    return tuple(_forward("gru_bifwd", "gru_bifwd", x,
                          [(h0_f, wi_f, bi_f, wh_f, bh_f),
                           (h0_b, wi_b, bi_b, wh_b, bh_b)]))


def _batch_major(x):
    """(T, B, C) frames as a view of batch-major (B, T, C) memory: the
    windowed kernels read a window as one run of a batch row's frames.
    Other layouts are copied."""
    if x.stride(0) != x.shape[2] or x.stride(2) != 1:
        x = x.transpose(0, 1).contiguous().transpose(0, 1)
    return x


def _windows(x, win: int, stride: int):
    """The (n_win, B, win*C) windows of the (T, B, C) view of batch-major
    frames that :func:`_batch_major` gives, as an overlapping view: window
    w of row b, flattened time-major then channel (pallas_gru.py:254-260),
    is the run of win*C values that starts at frame w*stride. Trailing
    frames that no window reaches are not in it."""
    n_win = n_windows(x.shape[0], win, stride)
    C = x.shape[2]
    return x.as_strided((n_win, x.shape[1], win * C),
                        (stride * C, x.stride(1), 1), x.storage_offset())


def _check_frames(x, name: str):
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name} reads bfloat16 frames, got {x.dtype}")


def gru_wfwd_cuda(x, h0, wi, bi, wh, bh, win: int, stride: int,
                  reverse: bool = False):
    """Launch the ``gru_fwd`` kernel over the windows of bf16 frames (port
    of ``_wfwd_kernel``). Arguments and result as
    :func:`gru_layer_windowed_plain`."""
    _check_frames(x, "gru_wfwd")
    (hs,) = _forward("gru_wfwd", "gru_fwd",
                     _windows(_batch_major(x), win, stride),
                     [(h0, wi, bi, wh, bh)], int(reverse))
    return hs


def gru_bwd_cuda(x, hprev, dhs, wi, bi, wh, bh, reverse: bool = False,
                 need_dx: bool = True):
    """Launch the ``gru_bwd`` kernels (port of ``_bwd_kernel``). Arguments
    and result as :func:`gru_backward_plain`."""
    return _backward("gru_bwd", x, hprev, dhs, wi, bi, wh, bh, reverse,
                     need_dx)


def gru_wbwd_cuda(x, hprev, dhs, wi, bi, wh, bh, win: int, stride: int,
                  need_dx: bool = False, reverse: bool = False):
    """Launch the ``gru_bwd`` kernels over the windows of bf16 frames (port
    of ``_wbwd_kernel``), then, with ``need_dx``, fold the windows'
    gradient onto the frames (``gru_fold_windows``: each frame's windows
    summed in a fixed order). Arguments and result as
    :func:`gru_win_backward_plain`; the frames' gradient is a (T, B, C)
    view of batch-major (B, T, C) float32 memory, the frames' own
    layout."""
    _check_frames(x, "gru_wbwd")
    T, B, C = x.shape
    xw = _windows(_batch_major(x), win, stride)
    dxw, *grads = _backward("gru_wbwd", xw, hprev, dhs, wi, bi, wh, bh,
                            reverse, need_dx)
    if dxw is None:
        return (None, *grads)
    dx = torch.empty((B, T, C), dtype=torch.float32, device=x.device)
    _call("gru_fold_windows", x.device, dxw.data_ptr(), dx.data_ptr(), T, B,
          C, win, stride, xw.shape[0])
    return (dx.transpose(0, 1), *grads)


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


class _KernelSpan:
    """A kernel call's span that, where it records, adds the call's weight
    products by route (:func:`product_counts`) to its attributes, and
    ``step_split``: the cluster size S of its sweep's step launches
    (:func:`step_counts` for a forward call, :func:`bwd_step_counts` for a
    backward one; 0 where it launched none)."""

    __slots__ = ("span", "backward", "rec", "before", "steps_before")

    def __init__(self, span, backward: bool):
        self.span = span
        self.backward = backward

    def _steps(self) -> dict:
        return bwd_step_counts() if self.backward else step_counts()

    def __enter__(self):
        self.rec = self.span.__enter__()
        if self.rec is not None:
            self.before = product_counts()
            self.steps_before = self._steps()
        return self.rec

    def __exit__(self, *exc):
        if self.rec is not None:
            after = product_counts()
            self.rec.attrs.update(
                {k: after[k] - self.before[k] for k in ROUTES})
            grew = [s for s, n in self._steps().items()
                    if n > self.steps_before[s]]
            self.rec.attrs["step_split"] = max(grew, default=0)
        return self.span.__exit__(*exc)


def _kernel_span(name: str, x, T: int, F: int, H: int, need_dx: bool,
                 plain: bool, directions: int = 1, **attrs):
    """The span of one kernel call (or its plain version), named by its
    ``LAUNCHES`` key: the recurrence's T steps of B rows, F input features
    and H units, the bytes of the input it reads, whether it forms dx, and
    its route; on a CUDA tensor it times the call's device work, counts
    its weight products by kernel (``wgmma``, ``mma_sync``) and gives its
    sweep's step kernel's cluster size (``step_split``)."""
    span = annotate(name, device=x.device, T=T, B=x.shape[1], F=F, H=H,
                    x_bytes=x.numel() * x.element_size(),
                    need_dx=bool(need_dx), directions=directions,
                    route="plain" if plain else "cuda", **attrs)
    return span if plain else _KernelSpan(span, name in _BWD_CALLS)


class GRULayerFn(torch.autograd.Function):
    """``hs = gru_layer(x, h0, wi, bi, wh, bh, reverse)`` with its backward
    (``_gru_core``, pallas_gru.py:766-800). ``plain`` picks the plain
    versions over the kernels; :func:`gru_layer` sets it from the device."""

    @staticmethod
    def forward(ctx, x, h0, wi, bi, wh, bh, reverse: bool, plain: bool):
        fwd = gru_layer_plain if plain else gru_fwd_cuda
        with _kernel_span("gru_fwd", x, x.shape[0], x.shape[2], wh.shape[0],
                          ctx.needs_input_grad[0], plain):
            hs = fwd(x, h0, wi, bi, wh, bh, reverse)
        ctx.save_for_backward(x, h0, wi, bi, wh, bh, hs)
        ctx.reverse, ctx.plain = reverse, plain
        return hs

    @staticmethod
    def backward(ctx, dhs):
        x, h0, wi, bi, wh, bh, hs = ctx.saved_tensors
        # h_{t-1} of each step in the forward's sweep (pallas_gru.py:782-785)
        if ctx.reverse:
            hprev = torch.cat([hs[1:], h0[None]])
        else:
            hprev = torch.cat([h0[None], hs[:-1]])
        bwd = gru_backward_plain if ctx.plain else gru_bwd_cuda
        need_dx = ctx.needs_input_grad[0]
        with _kernel_span("gru_bwd", x, x.shape[0], x.shape[2], wh.shape[0],
                          need_dx, ctx.plain):
            dx, dh0, dwi, dwh, dbi, dbh = bwd(
                x, hprev, dhs.contiguous(), wi, bi, wh, bh, ctx.reverse,
                need_dx=need_dx)
        if dx is not None:
            dx = dx.to(x.dtype)  # the kernel emits float32 (:796)
        return dx, dh0, dwi, dbi, dwh, dbh, None, None


class GRUBidirFn(torch.autograd.Function):
    """``(hs_f, hs_b) = gru_layer_bidir(x, h0_f, h0_b, wi_f, bi_f, wh_f,
    bh_f, wi_b, bi_b, wh_b, bh_b)`` with its backward
    (``_gru_bidir_core``, pallas_gru.py:846-881): the unidirectional
    backward once forward and once reversed, dx summed and formed only when
    x needs it. ``plain`` as in :class:`GRULayerFn`."""

    @staticmethod
    def forward(ctx, x, h0_f, h0_b, wi_f, bi_f, wh_f, bh_f, wi_b, bi_b, wh_b,
                bh_b, plain: bool):
        fwd = gru_layer_bidir_plain if plain else gru_bifwd_cuda
        with _kernel_span("gru_bifwd", x, x.shape[0], x.shape[2],
                          wh_f.shape[0], ctx.needs_input_grad[0], plain,
                          directions=2):
            hs_f, hs_b = fwd(x, h0_f, h0_b, wi_f, bi_f, wh_f, bh_f, wi_b,
                             bi_b, wh_b, bh_b)
        ctx.save_for_backward(x, h0_f, h0_b, wi_f, bi_f, wh_f, bh_f, wi_b,
                              bi_b, wh_b, bh_b, hs_f, hs_b)
        ctx.plain = plain
        return hs_f, hs_b

    @staticmethod
    def backward(ctx, dhs_f, dhs_b):
        (x, h0_f, h0_b, wi_f, bi_f, wh_f, bh_f, wi_b, bi_b, wh_b, bh_b,
         hs_f, hs_b) = ctx.saved_tensors
        need_dx = ctx.needs_input_grad[0]
        bwd = gru_backward_plain if ctx.plain else gru_bwd_cuda
        T, F, H = x.shape[0], x.shape[2], wh_f.shape[0]
        # h_{t-1} of each step in each direction's sweep (:860, :865)
        with _kernel_span("gru_bwd", x, T, F, H, need_dx, ctx.plain):
            dx_f, dh0_f, dwi_f, dwh_f, dbi_f, dbh_f = bwd(
                x, torch.cat([h0_f[None], hs_f[:-1]]), dhs_f.contiguous(),
                wi_f, bi_f, wh_f, bh_f, False, need_dx=need_dx)
        with _kernel_span("gru_bwd", x, T, F, H, need_dx, ctx.plain):
            dx_b, dh0_b, dwi_b, dwh_b, dbi_b, dbh_b = bwd(
                x, torch.cat([hs_b[1:], h0_b[None]]), dhs_b.contiguous(),
                wi_b, bi_b, wh_b, bh_b, True, need_dx=need_dx)
        dx = (dx_f + dx_b).to(x.dtype) if need_dx else None
        return (dx, dh0_f, dh0_b, dwi_f, dbi_f, dwh_f, dbh_f, dwi_b, dbi_b,
                dwh_b, dbh_b, None)


class GRUWindowedFn(torch.autograd.Function):
    """``hs = gru_layer_windowed(x, h0, wi, bi, wh, bh, win, stride,
    reverse)`` with its backward (``_gru_win_core``,
    pallas_gru.py:493-518). ``plain`` as in :class:`GRULayerFn`. Frames
    that require no gradient get none. Frames that require one are rounded
    to bf16 here, so that the gradient the backward forms for them passes
    the rounding straight through in x's dtype (autograd would round a
    gradient to bf16 at the input of a Function fed the rounded frames). A
    reversed call's spans carry ``reverse``."""

    @staticmethod
    def forward(ctx, x, h0, wi, bi, wh, bh, win: int, stride: int,
                reverse: bool, plain: bool):
        if ctx.needs_input_grad[0]:
            x = x.to(torch.bfloat16)
            if not plain:
                x = _batch_major(x)
        fwd = gru_layer_windowed_plain if plain else gru_wfwd_cuda
        rev = {"reverse": True} if reverse else {}
        with _kernel_span("gru_wfwd", x, n_windows(x.shape[0], win, stride),
                          wi.shape[0], wh.shape[0], False, plain, **rev):
            hs = fwd(x, h0, wi, bi, wh, bh, win, stride, reverse)
        ctx.save_for_backward(x, h0, wi, bi, wh, bh, hs)
        ctx.win, ctx.stride, ctx.reverse, ctx.plain = (win, stride, reverse,
                                                       plain)
        return hs

    @staticmethod
    def backward(ctx, dhs):
        x, h0, wi, bi, wh, bh, hs = ctx.saved_tensors
        # h_{t-1} of each step in the sweep (pallas_gru.py:509)
        if ctx.reverse:
            hprev = torch.cat([hs[1:], h0[None]])
        else:
            hprev = torch.cat([h0[None], hs[:-1]])
        bwd = gru_win_backward_plain if ctx.plain else gru_wbwd_cuda
        need_dx = ctx.needs_input_grad[0]
        # with dx, the most windows a frame's gradient sums
        attrs = {"fold": -(-ctx.win // ctx.stride)} if need_dx else {}
        if ctx.reverse:
            attrs["reverse"] = True
        with _kernel_span("gru_wbwd", x, hs.shape[0], wi.shape[0],
                          wh.shape[0], need_dx, ctx.plain, **attrs):
            dx, dh0, dwi, dwh, dbi, dbh = bwd(
                x, hprev, dhs.contiguous(), wi, bi, wh, bh, ctx.win,
                ctx.stride, need_dx=need_dx, reverse=ctx.reverse)
        return dx, dh0, dwi, dbi, dwh, dbh, None, None, None, None


# ---------------------------------------------------------------------------
# public ops
# ---------------------------------------------------------------------------


def _route(x) -> str:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type


def gru_layer(x, h0, wi, bi, wh, bh, reverse: bool = False):
    """GRU layer over time-major inputs, differentiable in every argument.

    Args:
        x: (T, B, F) float32 or bfloat16, last axis contiguous.
        h0: (B, H) float32 initial state.
        wi: (F, 3H), bi: (3H,), wh: (H, 3H), bh: (3H,) float32.
        reverse: sweep time back to front; hs keeps the original order.

    Returns:
        hs: (T, B, H) float32 (h_last at T-1, or at 0 when ``reverse``).
        The gradient of x is formed only when x requires it, and has x's
        dtype.
    """
    plain = _route(x) == "cpu"
    return GRULayerFn.apply(x, h0, wi, bi, wh, bh, reverse, plain)


def gru_layer_bidir(x, h0_f, h0_b, wi_f, bi_f, wh_f, bh_f, wi_b, bi_b, wh_b,
                    bh_b):
    """Bidirectional GRU layer over time-major inputs, both directions in
    one time loop (the JAX ``gru_layer_bidir``, argument order kept),
    differentiable in every argument.

    Args:
        x: (T, B, F) float32 or bfloat16, last axis contiguous.
        h0_f, h0_b: (B, H) float32 initial states of the forward and the
            reverse direction.
        wi_*, bi_*, wh_*, bh_*: each direction's weights, as in
            :func:`gru_layer`.

    Returns:
        (hs_f, hs_b), each (T, B, H) float32 in the original time order
        (the reverse direction's last state is ``hs_b[0]``). The gradient of
        x is formed only when x requires it, and has x's dtype.
    """
    plain = _route(x) == "cpu"
    return GRUBidirFn.apply(x, h0_f, h0_b, wi_f, bi_f, wh_f, bh_f, wi_b, bi_b,
                            wh_b, bh_b, plain)


def gru_layer_windowed(x, h0, wi, bi, wh, bh, win: int, stride: int,
                       reverse: bool = False):
    """GRU layer over overlapping windows of raw frames; with ``reverse``
    the sweep runs from the last window.

    Args:
        x: (T, B, C) raw frames, channel axis contiguous. Window w is
            frames [w*stride, w*stride + win), flattened time-major then
            channel. Frames that require a gradient (the output of a
            trainable layer) are read rounded to bf16 on every device, in
            any float dtype. Other frames are data: on a CUDA tensor they
            must be bfloat16, on the CPU float32 or bfloat16. On a CUDA
            tensor the frames are read batch-major: a (T, B, C) view of a
            (B, T, C) tensor goes in as it is, other layouts are copied to
            it first (and the copy is what the backward reads).
        wi: (win*C, 3H); the other arguments as in :func:`gru_layer`.

    Returns:
        hs: (n_win, B, H) float32, n_win = (T - win)//stride + 1. Frames
        after the last window are never read. h0 and the weights get their
        gradients. Frames that require a gradient get the windows' dgi
        Wi^T folded onto them (0 after the last window), in x's dtype,
        past the rounding; data frames get none.
    """
    n_windows(x.shape[0], win, stride)
    plain = _route(x) == "cpu"
    if not plain and not x.requires_grad:
        x = _batch_major(x)  # what the kernels read, kept for the backward
    return GRUWindowedFn.apply(x, h0, wi, bi, wh, bh, win, stride, reverse,
                               plain)


def gru_layer_bidir_windowed(x, h0_f, h0_b, wi_f, bi_f, wh_f, bh_f, wi_b,
                             bi_b, wh_b, bh_b, win: int, stride: int):
    """Bidirectional GRU layer over overlapping windows of raw frames,
    differentiable in every argument: :func:`gru_layer_windowed` once
    forward and once reversed over the same frames, whose windows are
    never built.

    Args:
        x: (T, B, C) raw frames, as :func:`gru_layer_windowed` takes them.
        h0_f, h0_b, wi_*, bi_*, wh_*, bh_*: as in :func:`gru_layer_bidir`,
            ``wi_*`` (win*C, 3H).

    Returns:
        (hs_f, hs_b), each (n_win, B, H) float32 in the original time
        order. Frames that require a gradient get both directions' dgi
        Wi^T folded onto them, each direction's fold in a fixed order and
        the two added by autograd (a + b, so bitwise the same in either
        order), float32 past the rounding; data frames get none.
    """
    if _route(x) != "cpu" and not x.requires_grad:
        x = _batch_major(x)  # one copy for both directions
    return (gru_layer_windowed(x, h0_f, wi_f, bi_f, wh_f, bh_f, win, stride),
            gru_layer_windowed(x, h0_b, wi_b, bi_b, wh_b, bh_b, win, stride,
                               reverse=True))
