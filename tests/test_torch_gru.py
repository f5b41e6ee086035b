"""Port GRU ops against the JAX package's Pallas GRU (interpret mode on the
CPU backend) and its lax.scan oracle.

Inputs are made once with numpy and handed to both packages. On CPU
tensors the port runs its plain versions; both sides compute in float32,
so agreement is to float32 roundoff through the recurrence: atol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_patient_speech_decoding_tpu.models.layers import (
    reformat_time_windows as jax_reformat,
)
from cross_patient_speech_decoding_tpu.ops import pallas_gru
from cross_patient_speech_decoding_tpu_torch.models.layers import (
    reformat_time_windows,
)
from cross_patient_speech_decoding_tpu_torch.ops import gru

torch.set_num_threads(2)

ATOL = 1e-5


def _case(seed=0, T=6, B=16, F=10, H=32):
    # the shapes and scales of tests/test_pallas_gru.py:_case
    rng = np.random.default_rng(seed)
    return [
        (rng.normal(size=(T, B, F)) * 0.5).astype(np.float32),
        (rng.normal(size=(B, H)) * 0.3).astype(np.float32),
        (rng.normal(size=(F, 3 * H)) / np.sqrt(F)).astype(np.float32),
        (rng.normal(size=(3 * H,)) * 0.1).astype(np.float32),
        (rng.normal(size=(H, 3 * H)) / np.sqrt(H)).astype(np.float32),
        (rng.normal(size=(3 * H,)) * 0.1).astype(np.float32),
    ]


def _win_case(seed=0, T=26, B=16, C=5, H=32, win=6):
    # tests/test_pallas_gru.py:_win_case
    args = _case(seed, T=T, B=B, F=C, H=H)
    rng = np.random.default_rng(seed + 100)
    F = win * C
    args[2] = (rng.normal(size=(F, 3 * H)) / np.sqrt(F)).astype(np.float32)
    return args


def _t(args):
    return [torch.from_numpy(a) for a in args]


def _j(args):
    return [jnp.asarray(a) for a in args]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", [dict(B=16, H=32, F=10),
                                   dict(B=10, H=50, F=9)])
def test_gru_layer_matches_pallas_and_reference(reverse, shape):
    args = _case(seed=7, **shape)
    got = gru.gru_layer(*_t(args), reverse=reverse).numpy()
    want_k = np.asarray(pallas_gru.gru_layer(*_j(args), reverse))
    want_r = np.asarray(pallas_gru.gru_layer_reference(*_j(args), reverse))
    assert got.shape == want_k.shape
    np.testing.assert_allclose(got, want_k, atol=ATOL)
    np.testing.assert_allclose(got, want_r, atol=ATOL)


def test_gru_layer_bf16_input_matches_pallas():
    """bf16 data input: both sides upcast the same rounded values."""
    args = _case(seed=2)
    x_bf = torch.from_numpy(args[0]).to(torch.bfloat16)
    got = gru.gru_layer(x_bf, *_t(args[1:])).numpy()
    x_j = jnp.asarray(args[0]).astype(jnp.bfloat16)
    want = np.asarray(pallas_gru.gru_layer(x_j, *_j(args[1:])))
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("win,stride,T", [(6, 2, 26), (5, 2, 25), (4, 4, 16),
                                          (7, 3, 23)])
def test_gru_layer_windowed_matches_pallas(win, stride, T):
    args = _win_case(T=T, win=win)
    got = gru.gru_layer_windowed(*_t(args), win, stride).numpy()
    want = np.asarray(pallas_gru.gru_layer_windowed(*_j(args), win, stride))
    assert got.shape == want.shape == ((T - win) // stride + 1, 16, 32)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_gru_layer_windowed_trailing_frames_odd_sizes():
    """T=27 with win 6 / stride 2 leaves a trailing frame no window reads;
    B=10, H=50 are neither 8- nor 128-multiples."""
    args = _win_case(T=27, B=10, H=50)
    got = gru.gru_layer_windowed(*_t(args), 6, 2).numpy()
    want = np.asarray(pallas_gru.gru_layer_windowed(*_j(args), 6, 2))
    xw = jax_reformat(jnp.asarray(args[0]).swapaxes(0, 1), 6, 2)
    ref = np.asarray(pallas_gru.gru_layer_reference(
        xw.swapaxes(0, 1), *_j(args[1:])))
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got, ref, atol=ATOL)
    # the trailing frame does not enter the result
    x2 = args[0].copy()
    x2[-1] = 1e3
    got2 = gru.gru_layer_windowed(torch.from_numpy(x2), *_t(args[1:]),
                                  6, 2).numpy()
    np.testing.assert_array_equal(got, got2)


def test_gru_layer_windowed_bf16_and_batch_major_view():
    """The model's layer-0 call: bf16 frames as a (T, B, C) view of a
    batch-major (B, T, C) tensor."""
    args = _win_case(seed=4)
    x_bt = torch.from_numpy(args[0]).transpose(0, 1).contiguous()
    x_view = x_bt.to(torch.bfloat16).transpose(0, 1)
    got = gru.gru_layer_windowed(x_view, *_t(args[1:]), 6, 2).numpy()
    x_j = jnp.asarray(args[0]).astype(jnp.bfloat16)
    want = np.asarray(pallas_gru.gru_layer_windowed(x_j, *_j(args[1:]), 6, 2))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_gru_layer_windowed_rejects_bad_geometry():
    args = _t(_win_case(T=4))  # T=4 < win=6
    with pytest.raises(ValueError, match="n_win"):
        gru.gru_layer_windowed(*args, 6, 2)
    with pytest.raises(ValueError, match="stride"):
        gru.gru_layer_windowed(*args, 4, 0)
    with pytest.raises(ValueError, match="stride"):
        gru.gru_layer_windowed(*args, 0, 1)


@pytest.mark.parametrize("win,stride,T", [(6, 2, 26), (7, 3, 24)])
def test_reformat_time_windows_matches_jax(win, stride, T):
    x = np.random.default_rng(1).normal(size=(3, T, 5)).astype(np.float32)
    got = reformat_time_windows(torch.from_numpy(x), win, stride).numpy()
    want = np.asarray(jax_reformat(jnp.asarray(x), win, stride))
    np.testing.assert_array_equal(got, want)


# (T, B, C, win, stride, layout of the frames): odd C, stride 1, stride =
# win, T with trailing frames no window reads, one window, frames that
# are time-major (copied by _batch_major) or a cropped view of batch-major
# memory (a storage offset and a batch stride past T C)
@pytest.mark.parametrize("T,B,C,win,stride,layout", [
    (26, 4, 5, 6, 2, "batch_major"),
    (25, 3, 7, 5, 1, "batch_major"),
    (16, 2, 3, 4, 4, "batch_major"),
    (27, 5, 5, 6, 2, "batch_major"),
    (6, 3, 9, 6, 4, "batch_major"),
    (23, 4, 7, 7, 3, "time_major"),
    (20, 1, 5, 5, 5, "time_major"),
    (24, 3, 3, 4, 3, "cropped"),
])
def test_windows_view_matches_reformat_time_windows(T, B, C, win, stride,
                                                    layout):
    """The windowed kernels' input, the overlapping view that _windows
    makes of the frames _batch_major gives, holds bit for bit the rows of
    reformat_time_windows, and is a view: no window stream is built."""
    base = torch.randn(B, T + 3, C, generator=torch.Generator().manual_seed(
        T + C)).to(torch.bfloat16)
    frames = {"batch_major": base[:, :T].contiguous(),
              "time_major": base[:, :T].transpose(0, 1).contiguous()
              .transpose(0, 1),
              "cropped": base[:, 2:T + 2]}[layout]
    x = frames.transpose(0, 1)  # (T, B, C)
    xb = gru._batch_major(x)
    got = gru._windows(xb, win, stride)
    assert got.shape == (gru.n_windows(T, win, stride), B, win * C)
    assert got.untyped_storage().data_ptr() == xb.untyped_storage().data_ptr()
    want = reformat_time_windows(frames, win, stride)
    assert torch.equal(got.transpose(0, 1), want)


def test_cpu_tensors_take_the_plain_version():
    """On the CPU no kernel is launched and the op equals its plain
    version exactly."""
    args = _t(_case(seed=5))
    gru.reset_launch_counts()
    got = gru.gru_layer(*args, reverse=True)
    want = gru.gru_layer_plain(*args, reverse=True)
    assert torch.equal(got, want)
    assert gru.LAUNCHES == {"gru_fwd": 0, "gru_wfwd": 0, "gru_bifwd": 0,
                            "gru_bwd": 0, "gru_wbwd": 0}
