#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card (Hopper, sm_90a) and check it.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure exits non-zero and the ok
line is never printed:

1. device: nvidia-smi name and power limit, torch and CUDA versions,
   compute capability (9, 0) required;
2. build: compile the kernels of ``ops/csrc`` (nvcc, sm_90a);
3. ctc_eval (slice 1's main path): ``make_ctc_eval_step`` of a
   RealtimeRNN at the fig_5 width (B=2000, T=600, C=60, hidden 512 x 3,
   11 classes, window 14 / stride 4), with the launch counts zeroed just
   before one step and read just after, checked against the same step
   through the plain versions on the card; step time is the median of 3
   steps;
4. ctc_train (slice 2's main path), same geometry: at dropout 0 the loss
   and every parameter's gradient through the kernels against the plain
   forwards and plain backward functions on the card; then, with the
   launch counts zeroed just before and read just after, one
   ``make_ctc_train_step`` step at dropout 0.3 with AdamW, which must
   launch all four kernels; then the median of 3 more steps, samples/s,
   model TFLOP/s and peak memory;
5. streaming: 400 bins of 60 channels x 10 samples through the same
   model, with the launch counts zeroed just before and read just after;
   online logits checked against the offline forward, the offline forward
   against the plain versions, and one streaming window through
   ``gru_fwd`` against its plain version at B=1, T=1, layer by layer;
6. kernels: each kernel against its plain version at the fig_5 shapes and
   at small odd shapes, with times of the kernel, the plain version and
   ``torch.nn.GRU`` (its backward for the backward kernels), and its
   bound; ends with the ``{"kernels": [...]}`` line, whose launch counts
   are the train step's.

Then the nvidia-smi line, and last ``{"ok": true, "device": {...}}``.
Exits non-zero without a CUDA card, and in a directory without the port.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

# fig_5 geometry (the JAX package's bench.py section_ctc)
B, T, C, H, N_LAYERS, N_CLASSES, WIN, STRIDE = 2000, 600, 60, 512, 3, 11, 14, 4
N_WIN = (T - WIN) // STRIDE + 1
# H100 SXM peaks (NVIDIA data sheet): float32 SIMT, bf16 dense tensor
# cores, HBM3
PEAK_F32_SIMT = 67e12
PEAK_BF16_TC = 989e12
PEAK_HBM = 3.35e12
KERNEL_ATOL = 1e-4  # kernel vs plain on hs: float32 sums in another order
LOGITS_ATOL = 1e-3  # eval step: kernel path vs plain path on the card
LOSS_RTOL = 1e-4
# gradients, kernel vs plain (per tensor, max |diff| over max |plain|):
# the weight gradients are float32 sums over n_win * B = 294,000 (t, b)
# terms taken in another order, and the recurrence carries the rounding
# of every step back to dh0
GRAD_RTOL = 1e-3
# launches of one train step: layer 0 windowed, layers 1-2 plain
TRAIN_LAUNCHES = {"gru_fwd": 2, "gru_wfwd": 1, "gru_bwd": 2, "gru_wbwd": 1}
# online vs offline logits: offline rounds its layer-0 frames to bf16,
# online does not; the JAX package's own bound between the two paths
# (tests/test_realtime.py:57)
STREAM_ATOL = 5e-3
REPS = 5


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # the port itself, from the checkout this script lies in: fails in a
    # directory that holds the script alone, even where another copy of
    # the port is importable
    import cross_patient_speech_decoding_tpu_torch as port
    from cross_patient_speech_decoding_tpu_torch.ops import _ext, gru

    here = Path(__file__).resolve().parent
    if Path(port.__file__).resolve().parent.parent != here:
        raise RuntimeError(f"the port at {port.__file__} is not the one "
                           f"in {here}")

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    cap = torch.cuda.get_device_capability(0)
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "capability": list(cap)})
    if tuple(cap) != (9, 0):
        raise RuntimeError(f"need compute capability (9, 0), got {cap}")

    # 2. build
    build_s = _ext.build(verbose=True)
    _ext.lib()
    emit({"phase": "build", "seconds": build_s,
          "libraries": [_ext.library_path(s).name for s in _ext.SOURCES]})

    model, batch = phase_ctc_eval(torch, dev, gru)
    train_res = phase_ctc_train(torch, dev, gru, batch)
    phase_streaming(torch, dev, gru, model)
    kernels = phase_kernels(torch, dev, gru, train_res["launches"])
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def cuda_ms(torch, fn, reps: int = REPS) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs after one warm-up,
    from CUDA events."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def plain_logits(torch, model, x):
    """The model's forward (no dropout) through the plain GRU versions on
    x's device; differentiable, through the plain backward functions."""
    from cross_patient_speech_decoding_tpu_torch.ops.gru import (
        GRULayerFn,
        GRUWindowedFn,
    )

    h0 = model.initial_hidden(x.shape[0])
    l0 = model.rnn.layer(0)
    hs = GRUWindowedFn.apply(
        x.to(torch.bfloat16).transpose(0, 1), h0[0].contiguous(), l0.wi,
        l0.bi, l0.wh, l0.bh, model.win_size, model.stride, True)
    for i in range(1, model.n_layers):
        li = model.rnn.layer(i)
        hs = GRULayerFn.apply(hs, h0[i].contiguous(), li.wi, li.bi, li.wh,
                              li.bh, False, True)
    return model.head(hs.transpose(0, 1))


def phase_ctc_eval(torch, dev, gru):
    import numpy as np

    from cross_patient_speech_decoding_tpu_torch.models import (
        RealtimeRNN,
        adjusted_input_lengths,
    )
    from cross_patient_speech_decoding_tpu_torch.ops.ctc import ctc_loss_mean
    from cross_patient_speech_decoding_tpu_torch.train import (
        make_ctc_eval_step,
    )

    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((B, T, C), generator=gen, device=dev)
    rng = np.random.default_rng(0)
    labels = torch.as_tensor(np.concatenate(
        [np.full((B, 2), 10), rng.integers(1, 10, (B, 3)),
         np.full((B, 2), 10)], axis=1).astype(np.int32), device=dev)
    il = torch.full((B,), T, dtype=torch.int32, device=dev)
    ll = torch.full((B,), 7, dtype=torch.int32, device=dev)
    batch = (x, labels, il, ll)

    model = RealtimeRNN(C, H, N_LAYERS, N_CLASSES, dropout=0.3,
                        win_size=WIN, stride=STRIDE, seed=0, device=dev)
    model.eval()
    step = make_ctc_eval_step(model)
    step(batch)  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()

    gru.reset_launch_counts()
    t0 = time.perf_counter()
    out = step(batch)
    torch.cuda.synchronize()
    step_times = [time.perf_counter() - t0]
    launches = dict(gru.LAUNCHES)
    missing = [k for k in ("gru_fwd", "gru_wfwd") if launches[k] == 0]
    if missing:
        raise RuntimeError(f"eval step launched no {missing}: {launches}")
    for _ in range(2):  # two more timed steps: the host clock is noisy
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        step_times.append(time.perf_counter() - t0)
    step_s = statistics.median(step_times)

    loss, per = float(out["loss"]), float(out["per"])
    with torch.no_grad():
        logits_k = model(x)
        logits_p = plain_logits(torch, model, x)
        in_adj = adjusted_input_lengths(il, WIN, STRIDE)
        loss_p = float(ctc_loss_mean(logits_p, in_adj, labels, ll))
    logit_err = float((logits_k - logits_p).abs().max())
    decode = check_decode(torch, model, step, batch, in_adj)
    res = {"phase": "ctc_eval", "B": B, "T": T, "C": C, "hidden": H,
           "n_layers": N_LAYERS, "n_win": N_WIN, "loss": loss, "per": per,
           "step_s": step_s, "step_s_runs": step_times,
           "samples_per_s": B / step_s,
           "launches": launches, "logits_max_abs_err_vs_plain": logit_err,
           "loss_plain": loss_p, **decode,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(res)
    if not (np.isfinite(loss) and np.isfinite(per)
            and bool(torch.isfinite(logits_k).all())):
        raise RuntimeError("non-finite eval output")
    if tuple(logits_k.shape) != (B, N_WIN, N_CLASSES):
        raise RuntimeError(f"logits shape {tuple(logits_k.shape)}")
    if logit_err > LOGITS_ATOL:
        raise RuntimeError(f"logits differ from plain by {logit_err}")
    if abs(loss - loss_p) > LOSS_RTOL * abs(loss_p):
        raise RuntimeError(f"loss {loss} vs plain {loss_p}")
    if not decode["decode_matches_cpu"]:
        raise RuntimeError(f"decode on the card differs from CPU: {decode}")
    return model, batch


def ctc_flops_per_step(B, T, C, H, NL, n_cls, win, stride):
    """Model FLOPs of one RealtimeRNN train step (forward + ~2x backward),
    the JAX package's analytic count (bench.py:_ctc_flops_per_step), so
    that model TFLOP/s compare across the two: windowed layer-0 input
    projection, stacked recurrences and the head; the CTC loss is left
    out."""
    n_win = (T - win) // stride + 1
    l0 = 2 * B * n_win * (win * C) * 3 * H
    rest = (NL - 1) * 2 * B * n_win * H * 3 * H
    rec = NL * 2 * B * n_win * H * 3 * H
    head = 2 * B * n_win * H * n_cls
    return 3 * (l0 + rest + rec + head)


def _kernel_name(name: str) -> str:
    """'void (anonymous namespace)::gate_grad_kernel<float>(float const*,
    ...)' -> 'gate_grad_kernel': no namespace, template or arguments."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("<")[0].split("::")[-1].strip()


def profile_step(torch, step, state, batch, gen):
    """One more train step under ``torch.profiler``: device time summed by
    kernel name, the device's busy time (one stream, so kernels do not
    overlap) against the step's host-clock time, and its idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batch, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        key = _kernel_name(e.key)
        by_kernel[key] = by_kernel.get(key, 0.0) + us / 1e3
    busy_ms = sum(by_kernel.values())
    top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12])
    return state, {"step_ms": wall_ms, "device_busy_ms": busy_ms,
                   "device_idle_share": 1.0 - busy_ms / wall_ms
                   if busy_ms else None,
                   "device_ms_by_kernel": top}


def _rel_errs(got, want) -> dict:
    """max |got - want| / max |want| per named tensor."""
    return {k: float((got[k] - want[k]).abs().max()
                     / want[k].abs().max().clamp(min=1e-30)) for k in want}


def phase_ctc_train(torch, dev, gru, batch):
    import numpy as np

    from cross_patient_speech_decoding_tpu_torch.models import (
        RealtimeRNN,
        adjusted_input_lengths,
    )
    from cross_patient_speech_decoding_tpu_torch.ops.ctc import ctc_loss_mean
    from cross_patient_speech_decoding_tpu_torch.train import (
        create_train_state,
        make_ctc_train_step,
        make_optimizer,
    )

    x, labels, il, ll = batch
    in_adj = adjusted_input_lengths(il, WIN, STRIDE)
    model = RealtimeRNN(C, H, N_LAYERS, N_CLASSES, dropout=0.3,
                        win_size=WIN, stride=STRIDE, seed=0, device=dev)
    names, params = zip(*model.named_parameters())

    # (a) dropout 0 (eval mode): loss and gradients, kernels vs plain
    model.eval()
    loss_k = ctc_loss_mean(model(x), in_adj, labels, ll)
    grads_k = dict(zip(names, torch.autograd.grad(loss_k, params)))
    loss_p = ctc_loss_mean(plain_logits(torch, model, x), in_adj, labels, ll)
    grads_p = dict(zip(names, torch.autograd.grad(loss_p, params)))
    loss_k, loss_p = float(loss_k.detach()), float(loss_p.detach())
    grad_errs = _rel_errs(grads_k, grads_p)
    del grads_k, grads_p

    # (b) one train step at dropout 0.3 with AdamW, launches counted
    model.train()
    tx = make_optimizer(1e-3, 1e-5, 100)
    state = create_train_state(model, tx)
    step = make_ctc_train_step(model, tx)
    gen = torch.Generator(device=dev).manual_seed(3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gru.reset_launch_counts()
    t0 = time.perf_counter()
    state, m = step(state, batch, gen)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(gru.LAUNCHES)
    losses = [float(m["loss"])]

    # (c) 3 more steps
    step_times = []
    for _ in range(3):
        t0 = time.perf_counter()
        state, m = step(state, batch, gen)
        torch.cuda.synchronize()
        step_times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    step_s = statistics.median(step_times)
    state, profile = profile_step(torch, step, state, batch, gen)
    flops = ctc_flops_per_step(B, T, C, H, N_LAYERS, N_CLASSES, WIN, STRIDE)
    finite = all(np.isfinite(losses)) and all(
        bool(torch.isfinite(p).all()) for p in model.parameters())
    res = {"phase": "ctc_train", "B": B, "T": T, "C": C, "hidden": H,
           "n_layers": N_LAYERS, "n_win": N_WIN, "dropout": 0.3,
           "optimizer": "AdamW lr 1e-3 wd 1e-5, linear decay over 100",
           "loss_dropout0": loss_k, "loss_dropout0_plain": loss_p,
           "grad_max_rel_err_vs_plain": grad_errs,
           "grad_tolerance": GRAD_RTOL, "launches": launches,
           "first_step_s": first_s, "step_s": step_s,
           "step_s_runs": step_times, "samples_per_s": B / step_s,
           "model_tflops_per_s": flops / step_s / 1e12,
           "model_flops_per_step": flops, "losses": losses,
           "steps": state.step, "finite": finite,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "profile": profile}
    emit(res)
    if abs(loss_k - loss_p) > LOSS_RTOL * abs(loss_p):
        raise RuntimeError(f"loss {loss_k} vs plain {loss_p}")
    bad = {k: v for k, v in grad_errs.items() if not v <= GRAD_RTOL}
    if bad:
        raise RuntimeError(f"gradients differ from plain: {bad}")
    if launches != TRAIN_LAUNCHES:
        raise RuntimeError(f"train step launched {launches}, expected "
                           f"{TRAIN_LAUNCHES}")
    if not finite:
        raise RuntimeError(f"non-finite loss or parameters: {losses}")
    return res


def check_decode(torch, model, step, batch, in_adj):
    """Greedy decode and PER at full width on outputs that emit symbols.

    The random model's +2 blank bias makes every window blank, which
    leaves decoding and PER trivial; with the head bias zeroed it emits
    symbols. The card's decode and PER must equal the CPU's on the same
    logits, and the eval step's PER must equal them.
    """
    from cross_patient_speech_decoding_tpu_torch.ops.ctc import greedy_decode
    from cross_patient_speech_decoding_tpu_torch.ops.metrics import per_batch

    x, labels, _, ll = batch
    with torch.no_grad():
        bias = model.head.bias.clone()
        model.head.bias.zero_()
        try:
            per_step = float(step(batch)["per"])
            lp = torch.log_softmax(model(x), dim=-1)
        finally:
            model.head.bias.copy_(bias)
        mask = (torch.arange(lp.shape[1], device=lp.device)[None, :]
                < in_adj[:, None])
        dec, dec_len = greedy_decode(lp, model.blank, mask)
        per_card = float(per_batch(dec, dec_len, labels, ll))
        dec_c, len_c = greedy_decode(lp.cpu(), model.blank, mask.cpu())
        per_cpu = float(per_batch(dec_c, len_c, labels.cpu(), ll.cpu()))
    same = (torch.equal(dec.cpu(), dec_c) and torch.equal(dec_len.cpu(), len_c)
            and per_card == per_cpu == per_step)
    return {"per_unbiased_head": per_card, "per_unbiased_head_cpu": per_cpu,
            "symbols_decoded": int(dec_len.sum()), "decode_matches_cpu": same}


def phase_streaming(torch, dev, gru, model):
    import numpy as np
    import scipy.signal as sps

    from cross_patient_speech_decoding_tpu_torch.ops import signal
    from cross_patient_speech_decoding_tpu_torch.realtime import (
        init_realtime_state,
        simulate_stream,
    )

    n_bins, bin_len = 400, 10
    bs, as_ = [], []
    for lo, hi in ((0.35, 0.5), (0.5, 0.65), (0.65, 0.8)):
        b, a = sps.butter(2, [lo, hi], btype="band")
        bs.append(b)
        as_.append(a)
    b_np, a_np = np.stack(bs), np.stack(as_)
    b = torch.as_tensor(b_np, dtype=torch.float32, device=dev)
    a = torch.as_tensor(a_np, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    chunks = torch.randn((n_bins, C, bin_len), generator=gen, device=dev)

    simulate_stream(model, init_realtime_state(model, b_np, a_np, C),
                    chunks[:20], b, a)  # warm-up
    torch.cuda.synchronize()
    gru.reset_launch_counts()
    t0 = time.perf_counter()
    _, (emitted, logits, did_run) = simulate_stream(
        model, init_realtime_state(model, b_np, a_np, C), chunks, b, a)
    torch.cuda.synchronize()
    ms_per_bin = (time.perf_counter() - t0) * 1e3 / n_bins
    launches = dict(gru.LAUNCHES)
    if launches["gru_fwd"] == 0:
        raise RuntimeError(f"streaming launched no gru_fwd: {launches}")

    st = signal.init_stream_state(b_np, a_np, C, device=dev)
    powers = []
    with torch.no_grad():
        for ch in chunks:
            p, st = signal.process_hg_chunk(ch, b, a, st)
            powers.append(p)
        offline = model(torch.stack(powers)[None])[0]
        x_off = torch.stack(powers)[None]  # (1, n_bins, C)
        offline_err = float(
            (offline - plain_logits(torch, model, x_off)[0]).abs().max())
        step_errs = check_stream_step(torch, gru, model,
                                      x_off[0, :WIN].reshape(1, 1, -1))
    online = logits[did_run]
    err = float((online - offline).abs().max())
    emit({"phase": "streaming", "bins": n_bins, "channels": C,
          "samples_per_bin": bin_len, "gru_steps": int(did_run.sum()),
          "symbols_emitted": int((emitted >= 0).sum()),
          "ms_per_bin": ms_per_bin, "launches": launches,
          "online_vs_offline_max_abs_err": err,
          "offline_vs_plain_max_abs_err": offline_err,
          "step_kernel_vs_plain_max_abs_err": step_errs})
    if online.shape != offline.shape:
        raise RuntimeError(f"online {online.shape} vs offline "
                           f"{offline.shape}")
    if not err <= STREAM_ATOL:
        raise RuntimeError(f"online differs from offline by {err}")
    if not offline_err <= LOGITS_ATOL:
        raise RuntimeError(f"offline differs from plain by {offline_err}")
    bad = {k: v for k, v in step_errs.items() if not v <= KERNEL_ATOL}
    if bad:
        raise RuntimeError(f"streaming-step kernel disagrees: {bad}")


def check_stream_step(torch, gru, model, window):
    """One streaming GRU step (T=1, B=1, float32) through ``gru_fwd`` and
    its plain version, layer by layer with the model's weights; each layer
    takes the plain output of the one below."""
    errs = {}
    x = window
    for i in range(model.n_layers):
        li = model.rnn.layer(i)
        args = (x, model.h0[i].contiguous(), li.wi, li.bi, li.wh, li.bh)
        hs_p = gru.gru_layer_plain(*args)
        errs[f"layer{i}"] = float((gru.gru_fwd_cuda(*args) - hs_p).abs().max())
        x = hs_p
    return errs


def _weights(torch, gen, dev, F, Hh):
    """Random (wi, bi, wh, bh) of a GRU layer with F inputs, Hh units."""

    def rn(*shape, scale):
        return torch.randn(shape, generator=gen, device=dev) * scale

    return [rn(F, 3 * Hh, scale=F ** -0.5), rn(3 * Hh, scale=0.1),
            rn(Hh, 3 * Hh, scale=Hh ** -0.5), rn(3 * Hh, scale=0.1)]


def _library_gru(torch, wi, bi, wh, bh):
    """``torch.nn.GRU`` holding the same function: weight_ih = wi^T,
    weight_hh = wh^T, same (r, z, n) order and n-gate form."""
    F, H3 = wi.shape
    g = torch.nn.GRU(F, H3 // 3).to(wi.device)
    with torch.no_grad():
        g.weight_ih_l0.copy_(wi.t())
        g.weight_hh_l0.copy_(wh.t())
        g.bias_ih_l0.copy_(bi)
        g.bias_hh_l0.copy_(bh)
    g.flatten_parameters()
    return g


def _check_small(torch, gru, dev, gen):
    """Odd shapes: B=10, H=50, trailing frames, reverse, both dtypes of
    ``gru_fwd``, batch-major and time-major frames of ``gru_wfwd``; the
    same for the backward kernels, with and without dx. Returns (forward
    max abs errors, backward max relative errors)."""
    fwd, bwd = {}, {}
    Bs, Hs = 10, 50
    h0 = torch.randn((Bs, Hs), generator=gen, device=dev) * 0.3
    w = _weights(torch, gen, dev, 6 * 5, Hs)
    frames = torch.randn((Bs, 27, 5), generator=gen, device=dev).to(
        torch.bfloat16).transpose(0, 1)
    hprev = torch.randn((11, Bs, Hs), generator=gen, device=dev) * 0.3
    dhs = torch.randn((11, Bs, Hs), generator=gen, device=dev)
    for layout, x in (("batch_major", frames),
                      ("time_major", frames.contiguous())):
        fwd[f"gru_wfwd_{layout}"] = float(
            (gru.gru_wfwd_cuda(x, h0, *w, 6, 2)
             - gru.gru_layer_windowed_plain(x, h0, *w, 6, 2)).abs().max())
        bwd[f"gru_wbwd_{layout}"] = max(_bwd_errs(
            gru.gru_wbwd_cuda(x, hprev, dhs, *w, 6, 2),
            gru.gru_win_backward_plain(x, hprev, dhs, *w, 6, 2)).values())
    hprev, dhs = hprev[:6], dhs[:6].contiguous()
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).rsplit(".", 1)[-1]
        for reverse in (False, True):
            x = torch.randn((6, Bs, 9), generator=gen, device=dev).to(dtype)
            w = _weights(torch, gen, dev, 9, Hs)
            fwd[f"gru_fwd_{dt}_rev{int(reverse)}"] = float(
                (gru.gru_fwd_cuda(x, h0, *w, reverse=reverse)
                 - gru.gru_layer_plain(x, h0, *w, reverse)).abs().max())
            for need_dx in (True, False):
                errs = _bwd_errs(
                    gru.gru_bwd_cuda(x, hprev, dhs, *w, reverse, need_dx),
                    gru.gru_backward_plain(x, hprev, dhs, *w, reverse,
                                           need_dx))
                key = f"gru_bwd_{dt}_rev{int(reverse)}_dx{int(need_dx)}"
                bwd[key] = max(errs.values())
    return fwd, bwd


BWD_OUTPUTS = ("dx", "dh0", "dwi", "dwh", "dbi", "dbh")


def _bwd_errs(got, want) -> dict:
    """Relative error (max |diff| / max |plain|) per output of a backward;
    dx must be None on both sides or on neither."""
    if (got[0] is None) != (want[0] is None):
        raise RuntimeError("dx formed on one side only")
    kept = [(k, g, w) for k, g, w in zip(BWD_OUTPUTS, got, want)
            if w is not None]
    return _rel_errs({k: g for k, g, _ in kept}, {k: w for k, _, w in kept})


def phase_kernels(torch, dev, gru, launches):
    gen = torch.Generator(device=dev).manual_seed(2)
    small, small_bwd = _check_small(torch, gru, dev, gen)
    emit({"phase": "kernels_small", "max_abs_err": small,
          "max_rel_err_backward": small_bwd})
    bad = {k: v for k, v in small.items() if not v <= KERNEL_ATOL}
    bad.update({k: v for k, v in small_bwd.items() if not v <= GRAD_RTOL})
    if bad:
        raise RuntimeError(f"small-shape kernels disagree: {bad}")

    h0 = torch.randn((B, H), generator=gen, device=dev) * 0.3
    out = []
    with torch.no_grad():
        # kernel 1: layer 0 over bf16 frames, batch-major as the model has
        # them, read as a (T, B, C) view
        frames = torch.randn((B, T, C), generator=gen, device=dev).to(
            torch.bfloat16).transpose(0, 1)
        F0 = WIN * C
        w0 = _weights(torch, gen, dev, F0, H)
        windows = gru.reformat_time_windows(
            frames.transpose(0, 1), WIN, STRIDE).transpose(0, 1).float()
        windows = windows.contiguous()  # (n_win, B, win*C) for cuDNN
        out.append(_measure(
            torch, "gru_wfwd", "cross_patient_speech_decoding_tpu/ops/"
            "pallas_gru.py:263",
            kernel=lambda: gru.gru_wfwd_cuda(frames, h0, *w0, WIN, STRIDE),
            plain=lambda: gru.gru_layer_windowed_plain(frames, h0, *w0, WIN,
                                                       STRIDE),
            library=_library_gru(torch, *w0), lib_x=windows, h0=h0,
            flops=2 * B * N_WIN * (F0 + H) * 3 * H,
            bytes_=frames.numel() * 2 + _nbytes(h0, *w0) + N_WIN * B * H * 4,
            launches=launches["gru_wfwd"],
            shapes={"frames": [T, B, C], "dtype": "bf16", "win": WIN,
                    "stride": STRIDE, "hs": [N_WIN, B, H]}))
        del windows
        # kernel 2: layers 1-2 over the f32 layer outputs
        x1 = torch.rand((N_WIN, B, H), generator=gen, device=dev) * 2 - 1
        w1 = _weights(torch, gen, dev, H, H)
        out.append(_measure(
            torch, "gru_fwd", "cross_patient_speech_decoding_tpu/ops/"
            "pallas_gru.py:80",
            kernel=lambda: gru.gru_fwd_cuda(x1, h0, *w1),
            plain=lambda: gru.gru_layer_plain(x1, h0, *w1),
            library=_library_gru(torch, *w1), lib_x=x1, h0=h0,
            flops=2 * B * N_WIN * (H + H) * 3 * H,
            bytes_=_nbytes(x1, h0, *w1) + N_WIN * B * H * 4,
            launches=launches["gru_fwd"],
            shapes={"x": [N_WIN, B, H], "dtype": "f32", "hs": [N_WIN, B, H]}))
        del x1
    out += phase_kernels_backward(torch, dev, gru, gen, h0, launches)
    return out


def phase_kernels_backward(torch, dev, gru, gen, h0, launches):
    """The backward kernels at the fig_5 shapes of the train step, on the
    same (x, hprev, dhs) as their plain versions; the library yardstick is
    ``torch.nn.GRU``'s backward (cuDNN), timed apart from its forward."""
    out = []
    hprev = torch.rand((N_WIN, B, H), generator=gen, device=dev) * 2 - 1
    dhs = torch.randn((N_WIN, B, H), generator=gen, device=dev) * 1e-3
    # kernel 4: layers 1-2, dx formed (their input trains)
    x1 = torch.rand((N_WIN, B, H), generator=gen, device=dev) * 2 - 1
    w1 = _weights(torch, gen, dev, H, H)
    out.append(_measure_bwd(
        torch, "gru_bwd", "cross_patient_speech_decoding_tpu/ops/"
        "pallas_gru.py:569",
        kernel=lambda: gru.gru_bwd_cuda(x1, hprev, dhs, *w1),
        plain=lambda: gru.gru_backward_plain(x1, hprev, dhs, *w1),
        library=_library_gru(torch, *w1), lib_x=x1, h0=h0, dhs=dhs,
        flops=2 * B * 3 * H * (3 * H + 3 * H) * N_WIN,
        bytes_=_nbytes(x1, hprev, dhs, *w1) * 2 - _nbytes(hprev, dhs)
        + B * H * 4,
        launches=launches["gru_bwd"],
        shapes={"x": [N_WIN, B, H], "dtype": "f32", "need_dx": True}))
    del x1
    # kernel 3: layer 0 over bf16 batch-major frames, no input gradient
    frames = torch.randn((B, T, C), generator=gen, device=dev).to(
        torch.bfloat16).transpose(0, 1)
    F0 = WIN * C
    w0 = _weights(torch, gen, dev, F0, H)
    windows = gru.reformat_time_windows(
        frames.transpose(0, 1), WIN, STRIDE).transpose(0, 1).float()
    windows = windows.contiguous()  # (n_win, B, win*C) for cuDNN
    out.append(_measure_bwd(
        torch, "gru_wbwd", "cross_patient_speech_decoding_tpu/ops/"
        "pallas_gru.py:287",
        kernel=lambda: gru.gru_wbwd_cuda(frames, hprev, dhs, *w0, WIN,
                                         STRIDE),
        plain=lambda: gru.gru_win_backward_plain(frames, hprev, dhs, *w0,
                                                 WIN, STRIDE),
        library=_library_gru(torch, *w0), lib_x=windows, h0=h0, dhs=dhs,
        flops=2 * B * 3 * H * (2 * F0 + 3 * H) * N_WIN,
        bytes_=frames.numel() * 2 + _nbytes(hprev, dhs) + 2 * _nbytes(*w0)
        + B * H * 4,
        launches=launches["gru_wbwd"],
        shapes={"frames": [T, B, C], "dtype": "bf16", "win": WIN,
                "stride": STRIDE, "need_dx": False}))
    return out


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _row(name, source, replaces, launches, err, times, flops, bytes_):
    """The kernels line's row (bound_ms and what this run measured, nothing
    else) and the extra keys of the phase line. ``times`` is (kernel,
    plain, library) ms."""
    ms, plain_ms, library_ms = times
    t_ops = flops / PEAK_F32_SIMT * 1e3
    t_bytes = bytes_ / PEAK_HBM * 1e3
    row = {
        "name": name, "route": "cuda",
        "source": f"cross_patient_speech_decoding_tpu_torch/ops/csrc/{source}",
        "replaces": replaces, "launches": launches, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
    }
    extra = {"flops": flops, "bytes": bytes_,
             "bound_ms_bf16_tensor_core": max(flops / PEAK_BF16_TC * 1e3,
                                              t_bytes)}
    return row, extra


def _measure(torch, name, replaces, kernel, plain, library, lib_x, h0,
             flops, bytes_, launches, shapes):
    hs_k = kernel()
    hs_p = plain()
    hs_l, _ = library(lib_x, h0[None])
    torch.cuda.synchronize()
    err = float((hs_k - hs_p).abs().max())
    lib_err = float((hs_l - hs_p).abs().max())
    del hs_k, hs_p, hs_l
    times = (cuda_ms(torch, kernel), cuda_ms(torch, plain),
             cuda_ms(torch, lambda: library(lib_x, h0[None])))
    row, extra = _row(name, "gru_fwd.cu", replaces, launches, err, times,
                      flops, bytes_)
    emit({"phase": "kernel", **row, **extra,
          "library_max_abs_err_vs_plain": lib_err,
          "tolerance": KERNEL_ATOL, "shapes": shapes})
    if not err <= KERNEL_ATOL:
        raise RuntimeError(f"{name} differs from plain by {err}")
    return row


def _measure_bwd(torch, name, replaces, kernel, plain, library, lib_x, h0,
                 dhs, flops, bytes_, launches, shapes):
    got = kernel()
    want = plain()
    errs = _bwd_errs(got, want)
    abs_err = max(float((g - w).abs().max())
                  for g, w in zip(got, want) if w is not None)
    del got, want
    # cuDNN: forward once, then time the backward alone; dx is asked for
    # where the kernel forms it
    xl = lib_x.detach().requires_grad_(name == "gru_bwd")
    h0l = h0[None].detach().requires_grad_()
    hs_l, _ = library(xl, h0l)
    wrt = [h0l, *library.parameters()] + ([xl] if xl.requires_grad else [])
    times = (cuda_ms(torch, kernel), cuda_ms(torch, plain),
             cuda_ms(torch, lambda: torch.autograd.grad(hs_l, wrt, dhs,
                                                        retain_graph=True)))
    del hs_l
    row, extra = _row(name, "gru_bwd.cu", replaces, launches, abs_err, times,
                      flops, bytes_)
    emit({"phase": "kernel", **row, **extra,
          "max_rel_err": errs, "tolerance_rel": GRAD_RTOL,
          "library_note": "torch.nn.GRU backward (cuDNN), also forms dx"
                          + ("" if name == "gru_bwd"
                             else " internally, on materialised windows"),
          "shapes": shapes})
    bad = {k: v for k, v in errs.items() if not v <= GRAD_RTOL}
    if bad:
        raise RuntimeError(f"{name} differs from plain: {bad}")
    return row


if __name__ == "__main__":
    sys.exit(main())
