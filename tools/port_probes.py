#!/usr/bin/env python3
"""Probes of the PyTorch port's kernels, one JSON line per result.

Run from the repository root:

    python tools/port_probes.py jacobi   # on a CUDA card
    python tools/port_probes.py route    # on a CUDA card
    python tools/port_probes.py bifwd    # on a CUDA card
    python tools/port_probes.py bwd      # on a CUDA card
    python tools/port_probes.py fwd      # on a CUDA card
    python tools/port_probes.py sweep    # on a CUDA card
    python tools/port_probes.py tf32     # on a CUDA card
    python tools/port_probes.py ab --against DIR [--phases streaming]
        [--repeats 5]                    # on a CUDA card
    python tools/port_probes.py ab --summary FILE [FILE ...]   # anywhere
    python tools/port_probes.py oracle --pairs 4 --seed 0   # on the CPU

- ``jacobi``: builds the kernels and prints the ptxas report of
  ``jacobi.cu`` (registers, stack, spills of every Kp's instance), builds
  the variants of ``JACOBI_VARIANTS`` (the warps a matrix gives A), then
  holds the Jacobi kernel against its plain version (one sweep and
  eight: bitwise equality, sweep counts) on the alignment
  fit's own batches (128 and 256 x 40 x 40), synthetic symmetric batches
  (cond 50) and a correlation batch, with the float64 eigenvalue,
  reconstruction and orthonormality errors and the plain and
  ``torch.linalg.eigh`` times; then, for each variant (the defaults first
  and last), bitwise equality, the kernel's time (CUDA events, 20
  launches a run, median of 7), the most sweeps a matrix ran, µs a step
  (time / (most sweeps x (Kp-1))), registers and shared memory from the
  profiler trace.
- ``route``: the Jacobi kernel's route (``jacobi_eigh_pallas``) against
  ``torch.linalg.eigh`` (``symmetric_eigh``) at batch 1-16 and K 8-64,
  and at batch 32-256 for K below 24: the crossover that sets
  ``ops/jacobi.py``'s ``ANY_BATCH_K`` and ``MIN_BATCH``.
- ``bifwd``: builds the kernels and prints the ptxas report of
  ``gru_fwd.cu`` (registers, stack, spills per kernel), then holds the
  bidirectional GRU kernel against its plain version and two ``gru_fwd``
  launches (max abs error, bitwise equality, two runs bitwise equal) at the
  seq2seq encoder's shape (T=191, B=1000, F=100, H=500; f32 and bf16 x),
  at H=1024 and at small odd shapes. At B >= 100 also the kernel,
  two-launch and cuDNN times (CUDA events, median of 5; cuDNN with TF32
  off, in float32 as the kernel) and, from the profiler trace, the
  projections' and the sweeps' device ms, µs a step, and each kernel's
  registers, shared memory and CTAs per SM.
- ``bwd``: builds the kernels (printing the ptxas report) and the
  backward library's variants of ``BWD_VARIANTS`` (the weight products on
  mma.sync, other tile shapes), then, at ``chip_smoke.py``'s fig_5 backward shapes (B=2000 and
  the benchmark's 512), the seq2seq encoder's (T=191, B=1000 and 1224,
  F=100, H=500, reversed, dx), its decoder's (T=1) and ``conv_rnn``'s
  (T=191, B=1073, F=100, H=128), holds each variant against the plain
  version (relative error, bitwise repeat) and times it (CUDA events,
  median of 5), with device ms, registers, shared memory and the CTAs per
  SM they allow for each kernel name (``torch.profiler`` trace). The
  defaults run first and last. Small shapes are the card tests' (``-m gpu``
  in ``tests/test_torch_kernels.py``). Last, the route sweep: the weight
  products of T=1 backward calls of 128-16384 rows at the cells' widths,
  on wgmma and on mma.sync, from which ``GRU_WGMMA_MIN_ROWS`` is set.
- ``fwd``: builds the kernels (printing the ptxas report) and the forward
  library's variants of ``FWD_VARIANTS`` (the projection on mma.sync, the
  wgmma kernel's ring, other step tile shapes), then, at the b2t cell's
  shapes
  (``gru_fwd`` B=64, T=244, F=H=768; ``gru_wfwd`` over 14 x 4 windows of
  512 features), ``chip_smoke.py``'s fig_5 forward shapes (``gru_fwd``
  over float32 x, ``gru_wfwd`` over the bf16 frames; B=2000 and 512), the
  seq2seq encoder's (``gru_bifwd``, B=1224) and decoder's (T=1, B=1000,
  F=H=500), ``conv_rnn``'s and the streaming step's (T=1, B=1, F=840,
  H=512), holds each variant against the plain version (max abs error on
  hs, bitwise repeat, bitwise equal to the default's first run) and
  times it (CUDA events, median of 5), with the
  step kernel's cluster size and µs a step, and device ms, launches,
  registers, shared memory and CTAs per SM of the projection and the step
  kernel (``torch.profiler`` trace). The defaults run first and last. Then
  streaming ms per bin (``chip_smoke.phase_streaming``, 400 bins at fig_5
  width) with the defaults, twice, and the route sweep of T=1 forwards.
  ``--cases`` and ``--variants`` (comma-separated) run a subset, without
  the streaming runs and the sweep.
- ``sweep``: the route sweeps of ``fwd`` and ``bwd`` alone.
- ``tf32``: the error of a 1024^3 float32 product against float64, as a
  plain ``@`` and through ``ops.precision.hdot``, under four caller
  settings of TF32, with the settings before and after the call.
- ``ab``: end-to-end phases of ``chip_smoke.py`` (``--phases``: ``ctc``,
  the CTC eval and train steps; ``streaming``; ``seq2seq``, its train and
  eval steps; ``kernels``, the forward kernels' times at the fig_5 and
  seq2seq shapes, median of 7; ``alignment``, the alignment fits, the
  Jacobi kernel's phase and 20-launch times, and one profiled ``chol``
  and ``gram`` fit with the host's enqueue time and the card's idle
  gaps; default all five) from another
  checkout of the repository, ``DIR`` (say, the parent commit unpacked
  with ``git archive``), and from this one, in turns: DIR, this, this,
  DIR, ``--repeats`` times. Each turn is a process of its own that builds
  (or reuses) its checkout's kernels and prints the phases' JSON lines,
  tagged here with the turn and the checkout. Last, one ``ab_summary``
  line for each alignment fit: for each method and checkout the median,
  quartiles and range of the fit's ms over the turns, and in how many
  pairs of adjacent turns (DIR, this) this checkout was faster; and one
  for the Jacobi kernel's times, median and range for each checkout.
  ``--summary`` prints those lines for the output of earlier runs.
- ``oracle``: batched ``fit_cca_aligner`` on the CPU at the bench
  geometry (150 trials x 200 bins x 40 latents, 27 classes) for
  ``--pairs`` pairs made from ``--seed``, down the kernel's route (the
  plain Jacobi, the Gram-route SVD forced as on the card), each pair
  against the float64 oracle of ``chip_smoke.py``.

Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from cross_patient_speech_decoding_tpu_torch.ops import (  # noqa: E402
    _ext,
    cca,
    gru,
    jacobi,
    precision,
)


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _card() -> torch.device:
    if not torch.cuda.is_available():
        raise SystemExit("this probe needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    _emit({"nvidia_smi": smi, "torch": torch.__version__})
    return torch.device("cuda", 0)


def _cuda_ms(fn, reps: int = 5, inner: int = 1) -> float:
    """chip_smoke.cuda_ms: median ms a call, ``inner`` calls a run."""
    import chip_smoke as cs

    return cs.cuda_ms(torch, fn, reps, inner)


def _sym(rng, b, k, cond=50.0):
    q, _ = np.linalg.qr(rng.normal(size=(b, k, k)))
    w = np.exp(rng.uniform(0, np.log(cond), (b, k)))
    return ((q * w[:, None, :]) @ np.swapaxes(q, 1, 2)).astype(np.float32)


# Builds of the Jacobi library timed by ``jacobi`` (jacobi.cu's macro):
# the warps a matrix gives A (at Kp = 40 up to 20 have a row pair).
JACOBI_VARIANTS = {
    "default": (),
    "a_warps_2": ("JACOBI_WARPS=2",),
    "a_warps_8": ("JACOBI_WARPS=8",),
}


def _path_batches(dev) -> dict:
    """The alignment fit's own Jacobi batches at chip_smoke.py's bench
    geometry: the chol fit's g^T g (128 x 40 x 40) and the gram fit's
    stacked whitening Grams (256 x 40 x 40)."""
    import chip_smoke as cs

    xa, xb, ids_t, _ = cs._alignment_data(torch, dev)
    with cs._RecordJacobi(jacobi) as rec:
        for method in ("chol", "gram"):
            cca.fit_cca_aligner(xa, xb, ids_t, ids_t, cs.AL_C, method=method,
                                t_len=cs.AL_T)
    return {"path_chol_128x40": rec.batches[0],
            "path_gram_256x40": rec.batches[1]}


def probe_jacobi() -> None:
    """The Jacobi kernel: ptxas report, checks against the plain version
    and float64, then each variant's time and µs a step."""
    from types import SimpleNamespace

    dev = _card()
    _emit({"build_s": _ext.build()})
    _emit({"ptxas": _ptxas_report("jacobi.cu")})
    _emit({"variant_build_s": _build_variants(JACOBI_VARIANTS, "jacobi.cu")})
    default = _ext.lib()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(32, 8, 30))
    cases = {**_path_batches(dev)}
    for b, k in ((128, 32), (128, 16), (17, 41), (300, 13), (1, 40),
                 (1, 64), (133, 64)):
        cases[f"sym{b}x{k}"] = torch.from_numpy(_sym(rng, b, k)).to(dev)
    cases["corr32x8"] = torch.from_numpy(
        np.stack([np.corrcoef(a) for a in x]).astype(np.float32)).to(dev)
    want = {}
    for name, At in cases.items():
        Ap, _, _ = jacobi._pad_odd(At)
        Ap = Ap.contiguous()
        pairs = jacobi._pairs_on(Ap.shape[-1], dev)
        for sweeps in (1, 8):
            wk, Vk, nk = jacobi.jacobi_eigh_cuda(Ap, sweeps)
            wp, Vp, n_p = jacobi.jacobi_eigh_plain(Ap, pairs, sweeps)
            res = {"case": name, "sweeps": sweeps,
                   "w_err": float((wk - wp).abs().max()),
                   "V_err": float((Vk - Vp).abs().max()),
                   "bitwise": bool(torch.equal(wk, wp) and torch.equal(Vk, Vp)),
                   "sweep_counts_equal": bool(torch.equal(nk, n_p)),
                   "sweeps_run": sorted(set(nk.tolist()))}
            if sweeps == 8:
                want[name] = (Ap, pairs, wp, Vp, n_p)
                w, V = jacobi.jacobi_eigh_pallas(At)
                w64 = torch.linalg.eigvalsh(At.cpu().double())
                scale = float(w64.abs().max())
                rec = V @ (w[..., None] * V.mT)
                res["eig_err_over_max_w"] = float(
                    (w.cpu().double() - w64).abs().max()) / scale
                res["rec_err_over_max_w"] = float((rec - At).abs().max()) / scale
                eye = torch.eye(V.shape[-1], device=dev)
                res["orth_err"] = float((V.mT @ V - eye).abs().max())
                res["plain_ms"] = _cuda_ms(
                    lambda: jacobi.jacobi_eigh_plain(Ap, pairs))
                res["eigh_ms"] = _cuda_ms(lambda: torch.linalg.eigh(At))
            _emit(res)
    # the defaults first and last: the spread between them is the noise
    for variant in [*JACOBI_VARIANTS, "default"]:
        defines = JACOBI_VARIANTS[variant]
        _ext._lib = (SimpleNamespace(**{**vars(default), **vars(
            _ext.load(defines, ["jacobi.cu"]))}) if defines else default)
        for name, (Ap, pairs, wp, Vp, n_p) in want.items():
            w, V, n = jacobi.jacobi_eigh_cuda(Ap)
            ms = _cuda_ms(lambda: jacobi.jacobi_eigh_cuda(Ap), reps=7,
                          inner=20)
            steps = int(n_p.max()) * (Ap.shape[-1] - 1)
            res = {"variant": variant, "defines": defines, "case": name,
                   "shape": list(Ap.shape),
                   "bitwise": bool(torch.equal(w, wp) and torch.equal(V, Vp)
                                   and torch.equal(n, n_p)),
                   "kernel_ms": ms, "max_sweeps": int(n_p.max()),
                   "us_per_step": ms * 1e3 / steps if steps else None}
            res["by_kernel"] = _trace_kernels(
                lambda: jacobi.jacobi_eigh_cuda(Ap))
            _emit(res)
    _ext._lib = default


# The route's crossover (ops/jacobi.py ANY_BATCH_K, MIN_BATCH): batch
# sizes and K, then larger batches at the K below ANY_BATCH_K
ROUTE_BATCHES = (1, 2, 4, 8, 16)
ROUTE_KS = (8, 16, 20, 24, 32, 40, 64)
ROUTE_WIDE_BATCHES = (32, 64, 128, 256)
ROUTE_SMALL_KS = (8, 12, 16, 20)


def probe_route() -> None:
    """The two solvers ``batched_eigh`` chooses between on a CUDA batch,
    each as the route runs it: the Jacobi kernel's route
    (``jacobi_eigh_pallas``: pad, kernel, sort, strip) and
    ``symmetric_eigh`` (``torch.linalg.eigh``), at every batch of
    ROUTE_BATCHES and K of ROUTE_KS, then of ROUTE_WIDE_BATCHES and
    ROUTE_SMALL_KS: CUDA-event and host-clock ms (median of 9; the host
    clock until a synchronize)."""
    import time

    dev = _card()
    _ext.lib()
    rng = np.random.default_rng(0)

    def host_ms(fn, reps=9):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    grid = [(K, b) for K in ROUTE_KS for b in ROUTE_BATCHES]
    grid += [(K, b) for K in ROUTE_SMALL_KS for b in ROUTE_WIDE_BATCHES]
    for K, b in grid:
        A = torch.from_numpy(_sym(rng, b, K)).to(dev)
        fns = {"kernel_route": lambda: jacobi.jacobi_eigh_pallas(A),
               "eigh": lambda: jacobi.symmetric_eigh(A)}
        res = {"batch": b, "K": K}
        for name, fn in fns.items():
            res[f"{name}_ms"] = _cuda_ms(fn, reps=9)
            res[f"{name}_host_ms"] = host_ms(fn)
        res["kernel_route_faster"] = (
            res["kernel_route_ms"] < res["eigh_ms"]
            and res["kernel_route_host_ms"] < res["eigh_host_ms"])
        _emit(res)


def _ptxas_report(source: str) -> dict:
    """Build ``source`` once more with ``-Xptxas -v`` (as a variant, so a
    cached library does not skip the compiler) and return, per kernel
    (name<config numbers>, ``,bf16`` for a bf16 A operand), its registers,
    stack frame and spill bytes."""
    import contextlib
    import io
    import re

    defines = ("GRU_PTXAS_REPORT=1",)
    _ext.library_path(source, defines).unlink(missing_ok=True)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _ext.build(verbose=True, defines=defines, sources=[source])
    out, name = {}, None
    for line in buf.getvalue().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            kernel = re.search(r"([a-z][a-z_]*_kernel)[IE]", mangled).group(1)
            cfg = re.findall(r"Li(\d+)E", mangled)
            name = (f"{kernel}<{','.join(cfg)}"
                    f"{',bf16' if 'bfloat16' in mangled else ''}>")
            out[name] = {}
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      line)
        if m and name:
            out[name].update(stack=int(m.group(1)), spill=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["regs"] = int(m.group(1))
    return out


def _bidir_case(gen, dev, T, B, F, H, dtype):
    """gru_bifwd's arguments at chip_smoke.py's scales."""
    import chip_smoke as cs

    x = (torch.rand((T, B, F), generator=gen, device=dev) * 2 - 1).to(dtype)
    h0 = [torch.randn((B, H), generator=gen, device=dev) * 0.3
          for _ in range(2)]
    w = [cs._weights(torch, gen, dev, F, H) for _ in range(2)]
    return (x, h0[0], h0[1], *w[0], *w[1])


def probe_bifwd() -> None:
    """``gru_bifwd`` at the seq2seq encoder's shape, at H=1024 and at small
    shapes: errors, times, and the projections and sweeps from the
    profiler trace."""
    import chip_smoke as cs

    dev = _card()
    # cuDNN's yardstick in float32, as the kernel and chip_smoke.py's row
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _emit({"build_s": _ext.build()})
    _emit({"ptxas": _ptxas_report("gru_fwd.cu")})
    gen = torch.Generator(device=dev).manual_seed(0)
    T, B, F = cs.S2S_TC, cs.S2S_B, cs.S2S_F
    cases = [("s2s_f32", T, B, F, cs.S2S_H, torch.float32),
             ("s2s_bf16", T, B, F, cs.S2S_H, torch.bfloat16),
             ("h1024_f32", T, B, F, 1024, torch.float32)]
    for T_, B_, F_, H_ in ((1, 1, 3, 1), (2, 7, 5, 33), (191, 33, 20, 7)):
        cases.append((f"small_{T_}x{B_}x{F_}x{H_}", T_, B_, F_, H_,
                      torch.float32))
    with torch.no_grad():
        for name, T_, B_, F_, H_, dtype in cases:
            args = _bidir_case(gen, dev, T_, B_, F_, H_, dtype)
            x, h0f, h0b, *w = args

            def kernel():
                return gru.gru_bifwd_cuda(*args)

            def two_launches():
                return (gru.gru_fwd_cuda(x, h0f, *w[:4]),
                        gru.gru_fwd_cuda(x, h0b, *w[4:], reverse=True))

            got, again = kernel(), kernel()
            want = gru.gru_layer_bidir_plain(*args)
            unfused = two_launches()
            res = {"case": name, "shape": [T_, B_, F_, H_],
                   "dtype": str(dtype),
                   "err_vs_plain": max(float((g - p).abs().max())
                                       for g, p in zip(got, want)),
                   "err_vs_two_gru_fwd": max(float((g - u).abs().max())
                                             for g, u in zip(got, unfused)),
                   "bitwise_equal_to_two_gru_fwd": all(
                       torch.equal(g, u) for g, u in zip(got, unfused)),
                   "bitwise_repeat": all(torch.equal(g, a)
                                         for g, a in zip(got, again))}
            del got, again, want, unfused
            if B_ >= 100:
                lib = cs._library_bigru(torch, w)
                xl, h0l = x.float(), torch.stack([h0f, h0b])
                res["kernel_ms"] = _cuda_ms(kernel)
                res["two_gru_fwd_ms"] = _cuda_ms(two_launches)
                res["cudnn_ms"] = _cuda_ms(lambda: lib(xl, h0l))
                by = _trace_kernels(kernel)
                res["by_kernel"] = by
                res["projection_ms"] = sum(
                    v["ms"] for k, v in by.items()
                    if k.startswith("mma_gemm_kernel"))
                res["sweep_ms"] = sum(v["ms"] for k, v in by.items()
                                      if k == "gru_step_mma_kernel")
                res["us_per_step"] = res["sweep_ms"] / (2 * T_) * 1e3
            _emit(res)


# Builds of the backward library timed by ``bwd`` (gru_mma.cuh's macros,
# MmaCfg<BM, BN, warps along M, warps along N, stages, CTAs per SM>):
# the defaults and tile shapes beside them.
# The weight products' routes (csrc/gru_mma.cuh) forced at any row count:
# every one on mma.sync, as below GRU_WGMMA_MIN_ROWS rows, or on wgmma.
MMA_SYNC = ("GRU_WGMMA_MIN_ROWS=(1LL << 62)",)
WGMMA = ("GRU_WGMMA_MIN_ROWS=1",)
BWD_VARIANTS = {
    "default": (),
    "mma_sync": MMA_SYNC,
    "big_16_warps": ("GRU_MMA_BIG=128, 128, 4, 4, 3, 1",),
    "big_4_stages": ("GRU_MMA_BIG=128, 128, 2, 4, 4, 1",),
    "big_128x64": ("GRU_MMA_BIG=128, 64, 2, 2, 3, 2",),
    "small_64x128": ("GRU_MMA_SMALL=64, 128, 2, 4, 3, 2",),
}
# H100 SM limits: 64K registers (allocated 256 a warp), 228 KiB of shared
# memory (1 KiB of it reserved per CTA), 2048 threads, 32 CTAs
_SM_REGS, _SM_SMEM, _SM_THREADS, _SM_CTAS = 65536, 233472, 2048, 32


def _ctas_per_sm(regs: int, smem: int, threads: int) -> int:
    """CTAs of a launch that fit on one SM at once (its registers, shared
    memory and threads)."""
    warps = -(-threads // 32)
    regs_warp = -(-regs * 32 // 256) * 256
    return min(_SM_REGS // (regs_warp * warps), _SM_SMEM // (smem + 1024),
               _SM_THREADS // threads, _SM_CTAS)


def _trace_kernels(fn) -> dict:
    """``fn()`` once under ``torch.profiler``: per kernel name
    (chip_smoke's), device ms, launches, and the first launch's registers
    per thread, shared memory, block and grid from the trace, with the
    CTAs per SM they allow."""
    import os
    import tempfile

    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    out = {}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        r = out.setdefault(cs._kernel_name(e["name"]),
                           {"ms": 0.0, "launches": 0})
        r["ms"] += e["dur"] / 1e3
        r["launches"] += 1
        a = e.get("args", {})
        if "regs" not in r and "registers per thread" in a:
            r.update(regs=a["registers per thread"],
                     smem=a.get("shared memory"), block=a.get("block"),
                     grid=a.get("grid"),
                     est_occupancy_pct=a.get("est. achieved occupancy %"))
            block = a.get("block")
            if isinstance(block, list) and r["smem"] is not None:
                r["ctas_per_sm"] = _ctas_per_sm(
                    r["regs"], r["smem"], int(np.prod(block)))
    if not out:  # no kernel events in the trace: device ms alone
        _, prof = cs.profile_call(torch, fn)
        out = {k: {"ms": v} for k, v in prof["device_ms_by_kernel"].items()}
    return out


def probe_bwd() -> None:
    from types import SimpleNamespace

    import chip_smoke as cs

    dev = _card()
    _emit({"build_s": _ext.build(verbose=True)})
    _emit({"variant_build_s": _build_variants(BWD_VARIANTS, "gru_bwd.cu")})
    default = _ext.lib()
    gen = torch.Generator(device=dev).manual_seed(0)

    def rn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    # chip_smoke.py's fig_5 backward shapes, then the seq2seq train step's:
    # the encoder reversed with dx, a decoder step
    cases = {}
    x1 = torch.rand((cs.N_WIN, cs.B, cs.H), generator=gen, device=dev) * 2 - 1
    hp, dh = (torch.rand((cs.N_WIN, cs.B, cs.H), generator=gen, device=dev)
              * 2 - 1), rn(cs.N_WIN, cs.B, cs.H, scale=1e-3)
    w1 = cs._weights(torch, gen, dev, cs.H, cs.H)
    cases["gru_bwd_fig5"] = (
        lambda: gru.gru_bwd_cuda(x1, hp, dh, *w1),
        lambda: gru.gru_backward_plain(x1, hp, dh, *w1))
    frames = rn(cs.B, cs.T, cs.C).to(torch.bfloat16).transpose(0, 1)
    w0 = cs._weights(torch, gen, dev, cs.WIN * cs.C, cs.H)
    cases["gru_wbwd_fig5"] = (
        lambda: gru.gru_wbwd_cuda(frames, hp, dh, *w0, cs.WIN, cs.STRIDE),
        lambda: gru.gru_win_backward_plain(frames, hp, dh, *w0, cs.WIN,
                                           cs.STRIDE))
    # the benchmark's cells: fig_5 at B = 512, the seq2seq encoder and
    # decoder at B = 1224 (and the bench's 1000), train-nn's conv_rnn
    hp5, dh5 = hp[:, :512].contiguous(), dh[:, :512].contiguous()
    x5 = x1[:, :512]
    cases["gru_bwd_fig5_b512"] = (
        lambda: gru.gru_bwd_cuda(x5, hp5, dh5, *w1),
        lambda: gru.gru_backward_plain(x5, hp5, dh5, *w1))
    f5 = frames[:, :512]
    cases["gru_wbwd_fig5_b512"] = (
        lambda: gru.gru_wbwd_cuda(f5, hp5, dh5, *w0, cs.WIN, cs.STRIDE),
        lambda: gru.gru_win_backward_plain(f5, hp5, dh5, *w0, cs.WIN,
                                           cs.STRIDE))
    for name, T, Bc, F, Hc, rev in (
            ("s2s_encoder", cs.S2S_TC, cs.S2S_B, cs.S2S_F, cs.S2S_H, True),
            ("s2s_decoder", 1, cs.S2S_B, cs.S2S_H, cs.S2S_H, False),
            ("s2s_encoder_b1224", cs.S2S_TC, 1224, cs.S2S_F, cs.S2S_H, True),
            ("s2s_decoder_b1224", 1, 1224, cs.S2S_H, cs.S2S_H, False),
            ("conv_rnn", cs.S2S_TC, 1073, 100, 128, False)):
        xs = rn(T, Bc, F, scale=0.5)
        hs, ds = rn(T, Bc, Hc, scale=0.3), rn(T, Bc, Hc, scale=1e-3)
        ws = cs._weights(torch, gen, dev, F, Hc)
        cases[f"gru_bwd_{name}"] = (
            lambda xs=xs, hs=hs, ds=ds, ws=ws, rev=rev:
                gru.gru_bwd_cuda(xs, hs, ds, *ws, rev),
            lambda xs=xs, hs=hs, ds=ds, ws=ws, rev=rev:
                gru.gru_backward_plain(xs, hs, ds, *ws, rev))
    # the defaults first and last: the spread between them is the noise
    order = [*BWD_VARIANTS, "default"]
    for case, (kernel, plain) in cases.items():
        want = plain()
        res = {"case": case, "plain_ms": _cuda_ms(plain)}
        _emit(res)
        for variant in order:
            defines = BWD_VARIANTS[variant]
            _ext._lib = (SimpleNamespace(**{**vars(default), **vars(
                _ext.load(defines, ["gru_bwd.cu"]))}) if defines else default)
            got = kernel()
            errs = cs._bwd_errs(got, want)
            res = {"case": case, "variant": variant, "defines": defines,
                   "max_rel_err": max(errs.values()), "rel_err": errs,
                   "bitwise_repeat": cs._bitwise_repeat(torch, got, kernel()),
                   "kernel_ms": _cuda_ms(kernel),
                   "by_kernel": _trace_kernels(kernel)}
            del got
            _emit(res)
        _ext._lib = default
        del want
    _route_sweep("bwd", "gru_bwd.cu")


# Row counts of the route sweep: T = 1 calls of B rows
SWEEP_ROWS = (128, 256, 512, 1024, 2048, 4096, 8192, 16384)
# (F, H, x dtype) of the sweep: fig_5's layers 1-2 and layer 0 (bf16 x),
# the seq2seq encoder and decoder, conv_rnn's first layer
SWEEP_SHAPES = ((512, 512, "f32"), (840, 512, "bf16"), (100, 500, "f32"),
                (500, 500, "f32"), (100, 128, "f32"))


def _weight_ms(by_kernel: dict) -> float:
    """Device ms of a call's weight products: the images' pass and the
    wgmma kernel, or mma_gemm_kernel's 128 x 128 MK products."""
    return sum(v["ms"] for k, v in by_kernel.items()
               if k.startswith(("presplit_kernel", "wgmma_gemm_kernel",
                                "mma_gemm_kernel<128x128,f32,MK",
                                "mma_gemm_kernel<128x128,bf16,MK")))


def _route_sweep(kind: str, source: str) -> None:
    """The weight products of T = 1 calls (``kind`` fwd: gru_fwd; bwd:
    gru_bwd with dx) at SWEEP_ROWS rows and SWEEP_SHAPES, on both routes
    (builds of ``source`` with each forced): device ms of the products, and
    of the whole call (CUDA events). GRU_WGMMA_MIN_ROWS comes from the
    row count from which wgmma is the faster at every shape."""
    from types import SimpleNamespace

    import chip_smoke as cs

    default = _ext.lib()
    on_wgmma, on_mma = (
        SimpleNamespace(**{**vars(default), **vars(_ext.load(d, [source]))})
        for d in (WGMMA, MMA_SYNC))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(3)
    for F, H, dt in SWEEP_SHAPES:
        w = cs._weights(torch, gen, dev, F, H)
        for rows in SWEEP_ROWS:
            x = torch.randn((1, rows, F), generator=gen, device=dev)
            if dt == "bf16":
                x = x.to(torch.bfloat16)
            h0 = torch.randn((rows, H), generator=gen, device=dev) * 0.3
            hp = h0[None]
            dh = torch.randn((1, rows, H), generator=gen, device=dev) * 1e-3
            if kind == "fwd":
                def call():
                    return gru.gru_fwd_cuda(x, h0, *w)
            else:
                def call():
                    return gru.gru_bwd_cuda(x, hp, dh, *w, False, True)
            res = {"sweep": kind, "F": F, "H": H, "x": dt, "rows": rows}
            for route, lib in (("wgmma", on_wgmma), ("mma_sync", on_mma),
                               ("wgmma", on_wgmma), ("mma_sync", on_mma)):
                _ext._lib = lib
                with torch.no_grad():
                    res.setdefault(f"{route}_weight_ms", []).append(
                        round(_weight_ms(_trace_kernels(call)), 5))
                    res.setdefault(f"{route}_call_ms", []).append(
                        round(_cuda_ms(call, inner=10), 5))
            _ext._lib = default
            _emit(res)


# Builds of the forward library timed by ``fwd``: the defaults, the
# routes and the wgmma ring, and step tiles beside the default (gru_fwd.cu's
# GRU_FWD_STEP, MmaCfg<BM, 3 x units, warps along M, warps along N, stages,
# CTAs per SM>).
FWD_VARIANTS = {
    "default": (),
    "mma_sync": MMA_SYNC,
    # the wgmma kernel's ring and registers
    "wgmma_4_stages": ("GRU_WGMMA_STAGES=4", "GRU_WGMMA_REGS=56, 224"),
    "step_128x32": ("GRU_FWD_STEP=128, 96, 4, 2, 3, 2",),
    "step_64x16": ("GRU_FWD_STEP=64, 48, 2, 1, 3, 4",),
    "step_warps_4x1": ("GRU_FWD_STEP=64, 96, 4, 1, 3, 2",),
    "step_3_ctas": ("GRU_FWD_STEP=64, 96, 2, 2, 3, 3",),
    "step_4_stages": ("GRU_FWD_STEP=64, 96, 2, 2, 4, 2",),
}


def _build_variants(variants, source) -> dict:
    """Build the variants' libraries of ``source``, all nvccs at once;
    returns the seconds each took."""
    import threading

    builds = {}

    def build(name, defines):
        builds[name] = _ext.build(defines=defines, sources=[source])

    threads = [threading.Thread(target=build, args=item)
               for item in variants.items() if item[1]]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return builds


def probe_fwd(only_cases=None, only_variants=None) -> None:
    """``only_cases`` and ``only_variants``: the names to run (default
    all; the default variant always runs last, the streaming phases and
    the route sweep only with every case)."""
    from types import SimpleNamespace

    import chip_smoke as cs
    from cross_patient_speech_decoding_tpu_torch.models import RealtimeRNN

    dev = _card()
    chosen = {k: v for k, v in FWD_VARIANTS.items()
              if only_variants is None or k in only_variants
              or k == "default"}
    _emit({"build_s": _ext.build(verbose=True)})
    _emit({"variant_build_s": _build_variants(chosen, "gru_fwd.cu")})
    default = _ext.lib()
    gen = torch.Generator(device=dev).manual_seed(0)

    def rn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    h0 = rn(cs.B, cs.H, scale=0.3)
    x1 = torch.rand((cs.N_WIN, cs.B, cs.H), generator=gen, device=dev) * 2 - 1
    w1 = cs._weights(torch, gen, dev, cs.H, cs.H)
    frames = rn(cs.B, cs.T, cs.C).to(torch.bfloat16).transpose(0, 1)
    w0 = cs._weights(torch, gen, dev, cs.WIN * cs.C, cs.H)
    xd = rn(1, cs.S2S_B, cs.S2S_H, scale=0.5)
    hd = rn(cs.S2S_B, cs.S2S_H, scale=0.3)
    wd = cs._weights(torch, gen, dev, cs.S2S_H, cs.S2S_H)
    xs = rn(1, 1, cs.WIN * cs.C)
    hs0 = rn(1, cs.H, scale=0.3)
    # the benchmark's cells: fig_5 at B = 512, the seq2seq encoder (both
    # directions) at B = 1224, train-nn's conv_rnn
    x5, f5, h5 = x1[:, :512], frames[:, :512], h0[:512]
    xe = rn(cs.S2S_TC, 1224, cs.S2S_F, scale=0.5)
    he = rn(1224, cs.S2S_H, scale=0.3)
    we = cs._weights(torch, gen, dev, cs.S2S_F, cs.S2S_H)
    xc = rn(cs.S2S_TC, 1073, 100, scale=0.5)
    hc = rn(1073, 128, scale=0.3)
    wc = cs._weights(torch, gen, dev, 100, 128)
    # the b2t cell at its mean padded length: 244 steps of B = 64, H = 768;
    # layers 1-4 over F = 768, layer 0 over 14 x 4 windows of 512 features
    xb = torch.rand((244, 64, 768), generator=gen, device=dev) * 2 - 1
    hb = rn(64, 768, scale=0.3)
    wb = cs._weights(torch, gen, dev, 768, 768)
    fb = rn(64, 4 * 243 + 14, 512).to(torch.bfloat16).transpose(0, 1)
    wb0 = cs._weights(torch, gen, dev, 14 * 512, 768)
    cases = {
        "gru_fwd_b2t": (lambda: gru.gru_fwd_cuda(xb, hb, *wb),
                        lambda: gru.gru_layer_plain(xb, hb, *wb)),
        "gru_wfwd_b2t": (
            lambda: gru.gru_wfwd_cuda(fb, hb, *wb0, 14, 4),
            lambda: gru.gru_layer_windowed_plain(fb, hb, *wb0, 14, 4)),
        "gru_fwd_fig5": (lambda: gru.gru_fwd_cuda(x1, h0, *w1),
                         lambda: gru.gru_layer_plain(x1, h0, *w1)),
        "gru_fwd_fig5_b512": (lambda: gru.gru_fwd_cuda(x5, h5, *w1),
                              lambda: gru.gru_layer_plain(x5, h5, *w1)),
        "gru_wfwd_fig5_b512": (
            lambda: gru.gru_wfwd_cuda(f5, h5, *w0, cs.WIN, cs.STRIDE),
            lambda: gru.gru_layer_windowed_plain(f5, h5, *w0, cs.WIN,
                                                 cs.STRIDE)),
        "gru_bifwd_s2s_encoder_b1224": (
            lambda: torch.cat(gru.gru_bifwd_cuda(xe, he, he, *we, *we)),
            lambda: torch.cat(gru.gru_layer_bidir_plain(xe, he, he, *we,
                                                        *we))),
        "gru_fwd_conv_rnn": (lambda: gru.gru_fwd_cuda(xc, hc, *wc),
                             lambda: gru.gru_layer_plain(xc, hc, *wc)),
        "gru_wfwd_fig5": (
            lambda: gru.gru_wfwd_cuda(frames, h0, *w0, cs.WIN, cs.STRIDE),
            lambda: gru.gru_layer_windowed_plain(frames, h0, *w0, cs.WIN,
                                                 cs.STRIDE)),
        "gru_fwd_s2s_decoder": (lambda: gru.gru_fwd_cuda(xd, hd, *wd),
                                lambda: gru.gru_layer_plain(xd, hd, *wd)),
        "gru_fwd_stream_step": (lambda: gru.gru_fwd_cuda(xs, hs0, *w0),
                                lambda: gru.gru_layer_plain(xs, hs0, *w0)),
    }
    order = [*chosen, "default"]
    with torch.no_grad():
        for case, (kernel, plain) in cases.items():
            if only_cases is not None and case not in only_cases:
                continue
            want = plain()
            first = None  # the default's hs, from its first run
            _emit({"case": case, "plain_ms": _cuda_ms(plain)})
            for variant in order:
                defines = FWD_VARIANTS[variant]
                _ext._lib = (SimpleNamespace(**{**vars(default), **vars(
                    _ext.load(defines, ["gru_fwd.cu"]))})
                    if defines else default)
                gru.reset_launch_counts()
                got = kernel()
                split = [k for k, n in gru.step_counts().items() if n]
                again = kernel()
                by = _trace_kernels(kernel)
                step = by.get("gru_step_mma_kernel", {})
                _emit({"case": case, "variant": variant, "defines": defines,
                       "max_abs_err": float((got - want).abs().max()),
                       "bitwise_repeat": bool(torch.equal(got, again)),
                       "bitwise_equal_default": (
                           None if first is None
                           else bool(torch.equal(got, first))),
                       "step_split": split,
                       "step_us": (1e3 * step["ms"] / step["launches"]
                                   if step.get("launches") else None),
                       "kernel_ms": _cuda_ms(kernel), "by_kernel": by})
                if first is None:
                    first = got
                del got, again
            _ext._lib = default
            del want, first
        if only_cases is not None:
            return
        model = RealtimeRNN(cs.C, cs.H, cs.N_LAYERS, cs.N_CLASSES,
                            win_size=cs.WIN, stride=cs.STRIDE, seed=0,
                            device=dev).eval()
        for _ in range(2):  # the spread of two runs
            cs.phase_streaming(torch, dev, gru, model)
    _route_sweep("fwd", "gru_fwd.cu")


# One turn of ``ab``, run with the checkout as working directory and
# first on the path: its own chip_smoke.py, port and kernels. The phases
# that ``sys.argv[1]`` names, in AB_PHASES' order.
_AB_TURN = """
import sys
import torch
import chip_smoke as cs
from cross_patient_speech_decoding_tpu_torch.models import RealtimeRNN
from cross_patient_speech_decoding_tpu_torch.ops import _ext, gru
_ext.lib()
dev = torch.device("cuda", 0)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
phases = sys.argv[1].split(",")
if "ctc" in phases:
    model, batch = cs.phase_ctc_eval(torch, dev, gru)
    cs.phase_ctc_train(torch, dev, gru, batch)
    del model, batch
if "streaming" in phases:
    model = RealtimeRNN(cs.C, cs.H, cs.N_LAYERS, cs.N_CLASSES,
                        win_size=cs.WIN, stride=cs.STRIDE, seed=0,
                        device=dev).eval()
    cs.phase_streaming(torch, dev, gru, model)
    del model
if "seq2seq" in phases:
    model, batch, _ = cs.phase_seq2seq_train(torch, dev, gru)
    cs.phase_seq2seq_eval(torch, dev, gru, model, batch)
    del model, batch
if "kernels" in phases:
    import json
    gen = torch.Generator(device=dev).manual_seed(0)
    h0 = torch.randn((cs.B, cs.H), generator=gen, device=dev) * 0.3
    x1 = torch.rand((cs.N_WIN, cs.B, cs.H), generator=gen, device=dev) * 2 - 1
    w1 = cs._weights(torch, gen, dev, cs.H, cs.H)
    frames = torch.randn((cs.B, cs.T, cs.C), generator=gen, device=dev).to(
        torch.bfloat16).transpose(0, 1)
    w0 = cs._weights(torch, gen, dev, cs.WIN * cs.C, cs.H)
    xb = torch.rand((cs.S2S_TC, cs.S2S_B, cs.S2S_F), generator=gen,
                    device=dev) * 2 - 1
    hb = [torch.randn((cs.S2S_B, cs.S2S_H), generator=gen, device=dev) * 0.3
          for _ in range(2)]
    wb = (cs._weights(torch, gen, dev, cs.S2S_F, cs.S2S_H)
          + cs._weights(torch, gen, dev, cs.S2S_F, cs.S2S_H))
    with torch.no_grad():
        res = {"phase": "kernels", "gru_bifwd_ms": cs.cuda_ms(
                   torch, lambda: gru.gru_bifwd_cuda(xb, *hb, *wb), 7),
               "gru_fwd_ms": cs.cuda_ms(
                   torch, lambda: gru.gru_fwd_cuda(x1, h0, *w1), 7),
               "gru_wfwd_ms": cs.cuda_ms(torch, lambda: gru.gru_wfwd_cuda(
                   frames, h0, *w0, cs.WIN, cs.STRIDE), 7)}
    print(json.dumps(res), flush=True)
if "alignment" in phases:
    import json
    from cross_patient_speech_decoding_tpu_torch.ops import cca, jacobi
    align = cs.phase_alignment(torch, dev, jacobi)
    cs.phase_kernel_jacobi(torch, dev, jacobi, align)
    # the kernel alone: 20 launches back to back a timed run (the parent's
    # chip_smoke.cuda_ms times one call)
    import inspect
    res = {"phase": "jacobi_kernel_20_launches"}
    # the wrapper took the pair table before the kernel formed it itself
    table = "pairs" in inspect.signature(jacobi.jacobi_eigh_cuda).parameters
    for name in ("chol_128", "gram_256"):
        A = align[name]
        args = (jacobi._pairs_on(A.shape[-1], A.device),) if table else ()
        res[f"{name}_ms"] = cs.cuda_ms(torch, lambda: [
            jacobi.jacobi_eigh_cuda(A, *args) for _ in range(20)], 7) / 20
    print(json.dumps(res), flush=True)
    del align
    xa, xb, ids_t, _ = cs._alignment_data(torch, dev)
    import time
    from torch.profiler import ProfilerActivity, profile
    for method in ("chol", "gram"):
        def fit():
            return cca.fit_cca_aligner(xa, xb, ids_t, ids_t, cs.AL_C,
                                       method=method, t_len=cs.AL_T)
        _, prof = cs.profile_call(torch, fit)
        # the host's time to enqueue one fit (no synchronize inside)
        enqueue = []
        for _ in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fit()
            enqueue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        # the device's timeline of one fit: kernels in order, the idle gaps
        with profile(activities=[ProfilerActivity.CUDA]) as p:
            fit()
            torch.cuda.synchronize()
        ks = sorted((e.time_range.start, e.time_range.end, e.name)
                    for e in p.events() if e.device_type.name == "CUDA")
        gaps = sorted(((b[0] - a[1], cs._kernel_name(a[2]),
                        cs._kernel_name(b[2])) for a, b in zip(ks, ks[1:])),
                      reverse=True)
        print(json.dumps({
            "phase": "profile_fit", "method": method, **prof,
            "enqueue_ms": sorted(enqueue),
            "span_us": ks[-1][1] - ks[0][0] if ks else None,
            "kernels": len(ks),
            "busy_us": sum(e - b for b, e, _ in ks),
            "gaps_us_top": [[round(g, 1), a, b] for g, a, b in gaps[:6]],
            "jacobi_at_us": [round(b - ks[0][0], 1) for b, _, n in ks
                             if "jacobi" in n]}), flush=True)
"""
AB_PHASES = ("ctc", "streaming", "seq2seq", "kernels", "alignment")


def ab_summary(runs) -> list:
    """The alignment fits of ``ab`` runs (``runs``: each run's lines as
    dicts, its turns numbered from 0): for each method and checkout the
    median, quartiles and range of the fit's ms, and the pairs of
    adjacent turns (2i, 2i+1: one from each checkout) in which the
    second turn's checkout (this one) was faster."""
    out = []
    fits = [[o for o in run if o.get("phase") == "alignment"] for run in runs]
    methods = sorted({m for run in fits for o in run for m in o["methods"]})
    for method in methods:
        ms, wins, pairs = {}, 0, 0
        for run in fits:
            by_turn = {o["turn"]: o for o in run}
            for o in run:
                ms.setdefault(o["checkout"], []).append(
                    o["methods"][method]["fit_ms"])
            for t in range(0, max(by_turn, default=-1), 2):
                a, b = by_turn.get(t), by_turn.get(t + 1)
                if a and b and a["checkout"] != b["checkout"]:
                    pairs += 1
                    # turns run DIR, this, this, DIR
                    this, other = (a, b) if t % 4 == 2 else (b, a)
                    wins += (this["methods"][method]["fit_ms"]
                             < other["methods"][method]["fit_ms"])
        stats = {}
        for root, v in ms.items():
            q = statistics.quantiles(v, n=4) if len(v) > 1 else [v[0]] * 3
            stats[root] = {"n": len(v), "median": statistics.median(v),
                           "quartiles": [q[0], q[2]],
                           "range": [min(v), max(v)]}
        out.append({"phase": "ab_summary", "method": method,
                    "fit_ms": stats, "pairs": pairs,
                    "pairs_this_faster": wins})
    # the Jacobi kernel's times: the kernel phase's row (``ms``; one call
    # a timing before the kernel's redesign, 20 after, and ``ms_one_call``
    # since) and the 20-launch timing that every turn makes
    times = {}
    for run in runs:
        for o in run:
            if o.get("phase") == "kernel" and "sweeps_run" in o:
                shape = "x".join(map(str, o["shape"]))
                for f in ("ms", "ms_one_call"):
                    if f in o:
                        times.setdefault(o["checkout"], {}).setdefault(
                            f"{shape} {f}", []).append(o[f])
            elif o.get("phase") == "jacobi_kernel_20_launches":
                for f in ("chol_128_ms", "gram_256_ms"):
                    times.setdefault(o["checkout"], {}).setdefault(
                        f"20 launches {f}", []).append(o[f])
    if times:
        out.append({"phase": "ab_summary", "jacobi_kernel_ms": {
            root: {k: {"median": statistics.median(v),
                       "range": [min(v), max(v)]} for k, v in t.items()}
            for root, t in times.items()}})
    return out


def probe_ab(against: str, phases: str, repeats: int) -> None:
    import os

    _card()
    here = Path(__file__).resolve().parents[1]
    other = Path(against).resolve()
    turns = [other, here, here, other] * repeats
    lines = []
    for turn, root in enumerate(turns):
        env = {**os.environ, "PYTHONPATH": str(root)}
        proc = subprocess.run([sys.executable, "-c", _AB_TURN, phases],
                              cwd=root, env=env, capture_output=True,
                              text=True)
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                obj = json.loads(line)
                for key in ("step_s_runs", "decode_matches_cpu"):
                    obj.pop(key, None)
                lines.append({"turn": turn, "checkout": str(root), **obj})
                _emit(lines[-1])
        if proc.returncode != 0:
            raise SystemExit(f"turn {turn} in {root} failed:\n"
                             f"{proc.stderr[-4000:]}")
    for obj in ab_summary([lines]):
        _emit(obj)


def _settings():
    m = torch.backends.cuda.matmul
    out = []
    for get in (lambda: m.fp32_precision, lambda: m.allow_tf32,
                torch.get_float32_matmul_precision):
        try:
            out.append(str(get()))
        except RuntimeError:
            out.append("raises")
    return out


def probe_tf32() -> None:
    dev = _card()
    m = torch.backends.cuda.matmul
    gen = torch.Generator(device=dev).manual_seed(0)
    A = torch.randn(1024, 1024, generator=gen, device=dev)
    B = torch.randn(1024, 1024, generator=gen, device=dev)
    ref = A.double() @ B.double()
    callers = {
        "default": lambda: None,
        "legacy_allow_tf32": lambda: setattr(m, "allow_tf32", True),
        "legacy_precision_high": lambda: torch.set_float32_matmul_precision(
            "high"),
        "new_api_tf32": lambda: setattr(m, "fp32_precision", "tf32"),
    }
    for name, setup in callers.items():
        torch.set_float32_matmul_precision("highest")
        m.fp32_precision = "ieee"
        setup()
        before = _settings()
        plain = float((A @ B - ref).abs().max())
        hdot = float((precision.hdot(A, B) - ref).abs().max())
        _emit({"caller": name, "settings_before": before,
               "settings_after": _settings(), "plain_err": plain,
               "hdot_err": hdot})


def probe_oracle(n_pairs: int, seed: int) -> None:
    import chip_smoke as cs

    torch.set_num_threads(4)
    N, T, K, C, lat = cs.AL_N, cs.AL_T, cs.AL_K, cs.AL_C, cs.AL_LAT
    rng = np.random.default_rng(0)
    latent = rng.normal(size=(C, T, lat)).astype(np.float32)
    ids = np.repeat(np.arange(C), N // C + 1)[:N].astype(np.int32)
    lat_t = torch.from_numpy(latent[ids])
    gen = torch.Generator().manual_seed(seed)

    def view():
        mixes = torch.randn((n_pairs, lat, K), generator=gen)
        noise = 0.3 * torch.randn((n_pairs, N, T, K), generator=gen)
        x = torch.einsum("ntl,blk->bntk", lat_t, mixes) + noise
        return x.reshape(n_pairs, N, T * K)

    xa, xb = view(), view()
    ids_t = torch.from_numpy(np.tile(ids, (n_pairs, 1)))
    svd_small = cca._svd_small
    # the card's route on CPU tensors: plain Jacobi, Gram-route SVD
    jacobi._route = lambda A: "plain"
    cca._svd_small = lambda g, method, force_gram=None: svd_small(
        g, method, force_gram=method == "gram")
    fits = {m: cca.fit_cca_aligner(xa, xb, ids_t, ids_t, C, method=m,
                                   t_len=T) for m in ("chol", "gram", "svd")}
    for i in range(n_pairs):
        a, b = (x[i].reshape(N, T, K).double().numpy() for x in (xa, xb))
        proj_o, s_o, cond = cs._oracle_fit(a, b, ids, ids)
        want = b @ proj_o
        res = {"pair": i, "oracle_min_canon_corr": float(s_o.min()),
               "gram_cond": float(cond)}
        for method, fit in fits.items():
            al = fit.alignment
            corr = np.abs(al.canon_corrs[i].double().numpy()[:len(s_o)] - s_o)
            err = np.abs(b @ al.proj_b_to_a[i].double().numpy() - want).max()
            res[method] = {"d": int(al.d[i]), "d_oracle": len(s_o),
                           "corr_max_abs_err": float(corr.max()),
                           "transform_max_rel_err":
                               float(err / np.abs(want).max())}
        _emit(res)


def probe_sweep() -> None:
    """The route sweeps of ``fwd`` and ``bwd`` alone."""
    _card()
    _ext.build()
    for kind, source in (("fwd", "gru_fwd.cu"), ("bwd", "gru_bwd.cu")):
        _route_sweep(kind, source)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("probe",
                    choices=("jacobi", "route", "bifwd", "bwd", "fwd",
                             "sweep", "tf32", "ab", "oracle"))
    ap.add_argument("--against", help="ab: the other checkout")
    ap.add_argument("--phases", default=",".join(AB_PHASES),
                    help="ab: comma-separated, of " + ", ".join(AB_PHASES))
    ap.add_argument("--summary", nargs="+", metavar="FILE",
                    help="ab: summarise the output of earlier runs")
    ap.add_argument("--repeats", type=int, default=1,
                    help="ab: how many times the turns DIR, this, this, "
                         "DIR run")
    ap.add_argument("--cases", help="fwd: comma-separated cases")
    ap.add_argument("--variants", help="fwd: comma-separated variants "
                                       "(the default runs last always)")
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if args.probe == "jacobi":
        probe_jacobi()
    elif args.probe == "route":
        probe_route()
    elif args.probe == "bifwd":
        probe_bifwd()
    elif args.probe == "bwd":
        probe_bwd()
    elif args.probe == "fwd":
        probe_fwd(*(None if a is None else a.split(",")
                    for a in (args.cases, args.variants)))
    elif args.probe == "sweep":
        probe_sweep()
    elif args.probe == "tf32":
        probe_tf32()
    elif args.probe == "ab" and args.summary:
        runs = [[json.loads(line) for line in Path(f).read_text().splitlines()
                 if line.startswith("{")] for f in args.summary]
        for obj in ab_summary(runs):
            _emit(obj)
    elif args.probe == "ab":
        if not args.against:
            ap.error("ab needs --against DIR")
        if not set(args.phases.split(",")) <= set(AB_PHASES):
            ap.error(f"--phases takes {AB_PHASES}")
        probe_ab(args.against, args.phases, args.repeats)
    else:
        probe_oracle(args.pairs, args.seed)


if __name__ == "__main__":
    main()
