"""The port's spans (``utils/profiling.py:annotate``): off, on under a
profiler and inside ``recording()``, the tree each hot path records, the
store's bound, and the spans' clock against the profiler's events.

The file imports neither JAX nor the JAX package. Its one card test
(marked ``gpu``) runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_tracing.py --noconftest -m gpu
"""

import math
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cross_patient_speech_decoding_tpu_torch.models import (
    RealtimeRNN,
    Seq2SeqRNN,
)
from cross_patient_speech_decoding_tpu_torch.ops import gru, jacobi
from cross_patient_speech_decoding_tpu_torch.realtime import (
    init_realtime_state,
    make_realtime_step,
)
from cross_patient_speech_decoding_tpu_torch.train import (
    create_train_state,
    fit,
    make_classifier_eval_step,
    make_classifier_train_step,
    make_ctc_eval_step,
    make_ctc_train_step,
    make_optimizer,
    make_seq2seq_eval_step,
    make_seq2seq_train_step,
)
from cross_patient_speech_decoding_tpu_torch.train.fold_parallel import (
    make_seq2seq_fold_trainer_fn,
)
from cross_patient_speech_decoding_tpu_torch.utils import profiling

C, H, NL, NCLS, WIN, STRIDE, T, L = 4, 8, 3, 5, 6, 2, 30, 3
N_WIN = (T - WIN) // STRIDE + 1
KERNELS = set(gru.LAUNCHES)


@pytest.fixture(autouse=True)
def fresh_store():
    profiling.reset()
    yield
    profiling.reset()


def _ctc_model(device="cpu"):
    return RealtimeRNN(C, H, NL, NCLS, dropout=0.0, win_size=WIN,
                       stride=STRIDE, seed=0, device=device)


def _ctc_batch(n=5, device="cpu", seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, T, C), generator=g)
    labels = torch.randint(1, NCLS, (n, L), generator=g, dtype=torch.int32)
    il = torch.full((n,), T, dtype=torch.int32)
    ll = torch.full((n,), L, dtype=torch.int32)
    return tuple(t.to(device) for t in (x, labels, il, ll))


def _s2s_model(device="cpu"):
    return Seq2SeqRNN(C, 6, H, NCLS, kernel_size=3, cnn_dropout=0.0,
                      rnn_dropout=0.0, seed=0, device=device)


def _s2s_batch(n=5, device="cpu"):
    g = torch.Generator().manual_seed(1)
    return (torch.randn((n, 12, C), generator=g).to(device),
            torch.randint(0, NCLS, (n, 3), generator=g).to(device))


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, profiling.spans()


def _children(recs, parent):
    return [r for r in recs if r["parent"] == parent["id"]]


def _one(recs, name):
    got = [r for r in recs if r["name"] == name]
    assert len(got) == 1, (name, [r["name"] for r in recs])
    return got[0]


def _check_step(recs, root_name, phases):
    """The one step rooted at ``root_name``: its phases as its children,
    every span of the step carrying the root's id as its step; returns
    (root, {phase: record})."""
    root = _one(recs, root_name)
    assert root["parent"] is None and root["step"] == root["id"]
    kids = _children(recs, root)
    assert [r["name"] for r in kids] == phases
    assert all(r["step"] == root["id"] for r in recs)
    for r in recs:
        assert r["start_ns"] <= r["end_ns"]
    return root, {r["name"]: r for r in kids}


def _kernels(recs, parent):
    return [r for r in _children(recs, parent) if r["name"] in KERNELS]


def test_off_returns_the_shared_noop_and_records_nothing(monkeypatch):
    def no_range(*_):
        raise AssertionError("record_function opened while off")

    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    first = profiling.annotate("x", rows=3)
    assert first is profiling.annotate("y", device=torch.device("cpu"))
    with first as inside:
        assert inside is None
    step = make_ctc_train_step(_ctc_model(), make_optimizer(1e-3, 0.0, 10))
    step(create_train_state(_ctc_model(), make_optimizer(1e-3, 0.0, 10)),
         _ctc_batch())
    assert profiling.spans() == []


def test_ctc_train_step_records_its_tree():
    model = _ctc_model()
    tx = make_optimizer(1e-3, 1e-4, 10, clip=5.0)
    state = create_train_state(model, tx)
    step = make_ctc_train_step(model, tx)
    _, recs = _profiled(lambda: step(state, _ctc_batch()))
    root, ph = _check_step(recs, "train_step",
                           ["forward", "loss", "backward", "update"])
    assert root["attrs"] == {"rows": 5}
    fwd = _kernels(recs, ph["forward"])
    assert [r["name"] for r in fwd] == ["gru_wfwd"] + ["gru_fwd"] * (NL - 1)
    w = fwd[0]["attrs"]
    assert w == {"T": N_WIN, "B": 5, "F": WIN * C, "H": H,
                 "x_bytes": T * 5 * C * 2, "need_dx": False,
                 "directions": 1, "route": "plain"}
    for r in fwd[1:]:
        assert r["attrs"] == {"T": N_WIN, "B": 5, "F": H, "H": H,
                              "x_bytes": N_WIN * 5 * H * 4, "need_dx": True,
                              "directions": 1, "route": "plain"}
    bwd = _kernels(recs, ph["backward"])
    assert sorted(r["name"] for r in bwd) == \
        ["gru_bwd"] * (NL - 1) + ["gru_wbwd"]
    assert all(r["step"] == root["id"] and r["device_ms"] is None
               for r in fwd + bwd)
    assert _one(bwd, "gru_wbwd")["attrs"]["need_dx"] is False


def test_ctc_eval_step_records_its_tree():
    model = _ctc_model()
    step = make_ctc_eval_step(model)
    _, recs = _profiled(lambda: step(_ctc_batch()))
    _, ph = _check_step(recs, "eval_step",
                        ["forward", "loss", "decode", "per"])
    fwd = _kernels(recs, ph["forward"])
    assert [r["name"] for r in fwd] == ["gru_wfwd"] + ["gru_fwd"] * (NL - 1)
    assert not any(r["attrs"]["need_dx"] for r in fwd)


def test_two_steps_carry_two_step_ids():
    model = _ctc_model()
    tx = make_optimizer(1e-3, 1e-4, 10)
    state = create_train_state(model, tx)
    step = make_ctc_train_step(model, tx)

    def two():
        step(state, _ctc_batch(seed=0))
        step(state, _ctc_batch(seed=1))

    _, recs = _profiled(two)
    roots = [r for r in recs if r["name"] == "train_step"]
    assert len(roots) == 2
    by_step = Counter(r["step"] for r in recs)
    assert set(by_step) == {r["id"] for r in roots}
    assert by_step[roots[0]["id"]] == by_step[roots[1]["id"]]


def test_seq2seq_train_and_eval_steps_record_their_tree():
    model = _s2s_model()
    tx = make_optimizer(1e-3, 1e-5, 10, clip=0.5)
    state = create_train_state(model, tx)
    step = make_seq2seq_train_step(model, tx, teacher_forcing=0.5)
    g = torch.Generator().manual_seed(0)
    _, recs = _profiled(lambda: step(state, _s2s_batch(), g))
    root, ph = _check_step(recs, "train_step",
                           ["forward", "loss", "backward", "update"])
    fwd = _kernels(recs, ph["forward"])
    assert [r["name"] for r in fwd] == ["gru_bifwd"] + ["gru_fwd"] * 3
    bi = fwd[0]["attrs"]
    assert bi["directions"] == 2 and bi["T"] == 12 - 3 + 1 and \
        bi["F"] == 6 and bi["H"] == H and bi["route"] == "plain"
    assert all(r["attrs"]["T"] == 1 and r["attrs"]["directions"] == 1
               for r in fwd[1:])
    bwd = _kernels(recs, ph["backward"])
    assert [r["name"] for r in bwd] == ["gru_bwd"] * 5
    assert all(r["step"] == root["id"] for r in bwd)

    profiling.reset()
    _, recs = _profiled(lambda: make_seq2seq_eval_step(model)(_s2s_batch()))
    _check_step(recs, "eval_step", ["forward", "loss"])


def test_classifier_steps_record_their_tree():
    from cross_patient_speech_decoding_tpu_torch.models import (
        TCNClassifier,
    )

    model = TCNClassifier(C, 4, NCLS, kernel_size=3, seed=0, device="cpu")
    tx = make_optimizer(1e-3, 1e-5, 10)
    state = create_train_state(model, tx)
    x = torch.randn(6, 12, C)
    y = torch.randint(0, NCLS, (6,))
    _, recs = _profiled(
        lambda: make_classifier_train_step(model, tx)(state, (x, y)))
    _check_step(recs, "train_step",
                ["forward", "loss", "backward", "update"])
    profiling.reset()
    _, recs = _profiled(lambda: make_classifier_eval_step(model)((x, y)))
    _check_step(recs, "eval_step", ["forward", "loss"])


def test_realtime_step_records_dsp_ring_and_gru_step_on_gru_bins():
    from scipy.signal import butter

    model = _ctc_model()
    model.eval()
    b, a = butter(2, [0.3, 0.6], btype="band")
    b, a = np.stack([b]), np.stack([a])
    state = init_realtime_state(model, b, a, C)
    tb = torch.as_tensor(b, dtype=torch.float32)
    ta = torch.as_tensor(a, dtype=torch.float32)
    step = make_realtime_step(model)
    n = WIN + 2 * STRIDE

    def run():
        nonlocal state
        ran = []
        for _ in range(n):
            state, (_, _, did) = step(state, torch.randn(C, 5), tb, ta)
            ran.append(did)
        return ran

    ran, recs = _profiled(run)
    roots = [r for r in recs if r["name"] == "realtime_step"]
    assert [r["attrs"]["bin"] for r in roots] == list(range(1, n + 1))
    assert sum(ran) == 3
    for root, did in zip(roots, ran):
        mine = [r for r in recs if r["step"] == root["id"]]
        kids = [r["name"] for r in _children(mine, root)]
        assert kids == ["dsp", "ring"] + (["gru_step"] if did else [])
        if did:
            gs = _one(mine, "gru_step")
            assert [r["name"] for r in _kernels(mine, gs)] == \
                ["gru_fwd"] * NL
            assert all(r["attrs"]["T"] == 1 and r["attrs"]["B"] == 1
                       for r in _kernels(mine, gs))


def test_fit_records_epochs_gathers_steps_and_validation():
    model = _ctc_model()
    tx = make_optimizer(1e-3, 1e-4, 10)
    state = create_train_state(model, tx)
    train = _ctc_batch(n=10)
    _, recs = _profiled(lambda: fit(
        state, make_ctc_train_step(model, tx), make_ctc_eval_step(model),
        train, _ctc_batch(n=4, seed=3), epochs=2, batch_size=4, seed=0))
    epochs = [r for r in recs if r["name"] == "epoch"]
    assert [r["attrs"]["epoch"] for r in epochs] == [0, 1]
    for ep in epochs:
        kids = [r["name"] for r in _children(recs, ep)]
        assert kids == ["gather", "train_step"] * 3 + ["validation"]
        val = _one(_children(recs, ep), "validation")
        assert [r["name"] for r in _children(recs, val)] == ["eval_step"]


def test_fold_trainer_records_its_epochs():
    from functools import partial

    trainer = make_seq2seq_fold_trainer_fn(
        partial(Seq2SeqRNN, n_filters=6, hidden=H, num_classes=NCLS,
                kernel_size=3, cnn_dropout=0.0, rnn_dropout=0.0),
        decay_iters=4)
    x, y = _s2s_batch(n=6)
    w = torch.ones(2, 6)
    te = torch.zeros(2, 6)
    te[:, :2] = 1
    _, recs = _profiled(lambda: trainer(x, y, w, te, 0, 2))
    epochs = [r for r in recs if r["name"] == "epoch"]
    assert [(r["attrs"]["fold"], r["attrs"]["epoch"]) for r in epochs] == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    for ep in epochs:
        assert [r["name"] for r in _children(recs, ep)] == ["train_step"]
    assert [r["attrs"]["fold"] for r in recs
            if r["name"] == "validation"] == [0, 1]


def test_kernel_spans_count_the_launches(monkeypatch):
    """With the kernel route taken (the wrappers replaced by counted plain
    versions), a step's kernel spans of route 'cuda' are its LAUNCHES
    deltas, one name for one name, and each carries the weight products
    its call launched by kernel (here two on wgmma, one on mma.sync)."""
    products = {"wgmma": 0, "mma_sync": 0}

    def counted(name, plain):
        def launch(*args, **kw):
            gru.LAUNCHES[name] += 1
            products["wgmma"] += 2
            products["mma_sync"] += 1
            return plain(*args, **kw)
        return launch

    monkeypatch.setattr(gru, "product_counts", lambda: dict(products))

    monkeypatch.setattr(gru, "_route", lambda x: "cuda")
    monkeypatch.setattr(gru, "_batch_major", lambda x: x)
    for name, plain in (("gru_fwd", gru.gru_layer_plain),
                        ("gru_wfwd", gru.gru_layer_windowed_plain),
                        ("gru_bifwd", gru.gru_layer_bidir_plain),
                        ("gru_bwd", gru.gru_backward_plain),
                        ("gru_wbwd", gru.gru_win_backward_plain)):
        monkeypatch.setattr(gru, f"{name}_cuda", counted(name, plain))
    for model, step_of, batch in (
            (_ctc_model(), make_ctc_train_step, _ctc_batch()),
            (_s2s_model(), make_seq2seq_train_step, _s2s_batch())):
        tx = make_optimizer(1e-3, 1e-5, 10)
        state = create_train_state(model, tx)
        gru.reset_launch_counts()
        profiling.reset()
        _, recs = _profiled(lambda: step_of(model, tx)(state, batch))
        got = Counter(r["name"] for r in recs if r["name"] in KERNELS)
        assert all(r["attrs"]["route"] == "cuda" for r in recs
                   if r["name"] in KERNELS)
        assert all((r["attrs"]["wgmma"], r["attrs"]["mma_sync"]) == (2, 1)
                   for r in recs if r["name"] in KERNELS)
        assert got == Counter({k: v for k, v in gru.LAUNCHES.items() if v})


FORWARD = ("gru_fwd", "gru_wfwd", "gru_bifwd")
PLAIN_ATTRS = {"T", "B", "F", "H", "x_bytes", "need_dx", "directions",
               "route"}


def test_plain_forward_spans_carry_no_step_split():
    """The plain route's forward spans keep their attributes as they were:
    no ``step_split``, which only the kernels' spans carry."""
    for model, step_of, batch in (
            (_ctc_model(), make_ctc_train_step, _ctc_batch()),
            (_s2s_model(), make_seq2seq_train_step, _s2s_batch())):
        tx = make_optimizer(1e-3, 1e-5, 10)
        state = create_train_state(model, tx)
        profiling.reset()
        _, recs = _profiled(lambda: step_of(model, tx)(state, batch))
        fwd = [r for r in recs if r["name"] in FORWARD]
        assert fwd and all(r["attrs"]["route"] == "plain" for r in fwd)
        assert all(set(r["attrs"]) == PLAIN_ATTRS for r in fwd)


def _split_counting_route(monkeypatch, fwd_split, bwd_split):
    """The kernel route taken, the wrappers replaced by plain versions
    that count their steps as the libraries do: a forward call's T steps
    as split over ``fwd_split`` CTAs (step_counts), a backward call's T
    steps over ``bwd_split`` (bwd_step_counts), one launch a step."""
    steps = {"fwd": dict.fromkeys(gru.STEP_SPLITS, 0),
             "bwd": dict.fromkeys(gru.BWD_STEP_SPLITS, 0)}

    def counted(name, plain):
        def launch(*args, **kw):
            gru.LAUNCHES[name] += 1
            out = plain(*args, **kw)
            if name in FORWARD:
                n = out[0].shape[0] if name == "gru_bifwd" else out.shape[0]
                steps["fwd"][fwd_split] += n * (2 if name == "gru_bifwd"
                                                else 1)
            else:  # dhs, the third argument, holds the call's T steps
                steps["bwd"][bwd_split] += args[2].shape[0]
            return out
        return launch

    monkeypatch.setattr(gru, "step_counts", lambda: dict(steps["fwd"]))
    monkeypatch.setattr(gru, "bwd_step_counts", lambda: dict(steps["bwd"]))
    monkeypatch.setattr(gru, "_route", lambda x: "cuda")
    monkeypatch.setattr(gru, "_batch_major", lambda x: x)
    for name, plain in (("gru_fwd", gru.gru_layer_plain),
                        ("gru_wfwd", gru.gru_layer_windowed_plain),
                        ("gru_bifwd", gru.gru_layer_bidir_plain),
                        ("gru_bwd", gru.gru_backward_plain),
                        ("gru_wbwd", gru.gru_win_backward_plain)):
        monkeypatch.setattr(gru, f"{name}_cuda", counted(name, plain))
    return steps


def _train_step_spans():
    """A CTC and a seq2seq train step's kernel spans, each step's apart."""
    for model, step_of, batch in (
            (_ctc_model(), make_ctc_train_step, _ctc_batch()),
            (_s2s_model(), make_seq2seq_train_step, _s2s_batch())):
        tx = make_optimizer(1e-3, 1e-5, 10)
        state = create_train_state(model, tx)
        profiling.reset()
        _, recs = _profiled(lambda: step_of(model, tx)(state, batch))
        yield [r for r in recs if r["name"] in KERNELS]


def test_forward_kernel_spans_carry_their_step_split(monkeypatch):
    """With the kernel route taken (the wrappers replaced by plain versions
    that count their steps as split over 4 CTAs in the forward and 16 in
    the backward), each forward kernel span's ``step_split`` is the cluster
    size whose count its call raised; the backward's spans carry the
    backward's (bwd_step_counts), not the forward's."""
    _split_counting_route(monkeypatch, 4, 16)
    for kern in _train_step_spans():
        assert {r["name"] for r in kern} & set(FORWARD)
        for r in kern:
            want = 4 if r["name"] in FORWARD else 16
            assert r["attrs"]["step_split"] == want


@pytest.mark.parametrize("bwd_split", gru.BWD_STEP_SPLITS)
def test_backward_kernel_spans_carry_their_step_split(monkeypatch,
                                                      bwd_split):
    """Each backward kernel span (``gru_bwd``, ``gru_wbwd``, both
    directions' of the bidirectional encoder) carries the cluster size its
    call's steps were launched in, and the backward counter grows by the
    span's T, one launch a step: the spans' T sum to the counter."""
    steps = _split_counting_route(monkeypatch, 2, bwd_split)
    counted = 0
    for kern in _train_step_spans():
        bwd = [r for r in kern if r["name"] in ("gru_bwd", "gru_wbwd")]
        assert len(bwd) >= 2
        assert all(r["attrs"]["step_split"] == bwd_split for r in bwd)
        assert all(r["attrs"]["step_split"] == 2 for r in kern
                   if r["name"] in FORWARD)
        grew = steps["bwd"][bwd_split] - counted
        assert grew == sum(r["attrs"]["T"] for r in bwd) > 0
        counted += grew
    assert all(n == 0 for s, n in steps["bwd"].items() if s != bwd_split)


def test_recording_keeps_records_without_a_profiler_and_is_bounded(
        monkeypatch):
    def no_range(*_):
        raise AssertionError("no range without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    with profiling.recording():
        with profiling.annotate("outer", root=True, k=1):
            with profiling.annotate("inner"):
                pass
    recs = profiling.spans()
    assert [r["name"] for r in recs] == ["outer", "inner"]
    assert recs[1]["parent"] == recs[0]["id"] == recs[1]["step"]
    assert recs[0]["attrs"] == {"k": 1}
    assert profiling.spans() == recs  # not cleared by reading
    assert profiling.annotate("after") is profiling._OFF

    monkeypatch.setattr(profiling, "MAX_SPANS", 5)
    profiling.reset()
    assert profiling.spans() == []
    with profiling.recording():
        for i in range(12):
            with profiling.annotate("s", i=i):
                pass
    assert [r["attrs"]["i"] for r in profiling.spans()] == \
        list(range(7, 12))


def test_other_thread_spans_take_the_step_and_its_open_span():
    import threading

    got = {}

    def worker():
        with profiling.annotate("gru_bwd"):
            pass

    with profiling.recording():
        with profiling.annotate("train_step", root=True) as root:
            with profiling.annotate("backward") as bwd:
                t = threading.Thread(target=worker)
                t.start()
                t.join(timeout=10)
                assert not t.is_alive()
                got["root"], got["bwd"] = root.id, bwd.id
    rec = _one(profiling.spans(), "gru_bwd")
    assert rec["step"] == got["root"] and rec["parent"] == got["bwd"]


def test_span_start_lies_on_the_profilers_clock():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(5):  # the first ranges of a profile start slowly
            with profiling.annotate("cpsd_warm"):
                pass
        with profiling.annotate("cpsd_clock"):
            torch.ones(32, 32).sum()
    span = _one(profiling.spans(), "cpsd_clock")
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "cpsd_clock"]
    assert len(ev) == 1
    assert abs(ev[0].start_ns() - span["start_ns"]) < 50_000
    assert ev[0].start_ns() <= span["start_ns"] <= span["end_ns"] <= \
        ev[0].start_ns() + ev[0].duration_ns()


# ------------------------------------------------------------------ card --


@pytest.mark.gpu
@pytest.mark.parametrize("pairs", [None, 2])
def test_kernel_spans_equal_launches_and_time_the_device_on_the_card(
        monkeypatch, pairs):
    """With the default pool of event pairs, and with a pool of two, which
    a step's kernel spans use up (their pairs come back read)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    dev = torch.device("cuda", 0)
    if pairs is not None:
        monkeypatch.setattr(profiling, "EVENT_PAIRS", pairs)
        monkeypatch.setattr(profiling._REC, "pools", {})
    for model, step_of, batch in (
            (_ctc_model(dev), make_ctc_train_step, _ctc_batch(64, dev)),
            (_s2s_model(dev), make_seq2seq_train_step, _s2s_batch(64, dev))):
        tx = make_optimizer(1e-3, 1e-5, 10)
        state = create_train_state(model, tx)
        step = step_of(model, tx)
        step(state, batch)  # builds and loads the kernels
        torch.cuda.synchronize()
        gru.reset_launch_counts()
        profiling.reset()
        with profiling.recording():
            step(state, batch)
        torch.cuda.synchronize()
        recs = profiling.spans()
        kern = [r for r in recs if r["name"] in KERNELS]
        assert Counter(r["name"] for r in kern) == \
            Counter({k: v for k, v in gru.LAUNCHES.items() if v})
        root = _one(recs, "train_step")
        bwd = _one(recs, "backward")
        for r in kern:
            assert r["attrs"]["route"] == "cuda"
            assert r["step"] == root["id"]
            assert math.isfinite(r["device_ms"]) and r["device_ms"] > 0
            if r["name"] in ("gru_bwd", "gru_wbwd"):
                assert r["parent"] == bwd["id"]
                # K = 3H in two k-tiles ([dr | dz], dgn): one a rank
                assert r["attrs"]["step_split"] == 2
            else:  # H = 8, one k-tile: no split
                assert r["attrs"]["step_split"] == 1
        # the backward's sweeps: one step launch a step of every call
        assert gru.bwd_step_counts() == {
            s: sum(r["attrs"]["T"] for r in kern
                   if r["name"] in ("gru_bwd", "gru_wbwd")) if s == 2 else 0
            for s in gru.BWD_STEP_SPLITS}
    A = torch.randn(3, 8, 8, device=dev)
    A = A @ A.transpose(1, 2)
    jacobi.reset_launch_counts()
    profiling.reset()
    with profiling.recording():
        jacobi.jacobi_eigh_cuda(A.contiguous(), sweeps=6)
    torch.cuda.synchronize()
    rec = _one(profiling.spans(), "jacobi_eigh")
    assert jacobi.LAUNCHES["jacobi_eigh"] == 1
    assert rec["attrs"] == {"batch": 3, "K": 8, "sweeps": 6}
    assert math.isfinite(rec["device_ms"]) and rec["device_ms"] > 0
