"""Port CTC training against the JAX package's: loss gradient, optimizer,
train steps, fit, dropout and checkpoints.

Inputs and initial parameters are made once (numpy, flax init) and given
to both packages (``realtime_rnn_params_from_flax``). The JAX model runs
its Pallas kernel path in interpret mode, forced on as
tests/test_torch_realtime_rnn.py does, so both sides round the layer-0
frames to bf16 and accumulate in float32. Tolerances are stated at each
comparison.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cross_patient_speech_decoding_tpu.ops.pallas_gru as pg
from cross_patient_speech_decoding_tpu.models import RealtimeRNN as JaxRNN
from cross_patient_speech_decoding_tpu.ops import ctc as jctc
from cross_patient_speech_decoding_tpu.train import (
    create_train_state as jax_create_state,
)
from cross_patient_speech_decoding_tpu.train import loops as jloops
from cross_patient_speech_decoding_tpu.train.steps import (
    make_ctc_eval_step as jax_eval_step,
)
from cross_patient_speech_decoding_tpu.train.steps import (
    make_ctc_train_step as jax_train_step,
)
from cross_patient_speech_decoding_tpu_torch.models import (
    RealtimeRNN,
    realtime_rnn_params_from_flax,
)
from cross_patient_speech_decoding_tpu_torch.ops import ctc
from cross_patient_speech_decoding_tpu_torch.train import (
    create_train_state,
    fit,
    load_checkpoint,
    make_ctc_eval_step,
    make_ctc_train_step,
    make_optimizer,
    save_checkpoint,
)
from cross_patient_speech_decoding_tpu_torch.train.loops import (
    append_metrics,
    clip_by_global_norm_,
)

torch.set_num_threads(2)

KW = dict(hidden=32, n_layers=3, n_classes=7, win_size=6, stride=2)
B, T, C, L = 8, 40, 5, 4


@pytest.fixture
def jax_kernel_path(monkeypatch):
    monkeypatch.setattr(pg, "enabled", lambda: True)
    monkeypatch.setattr(pg, "worthwhile", lambda B, T: True)


def _pair(dropout=0.0, seed=0):
    jm = JaxRNN(input_grad=False, dropout=dropout, **KW)
    probe = jnp.zeros((1, 4 * KW["win_size"], C), jnp.float32)
    params = jm.init({"params": jax.random.key(seed)}, probe, True)
    tm = _port_model(dropout)
    tm.load_state_dict(realtime_rnn_params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, tm


def _port_model(dropout=0.0, seed=0):
    return RealtimeRNN(C, KW["hidden"], KW["n_layers"], KW["n_classes"],
                       dropout=dropout, win_size=KW["win_size"],
                       stride=KW["stride"], seed=seed, device="cpu")


def _batch(n=B, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, T, C)).astype(np.float32)
    labels = rng.integers(1, KW["n_classes"], size=(n, L)).astype(np.int32)
    il = rng.integers(30, T + 1, size=n).astype(np.int32)
    ll = rng.integers(1, L + 1, size=n).astype(np.int32)
    return x, labels, il, ll


def _flat(params):
    flat = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    return {".".join(p.key for p in path): np.asarray(v) for path, v in flat}


# ---------------------------------------------------------------- CTC loss --


@pytest.mark.parametrize("weighted", [False, True])
def test_ctc_loss_grads_match_jax_grad(weighted):
    """F.ctc_loss's backward against jax.grad of the JAX ctc_loss_mean, with
    one infeasible row (more labels than frames: zeroed, no gradient) and
    with sample weights. float32 both sides: atol 1e-6 on the logits'
    gradient (entries up to ~0.1)."""
    rng = np.random.default_rng(11)
    n, Tl, V, Ll = 6, 12, 5, 4
    logits = (rng.normal(size=(n, Tl, V)) * 2).astype(np.float32)
    labels = rng.integers(1, V, size=(n, Ll)).astype(np.int32)
    il = np.array([12, 10, 3, 12, 8, 11], np.int32)  # row 2 infeasible
    ll = np.array([4, 3, 4, 2, 1, 4], np.int32)
    w = np.array([1.0, 0.5, 2.0, 0.0, 1.0, 3.0], np.float32)
    wj = jnp.asarray(w) if weighted else None
    loss_j, g_j = jax.value_and_grad(
        lambda lg: jctc.ctc_loss_mean(lg, jnp.asarray(il), jnp.asarray(labels),
                                      jnp.asarray(ll), 0, wj))(
        jnp.asarray(logits))
    lt = torch.tensor(logits, requires_grad=True)
    wt = torch.from_numpy(w) if weighted else None
    loss = ctc.ctc_loss_mean(lt, torch.from_numpy(il),
                             torch.from_numpy(labels), torch.from_numpy(ll),
                             0, wt)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5)
    g = lt.grad.numpy()
    np.testing.assert_allclose(g, np.asarray(g_j), atol=1e-6)
    assert np.all(g[2] == 0.0)  # the infeasible row
    assert np.abs(g[[0, 1, 4, 5]]).max() > 1e-3


# --------------------------------------------------------------- optimizer --


@pytest.mark.parametrize("clip", [None, 0.5])
def test_optimizer_matches_optax(clip):
    """5 updates of fixed gradients, decay over 3 steps (the schedule is
    crossed and then held), clipping off and on (the global norm of these
    gradients is ~3, above 0.5). float32 both sides, with the decay and the
    Adam step applied in another order (torch scales p by 1 - lr*wd first,
    optax adds both updates): atol 5e-7, a few ulps of |p| <= 2."""
    rng = np.random.default_rng(12)
    p0 = {"a": rng.normal(size=(4, 3)).astype(np.float32),
          "b": rng.normal(size=(3,)).astype(np.float32)}
    grads = [{k: (rng.normal(size=v.shape) * s).astype(np.float32)
              for k, v in p0.items()} for s in (1.0, 2.0, 0.1, 1.5, 0.5)]
    tx_j = jloops.make_optimizer(1e-2, 1e-1, 3, end_factor=0.2, clip=clip)
    pj = {k: jnp.asarray(v) for k, v in p0.items()}
    sj = tx_j.init(pj)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in p0.items()}
    tx = make_optimizer(1e-2, 1e-1, 3, end_factor=0.2, clip=clip)
    opt, sched = tx.init(params.values())
    for i, g in enumerate(grads):
        upd, sj = tx_j.update({k: jnp.asarray(v) for k, v in g.items()}, sj,
                              pj)
        pj = jax.tree_util.tree_map(lambda a, u: a + u, pj, upd)
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k].copy())
        if clip is not None:
            clip_by_global_norm_([p.grad for p in params.values()], clip)
        opt.step()
        sched.step()
        for k, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(pj[k]),
                                       atol=5e-7, err_msg=f"{k} step {i}")
    assert tx.factor(0) == 1.0 and tx.factor(3) == tx.factor(9) == 0.2


def test_clip_leaves_small_gradients_alone():
    g = [torch.tensor([0.3, 0.0]), torch.tensor([0.4])]
    clip_by_global_norm_(g, 0.6)  # norm 0.5 < 0.6
    assert torch.equal(g[0], torch.tensor([0.3, 0.0]))
    clip_by_global_norm_(g, 0.25)  # norm 0.5: scaled by 0.25/0.5
    torch.testing.assert_close(torch.cat(g), torch.tensor([0.15, 0.0, 0.2]))


# -------------------------------------------------------------- train step --


def test_three_train_steps_match_jax(jax_kernel_path):
    """3 steps at dropout 0 from the same parameters, with clipping. The
    loss agrees to rtol 1e-5 at every step; every parameter after every
    step to atol 2e-6 (float32 gradients through the interpret-mode Pallas
    kernels and the port's plain backward, then AdamW, whose first steps
    move each entry by about lr = 1e-3)."""
    jm, params, tm = _pair()
    tx_j = jloops.make_optimizer(1e-3, 1e-5, 2, clip=5.0)
    state_j = jax_create_state(jm, params, tx_j)
    step_j = jax.jit(jax_train_step(jm, tx_j))
    tx = make_optimizer(1e-3, 1e-5, 2, clip=5.0)
    state = create_train_state(tm, tx)
    step = make_ctc_train_step(tm, tx)
    batch = _batch()
    bj = tuple(jnp.asarray(a) for a in batch)
    bt = tuple(torch.from_numpy(a) for a in batch)
    for i in range(3):
        state_j, mj = step_j(state_j, bj, jax.random.key(i))
        state, m = step(state, bt, None)
        np.testing.assert_allclose(float(m["loss"]), float(mj["loss"]),
                                   rtol=1e-5)
        want = _flat({"params": state_j.params})
        got = tm.state_dict()
        assert set(got) == set(want)
        for name, v in want.items():
            np.testing.assert_allclose(got[name].numpy(), v, atol=2e-6,
                                       err_msg=f"{name} after step {i}")
    assert state.step == 3 and int(state_j.step) == 3


def _train(dropout, gen_seed, n_steps=2, tm=None):
    tm = tm or _port_model(dropout)
    tx = make_optimizer(1e-3, 1e-5, 100)
    state = create_train_state(tm, tx)
    step = make_ctc_train_step(tm, tx)
    gen = torch.Generator().manual_seed(gen_seed)
    bt = tuple(torch.from_numpy(a) for a in _batch())
    losses = [float(step(state, bt, gen)[1]["loss"]) for _ in range(n_steps)]
    return losses, tm.state_dict()


def test_dropout_repeats_with_its_generator():
    """The same generator seed gives the same steps twice, bitwise; another
    seed gives other losses and parameters; no dropout differs from both."""
    la, sa = _train(0.3, 5)
    lb, sb = _train(0.3, 5)
    lc, sc = _train(0.3, 6)
    l0, _ = _train(0.0, 5)
    assert la == lb and all(torch.equal(sa[k], sb[k]) for k in sa)
    assert la[0] != lc[0] and not torch.equal(sa["rnn.fwd0.wi"],
                                              sc["rnn.fwd0.wi"])
    assert la[0] != l0[0]


def test_dropout_mask_statistics_and_eval_mode():
    """Between layers, flax's dropout: a kept share of 1 - p, kept values
    scaled by 1/(1 - p); off in eval mode."""
    from cross_patient_speech_decoding_tpu_torch.models.layers import _dropout

    x = torch.ones(200, 500)
    gen = torch.Generator().manual_seed(0)
    y = _dropout(x, 0.3, gen)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.01
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.7))
    tm = _port_model(0.5).eval()
    xb = torch.from_numpy(_batch()[0])
    with torch.no_grad():
        assert torch.equal(tm(xb, torch.Generator().manual_seed(1)),
                           tm(xb, torch.Generator().manual_seed(2)))


# --------------------------------------------------------------------- fit --


def test_fit_history_and_best_epoch_match_jax(jax_kernel_path):
    """fit at dropout 0 with mini-batches (batch_size < n, the same numpy
    permutations on both sides): per-epoch val loss to rtol 1e-4, PER
    exactly, the same best epoch; the best state is a copy."""
    jm, params, tm = _pair(seed=1)
    train = _batch(n=12, seed=2)
    val = _batch(n=6, seed=3)
    tx_j = jloops.make_optimizer(3e-2, 1e-5, 100)
    res_j = jloops.fit(
        jax_create_state(jm, params, tx_j), jax_train_step(jm, tx_j),
        jax_eval_step(jm), tuple(jnp.asarray(a) for a in train),
        tuple(jnp.asarray(a) for a in val), epochs=3, key=jax.random.key(0),
        batch_size=5, seed=4)
    tx = make_optimizer(3e-2, 1e-5, 100)
    state = create_train_state(tm, tx)
    res = fit(state, make_ctc_train_step(tm, tx), make_ctc_eval_step(tm),
              tuple(torch.from_numpy(a) for a in train),
              tuple(torch.from_numpy(a) for a in val), epochs=3,
              batch_size=5, seed=4)
    assert [h["epoch"] for h in res.history] == [0, 1, 2]
    for h, hj in zip(res.history, res_j.history):
        np.testing.assert_allclose(h["loss"], hj["loss"], rtol=1e-4)
        assert h["per"] == pytest.approx(hj["per"], abs=1e-6)
    assert res.best_epoch == res_j.best_epoch
    assert res.best_metric == pytest.approx(res_j.best_metric, rel=1e-4)
    assert res.best_state.step == 3 * (res.best_epoch + 1)
    assert res.best_state.model is not tm


def test_append_metrics_formats(tmp_path):
    rec = {"epoch": 0, "loss": 1.5, "per": 0.25}
    append_metrics(str(tmp_path / "m.csv"), rec)
    append_metrics(str(tmp_path / "m.csv"), {**rec, "epoch": 1})
    lines = (tmp_path / "m.csv").read_text().splitlines()
    assert lines == ["epoch,loss,per", "0,1.5,0.25", "1,1.5,0.25"]
    append_metrics(str(tmp_path / "m.jsonl"), rec, "jsonl")
    assert json.loads((tmp_path / "m.jsonl").read_text()) == rec
    append_metrics(str(tmp_path / "tb"), rec, "tb")
    append_metrics(str(tmp_path / "tb"), {**rec, "epoch": 1}, "tb")
    (ev,) = (tmp_path / "tb").glob("events.out.tfevents.*")
    data = ev.read_bytes()
    assert b"brain.Event:2" in data and b"per" in data
    with pytest.raises(ValueError, match="log_format"):
        append_metrics(str(tmp_path / "x"), rec, "xml")


# -------------------------------------------------------------- checkpoint --


def test_checkpoint_round_trip_is_bitwise(tmp_path):
    """2 steps, save, load into a fresh state, 1 step equals 3 steps
    straight, bitwise on the CPU (dropout on, the generator's state carried
    by the caller)."""
    bt = tuple(torch.from_numpy(a) for a in _batch())
    tx = make_optimizer(1e-3, 1e-5, 2)

    def run(tm, n, gen, state=None):
        state = state or create_train_state(tm, tx)
        step = make_ctc_train_step(tm, tx)
        for _ in range(n):
            state, m = step(state, bt, gen)
        return state, m

    gen = torch.Generator().manual_seed(3)
    straight, m3 = run(_port_model(0.3), 3, gen)

    gen = torch.Generator().manual_seed(3)
    state, _ = run(_port_model(0.3), 2, gen)
    path = tmp_path / "ck" / "state.pt"
    save_checkpoint(str(path), state, {"epoch": 1})
    assert json.loads((tmp_path / "ck" / "state.pt.meta.json").read_text()) \
        == {"epoch": 1}
    fresh = create_train_state(_port_model(0.3, seed=9), tx)
    loaded = load_checkpoint(str(path), fresh)
    assert loaded.step == 2
    resumed, m1 = run(loaded.model, 1, gen, loaded)
    assert resumed.step == straight.step == 3
    assert torch.equal(m1["loss"], m3["loss"])
    a, b = straight.model.state_dict(), resumed.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert resumed.schedule.get_last_lr() == straight.schedule.get_last_lr()
