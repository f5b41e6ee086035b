"""The port's ``parallel/`` against the JAX package's: the padding and the
sharding helpers, ``make_mesh``'s refusals, the data-parallel CTC and
classifier steps on two gloo ranks on the CPU, the launcher's failure
handling and the multi-rank dry run.

JAX runs its sharded steps on a two-device CPU mesh (``tests/conftest.py``
provisions eight), the port on two ranks that ``parallel.launch`` spawns;
the rank bodies live in ``torch_parallel_ranks.py``, which imports no JAX,
and the ranks check that nothing did. The JAX side's GRU goes through its
Pallas kernels in interpret mode (forced on), so both sides round the
CTC model's layer-0 frames to bf16. Tolerances are stated at each
comparison.
"""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cross_patient_speech_decoding_tpu.models as jmodels
import cross_patient_speech_decoding_tpu.ops.pallas_gru as pg
import torch_parallel_ranks as ranks
from cross_patient_speech_decoding_tpu.parallel import mesh as jmesh
from cross_patient_speech_decoding_tpu.train import (
    create_train_state as jax_create_state,
)
from cross_patient_speech_decoding_tpu.train import loops as jloops
from cross_patient_speech_decoding_tpu_torch import models, parallel
from cross_patient_speech_decoding_tpu_torch.models import (
    nn_classifier_params_from_flax,
    realtime_rnn_params_from_flax,
)
from cross_patient_speech_decoding_tpu_torch.parallel import dryrun
from cross_patient_speech_decoding_tpu_torch.parallel import mesh as pm
from cross_patient_speech_decoding_tpu_torch.train import (
    create_train_state,
    make_classifier_train_step,
    make_ctc_train_step,
    make_optimizer,
)

torch.set_num_threads(2)

CTC_KW = dict(hidden=16, n_layers=2, n_classes=7, win_size=6, stride=2)
B, T, C, L = 5, 24, 5, 3  # 5 rows: one zero-weight pad row on rank 1
CTC_TX = dict(lr=1e-3, weight_decay=1e-5, decay_steps=2, clip=5.0)
NCLS, NF, H, K, DM = 5, 8, 12, 4, 8
CLS_T = 10
CLS_TX = dict(lr=1e-3, weight_decay=1e-5, decay_steps=10, end_factor=0.01,
              clip=0.5)
# tests/test_torch_ctc_train.py's and tests/test_torch_nn_models.py's
# one-device tolerances against JAX
LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-6
STATS_ATOL = 1e-6
# against the one-device port: two partial sums added in another order
ONE_DEVICE_RTOL = 1e-5


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _ctc_batch():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, T, C)).astype(np.float32)
    labels = rng.integers(1, CTC_KW["n_classes"], (B, L)).astype(np.int32)
    il = rng.integers(18, T + 1, B).astype(np.int32)
    ll = rng.integers(1, L + 1, B).astype(np.int32)
    return x, labels, il, ll


def _cls_batch():
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(B, CLS_T, C)) * 1.5 + 0.3).astype(np.float32)
    y = rng.integers(0, NCLS, B).astype(np.int32)
    return x, y


def _jax_classifier(family):
    if family == "transformer":
        return jmodels.TransformerClassifier(
            d_model=DM, num_classes=NCLS, n_heads=2, n_layers=1, dim_ff=16,
            dropout=0.0)
    return jmodels.TemporalConvRNN(
        n_filters=NF, hidden=H, num_classes=NCLS, kernel_size=K,
        n_layers=2, cnn_dropout=0.0, rnn_dropout=0.0)


def _port_classifier_spec(family):
    if family == "transformer":
        return {"cls": "TransformerClassifier", "args": (C, DM, NCLS),
                "kw": dict(n_heads=2, n_layers=1, dim_ff=16, dropout=0.0)}
    return {"cls": "TemporalConvRNN", "args": (C, NF, H),
            "kw": dict(num_classes=NCLS, kernel_size=K, n_layers=2,
                       cnn_dropout=0.0, rnn_dropout=0.0)}


def _port_model(spec):
    return getattr(models, spec["cls"])(*spec["args"], **spec["kw"],
                                        device="cpu")


@pytest.fixture(scope="module")
def steps():
    """One flax init a model; the JAX package's padded sharded steps on a
    two-device mesh, the port's on two ranks (one launch) and its
    one-device steps, from the same weights and batch."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pg, "enabled", lambda: True)
        mp.setattr(pg, "worthwhile", lambda B, T: True)
        mp.setattr(pg, "MIN_BT", 1)
        mp.setattr(pg, "MIN_SEQ_T", 1)
        return _steps()


def _steps():
    jm2 = jmesh.make_mesh(2)
    out = {"jax": {}, "one": {}}
    key = jax.random.key(4)
    # CTC
    jm = jmodels.RealtimeRNN(input_grad=False, dropout=0.0, **CTC_KW)
    batch = _ctc_batch()
    bj = tuple(jnp.asarray(a) for a in batch)
    params = jm.init({"params": jax.random.key(0)},
                     jnp.zeros((1, 4 * CTC_KW["win_size"], C)), True)
    sd = {k: v.numpy() for k, v in realtime_rnn_params_from_flax(
        _np_tree(params)).items()}
    tx_j = jloops.make_optimizer(**CTC_TX)
    state_j, mj = jmesh.make_padded_sharded_ctc_train_step(jm, tx_j, jm2)(
        jax_create_state(jm, params, tx_j), bj, key)
    out["jax"]["ctc"] = (float(mj["loss"]), realtime_rnn_params_from_flax(
        _np_tree({"params": state_j.params})))
    model_kw = dict(in_channels=C, dropout=0.0, **CTC_KW)
    spec = {"ctc": {"model": model_kw, "state": sd, "tx": CTC_TX,
                    "batch": batch}, "classifiers": {}}
    tm = models.RealtimeRNN(**model_kw, device="cpu")
    tm.load_state_dict(ranks._state_dict(sd))
    tx = make_optimizer(**CTC_TX)
    _, m1 = make_ctc_train_step(tm, tx)(
        create_train_state(tm, tx), tuple(map(torch.from_numpy, batch)), None)
    out["one"]["ctc"] = (float(m1["loss"]), {n: p.grad.numpy().copy()
                                             for n, p in tm.named_parameters()})
    # classifiers
    x, y = _cls_batch()
    for family in ("transformer", "conv_rnn"):
        jc = _jax_classifier(family)
        v = dict(jc.init(jax.random.key(0), jnp.asarray(x)))
        tx_j = jloops.make_optimizer(**CLS_TX)
        with jax.default_matmul_precision("highest"):
            state_j, mj = jmesh.make_sharded_classifier_train_step(
                jc, tx_j, jm2)(jax_create_state(jc, v, tx_j),
                               (jnp.asarray(x), jnp.asarray(y)), key)
        out["jax"][family] = (
            float(mj["loss"]), float(mj["acc"]),
            nn_classifier_params_from_flax(_np_tree(state_j.params),
                                           _np_tree(state_j.batch_stats)))
        cs = _port_classifier_spec(family)
        sd = {k: t.numpy() for k, t in nn_classifier_params_from_flax(
            _np_tree(v["params"]), _np_tree(v.get("batch_stats", {})))
            .items()}
        spec["classifiers"][family] = {**cs, "state": sd, "tx": CLS_TX,
                                       "batch": (x, y)}
        tm = _port_model(cs)
        tm.load_state_dict(ranks._state_dict(sd))
        tx = make_optimizer(**CLS_TX)
        _, m1 = make_classifier_train_step(tm, tx)(
            create_train_state(tm, tx), (torch.from_numpy(x),
                                         torch.from_numpy(y)),
            torch.Generator().manual_seed(0))
        out["one"][family] = (float(m1["loss"]),
                              {n: p.grad.numpy().copy()
                               for n, p in tm.named_parameters()})
    out["port"] = parallel.launch(ranks.step_checks, 2, (spec,),
                                  devices="cpu", timeout=120)
    return out


# ------------------------------------------------------------- helpers --

def test_pad_with_weights_and_shard_batch_match_jax():
    """JAX's padding (repeated leading rows at weight 0) and each device's
    block of ``shard_batch``, bit for bit, for 5 rows over 2 and 3 ranks
    and 3 rows over 4 (the pad wraps)."""
    rng = np.random.default_rng(1)
    for n, n_dev in ((5, 2), (5, 3), (3, 4), (4, 2)):
        arrays = (rng.normal(size=(n, 3)).astype(np.float32),
                  rng.integers(0, 9, n).astype(np.int32))
        (pj, wj) = jmesh._pad_with_weights(
            tuple(jnp.asarray(a) for a in arrays), n_dev)
        (pt, wt) = pm._pad_with_weights(
            tuple(torch.from_numpy(a) for a in arrays), n_dev)
        np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
        for a, b in zip(pt, pj):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        if n_dev > 2:
            continue
        jsh = jmesh.shard_batch(pj, jmesh.make_mesh(n_dev))
        for r in range(n_dev):
            m = pm.Mesh(n_dev, r, torch.device("cpu"))
            got = parallel.shard_batch(pt, m)
            for a, b in zip(got, jsh):
                want = [s.data for s in b.addressable_shards
                        if s.device == jax.devices()[r]][0]
                np.testing.assert_array_equal(a.numpy(), np.asarray(want))
            assert parallel.replicated(m)(pt[0]) is pt[0]
            torch.testing.assert_close(
                parallel.batch_sharding(m, 2)(pt[0]), got[0], rtol=0,
                atol=0)


def test_map_fold_blocks_pads_with_repeated_folds():
    """An intended difference: the fold axis is padded to the world size
    by repeating leading folds (JAX pads zero masks); the pad is cut from
    the result. 3 folds over 2 ranks: rank 0 gets folds 0-1, rank 1 folds
    2 and 0 (here each rank's mesh has no group, so no gather)."""
    folds = torch.arange(3.0)[:, None] * torch.ones(3, 4)
    hp = {"lam": torch.tensor([10.0, 11.0, 12.0])}
    seen = []

    def fn(f, h):
        seen.append((f[:, 0].tolist(), h["lam"].tolist()))
        return f[:, 0] * 2

    out = [pm.map_fold_blocks(fn, pm.Mesh(2, r, torch.device("cpu")),
                              folds, hp) for r in (0, 1)]
    assert seen == [([0.0, 1.0], [10.0, 11.0]), ([2.0, 0.0], [12.0, 10.0])]
    assert [o.tolist() for o in out] == [[0.0, 2.0], [4.0, 0.0]]


def test_make_mesh_refusals(monkeypatch):
    """JAX's refusal of more devices than exist, with the card count
    patched (tests/test_parallel.py:155 does this for JAX); a mesh of
    several ranks needs a process group; one rank needs none; NCCL takes
    distinct cards only."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for n in (2, 99):
        with pytest.raises(ValueError, match=f"n_devices={n}"):
            parallel.make_mesh(n)
    with pytest.raises(ValueError, match="n_devices=2"):
        parallel.launch(ranks.fail_on_rank, 2, (0, "."))
    with pytest.raises(RuntimeError, match="process group"):
        parallel.make_mesh(2, device="cpu")
    m = parallel.make_mesh(1, device="cpu")
    assert (m.size, m.rank, m.device, m.group, m.shape) == (
        1, 0, torch.device("cpu"), None, {"data": 1})
    devs = pm.rank_devices(2, ["cuda:0", "cuda"])
    assert devs == [torch.device("cuda", 0)] * 2
    assert pm.default_backend(devs) == "gloo"
    assert pm.default_backend([torch.device("cuda", i)
                               for i in range(2)]) == "nccl"
    assert pm.default_backend(pm.rank_devices(2, "cpu")) == "gloo"
    with pytest.raises(ValueError, match="gloo"):
        parallel.launch(ranks.fail_on_rank, 2, (0, "."), devices=devs,
                        backend="nccl")


# ---------------------------------------------------------------- steps --

def test_ranks_import_no_jax_and_refuse_another_world_size(steps):
    res = steps["port"]
    assert res["jax_imported"] == [False, False]
    assert res["mesh"] == (2, 0, "cpu", 2)
    assert "n_devices=3" in res["mesh3"]


def test_sharded_ctc_step_matches_jax(steps):
    """One padded sharded CTC step (5 rows over 2 ranks, AdamW with
    clipping, dropout 0) against JAX's on a 2-device mesh: loss rtol 1e-5,
    every parameter atol 2e-6."""
    loss_j, want = steps["jax"]["ctc"]
    got = steps["port"]["ctc"]
    np.testing.assert_allclose(got["metrics"]["loss"], loss_j,
                               rtol=LOSS_RTOL)
    assert set(got["state"]) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got["state"][name], w.numpy(),
                                   atol=PARAM_ATOL, err_msg=name)
    assert got["replicas_equal"]


def _grad_rel(got: dict, want: dict) -> float:
    top = max(float(np.abs(w).max()) for w in want.values())
    return max(float(np.abs(got[k] - w).max()) for k, w in want.items()) / top


def test_sharded_ctc_step_matches_one_device(steps):
    """The same step against the port's one-device step on the 5 rows: the
    loss and the reduced gradients within 1e-5 relative."""
    loss_1, grads_1 = steps["one"]["ctc"]
    got = steps["port"]["ctc"]
    np.testing.assert_allclose(got["metrics"]["loss"], loss_1,
                               rtol=ONE_DEVICE_RTOL)
    assert _grad_rel(got["grads"], grads_1) <= ONE_DEVICE_RTOL


def _zero_grad_params(family):
    """Parameters whose exact gradient is 0 (tests/test_torch_nn_models.py:
    the conv bias under a BatchNorm, the attention's key bias): Adam moves
    them by rounding noise of about lr on either side."""
    if family == "conv_rnn":
        return {"conv.bias"}
    return {"blocks.0.attn.key.bias"}


@pytest.mark.parametrize("family", ["transformer", "conv_rnn"])
def test_sharded_classifier_step_matches_jax(steps, family):
    """One sharded classifier step (5 rows over 2 ranks, one pad row in
    rank 1's shard) against JAX's: loss rtol 1e-5, accuracy (the weighted
    share of hits) exact, parameters atol 2e-6 (2 lr for a parameter of
    zero exact gradient), the rank-averaged running statistics of
    ``conv_rnn``'s per-shard BatchNorm atol 1e-6."""
    loss_j, acc_j, want = steps["jax"][family]
    got = steps["port"][family]
    np.testing.assert_allclose(got["metrics"]["loss"], loss_j,
                               rtol=LOSS_RTOL)
    assert got["metrics"]["acc"] == pytest.approx(acc_j, abs=1e-7)
    assert set(got["state"]) == set(want)
    zeros = _zero_grad_params(family)
    for name, w in want.items():
        atol = (STATS_ATOL if name.endswith(("norm.mean", "norm.var"))
                else 2 * CLS_TX["lr"] if name in zeros else PARAM_ATOL)
        np.testing.assert_allclose(got["state"][name], w.numpy(), atol=atol,
                                   err_msg=name)
    assert got["replicas_equal"]


def test_sharded_classifier_step_matches_one_device(steps):
    """The transformer (no BatchNorm) against the port's one-device step:
    loss and reduced gradients within 1e-5 relative. ``conv_rnn`` differs
    from it by design: each shard normalises with its own statistics."""
    loss_1, grads_1 = steps["one"]["transformer"]
    got = steps["port"]["transformer"]
    np.testing.assert_allclose(got["metrics"]["loss"], loss_1,
                               rtol=ONE_DEVICE_RTOL)
    assert _grad_rel(got["grads"], grads_1) <= ONE_DEVICE_RTOL
    loss_bn, _ = steps["one"]["conv_rnn"]
    assert steps["port"]["conv_rnn"]["metrics"]["loss"] != loss_bn


def test_dropout_draws_differ_between_ranks(steps):
    """Rank 0 draws from the step's generator (one rank repeats the
    one-device step), rank 1 from its own: different masks, each at the
    keep rate (20000 draws at p 0.3: within 0.015, ~4.6 sigma). Two steps
    at dropout 0.3 keep the replicas equal."""
    m0, m1 = steps["port"]["masks"]
    want = (torch.rand(20000, generator=torch.Generator().manual_seed(11))
            < 0.3).numpy()
    np.testing.assert_array_equal(m0, want)
    assert (m0 != m1).mean() > 0.3
    for m in (m0, m1):
        assert abs(m.mean() - 0.3) < 0.015
    d = steps["port"]["dropout"]
    assert np.isfinite(d["losses"]).all() and d["replicas_equal"]


# ------------------------------------------------------------- launcher --

def _alive(pid_dir) -> list:
    """The pids written to ``pid_dir`` whose processes still exist."""
    alive = []
    for p in pid_dir.glob("*.pid"):
        pid = int(p.read_text())
        try:
            os.kill(pid, 0)
            alive.append(pid)
        except ProcessLookupError:
            pass
    return alive


def _dead(pid_dir) -> bool:
    return len(list(pid_dir.glob("*.pid"))) == 2 and not _alive(pid_dir)


def test_a_failing_rank_fails_the_launch(tmp_path):
    """Rank 1 raises while rank 0 waits in an all-reduce: the launch
    raises rank 1's exception (its traceback the cause) well within the
    deadline, and no rank is left."""
    t0 = time.perf_counter()
    with pytest.raises(ValueError, match="injected failure on rank 1") as e:
        parallel.launch(ranks.fail_on_rank, 2, (1, str(tmp_path)),
                        devices="cpu", timeout=60)
    assert time.perf_counter() - t0 < 30
    assert "rank 1 of 2 failed" in str(e.value.__cause__)
    assert _dead(tmp_path)


def test_a_hanging_rank_hits_the_deadline(tmp_path):
    """Rank 1 sleeps past the deadline: the launch raises TimeoutError
    within 16 s of it, and no rank is left. The deadline starts before the
    ranks are spawned, and a rank that starts beside busy test workers
    (torch's import, the group's rendezvous) can take more than 4 s to
    reach its body and write its pid; a launch that ends before both
    ranks wrote theirs has not yet seen the hang, so it runs again with a
    deadline twice as long."""
    for timeout in (4, 8, 16, 32):
        pid_dir = tmp_path / str(timeout)
        pid_dir.mkdir()
        t0 = time.perf_counter()
        with pytest.raises(TimeoutError):
            parallel.launch(ranks.hang_on_rank, 2, (1, str(pid_dir)),
                            devices="cpu", timeout=timeout)
        assert time.perf_counter() - t0 < timeout + 16
        assert _alive(pid_dir) == []
        if len(list(pid_dir.glob("*.pid"))) == 2:
            break
    assert _dead(pid_dir)


@pytest.mark.parametrize("n", [2, 3])
def test_dryrun_multichip(n):
    """The six surfaces on n CPU ranks (3: the data-parallel batches and
    the nested scorer's outer folds pad), each against the one-device run
    on the rank: the steps' losses and gradients within 1e-5 relative,
    the fold trainer bit for bit, the decoders and fits exactly."""
    res = dryrun.dryrun_multichip(n, device="cpu", verbose=False)
    assert res["world_size"] == n and res["backend"] == "gloo"
    for k in ("ctc_step", "classifier_step"):
        assert res[k]["loss_rel_err"] <= 1e-5
        assert res[k]["grad_rel_err"] <= 1e-5
    assert res["ctc_step"]["rows"] == 2 * n + 1
    assert res["seq2seq_folds"]["equal_to_one_device"]
    assert res["fold_decode"]["max_acc_diff_vs_one_device"] == 0.0
    assert res["alignment_fits"]["max_corr_diff_vs_one_device"] == 0.0
    assert res["nested_scorer"]["outer_folds"] == n + 1
    assert res["nested_scorer"]["max_score_diff_vs_one_device"] == 0.0
    assert res["nested_scorer"]["max_acc_diff_vs_one_device"] == 0.0
