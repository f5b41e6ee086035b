"""``cpsd analyze`` and the port's utilities against the JAX package's:
``run_analyze`` on the same results files (both tests, 2 and 3 groups,
within 1e-12), the TensorBoard writer byte for byte (clock, host name and
process pinned) and read back by TensorBoard, ``fit(log_format='tb')``,
the timers, ``annotate`` in a profiler trace, the data-scaling fit, the
channel grid and the plot functions under the Agg backend.
"""

import json
import time

import numpy as np
import pytest
import torch

from cross_patient_speech_decoding_tpu.cli import experiments as je
from cross_patient_speech_decoding_tpu.utils import scaling as jsc
from cross_patient_speech_decoding_tpu.utils import tb_events as jtb
from cross_patient_speech_decoding_tpu.utils import visualization as jvis
from cross_patient_speech_decoding_tpu.utils.config import (
    AnalyzeConfig as JaxAnalyzeConfig,
)
from cross_patient_speech_decoding_tpu_torch import utils as tu
from cross_patient_speech_decoding_tpu_torch.cli import experiments as te
from cross_patient_speech_decoding_tpu_torch.cli import main as tmain
from cross_patient_speech_decoding_tpu_torch.data import loaders
from cross_patient_speech_decoding_tpu_torch.train import loops
from cross_patient_speech_decoding_tpu_torch.utils import scaling as tsc
from cross_patient_speech_decoding_tpu_torch.utils import tb_events as ttb
from cross_patient_speech_decoding_tpu_torch.utils import visualization as tvis
from cross_patient_speech_decoding_tpu_torch.utils.config import (
    AnalyzeConfig,
)

torch.set_num_threads(2)

TOL = 1e-12


# ------------------------------------------------------------- analyze --


def _results(tmp_path, spec, seed=0):
    """Results pickles ``{name: (n_iter, mean accuracy)}`` in the drivers'
    layout (``append_results_pkl``), and the ``inputs`` string."""
    rng = np.random.default_rng(seed)
    inputs = []
    for name, (n_iter, mean) in spec.items():
        path = tmp_path / f"{name}.pkl"
        for _ in range(n_iter):
            loaders.append_results_pkl(
                path, np.clip(rng.normal(mean, 0.05, 20), 0, 1),
                params={"name": name})
        inputs.append(f"{name}={path}")
    return ",".join(inputs)


def _same_analysis(got, want):
    assert list(got["groups"]) == list(want["groups"])
    for k in want["groups"]:
        np.testing.assert_array_equal(got["groups"][k], want["groups"][k])
    assert [(r.a, r.b, r.significant) for r in got["pairwise"]] == [
        (r.a, r.b, r.significant) for r in want["pairwise"]]
    np.testing.assert_allclose([r[2:5] for r in got["pairwise"]],
                               [r[2:5] for r in want["pairwise"]],
                               rtol=TOL, atol=TOL)
    if want["anova"] is None:
        assert got["anova"] is None
        return
    a, b = got["anova"], want["anova"]
    assert a.group == b.group
    np.testing.assert_allclose([a.f_statistic, a.anova_p],
                               [b.f_statistic, b.anova_p], rtol=TOL,
                               atol=TOL)
    for x, y in ((a.tukey_statistic, b.tukey_statistic),
                 (a.tukey_p, b.tukey_p)):
        np.testing.assert_allclose(x, y, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("test", ["wilcoxon", "permutation"])
@pytest.mark.parametrize("n_groups", [2, 3])
def test_run_analyze_equals_jax(tmp_path, test, n_groups):
    spec = dict(list({"chance": (12, 0.11), "patient": (12, 0.35),
                      "aligned": (12, 0.45)}.items())[:n_groups])
    inputs = _results(tmp_path, spec)
    got = te.run_analyze(AnalyzeConfig(inputs=inputs, test=test),
                         verbose=False)
    want = je.run_analyze(JaxAnalyzeConfig(inputs=inputs, test=test),
                          verbose=False)
    _same_analysis(got, want)
    assert (got["anova"] is None) == (n_groups == 2)


def test_run_analyze_h5_unequal_and_errors(tmp_path, capsys):
    """A reference CTC results h5 is read as PERs; unequal iteration
    counts use the common prefix (with a note); malformed inputs raise as
    in JAX."""
    pytest.importorskip("h5py")
    rng = np.random.default_rng(1)
    h5 = loaders.save_ctc_results_h5(tmp_path / "ref.h5",
                                     rng.uniform(20, 40, (9, 5)))
    inputs = _results(tmp_path, {"a": (10, 0.4)}) + f",ref={h5}"
    got = te.run_analyze(AnalyzeConfig(inputs=inputs))
    assert "unequal iteration counts" in capsys.readouterr().out
    _same_analysis(got, je.run_analyze(JaxAnalyzeConfig(inputs=inputs),
                                       verbose=False))
    assert len(got["groups"]["ref"]) == 9
    for bad, err in (("a=x.pkl", FileNotFoundError), ("a", ValueError),
                     (inputs + ",a=" + str(h5), ValueError)):
        with pytest.raises(err):
            te.run_analyze(AnalyzeConfig(inputs=bad), verbose=False)
    with pytest.raises(ValueError, match="wilcoxon"):
        te.run_analyze(AnalyzeConfig(inputs=inputs, test="t"))
    loaders.save_pkl({"accs": []}, tmp_path / "e.pkl")
    with pytest.raises(ValueError, match="no per-iteration"):
        te.run_analyze(AnalyzeConfig(
            inputs=f"a={tmp_path / 'a.pkl'},e={tmp_path / 'e.pkl'}"))


def test_cli_analyze(tmp_path, capsys):
    """``cpsd analyze`` through the port's CLI prints the pairwise rows
    and the ANOVA; it runs on the host and refuses ``device=``."""
    inputs = _results(tmp_path, {"x": (8, 0.2), "y": (8, 0.5),
                                 "z": (8, 0.52)})
    assert tmain.main(["analyze", f"inputs={inputs}", "alpha=0.01"]) == 0
    out = capsys.readouterr().out
    assert "wilcoxon x vs y" in out and "ANOVA: F=" in out
    with pytest.raises(ValueError, match="no device"):
        tmain.main(["analyze", f"inputs={inputs}", "device=cpu"])


# ---------------------------------------------------------- TensorBoard --


def test_tb_event_files_equal_jax_byte_for_byte(tmp_path, monkeypatch):
    monkeypatch.setattr(ttb.socket, "gethostname", lambda: "host")
    monkeypatch.setattr(jtb.socket, "gethostname", lambda: "host")
    files = []
    for mod, name in ((jtb, "jax"), (ttb, "port")):
        clock = iter(np.arange(1.7e9, 1.7e9 + 100, 0.25).tolist())
        monkeypatch.setattr(time, "time", lambda: next(clock))
        w = mod.TBEventWriter(str(tmp_path / name))
        w.add_scalars(0, {"loss": 1.5, "per": 88.0})
        w.add_scalars(5, {"loss": 0.5, "per": 42.0, "acc": 1})
        w.add_scalars(-1, {"neg_step": -2.5})
        files.append(w.path)
    jax_file, port_file = (open(f, "rb").read() for f in files)
    assert jax_file == port_file
    assert files[0].rsplit("/", 1)[1] == files[1].rsplit("/", 1)[1]
    assert ttb._crc32c(b"123456789") == 0xE3069283


def test_tb_files_read_back_by_tensorboard(tmp_path):
    ea = pytest.importorskip(
        "tensorboard.backend.event_processing.event_accumulator")
    for epoch, (loss, per) in enumerate(((2.0, 90.0), (1.0, 70.0),
                                         (0.5, 40.0))):
        loops.append_metrics(str(tmp_path / "run"),
                             {"epoch": epoch * 2, "loss": loss, "per": per,
                              "note": "text"}, "tb")
    acc = ea.EventAccumulator(str(tmp_path / "run"))
    acc.Reload()
    assert set(acc.Tags()["scalars"]) == {"loss", "per"}
    assert [(e.step, e.value) for e in acc.Scalars("per")] == [
        (0, 90.0), (2, 70.0), (4, 40.0)]
    # one writer a run directory and process: one file
    assert len(list((tmp_path / "run").glob("events.out.tfevents.*"))) == 1


def test_fit_writes_tb_log(tmp_path):
    """``fit(log_format='tb')`` writes one scalar event an evaluation into
    the run directory."""
    ea = pytest.importorskip(
        "tensorboard.backend.event_processing.event_accumulator")
    torch.manual_seed(0)
    model = torch.nn.Linear(3, 1)
    tx = loops.make_optimizer(0.1, 0.0, 10)
    X = torch.randn(16, 3)
    y = X @ torch.tensor([1.0, -1.0, 0.5])

    def loss_of(m):
        return ((m(X)[:, 0] - y) ** 2).mean()

    def train_step(state, batch, gen):
        state.optimizer.zero_grad()
        loss = loss_of(state.model)
        loss.backward()
        state.optimizer.step()
        state.schedule.step()
        return state, {"loss": loss.detach()}

    def eval_step(batch):
        with torch.no_grad():
            return {"loss": loss_of(model)}

    from cross_patient_speech_decoding_tpu_torch.train import (
        create_train_state,
    )

    res = loops.fit(create_train_state(model, tx), train_step, eval_step,
                    (X, y), (X, y), epochs=4,
                    log_path=str(tmp_path / "tb"), log_format="tb")
    acc = ea.EventAccumulator(str(tmp_path / "tb"))
    acc.Reload()
    got = [(e.step, e.value) for e in acc.Scalars("loss")]
    assert [s for s, _ in got] == [0, 1, 2, 3]
    np.testing.assert_allclose([v for _, v in got],
                               [h["loss"] for h in res.history], rtol=1e-6)


# ------------------------------------------------------ timers, tracing --


def test_timers_on_the_cpu():
    with tu.Timer() as t:
        time.sleep(0.01)
    assert t.elapsed >= 0.01
    calls = []

    def fn(a):
        calls.append(1)
        return {"y": (a * 2, [a + 1])}

    ms = tu.median_ms(fn, torch.ones(8), warmup=1, iters=5)
    assert ms >= 0.0 and len(calls) == 6
    st = tu.StageTimer(force_host=True)
    for _ in range(3):
        with st.stage("prep", [torch.ones(4)]):
            time.sleep(0.002)
    with st.stage("fit"):
        pass
    assert st.counts == {"prep": 3, "fit": 1}
    assert st.totals["prep"] >= 0.006
    rep = st.report().splitlines()
    assert rep[0].startswith("prep: total") and "n=3" in rep[0]


def test_timers_synchronise_cuda_results(monkeypatch):
    """``median_ms`` and ``StageTimer`` synchronise the CUDA devices of the
    tensors a result holds, and nothing for CPU tensors."""
    from cross_patient_speech_decoding_tpu_torch.utils import timers

    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    timers._block({"a": [torch.ones(2)], "b": (torch.zeros(1), 3)})
    assert synced == []

    class _Cuda:  # a stand-in for a CUDA tensor's device attributes
        is_cuda = True
        device = torch.device("cuda", 1)

    monkeypatch.setattr(timers, "_tensors", lambda tree: iter(tree))
    timers._block([_Cuda(), _Cuda()])
    assert synced == [torch.device("cuda", 1)]


def test_annotate_range_in_profiler_trace(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tu.annotate("cpsd_stage"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert "cpsd_stage" in {e.key for e in prof.key_averages()}
    with tu.trace(str(tmp_path / "tr")):
        with tu.annotate("cpsd_traced"):
            torch.ones(8).sum()
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())
    names = {e.get("name") for e in events["traceEvents"]}
    assert "cpsd_traced" in names


# ------------------------------------------------- scaling, visualization --


def test_scaling_equals_jax():
    rng = np.random.default_rng(2)
    trials = np.array([10, 20, 40, 80, 160])
    per = 60 * trials ** -0.3 * np.exp(rng.normal(0, 0.02, 5))
    got, want = tsc.log_linear_fit(trials, per), jsc.log_linear_fit(trials,
                                                                    per)
    for k in ("slope", "intercept", "r", "p_value"):
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got["predict"](np.array([5.0, 500.0])),
                               want["predict"](np.array([5.0, 500.0])),
                               rtol=TOL)
    for target in (25.0, 1e-300):
        assert tsc.trials_to_target_per(trials, per, target) == \
            jsc.trials_to_target_per(trials, per, target)
    assert tsc.trials_to_target_per(trials, per[::-1]) == float("inf")
    assert tu.log_linear_fit is tsc.log_linear_fit


def test_channel_grid_equals_jax():
    rng = np.random.default_rng(3)
    cmap = np.full((6, 5), np.nan)
    cmap.ravel()[rng.permutation(30)[:22]] = rng.permutation(22) + 1
    data = rng.normal(size=22)
    np.testing.assert_array_equal(tvis.map_to_channel_grid(data, cmap),
                                  jvis.map_to_channel_grid(data, cmap))


def test_plot_functions_write_files(tmp_path):
    pytest.importorskip("matplotlib")
    rng = np.random.default_rng(4)
    lats = [rng.normal(size=(3, 10, 4)) for _ in range(2)]
    tvis.plot_latent_trajectories_1d(lats, labels=["a", "b"], dims=2,
                                     save_path=tmp_path / "1d.png")
    tvis.plot_latent_trajectories_2d(lats, save_path=tmp_path / "2d.png")
    tvis.plot_latent_trajectories_3d(lats, save_path=tmp_path / "3d.png")
    cmap = np.full((4, 4), np.nan)
    cmap[1:3, :] = np.arange(1, 9, dtype=np.float64).reshape(2, 4)
    tvis.plot_channel_map(rng.normal(size=8), cmap, title="t", label="HG",
                          save_path=tmp_path / "cm.png")
    tvis.plot_channel_map_seq(rng.normal(size=(2, 20, 8)), cmap,
                              np.linspace(0, 1, 20),
                              [(0.0, 0.5), (0.5, 1.0)], ["low", "high"],
                              title="seq", label="HG",
                              save_path=tmp_path / "cms.png")
    tvis.plot_rdm(rng.random((4, 4)), labels=list("abcd"),
                  save_path=tmp_path / "rdm.png")
    groups = {"a": rng.random(6), "b": rng.random(6)}
    assert tvis.plot_group_comparison(groups, "acc", baseline=0.1,
                                      save_path=str(tmp_path / "g.png")) \
        is None
    ks = np.array([5, 20, 80])
    vals = [rng.random(4) * 50 + 20 for _ in ks]
    fit = tsc.log_linear_fit(ks, np.array([v.mean() for v in vals]))
    tvis.plot_scaling_curve(ks, vals, "PER (%)", fit=fit,
                            save_path=str(tmp_path / "s.png"))
    p = tvis.save_panel(str(tmp_path / "sub"), "p.png",
                        tvis.plot_group_comparison, groups, "acc")
    assert p.endswith("sub/p.png")
    for name in ("1d", "2d", "3d", "cm", "cms", "rdm", "g", "s", "sub/p"):
        assert (tmp_path / f"{name}.png").stat().st_size > 0
