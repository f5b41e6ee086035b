"""Package-level contracts of the PyTorch port: import hygiene, the
package namespaces against the JAX package's, default device, and the C
interface of the kernel library."""

import ast
import importlib
import re
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from cross_patient_speech_decoding_tpu_torch.ops import _ext, gru, signal
from cross_patient_speech_decoding_tpu_torch.models import RealtimeRNN
from cross_patient_speech_decoding_tpu_torch.utils import resolve_device

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "cross_patient_speech_decoding_tpu_torch"
FORBIDDEN = {"jax", "flax", "optax"}


def _port_files():
    # the card's tests run where JAX is not installed; the multi-rank
    # tests' rank bodies run in processes that must not import it
    extra = [ROOT / "tests" / "test_torch_kernels.py",
             ROOT / "tests" / "torch_parallel_ranks.py", ROOT / "chip_smoke.py"]
    return sorted(PORT.rglob("*.py")) + extra


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_nothing_of_jax():
    files = _port_files()
    assert len(files) > 10 and files[-1].exists()
    bad = []
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            # exact match: the port's own name shares the JAX package's
            # name as a prefix
            if top in FORBIDDEN or top == "cross_patient_speech_decoding_tpu":
                bad.append(f"{path.relative_to(ROOT)}: {name}")
    assert bad == []


def test_hygiene_check_catches_a_jax_import(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import jax.numpy as jnp\n"
                 "from cross_patient_speech_decoding_tpu.ops import ctc\n"
                 "from cross_patient_speech_decoding_tpu_torch import ops\n")
    tops = [n.split(".")[0] for n in _imports(p)]
    assert tops == ["jax", "cross_patient_speech_decoding_tpu",
                    "cross_patient_speech_decoding_tpu_torch"]


SUBPACKAGES = ("analysis", "cli", "data", "decoders", "models", "ops",
               "parallel", "realtime", "sweep", "train", "utils")


def _public(mod) -> set:
    """A package's public names: ``__all__``, else the non-module names
    without a leading underscore that its ``__init__`` binds."""
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n, v in vars(mod).items()
                 if not n.startswith("_") and n != "annotations"
                 and not isinstance(v, types.ModuleType)]
    return set(names)


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_exports_every_name_jax_does(sub):
    """Every public name of a JAX subpackage is a public name of the port's
    (the port may have more). The one allowance: ``decoders`` reaches the
    scikit-learn estimators of ``sklearn_compat`` on first access instead
    of at import (the card machine has no scikit-learn); they must still
    resolve here."""
    jax_pkg = importlib.import_module(
        f"cross_patient_speech_decoding_tpu.{sub}")
    port = importlib.import_module(
        f"cross_patient_speech_decoding_tpu_torch.{sub}")
    missing = _public(jax_pkg) - _public(port)
    lazy = set(getattr(port, "_SKLEARN_COMPAT", ()))
    assert missing <= lazy, sorted(missing - lazy)
    if sub == "decoders":
        assert missing == lazy
    for name in _public(jax_pkg):
        assert getattr(port, name) is not None, name


def test_ops_package_imports_without_scipy_or_h5py():
    """The ops namespace re-exports the JAX package's (the metrics' scipy
    p-values included) yet imports neither scipy nor h5py."""
    code = ("import sys; import cross_patient_speech_decoding_tpu_torch.ops; "
            "print(sorted({'scipy', 'h5py'} & set(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT)
    assert out.stdout.strip() == "[]"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_is_cuda_and_raises_without_it(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_points_default_to_cuda(no_cuda, tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RealtimeRNN(4, 8, 1, 3)
    b = np.array([[1.0, 0.0, -1.0]])
    a = np.array([[1.0, -0.5, 0.1]])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        signal.init_stream_state(b, a, 3)
    assert RealtimeRNN(4, 8, 1, 3, device="cpu").device.type == "cpu"
    from cross_patient_speech_decoding_tpu_torch.cli.experiments import (
        run_train_ctc,
    )
    from cross_patient_speech_decoding_tpu_torch.data import (
        make_synthetic_patients_device,
    )
    from cross_patient_speech_decoding_tpu_torch.utils.config import (
        TrainCTCConfig,
    )

    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_synthetic_patients_device(T=4)
    assert make_synthetic_patients_device(
        T=4, device="cpu").X[0].device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_train_ctc(TrainCTCConfig(out=""))
    from cross_patient_speech_decoding_tpu_torch.cli import (
        subsample_experiments as sub,
    )
    from cross_patient_speech_decoding_tpu_torch.data import surrogates

    for sweep in (sub.run_trial_subsample, sub.run_grid_subsample,
                  sub.run_spatial_avg, sub.run_pitch_subsample):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sweep(sub.SubsampleConfig(), verbose=False)
    X = np.zeros((3, 2, 2), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        surrogates.fit_tme(X, steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        surrogates.tme_surrogate(X, steps=1)
    from cross_patient_speech_decoding_tpu_torch.cli import experiments
    from cross_patient_speech_decoding_tpu_torch.sweep import ctc
    from cross_patient_speech_decoding_tpu_torch.utils import config

    for run, cfg in ((experiments.run_tune_ctc, config.TuneCTCConfig()),
                     (experiments.compute_xforms,
                      config.MakeXformsConfig()),
                     (experiments.run_realtime_sim,
                      config.RealtimeSimConfig(n_bins=2))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run(cfg)
    batch = (np.zeros((2, 20, 3), np.float32), np.ones((2, 1), np.int32),
             np.full(2, 20), np.ones(2, np.int32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ctc.make_ctc_bucket_trainer(batch, batch, 11)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ctc.make_ctc_cv_bucket_trainer(batch, np.ones((1, 2)),
                                       np.ones((1, 2)), 11)
    from cross_patient_speech_decoding_tpu_torch.analysis import cluster
    from cross_patient_speech_decoding_tpu_torch.cli.reproduce import (
        run_reproduce,
    )

    (tmp_path / "m.yaml").write_text(
        "jobs:\n  - command: svm-decode\n    overrides: {out: ''}\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_reproduce(config.ReproduceConfig(
            manifest=str(tmp_path / "m.yaml")), verbose=False)
    x, labels = np.eye(4, dtype=np.float32), np.array([0, 0, 1, 1])
    for fn in (cluster.silhouette_samples, cluster.silhouette_positive_mean,
               cluster.calinski_harabasz, cluster.davies_bouldin):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(x, labels)
    for fn in (cluster.pca_embed, cluster.tsne_embed):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(x)
    from cross_patient_speech_decoding_tpu_torch import parallel
    from cross_patient_speech_decoding_tpu_torch.parallel import dryrun

    for n in (1, 2):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            parallel.make_mesh(n)
    assert parallel.make_mesh(1, device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        experiments.run_svm_decode(config.SVMDecodeConfig(n_devices=2))


def test_state_from_numpy_defaults_to_cuda(no_cuda):
    from cross_patient_speech_decoding_tpu_torch.ops import state_from_numpy
    from cross_patient_speech_decoding_tpu_torch.ops.pca import PCAState

    state = {name: np.zeros(2, np.float32) for name in PCAState._fields}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        state_from_numpy(PCAState, state)
    assert state_from_numpy(PCAState, state, "cpu").mean.device.type == "cpu"


def test_kernel_wrappers_check_their_arguments():
    """The CUDA wrappers validate before touching the library, so the
    checks run here on CPU tensors."""
    T, B, F, H = 3, 4, 5, 6
    x = torch.zeros(T, B, F)
    args = [torch.zeros(B, H), torch.zeros(F, 3 * H), torch.zeros(3 * H),
            torch.zeros(H, 3 * H), torch.zeros(3 * H)]
    with pytest.raises(TypeError, match="x must be"):
        gru._check_args(x.double(), *args, F)
    with pytest.raises(ValueError, match="wi has shape"):
        gru._check_args(x, args[0], torch.zeros(F + 1, 3 * H), *args[2:], F)
    with pytest.raises(ValueError, match="contiguous last axis"):
        gru._check_args(x.transpose(1, 2), *args, F)
    with pytest.raises(ValueError, match="wh must be contiguous"):
        gru._check_args(x, *args[:3], torch.zeros(3 * H, H).t(), args[4], F)
    # parameters that train pass: the kernels have their backward
    wi = args[1].clone().requires_grad_()
    gru._check_args(x, args[0], wi, *args[2:], F)
    hprev = torch.zeros(T, B, H)
    with pytest.raises(ValueError, match="dhs has shape"):
        gru._check_streams(x, T, H, hprev=hprev, dhs=hprev[:2])
    with pytest.raises(ValueError, match="hprev must be contiguous"):
        gru._check_streams(x, T, H, hprev=torch.zeros(B, T, H).transpose(0, 1))
    with pytest.raises(TypeError, match="dhs must be float32"):
        gru._check_streams(x, T, H, hprev=hprev, dhs=hprev.double())
    # the windowed wrappers: bf16 frames and a window geometry, checked
    # before their windows reach the shared launch bodies
    frames = torch.zeros(8, B, 2)
    w = (torch.zeros(B, H), torch.zeros(6, 3 * H), torch.zeros(3 * H),
         torch.zeros(H, 3 * H), torch.zeros(3 * H))
    with pytest.raises(TypeError, match="gru_wfwd reads bfloat16 frames"):
        gru.gru_wfwd_cuda(frames, *w, 3, 2)
    with pytest.raises(TypeError, match="gru_wbwd reads bfloat16 frames"):
        gru.gru_wbwd_cuda(frames, hprev, hprev, *w[1:], 3, 2)
    with pytest.raises(ValueError, match="n_win"):
        gru.gru_wfwd_cuda(frames.bfloat16(), *w, 9, 2)
    with pytest.raises(ValueError, match="wi has shape"):
        gru.gru_wfwd_cuda(frames.bfloat16(), w[0], torch.zeros(7, 3 * H),
                          *w[2:], 3, 2)
    with pytest.raises(ValueError, match="hprev has shape"):
        gru.gru_wbwd_cuda(frames.bfloat16(), hprev, hprev, *w[1:], 3, 1)


def test_c_interface_matches_the_source():
    """Every ctypes signature names an extern "C" function of its source
    with the same number of parameters, each source builds into a library
    of its own, and the build flags target sm_90a."""
    assert set(_ext.SOURCES) == {"gru_fwd.cu", "gru_bwd.cu", "jacobi.cu"}
    for source, signatures in _ext.SOURCES.items():
        src = (_ext.CSRC / source).read_text()
        c_part = src[src.index('extern "C" {'):]
        found = {
            m.group(1): len(m.group(2).split(","))
            for m in re.finditer(r"^int (\w+)\(([^)]*)\)", c_part, re.M)
        }
        assert found == {k: len(v) for k, v in signatures.items()}, source
        assert _ext.library_path(source).parent == _ext.BUILD_DIR
    assert "arch=compute_90a,code=sm_90a" in _ext.NVCC_FLAGS
    paths = {_ext.library_path(s) for s in _ext.SOURCES}
    assert len(paths) == len(_ext.SOURCES)


def _local_includes(path: Path):
    return re.findall(r'^\s*#\s*include\s+"([^"]+)"', path.read_text(), re.M)


def test_headers_list_every_local_include():
    """Every ``#include "..."`` of a source or header in csrc/ names a file
    of csrc/ that ``_ext.HEADERS`` lists (so that it enters the libraries'
    hash), and every listed header is included somewhere."""
    files = sorted(_ext.CSRC.glob("*.cu")) + sorted(_ext.CSRC.glob("*.cuh"))
    assert {f.name for f in files} >= set(_ext.SOURCES)
    included = set()
    for path in files:
        for name in _local_includes(path):
            assert (_ext.CSRC / name).is_file(), f"{path.name}: {name}"
            included.add(name)
    assert included == set(_ext.HEADERS)
    assert {f.name for f in files if f.suffix == ".cuh"} == set(_ext.HEADERS)


@pytest.mark.parametrize("header", _ext.HEADERS)
def test_library_path_follows_every_header(header, tmp_path, monkeypatch):
    """Editing any listed header renames every library (a rebuild)."""
    for path in _ext.CSRC.iterdir():
        (tmp_path / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(_ext, "CSRC", tmp_path)
    before = {s: _ext.library_path(s) for s in _ext.SOURCES}
    with open(tmp_path / header, "a") as f:
        f.write("\n// edited\n")
    after = {s: _ext.library_path(s) for s in _ext.SOURCES}
    assert all(before[s] != after[s] for s in _ext.SOURCES)


def test_include_check_finds_includes(tmp_path):
    p = tmp_path / "k.cu"
    p.write_text('#include "a.cuh"\n  #  include "b.cuh"\n'
                 "#include <cuda_runtime.h>\n// #include \"c.cuh\" is prose\n")
    assert _local_includes(p) == ["a.cuh", "b.cuh"]


def test_library_path_keys_build_variants():
    """A variant's defines give it a library of its own, beside the
    default build (no defines), under the same build directory."""
    base = _ext.library_path("gru_bwd.cu")
    variant = ("GRU_MMA_BIG=128, 128, 4, 4, 3, 1",)
    assert _ext.library_path("gru_bwd.cu", ()) == base
    assert _ext.library_path("gru_bwd.cu", variant) != base
    assert (_ext.library_path("gru_bwd.cu", variant)
            == _ext.library_path("gru_bwd.cu", list(variant)))
    assert _ext.library_path("gru_bwd.cu", variant).parent == _ext.BUILD_DIR


def _probes():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "port_probes", ROOT / "tools" / "port_probes.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _probe_variants():
    return _probes().BWD_VARIANTS


@pytest.mark.parametrize("variant", sorted(_probe_variants()))
def test_probe_variants_name_the_header_macros(variant):
    """Every define of the backward probe's variants overrides a macro
    that gru_mma.cuh defaults with #ifndef, and a tile shape has the six
    MmaCfg parameters."""
    header = (_ext.CSRC / "gru_mma.cuh").read_text()
    for d in _probe_variants()[variant]:
        name, value = d.split("=", 1)
        assert re.search(rf"^#ifndef {name}$", header, re.M), name
        if name in ("GRU_MMA_BIG", "GRU_MMA_SMALL"):
            assert len([int(v) for v in value.split(",")]) == 6


@pytest.mark.parametrize("variant", sorted(_probes().FWD_VARIANTS))
def test_forward_probe_variants_name_the_source_macros(variant):
    """Every define of the forward probe's variants overrides a macro that
    gru_fwd.cu or gru_mma.cuh defaults with #ifndef, and a step tile has
    the six MmaCfg parameters."""
    text = "\n".join((_ext.CSRC / f).read_text()
                     for f in ("gru_fwd.cu", "gru_mma.cuh"))
    for d in _probes().FWD_VARIANTS[variant]:
        name, value = d.split("=", 1)
        assert re.search(rf"^#ifndef {name}$", text, re.M), name
        if name == "GRU_FWD_STEP":
            assert len([int(v) for v in value.split(",")]) == 6


@pytest.mark.parametrize("variant", sorted(_probes().JACOBI_VARIANTS))
def test_jacobi_probe_variants_name_the_source_macros(variant):
    """Every define of the Jacobi probe's variants overrides a macro that
    jacobi.cu defaults with #ifndef, with an integer value."""
    text = (_ext.CSRC / "jacobi.cu").read_text()
    for d in _probes().JACOBI_VARIANTS[variant]:
        name, value = d.split("=", 1)
        assert re.search(rf"^#ifndef {name}$", text, re.M), name
        assert int(value) >= 0


def test_jacobi_source_takes_the_wrappers_sizes():
    """The kernel's largest instance (KMAX, csrc/jacobi.cu) is the
    wrapper's bound (MAX_K): every Kp the wrapper lets through has an
    instance."""
    from cross_patient_speech_decoding_tpu_torch.ops import jacobi

    text = (_ext.CSRC / "jacobi.cu").read_text()
    kmax = int(re.search(r"constexpr int KMAX = (\d+);", text).group(1))
    assert kmax == jacobi.MAX_K


def test_ab_summary_counts_pairs_won_and_quartiles():
    """The A/B summary pairs turns 0-1 and 2-3 (DIR, this, this, DIR),
    counts the pairs this checkout won, and gives each checkout's median,
    quartiles and range of a fit's ms; the Jacobi kernel's times by
    checkout and shape."""
    def turn(t, root, ms):
        return {"turn": t, "checkout": root, "phase": "alignment",
                "methods": {"gram": {"fit_ms": ms}}}

    run = [turn(0, "dir", 4.0), turn(1, "this", 3.0),
           turn(2, "this", 5.0), turn(3, "dir", 4.5),
           {"turn": 1, "checkout": "this", "phase": "kernel",
            "sweeps_run": [7], "shape": [128, 40, 40], "ms": 0.1}]
    fit, kernel = _probes().ab_summary([run, run[:2]])
    assert fit["method"] == "gram"
    assert (fit["pairs"], fit["pairs_this_faster"]) == (3, 2)
    assert fit["fit_ms"]["dir"]["range"] == [4.0, 4.5]
    assert fit["fit_ms"]["this"]["median"] == 3.0
    assert fit["fit_ms"]["this"]["n"] == 3
    assert kernel["jacobi_kernel_ms"]["this"]["128x40x40 ms"] == {
        "median": 0.1, "range": [0.1, 0.1]}
