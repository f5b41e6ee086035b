"""Dataclass configs with YAML loading.

Port of ``cross_patient_speech_decoding_tpu/utils/config.py``: the
key=value coercion, ``load_config`` (defaults <- YAML <- overrides; PyYAML
imported only when a file is given), ``config_from_values``, the
classical decoder's config, the seq2seq trainer's, the NN classifier
driver's, the CTC trainer's, the CTC sweep's, the offline transforms',
the statistics' (``cpsd analyze``), the streaming simulation's and the
matrix runner's (``cpsd reproduce``). The subsample sweeps' config lives
with their driver. Field names and defaults are the JAX package's, so a
results file written by either driver resumes in the other.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from pathlib import Path
from typing import Any

def _coerce(val: str, typ):
    if typ is bool or isinstance(typ, type) and issubclass(typ, bool):
        return str(val).lower() in ("1", "true", "yes", "y")
    if typ is tuple:
        # comma list override (e.g. win_sizes=2,4 or pitches=1.5,2.5);
        # elements become int/float when possible, else stay strings
        # (the grid sweep's 'AxB' rectangular window specs)
        def elem(s):
            for t in (int, float):
                try:
                    return t(s)
                except ValueError:
                    continue
            return s

        return tuple(elem(s) for s in str(val).split(",") if s != "")
    try:
        if typ in (int, float, str):
            return typ(val)
    except (TypeError, ValueError):
        pass
    # int-or-float unions and strings fall through
    for t in (int, float):
        try:
            return t(val)
        except (TypeError, ValueError):
            continue
    return val


def load_config(cls, yaml_path: str | None = None, overrides: list[str] | None = None):
    """Build config dataclass from defaults <- YAML <- key=value overrides."""
    values: dict[str, Any] = {}
    if yaml_path:
        import yaml

        values.update(yaml.safe_load(Path(yaml_path).read_text()) or {})
    for ov in overrides or []:
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got {ov!r}")
        k, v = ov.split("=", 1)
        values[k] = v
    return config_from_values(cls, values)


def config_from_values(cls, values: dict):
    """Build a config dataclass from an already-merged value dict
    (YAML-typed or string values; strings are coerced per field type).
    Shared by :func:`load_config` and the ``cpsd reproduce`` matrix
    expansion."""
    import typing

    hints = typing.get_type_hints(cls)
    names = {f.name for f in fields(cls)}
    kwargs = {}
    for k, v in values.items():
        if k not in names:
            raise KeyError(f"unknown config key {k!r} for {cls.__name__}")
        typ = hints.get(k, str)
        kwargs[k] = _coerce(v, typ if isinstance(typ, type) else str) if isinstance(v, str) else v
    cfg = cls(**kwargs)
    for f in fields(cls):
        if getattr(cfg, f.name) is REQUIRED:
            raise ValueError(f"missing required config field {f.name!r}")
    return cfg


REQUIRED = object()  # sentinel: Hydra's ??? equivalent


@dataclass
class SVMDecodeConfig:
    """Classical cross-patient decode (aligned_decode_svm_ncv.py analog)."""

    target_pt: str = "S14"
    data: str = "synthetic"  # path to pt_decoding_data pkl or 'synthetic'
    p_ind: int = -1
    lab_type: str = "phon"
    algn_type: str = "phon_seq"
    strategy: str = "sep_align"  # sep_align | sep_dimred | joint_pca | mcca
    n_iter: int = 50
    n_folds: int = 20
    n_comp: float = 0.8
    max_k: int = 32
    lam: float = 1.0
    kernel: str = "rbf"
    tar_in_train: bool = True
    # -po flag: False = single-patient decode (no cross data pooled: the
    # reference's PCA+SVC-on-target-only branch,
    # aligned_decode_svm_ncv.py:415-437, fig_3's per-patient baseline)
    pool_train: bool = True
    # -pp flag: comma list of cross patients to pool ('all' = every
    # pre_pt; also covers the legacy -n/--no_S23 exclusion),
    # aligned_decode_svm_ncv.py:280-282
    pooled_pts: str = "all"
    # -tss flag: stratified per-fold subsample of the TARGET train split
    # (aligned_decode_svm_ncv.py:351-360)
    trial_subsample: float = 1.0
    # persist per-iteration y_true/y_pred/wrong_trs next to the accs
    # (out_data keys of aligned_decode_svm_ncv.py:440-456)
    save_preds: bool = True
    # nested Bayesian hyperparameter search per outer fold, the
    # reference's do_cv flag wiring BayesSearchCV(n_iter=25, n_points=5)
    # into the main driver (aligned_decode_svm_ncv.py:373-404);
    # nested_rounds x nested_points = its n_iter candidate budget
    nested: bool = False
    nested_rounds: int = 5
    nested_points: int = 5
    nested_inner: int = 5
    bagging: int = 0  # >0: bootstrap ensemble head (aligned_decode_svm.py:262)
    random_data: bool = False  # -r control: replace cross data with noise
    # none | tme | shuffle (supp_fig_11 controls)
    surrogate: str = "none"
    chance: bool = False  # label-shuffle chance decoding
    fold_batch: int = 20  # folds solved as one batch
    # iterations per batch of folds (stacked as extra fold rows;
    # per-iteration seeds and persistence unchanged)
    iter_batch: int = 1
    # fold sharding over n ranks, one device each (parallel/); 0 = one
    # device
    n_devices: int = 0
    # synthetic-data scale (data='synthetic' only): patients / trial length
    # / trials-per-class; reference scale is 8 patients, T=200
    synth_patients: int = 4
    synth_T: int = 40
    synth_trials: int = 15
    seed: int = 0
    out: str = "results/svm_decode.pkl"


@dataclass
class TrainSeq2SeqConfig:
    """Seq2seq trainer (train_seq2seq.py analog)."""

    data: str = "synthetic"  # path to pt_decoding_data*.pkl or 'synthetic'
    target_pt: str = "S14"
    p_ind: int = 1  # phoneme-position arrays to decode (train_seq2seq.py:82)
    lab_type: str = "phon"
    algn_type: str = "phon_seq"
    n_iter: int = 50
    n_folds: int = 20
    epochs: int = 500
    # minibatch size of the sequential path (fold_parallel=false); the
    # fold-parallel path takes one full-batch step an epoch
    batch_size: int = 5000
    n_filters: int = 100
    hidden: int = 500
    n_enc_layers: int = 1
    n_dec_layers: int = 1
    kernel_size: int = 10
    lr: float = 1e-4  # train_seq2seq.py:135
    weight_decay: float = 1e-5  # l2_reg, train_seq2seq.py:136
    clip: float = 0.5  # gclip_val, train_seq2seq.py:121
    # LinearLR decays over max_epochs in the reference (train_seq2seq.py:169)
    decay_iters: int = 500
    pooled: bool = True  # cross-patient aligned pooling
    # train the folds of an iteration through one fold trainer
    # (train/fold_parallel.py: one model per fold, in turn); false = one
    # train.loops.fit per fold with validation every epochs // 20
    fold_parallel: bool = True
    # folds per fold-trainer call (0 = all n_folds at once); each chunk's
    # models draw from their own seeds (seed + it + 31 * first fold). In
    # the port it sets only those seeds: the folds train one at a time
    # whatever the chunk, so it bounds no memory
    fold_chunk: int = 0
    # 'scan' | 'pallas': accepted for the JAX package's configs; the port
    # has one GRU route per device (the kernels on a CUDA tensor, their
    # plain versions on a CPU one), so both run the same code
    rnn_impl: str = "scan"
    # fold sharding over n ranks, one device each (parallel/; needs
    # fold_parallel, n must divide fold_chunk or n_folds); 0 = one device
    n_devices: int = 0
    # augmented copies of the pooled ALIGNED train rows (the reference's
    # post-alignment augmentation list, train_seq2seq.py:91:
    # time_shifting,noise_jitter,scaling); '' = none, 'all' = all five
    augmentations: str = ""
    log_metrics: bool = True  # per-epoch (or per-iteration) CSV logs
    log_format: str = "csv"  # csv | jsonl (tailable) | tb (TensorBoard)
    trace: bool = False  # device profile of the first iteration
    # synthetic-data scale (data='synthetic' only): 9 sequence classes x
    # synth_trials trials per patient (synth_trials is PER CLASS; the CTC
    # config's same-named knob is the total per patient). Reference
    # scale: 8 patients, ~150 trials (9 x 17 = 153), T=200.
    synth_patients: int = 3
    synth_T: int = 60
    synth_trials: int = 12
    seed: int = 0
    out: str = "results/seq2seq.csv"


@dataclass
class TrainNNConfig:
    """NN-classifier decode driver — the working version of the reference's
    ``scripts/aligned_decode_nn.py`` (which never constructs its classifier
    and crashes at :265; model surface `nn_models/models.py:393-596`):
    aligned cross-patient pooling -> NN classifier -> k-fold accuracy."""

    data: str = "synthetic"  # pt_decoding_data*.pkl path or 'synthetic'
    target_pt: str = "S14"
    p_ind: int = -1
    lab_type: str = "phon"
    algn_type: str = "phon_seq"
    model: str = "tcn"  # tcn | transformer | cnn_transformer | conv_rnn
    pooled: bool = True  # aligned cross-patient pooling (False: target only)
    n_iter: int = 50
    n_folds: int = 20
    epochs: int = 100
    batch_size: int = 5000
    n_filters: int = 100
    hidden: int = 128
    d_model: int = 64
    n_heads: int = 4
    n_layers: int = 2
    dim_ff: int = 256
    kernel_size: int = 10
    dropout: float = 0.3
    n_comp: float = 0.9
    max_k: int = 24
    lr: float = 1e-3
    weight_decay: float = 1e-5
    clip: float = 0.5
    decay_iters: int = 20
    log_metrics: bool = True  # per-epoch CSV under logs/{run_name}/
    log_format: str = "csv"  # csv | jsonl (tailable) | tb (TensorBoard)
    trace: bool = False  # device profile of the first iteration
    # data-parallel classifier step over n ranks, one device each
    # (parallel/); 0 = one device
    n_devices: int = 0
    seed: int = 0
    out: str = "results/nn_decode.pkl"


@dataclass
class TrainCTCConfig:
    """CTC trainer (train_ctc_rnn.py analog).

    ``data`` is 'synthetic' or a path to the reference CTC HDF5 file
    (keys ``{pt}/norm_rt_HG_pow[_z]``/``labels_train``/test splits —
    train_ctc_rnn.py:264-320). File-backed runs honor the full reference
    ingestion: tw crop, sil tokens, per-patient pooling with the
    only-train patient list, stratified target subsampling, tuned-hparam
    overrides, and optional precomputed PCA/CCA transforms.
    """

    data: str = "synthetic"
    target_pt: str = "S14"
    train_pts: str = ""  # comma list of pooled patients ('' = target only)
    only_train_pts: str = "S33"  # pts with 1 data block (train_ctc_rnn.py:125)
    zscore: bool = False
    tw_orig: str = "0,4"
    tw_select: str = "0.5,3.5"
    n_sil: int = 0
    target_subsample: float = 1.0  # stratified train-size fraction
    # stratified fraction of each CROSS patient's pooled trials (the
    # fig_5 data-scaling axis: PER vs cross-patient trial count; the
    # log-regression cell of fig_5.ipynb fits over runs at several
    # fractions) — 1.0 pools everything
    cross_subsample: float = 1.0
    hparam_dir: str = ""  # tuned-hparams h5 dir (train_ctc_rnn.py:375-423)
    pca_path: str = ""  # precomputed {pt}/components h5 (tune_ctc_rnn.py:1050)
    cca_path: str = ""  # precomputed {src}_to_{tgt}/components h5
    align_pt: str = ""  # alignment space for precomputed CCA ('' = target)
    context: str = "aligned"  # chance | patient | unaligned | aligned
    n_iter: int = 50
    epochs: int = 300
    # minibatch size (training.batch_size: 512 in the reference YAML);
    # 0 = full-batch, one step per epoch (the JAX package's default)
    batch_size: int = 0
    # train-set augmentations (training.augmentations YAML list): comma
    # list of time_warping,time_masking,time_shifting,noise_jitter,scaling;
    # 'all' = every transform appending one augmented copy of the pooled
    # train set (realtime_datamodule.py:239-244). NOTE the reference YAML
    # ships with all five ENABLED — pass augmentations=all for the exact
    # reference training recipe; '' keeps the default run 6x lighter.
    augmentations: str = ""
    hidden: int = 128
    n_layers: int = 2
    dropout: float = 0.3
    win_size: int = 14
    stride: int = 4
    lr: float = 1e-3  # training.learning_rate (train_ctc_rnn_config.yaml)
    weight_decay: float = 1e-4  # model.l2_reg in the reference YAML
    decay_steps: int = 100
    clip: float = 5.0  # training.gclip_val in the reference YAML
    n_components: float = 0.9
    val_frac: float = 0.2  # training.val_size in the reference YAML
    test_frac: float = 0.2
    decode: str = "greedy"  # greedy | beam (prefix beam rescoring at test)
    beam_size: int = 100
    # chance-context label null: 'permute' shuffles the real labels across
    # trials (train_ctc_rnn.py:155-158, marginal-preserving); 'random'
    # draws fresh uniform phoneme sequences (tune_ctc_rnn.py
    # make_chance_labels)
    chance_mode: str = "permute"
    # persist per-iteration test-set log-probs in the results pkl like the
    # reference's results-h5 'logits' dataset (train_ctc_rnn.py:448-491)
    save_logits: bool = False
    log_metrics: bool = True  # per-epoch CSV under logs/{run_name}/
    log_format: str = "csv"  # csv | jsonl (tailable) | tb (TensorBoard)
    trace: bool = False  # device profile of the first iteration
    # data-parallel training over n ranks, one device each (parallel/);
    # 0 = one device
    n_devices: int = 0
    # synthetic-data scale (data='synthetic' only): reference CTC
    # production scale is 8 patients, ~250 trials, T=600 bins (4 s @
    # 200 Hz cropped to 3 s). synth_trials is the TOTAL per patient,
    # rounded down to a multiple of the 27 sequence classes (unlike
    # TrainSeq2SeqConfig.synth_trials, which is per class).
    synth_patients: int = 3
    synth_trials: int = 120
    synth_T: int = 200
    seed: int = 0
    # warm-start every iteration from a reference Lightning checkpoint
    # (models.torch_import): the architecture comes from the checkpoint
    init_ckpt: str = ""
    out: str = "results/ctc.pkl"  # incremental per-iteration results (resume)
    # additionally write the reference's results-h5 layout
    # (train_ctc_rnn.py:448-491: phoneme_error_rate/logits/phon table/
    # model_hparams attrs) at this path when set
    results_h5: str = ""


@dataclass
class TuneCTCConfig:
    """CTC hyperparameter sweep (tune_ctc_rnn.py analog)."""

    data: str = "synthetic"  # 'synthetic' or the reference CTC h5 path
    target_pt: str = "S14"
    train_pts: str = ""
    only_train_pts: str = "S33"
    zscore: bool = False
    tw_orig: str = "0,4"
    tw_select: str = "0.5,3.5"
    n_sil: int = 0
    pca_path: str = ""  # precomputed transforms (tune_ctc_rnn.py:1050-1079)
    cca_path: str = ""
    align_pt: str = ""
    n_trials: int = 30
    rungs: str = "30,100"  # successive-halving epoch rungs
    eta: int = 3
    # per-trial k-fold CV (the reference CV trainable, train_func_cv /
    # CTCHeldOutTargetVal[Align]CVDataModule, tune_ctc_rnn.py:550-634;
    # reference uses 5): each trial's metric is the fold-mean val PER.
    # 0 = single held-out val split (the cheap default). Pooled contexts
    # with on-the-fly fitting refit PCA/CCA per fold on that fold's
    # target-train rows (the leak-free AlignCV semantics).
    cv_folds: int = 0
    align_train: bool = False  # tune_ctc_rnn_align: pool aligned cross data
    pool_train: bool = False  # pool unaligned cross data (tune_ctc_rnn)
    sampler: str = "random"  # random | tpe (BOHB-style model-based search)
    # (trial x fold) model sharding over n ranks, one device each
    # (parallel/); 0 = one device
    n_devices: int = 0
    # how many fold models of the CV trainable train concurrently in the
    # JAX package (0 = all at once); validated as there, but the port
    # trains the models one at a time whatever its value
    model_chunk: int = 0
    n_components: float = 0.9
    # synthetic-data scale (data='synthetic' only; see TrainCTCConfig)
    synth_patients: int = 3
    synth_trials: int = 120
    synth_T: int = 200
    seed: int = 0
    manifest: str = "results/tune_manifest.jsonl"
    # tune -> train handoff: when set, the winning config is written as
    # {hparam_out}/{pt}/{pt}_ctcRNN_{context}_hp.h5 — the reference's
    # tuned-hparams layout consumed by `cpsd train-ctc hparam_dir=...`
    hparam_out: str = ""


@dataclass
class MakeXformsConfig:
    """Generate the offline PCA/CCA transform h5s that ``tune-ctc`` /
    ``train-ctc`` consume via ``pca_path=``/``cca_path=``
    (`tune_ctc_rnn.py:1050-1079` contract: ``{pt}/components`` and
    ``{src}_to_{tgt}/components``). The reference repo only ever READS
    these files (its generator lived outside the repo); this command
    produces them from a CTC dataset."""

    data: str = "synthetic"  # 'synthetic' or the reference CTC h5 path
    target_pt: str = "S14"
    train_pts: str = ""  # comma list of source patients ('' = all others)
    only_train_pts: str = "S33"
    zscore: bool = False
    tw_orig: str = "0,4"
    tw_select: str = "0.5,3.5"
    n_components: float = 0.9  # variance fraction per patient
    seed: int = 0
    pca_out: str = "results/pca_xforms.h5"
    cca_out: str = "results/cca_xforms.h5"


@dataclass
class AnalyzeConfig:
    """Statistical comparison of saved experiment results (the fig_4 /
    fig_5 notebook flows applied to driver output pickles)."""

    # comma-separated name=path pairs of incremental results pickles,
    # e.g. "patient=results/ps.pkl,aligned=results/aligned.pkl"
    inputs: str = ""
    alpha: float = 0.05
    test: str = "wilcoxon"  # wilcoxon | permutation (paired, per iteration)


@dataclass
class RealtimeSimConfig:
    """Streaming decode simulation + latency report."""

    n_channels: int = 64
    bin_len: int = 10
    n_bins: int = 400
    hidden: int = 128
    n_layers: int = 2
    n_classes: int = 11
    seed: int = 0
    # stream a trained model instead of a random-init one: path to a
    # reference Lightning checkpoint (models.torch_import) — architecture
    # and channel count then come from the checkpoint, overriding the
    # hidden/n_layers/n_classes/n_channels fields above
    ckpt: str = ""
    # per-step latency distribution: number of timed samples (0 = skip,
    # report only the amortized figure); each sample runs
    # ``per_step_chain`` single steps before one synchronisation
    per_step_samples: int = 0
    per_step_chain: int = 200
    # persist the measured latency distribution for offline analysis
    # (analysis.latency — the supp_fig_20/24 flows)
    out: str = ""


@dataclass
class ReproduceConfig:
    """Manifest-driven full-matrix orchestration (``cpsd reproduce``).

    The reference's de-facto top-level driver is a SLURM job array over
    patients x strategies x contexts (the reference repository's `README.md:27`;
    each script parameterized per target, e.g.
    `aligned_decode_svm_ncv.py:114-120`). Here one manifest YAML expands
    into sequenced driver invocations with cross-matrix resume: jobs
    whose incremental result pickles already hold ``n_iter`` iterations
    are skipped, partially-done jobs resume from their last completed
    iteration (the per-driver ``_completed_results`` machinery).

    Manifest format::

        defaults:            # optional, merged into every job
          data: synthetic
          n_iter: 50
        jobs:
          - command: svm-decode
            matrix:          # cross-product, expanded in listed order
              target_pt: [S14, S26]
              strategy: [sep_align, joint_pca]
            overrides:       # per-job fixed values; strings may use
              n_folds: 20    # {placeholders} from the matrix point
              out: "results/svm/{target_pt}_{strategy}.pkl"
    """

    manifest: str = ""  # path to the matrix YAML (required)
    dry_run: bool = False  # print the expanded matrix and exit
    keep_going: bool = False  # continue past a failed job
    # comma filter: run only jobs whose command OR expanded out-path
    # contains one of these substrings ('' = all)
    only: str = ""
    # forwarded to every expanded config that has an n_devices field
    # (0 = leave each job's own value)
    n_devices: int = 0
