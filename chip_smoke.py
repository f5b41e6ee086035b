#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card (Hopper, sm_90a) and check it.

Run from the repository root with no arguments:

    python3 chip_smoke.py

or, for phases 1 and 2 and then the windowed backward with the frames'
gradient at the ``b2t_gru`` cell's shape alone (row ``gru_wbwd_dx`` of
phase 7), or the forward or the backward kernels at the shapes whose
sweep steps split K over a cluster alone, or the bidirectional windowed
layer 0 at the ``b2t24_bigru`` cell's shape alone (its last rows):

    python3 chip_smoke.py gru_wbwd_dx
    python3 chip_smoke.py fwd_split
    python3 chip_smoke.py bwd_split
    python3 chip_smoke.py wbidir

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
   steps, then one profiled step;
4. ctc_train (slice 2's main path), same geometry: at dropout 0 the loss
   and every parameter's gradient through the kernels against the plain
   forwards and plain backward functions on the card; then, with the
   launch counts zeroed just before and read just after, one
   ``make_ctc_train_step`` step at dropout 0.3 with AdamW, which must
   launch all four kernels; then the median of 3 more steps, samples/s,
   model TFLOP/s and peak memory;
4a. ctc_driver (slice 9's main path): ``cli.experiments.run_train_ctc``,
   the ``train-ctc`` entry point, in the aligned context at the
   reference's production scale (8 synthetic patients of 243 trials,
   T=600, made on the card), fig_5 width, batch 512, all five
   augmentations, beam 100, dropout 0.3, one iteration of 2 epochs (the
   epochs cut), writing its results under a temporary ``out``. With the
   launch counts zeroed just before and read just after, the iteration
   must launch exactly 7 ``jacobi_eigh`` (one per CCA fit), one
   ``gru_wbwd`` and two ``gru_bwd`` per train step and one ``gru_wfwd``
   and two ``gru_fwd`` per forward (train steps, validation, test,
   beam and saved log-probs), counted by wrappers; the plain GRU and
   Jacobi versions raise on CUDA tensors throughout. Finite losses, PER in
   [0, 100 x 147 / 3], the native beam search taken and equal to the
   Python one on 8 test rows, results_h5 read back where h5py is
   installed, and a second call resuming with no launch. Prep (PCA, CCA),
   epoch, validation and beam times, samples/s, wall time, peak memory
   and a profiled epoch. Then hidden 64 x 2, 3 patients, T=200, one epoch
   at dropout 0 on the card and on the CPU from the same data: latents,
   validation losses and PER against each other, and ``fir_filter``
   under the caller's TF32 against the CPU;
4b. tune_ctc (slice 13's main path): ``cli.experiments.run_tune_ctc``,
   the ``tune-ctc`` entry point, on the CTC driver's data (8 synthetic
   patients of 243 trials, T=600, aligned): BOHB with TPE (4 trials, rungs
   of 1 and 2 epochs, eta 3), its widths drawn from the reference's space.
   With the launch counts zeroed just before and read just after, the run
   must launch exactly 7 ``jacobi_eigh`` (one chol fit a cross patient)
   and, per model of L layers trained E epochs, E + 1 ``gru_wfwd``,
   (E + 1)(L - 1) ``gru_fwd``, E ``gru_wbwd`` and E (L - 1) ``gru_bwd``;
   results in JAX's order with finite PERs; a second call on the same
   manifest launches nothing. Then ``make_ctc_bucket_trainer`` on that
   run's train and validation sets at fig_5 width (hidden 512 x 3, dropout
   0.3), two trials of 2 epochs: exactly 6 / 12 / 4 / 8 launches, ms a
   trial-epoch, samples/s, peak memory and the idle share of one profiled
   trial-epoch. Then ``cv_folds=5 model_chunk=1`` (2 trials, one rung of
   1 epoch): every fold's prep refitted, 35 ``jacobi_eigh``, the B x F
   models in turn. Then make-xforms at the same scale (``run_make_xforms``
   where h5py imports, else its computation ``compute_xforms``): exactly
   the ``jacobi_eigh`` launches the latent widths give
   (``xform_jacobi_launches``), the PCA components bit for bit the CPU's
   and each source's projection within 1e-3 of the CPU's from the same
   host data. Then ``run_realtime_sim`` from a Lightning checkpoint the
   script writes in the reference's layout (60 channels, hidden 512 x 3,
   window 14 / stride 4, 11 classes, seed 0): 400 bins, 100 per-step
   samples of 20 steps, exactly 3 ``gru_fwd`` a GRU step, the timed
   stream's logits within 5e-3 of the imported model's offline forward,
   p50 below the 10 ms bin, the out pickle with JAX's keys. Last, small
   depth on the card and on the CPU from the same data and initial
   weights: two trials of one bucket (hidden 16 x 2, 2 epochs, dropout 0)
   and one ``run_train_ctc init_ckpt=`` iteration;
5. streaming: 400 bins of 60 channels x 10 samples through the same
   model, with the launch counts zeroed just before and read just after;
   online logits checked against the offline forward, the offline forward
   against the plain versions, and one streaming window through
   ``gru_fwd`` against its plain version at B=1, T=1, layer by layer;
5'. ctc_bidir (the bidirectional RealtimeRNN's main path): the model at
   the same fig_5 width (hidden 512 x 3, window 14 / stride 4, B=2000,
   T=600): with the launch counts zeroed just before and read just after,
   one ``make_ctc_eval_step`` step must launch exactly 3 ``gru_bifwd``
   and nothing else (BIDIR_EVAL_LAUNCHES), its logits held against the
   same forward through the plain versions on the card; at dropout 0 the
   loss and every gradient through the kernels against the plain
   forwards and backward functions; one ``make_ctc_train_step`` step at
   dropout 0.3 with AdamW must launch exactly 3 ``gru_bifwd`` and 6
   ``gru_bwd`` (layer 0 bf16 without dx, both directions) and no windowed
   kernel (BIDIR_TRAIN_LAUNCHES), the plain versions raising on CUDA
   tensors throughout; the median of 3 steps of each kind, samples/s,
   peak memory, one profiled train step. Then ``gru_bifwd`` alone at the
   layer-0 shape (147 x 2000 windows of 840 bf16 features, H=512) against
   its plain version, timed beside it and cuDNN's bidirectional GRU, and
   ``gru_bwd`` reversed, bf16, no dx, at that shape against its plain
   version. Then an LSTM Seq2SeqRNN at the seq2seq bench geometry (B=1000,
   T=200, C=30, 100 filters of width 10, hidden 500) at dropout 0 and
   teacher forcing 1 against the same model with ``torch.nn.LSTM`` (cuDNN)
   on the same weights (logits 1e-4 relative, gradients GRAD_RTOL), and
   its ``make_seq2seq_train_step`` (no GRU launch, the median of 3 steps);
   last, a reference seq2seq checkpoint of a GRU and of an LSTM cell,
   written by the script from torch modules at those widths, read by
   ``seq2seq_from_ckpt`` onto the card, its eval logits at teacher forcing
   1 against the modules' own forward (1e-4 relative, 64 trials);
5a. seq2seq_train (slice 4's main path): a Seq2SeqRNN at the JAX
   package's bench geometry (bench.py:section_seq2seq: B=1000, T=200,
   C=30, 100 conv filters of width 10, hidden 500, 3 decoder steps, 9
   classes; seed 0; depth not cut). At dropout 0 and teacher forcing 1
   the loss and every parameter's gradient through the kernels against
   the same model through the plain GRU versions on the card; then, with
   the launch counts zeroed just before and read just after, one
   ``make_seq2seq_train_step`` step at dropout 0.3, teacher forcing 0.5,
   AdamW, whose exact launches are asserted (SEQ2SEQ_TRAIN_LAUNCHES); the
   median of 3 more steps, samples/s, model TFLOP/s, peak memory and one
   profiled step; the conv with TF32 switched on by the caller;
5b. seq2seq_eval: ``make_seq2seq_eval_step`` on the same batch, with its
   exact launches (SEQ2SEQ_EVAL_LAUNCHES), logits, loss and accuracy
   against the plain path on the card, the median of 3 steps;
5c. seq2seq_driver (slice 11's main path): ``cli.experiments.
   run_train_seq2seq``, the ``train-seq2seq`` entry point, fold-parallel,
   at the reference's width (100 filters of width 10, hidden 500, one
   encoder and one decoder layer, dropout 0.3, teacher forcing 0.5, AdamW)
   and data scale (8 synthetic patients of 9 classes x 17 trials, a pooled
   set of 1224, T=200, made on the card; 20 folds in one chunk); cut: one
   iteration of 2 epochs (the reference: 50 of 500). With the launch
   counts zeroed just before and read just after, the iteration must
   launch exactly 7 ``jacobi_eigh`` (one per source patient's chol CCA
   fit, batched over the folds at K = 24), per fold and epoch one train
   step's kernels and per fold one evaluation's (``s2s_driver_launches``:
   60 ``gru_bifwd``, 180 ``gru_fwd``, 200 ``gru_bwd``), counted by the
   wrappers; the plain GRU and Jacobi versions raise on CUDA tensors.
   Accuracies finite in [0, 1], the results CSV and the progress pickle
   written, a second call resuming with no launch. Every Jacobi batch of
   that run (20 x 24 x 24) bit for bit its plain version, and the first
   ``gru_bifwd``, ``gru_fwd`` and ``gru_bwd`` launch of each shape (the
   encoder both ways and the decoder, at the fold's B = 1224) against
   their plain versions on the same inputs (forward 1e-4, backward 1e-3
   relative). Iteration wall time,
   the per-fold features' ms (PCA, CCA), ms per fold-epoch, training
   samples/s, eval ms, peak memory, and the device idle share of one
   fold-epoch and of one whole iteration under ``torch.profiler``. Then
   hidden 32, 8 filters, 3 patients, T=40, 4 folds, 3 epochs at dropout 0
   and teacher forcing 1 on the card and on the CPU from the same data and
   weights: per-fold latents on the target's separated columns (2e-4, 1e-3
   mapped), every fold-epoch loss within 1e-3, accuracies equal up to the
   test trials whose top two logits lie within 1e-4; the same on the card
   with the reference's post-alignment augmentations (masks tiled over the
   copies); and ``run_prewarm_seq2seq`` at that depth;
5d. train_nn (slice 14's main path): ``cli.experiments.run_train_nn``,
   the ``train-nn`` entry point, for each of the four model families
   (``tcn``, ``transformer``, ``cnn_transformer``, ``conv_rnn``) at
   ``TrainNNConfig``'s default widths (100 filters of width 10, hidden
   128, d_model 64, 4 heads, 2 layers, dim_ff 256, dropout 0.3, max_k 24,
   batch 5000: one full-batch step an epoch) on a ``pt_decoding_data``
   pickle the script writes at the reference's scale (the eight paper
   patients of 9 classes x 15 trials, T=200, target S26); cut: one
   iteration of 20 folds x 2 epochs (the reference: 50 of 20 x 100).
   With the launch counts zeroed just before and read just after, the
   iteration must launch exactly one ``jacobi_eigh`` a source and fold
   (140) and, for ``conv_rnn``, per fold n_layers x (epochs + 1)
   ``gru_fwd`` and n_layers x epochs ``gru_bwd`` with dx (120 and 80;
   none for the other families: ``nn_driver_launches``); the plain GRU
   and Jacobi versions raise on CUDA tensors; the first launch of each
   shape of those kernels against its plain version (GRU forward 1e-4,
   backward 1e-3 relative, Jacobi bit for bit); accuracies finite in [0,
   1]; the results pickle with JAX's keys; a second call resumes with no
   launch. Iteration wall time, ms per fold-epoch, training samples/s,
   per-fold PCA and CCA ms, eval ms, peak memory and, for ``conv_rnn``,
   the idle share of one profiled fold-epoch. Then 3 patients, T=40, 4
   folds, narrow widths at dropout 0 for all four families on the card
   and on the CPU from the same file and weights: every fold-epoch loss
   within 1e-3, accuracies equal up to the test trials whose top two
   logits lie within 1e-4;
5e. reproduce (slice 15's main path): ``cli.main.main(["reproduce",
   "manifest=..."])``, the ``cpsd reproduce`` entry point on its default
   device, over a manifest of six ``manifests/paper.yaml`` jobs at target
   S26, each at the data scale and widths of the earlier phase for its
   driver: svm-decode sep_align and joint_pca and the svm-chance control
   (the svm_decode phase's scale, on a decoding pickle of the eight paper
   patients noisy enough that the accuracies vary, 10 iterations of 50),
   train-seq2seq
   pooled (fold_chunk 4, rnn_impl pallas; the seq2seq_driver phase's
   scale, 1 iteration of 2 epochs), train-nn conv_rnn (the train_nn
   phase's file, 1 iteration of 2 epochs), train-ctc aligned at fig_5
   width with ``log_format: tb`` (the ctc_driver phase's data, 1
   iteration of 2 epochs); the cuts listed in REPRO_REDUCED. With the
   launch counts zeroed just before and read just after, each job must
   launch exactly what the earlier phases derive for its config (70 / 0 /
   70 ``jacobi_eigh`` for the svm jobs, ``s2s_driver_launches``,
   ``nn_driver_launches``, the CTC driver's per step and per forward),
   all six kernels must run, and the plain versions raise on CUDA
   tensors; the first launch of each kernel at each shape in that run
   (the CTC job's full and partial batches among them) against its plain
   version (GRU forward 1e-4, backward 1e-3 relative, Jacobi bit for
   bit); the sep_align job's accuracies equal a direct
   ``run_svm_decode`` of its config; the CTC job's event files parse
   (both CRCs) with one event an epoch whose values are the records
   ``append_metrics`` was handed, to float32. A second call skips every
   job with no launch in under 2 s; a dry run of the chance job leaves
   every results file's bytes and mtime. ``cpsd analyze`` over the three
   svm results: three pairwise rows and the ANOVA, equal to the same call
   on a copy of the files, the Wilcoxon p-values within 1e-12 of
   ``scipy.stats.wilcoxon``, and at least one row's p finite and above
   the least that 10 pairs allow. Then the analysis library on the
   sep_align job's pooled features (1080 trials x 6400) on the card
   against the CPU: the silhouette samples and their positive mean over
   the CPU's positive samples within 1e-4 of the silhouette's range (a
   sample whose sign differs must lie within their error of 0);
   Calinski-Harabasz, Davies-Bouldin, ``pt_corr_multi`` (r and p, of the
   matched conditions and of the mismatched ones, whose p-values lie
   inside (0, 1)) and ``pt_corr_dims`` within 1e-4 relative; t-SNE's
   affinities within 1e-3 of the largest, each of its first 10 steps from
   the CPU's state within 1e-4 of max |y|, the final KL divergence of 500
   iterations within 2 % (the free-running first 10 iterations are
   reported: the loop is chaotic). Job walls, the matrix's overhead, the
   resume's wall, analyze ms, t-SNE ms and idle share, peak memory;
5f. parallel (slice 17's main path): ``parallel/`` over
   ``torch.distributed``, ranks started by ``parallel.launch``. (a) One
   NCCL rank: ``make_padded_sharded_ctc_train_step`` at fig_5 width
   (B=2000) at dropout 0 against ``make_ctc_train_step`` from the same
   state (loss 1e-4 relative, every gradient 1e-3 x max abs), with the
   launch counts zeroed just before one step and read just after
   (exactly 1 ``gru_wfwd``, 2 ``gru_fwd``, 1 ``gru_wbwd``, 2 ``gru_bwd``)
   and the first launch of each kernel shape against its plain version;
   then the step at dropout 0.3 timed beside the one-device step (median
   of 3), the all-reduce's time, the NCCL kernels' device time and the
   idle share of a profiled step. (b) Two gloo ranks sharing cuda:0: the
   same step on B - 1 = 1999 rows (one zero-weight pad row, 1000 rows a
   rank) against the one-device step on those rows, the launches and the
   first launches checked on each rank, the replicas' parameters equal;
   ``run_svm_decode`` sep_align with ``n_devices=2`` on the reproduce
   phase's noise-24 pickle (20 folds, 10 a rank) against ``n_devices=0``:
   predictions equal on the decided trials, exactly 7 ``jacobi_eigh`` a
   rank, each rank's first Jacobi batch bit for bit its plain version;
   ``run_train_seq2seq`` fold-parallel (4 folds) with ``n_devices=2``
   against ``n_devices=0``: every fold's accuracy and every fold-epoch's
   loss bit for bit; ``dryrun_multichip(2)``;
6. alignment (slice 3's main path): the natively batched
   ``fit_cca_aligner`` at the JAX package's bench geometry
   (bench.py:section_alignment: 128 pairs of 150 trials x 200 bins x 40
   latents, 27 classes, flat layout). For each method, the Jacobi launch
   count of one fit (zeroed just before, read just after) must be chol 1,
   gram 2, svd 0; the kernel route is held against the same fit through
   the plain Jacobi on the card, the first 4 pairs above the Gram floor
   (see GRAM_FLOOR) against a float64 copy of the bench's numpy oracle,
   and one chol fit with TF32 switched on by the caller against both; the
   same oracle pairs fitted one at a time by chol and gram (the kernel
   then takes batches of 1 and 2), with their launches, against the
   oracle within the same bounds; fit times (median of 5), fits/s,
   plain-route fit times and one profiled chol fit; then
   ``fit_mcca_aligner`` and ``joint_pca_fit`` on the card against the
   CPU;
6a. svm_decode (slice 10's main path): ``cli.experiments.run_svm_decode``,
   the ``svm-decode`` entry point, sep_align with the RBF kernel ridge
   head at the reference's scale (8 synthetic patients of 9 classes x 15
   trials, a pooled training set of 1080, T=200, max_k 32, made on the
   card): 2 fixed-parameter iterations of 20 folds in one batch (the
   iterations cut from 50), then one nested iteration (20 outer folds, 2
   TPE rounds of 5 points x 5 inner folds; the rounds cut from 5). With
   the launch counts zeroed just before each call and read just after, a
   fixed iteration must launch exactly 7 ``jacobi_eigh`` (one per source
   patient's batched chol CCA fit) and the nested one 77 (7 per fit batch:
   5 scoring batches a round, one refit batch), counted by the wrapper,
   and nothing else; the plain Jacobi version raises on CUDA tensors;
   accuracies finite in [0, 1]; a second call resumes with no launch.
   Iteration wall time, folds/s, peak memory, the prep (PCA, CCA), fit
   and predict ms of one more iteration (each part synchronised) and its
   device idle share under ``torch.profiler``. Then 3 patients, T=40, 4
   folds on the card and on the CPU from the same data, at the driver's
   noise and at one that leaves hard trials (the CPU's Jacobi on the
   kernel's route through its plain version): all four strategies
   and a bagged head of 3, predictions equal where the CPU's top two
   scores differ by more than 1e-4 of their magnitude, fold accuracies
   within the weight of the undecided test trials, sep_align's latents
   on the target's separated columns within 2e-4 (PCA) and 1e-3 (mapped
   sources);
6b. subsample (the sweeps' main path): ``cli.subsample_experiments``, the
   ``subsample-{trials,grid,spatial,pitch}`` entry points, on the files
   the reference's drivers read, written to a temporary directory at its
   scale (the eight paper patients of 9 classes x 15 trials, T=200, the
   port's synthetic widths with S26 at 111; geometry ``.mat`` files of
   the figure notebooks' channel maps and seeded significant channels; a
   ``pt_savg_data`` pickle of 2x2 and 4x4 contact averages), target S26
   at ``SubsampleConfig``'s defaults (5 folds, max_k 24, sep_align): the
   trial sweep (k 5-130 by 25), the grid sweep (windows 2, 4, 8), the
   spatial average (contacts 2, 4) and the pitch sweep (1.5, 2.5, 4 mm),
   each point twice (cut from 10), and one nested trial point (k 130, 2
   TPE rounds of 3 points x 3 inner folds). With the launch counts zeroed
   just before each sweep and read just after, each decode must launch
   exactly the ``jacobi_eigh`` count its sources' PCA widths give
   (``sweep_jacobi_launches``: one a source and fit batch from K = 24;
   none for the 2- and 4-wide windows, one a source for the trial sweep),
   and nothing else; the plain Jacobi and GRU versions raise on CUDA
   tensors; accuracies finite in [0, 1], the results pickles with the
   JAX driver's keys. Then ``run_svm_decode`` at the svm_decode phase's
   scale with ``surrogate=tme`` (a 1000-step TME fit per cross patient on
   the card: each within 5 % of the data's largest marginal eigenvalue,
   one against the CPU's fit over 200 steps within 1e-3, 20 card samples'
   mode-1 scatter against the implied eigenvalues) and ``shuffle`` (two
   surrogates redrawn on the CPU bit for bit), 7 ``jacobi_eigh`` each.
   Wall time, decodes/s and ms per decode a sweep, TME ms per patient and
   µs per step, peak memory, the device idle share of one profiled
   trial-sweep decode; the kernel bit for bit its plain version on the
   first batch of each shape the phase gave it. Then each sweep at small
   depth (4 patients, T=40, one iteration a point) on the card and on the
   CPU: the same masks and indices, predictions equal where the CPU's top
   two scores differ by more than 1e-4 of their magnitude, accuracies
   within the weight of the undecided test trials;
7. kernels: each kernel against its plain version at the fig_5 shapes
   (``gru_bifwd`` at the seq2seq encoder's, two runs bitwise equal) and
   at small odd shapes, with
   times of the kernel, the plain version and ``torch.nn.GRU`` (its
   backward for the backward kernels, bidirectional for ``gru_bifwd``,
   beside which the two-``gru_fwd`` alternative is timed too), and its
   bound; the Jacobi kernel on the alignment fit's own Gram batches and
   odd shapes (one sweep and full solves bit for bit equal to the plain
   version, as are two launches; full solves against float64) and at
   every even Kp from 2 to 64 at batch 1 and 133, timed against its plain
   version and ``torch.linalg.eigh``, with µs a step; ends with the
   ``{"kernels": [...]}`` line (rows 1-5 also carry each ``tune_ctc``
   run's launches: ``launches_tune_ctc*``, ``launches_make_xforms``,
   ``launches_realtime_sim``), whose launch counts are the CTC train
   step's, for ``gru_bifwd`` the seq2seq train step's and, for the Jacobi
   kernel, the chol fit's, with its launches per svm-decode iteration
   (fixed and nested) and per subsample run (``launches_subsample_*``)
   beside them, and for ``gru_bifwd``, ``gru_fwd``, ``gru_bwd`` and
   ``jacobi_eigh`` their launches per ``seq2seq_driver`` iteration and,
   for ``gru_fwd``, ``gru_bwd`` and ``jacobi_eigh``, per ``train_nn``
   iteration of each family that launches them, and for every kernel its
   launches in the ``reproduce`` phase's matrix (``launches_reproduce``),
   and for ``gru_bifwd`` and ``gru_bwd`` their launches per ``ctc_bidir``
   step (``launches_ctc_bidir_*``) and their times at its layer-0 shape
   (``*_ctc_bidir_layer0``, ``*_ctc_bidir_layer0_reversed``), and for
   every kernel its launches a rank in the ``parallel`` phase
   (``launches_parallel_*``). Row ``gru_wbwd_dx`` is
   ``gru_wbwd`` with the frames' gradient at the ``b2t_gru`` cell's mean
   padded shape, against its plain version to 1e-5 of each output's
   largest value, its launches those of one ``BrainToTextGRU`` train step
   at the published widths (every forward step split over a cluster of
   8, every backward sweep step over one of 16), timed beside cuDNN's
   backward over the materialised windows (``phase_kernel_wbwd_dx``).
   Rows ``gru_fwd_b2t``, ``gru_wfwd_b2t`` and ``gru_fwd_fig5_train`` are
   the forward kernels at the train cells' shapes whose steps split K over
   a cluster, against their plain versions to KERNEL_ATOL, with the
   cluster size (``step_split``) and the step kernel's µs a launch
   (``phase_kernels_fwd_split``); the last rows, ``gru_bwd_b2t``,
   ``gru_wbwd_b2t`` and ``gru_bwd_fig5_train``, the backward kernels
   there, dx formed, against their plain versions to 1e-5 of each
   output's largest value, with the backward sweep's cluster size and
   its step launch's µs (``phase_kernels_bwd_split``). These six rows'
   launches are those this run counted in a train step of their cell
   (row ``gru_wbwd_dx``'s b2t step, phase 4's fig_5 step); run alone
   (``fwd_split``, ``bwd_split``) they are null. Row ``gru_wbidir`` is
   the bidirectional windowed layer 0 (a ``gru_wfwd`` and a ``gru_wbwd``
   with the frames' gradient a direction, the second reversed) at the
   ``b2t24_bigru`` cell's longest batch, forward and backward against
   its plain version on the card to 1e-5 of each output's largest value,
   two runs bitwise equal, the frames' gradient the two directions'
   ``gru_wbwd`` folds added bit for bit, its launches those of one train
   step of the '24 baseline at the published widths (with the cluster
   size of every sweep step), timed beside cuDNN's bidirectional GRU over
   the materialised windows, with the two forward calls against one
   ``gru_bifwd`` over the same windows (bit for bit), the fold and the
   add alone and the day layers at this cell's and at ``b2t_gru``'s batch
   (``phase_kernel_wbidir``; alone: ``python3 chip_smoke.py wbidir``).

Then the nvidia-smi line, and last ``{"ok": true, "device": {...}}``.
Exits non-zero without a CUDA card, and in a directory without the port.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

# fig_5 geometry (the JAX package's bench.py section_ctc)
B, T, C, H, N_LAYERS, N_CLASSES, WIN, STRIDE = 2000, 600, 60, 512, 3, 11, 14, 4
N_WIN = (T - WIN) // STRIDE + 1
# H100 SXM peaks (NVIDIA data sheet): float32 SIMT, bf16 and TF32 dense
# tensor cores, HBM3
PEAK_F32_SIMT = 67e12
PEAK_BF16_TC = 989e12
PEAK_TF32_TC = 495e12
PEAK_HBM = 3.35e12
# the unidirectional GRU kernels' products (forward and backward) run as
# 3xTF32 (three TF32 products per float32 product, gru_mma.cuh), two where
# the A operand is bf16 (exact in TF32): their float32-equivalent peaks
PEAK_3XTF32 = PEAK_TF32_TC / 3
PEAK_2XTF32 = PEAK_TF32_TC / 2
KERNEL_ATOL = 1e-4  # kernel vs plain on hs: float32 sums in another order
LOGITS_ATOL = 1e-3  # eval step: kernel path vs plain path on the card
LOSS_RTOL = 1e-4
# gradients, kernel vs plain (per tensor, max |diff| over max |plain|):
# the weight gradients are float32 sums over n_win * B = 294,000 (t, b)
# terms taken in another order, and the recurrence carries the rounding
# of every step back to dh0
GRAD_RTOL = 1e-3
# launches of one train step: layer 0 windowed, layers 1-2 plain
TRAIN_LAUNCHES = {"gru_fwd": 2, "gru_wfwd": 1, "gru_bifwd": 0, "gru_bwd": 2,
                  "gru_wbwd": 1}
# b2t_gru's mean padded batch (portbench/traffic/b2t_days4_b64.json: 64
# rows, 4 days of 16, cropped to the longest of 64 lengths uniform in
# 200-1,000 bins) at the published widths (BrainToTextGRU: C 512, 45 days,
# window 14, stride 4, hidden 768 x 5, 41 classes); layer 0's frames are
# the day layers' output, so its backward forms their gradient
B2T_B, B2T_T, B2T_C, B2T_H, B2T_L, B2T_CLS, B2T_DAYS = (
    64, 988, 512, 768, 5, 41, 45)
B2T_N_WIN = (B2T_T - WIN) // STRIDE + 1
B2T_TRAIN_LAUNCHES = {"gru_fwd": 4, "gru_wfwd": 1, "gru_bifwd": 0,
                      "gru_bwd": 4, "gru_wbwd": 1}
# the forward step kernel's cluster size (gru_fwd.cu: step_split) on the
# H100's 132 SMs: b2t's 24 step tiles of B = 64, H = 768 split over 8 CTAs,
# fig_5 train's 128 of B = 512, H = 512 over 2
B2T_STEP_SPLIT, FIG5_TRAIN_B, FIG5_TRAIN_STEP_SPLIT = 8, 512, 2
# the backward sweep's cluster size (gru_mma.cuh: step_split): b2t's 12 step
# tiles of 64 x 64 over 16 CTAs, fig_5 train's 64 over 4
B2T_BWD_STEP_SPLIT, FIG5_TRAIN_BWD_STEP_SPLIT = 16, 4
# the b2t24_bigru cell's longest batch (portbench/traffic/
# b2t24_shuffle_b64.json: 64 trials shuffled over 24 days, lengths uniform
# in 200-1,200 bins, the batch cropped to its longest, about 1,185) at the
# published widths (BrainToTextGRU, bidirectional, a zero state, the
# smoothing: C 256, 24 days, window 32, stride 4, hidden 1,024 x 5, 41
# classes): layer 0 is the bidirectional windowed layer, the windowed op
# forward and reversed, its frames the day layers' output, so each
# direction's backward forms their gradient
B24_B, B24_T, B24_C, B24_H, B24_L, B24_CLS, B24_DAYS = (
    64, 1184, 256, 1024, 5, 41, 24)
B24_WIN, B24_STRIDE = 32, 4
B24_N_WIN = (B24_T - B24_WIN) // B24_STRIDE + 1
B24_TRAIN_LAUNCHES = {"gru_fwd": 0, "gru_wfwd": 2, "gru_bifwd": B24_L - 1,
                      "gru_bwd": 2 * (B24_L - 1), "gru_wbwd": 2}
# gru_wbwd with the frames' gradient vs its plain version, per output (max
# |diff| over max |plain|): float32 sums in another order over at most
# 244 x 64 (t, b) terms, the frames' gradient over 4 windows a frame
B2T_GRAD_RTOL = 1e-5
# the bidirectional RealtimeRNN at the same width: layer 0 materialises
# the windows once (bf16, no gradient), every layer is one gru_bifwd and,
# in the backward, gru_bwd forward and reversed (layer 0 without dx)
BIDIR_EVAL_LAUNCHES = {"gru_fwd": 0, "gru_wfwd": 0, "gru_bifwd": N_LAYERS,
                       "gru_bwd": 0, "gru_wbwd": 0}
BIDIR_TRAIN_LAUNCHES = {**BIDIR_EVAL_LAUNCHES, "gru_bwd": 2 * N_LAYERS}
# seq2seq: the JAX package's bench geometry (bench.py:558-596)
S2S_B, S2S_T, S2S_C, S2S_F, S2S_K, S2S_H, S2S_L, S2S_CLS = (
    1000, 200, 30, 100, 10, 500, 3, 9)
S2S_TC = S2S_T - S2S_K + 1  # VALID conv: the encoder's 191 steps
# one forward: the one-layer bidirectional encoder is one gru_bifwd
# launch, the one-layer decoder one gru_fwd launch (T=1) per step; the
# backward: gru_bwd forward and reversed for the encoder, one per decoder
# step
SEQ2SEQ_EVAL_LAUNCHES = {"gru_fwd": S2S_L, "gru_wfwd": 0, "gru_bifwd": 1,
                         "gru_bwd": 0, "gru_wbwd": 0}
SEQ2SEQ_TRAIN_LAUNCHES = {**SEQ2SEQ_EVAL_LAUNCHES, "gru_bwd": 2 + S2S_L}
# the LSTM Seq2SeqRNN (plain torch ops) against torch.nn.LSTM (cuDNN) with
# the same weights, both float32 (TF32 off): logits x max |logits|,
# gradients per tensor as GRAD_RTOL
LSTM_LOGITS_RTOL = 1e-4
# a reference seq2seq checkpoint imported by seq2seq_from_ckpt against the
# torch modules it was written from, on the card (x max |logits|)
CKPT_LOGITS_RTOL = 1e-4
CKPT_B = 64  # trials of the checkpoint check, at the seq2seq widths
# the conv with the caller's TF32 on, against TF32 off (x max |out|): the
# module pins float32, so the two agree to float32 roundoff (a TF32 conv
# errs ~1e-3)
CONV_TF32_RTOL = 1e-5
# online vs offline logits: offline rounds its layer-0 frames to bf16,
# online does not; the JAX package's own bound between the two paths
# (tests/test_realtime.py:57)
STREAM_ATOL = 5e-3
REPS = 5
# alignment: the JAX package's bench geometry (bench.py:466-534)
AL_PAIRS, AL_N, AL_T, AL_K, AL_C, AL_LAT = 128, 150, 200, 40, 27, 8
AL_LAUNCHES = {"chol": 1, "gram": 2, "svd": 0}
# kernel route vs plain route of the same fit on the card
ROUTE_CORR_ATOL = 1e-4
ROUTE_PROJ_RTOL = 1e-3  # x max |proj|
# vs the float64 oracle: the JAX package's own bounds
# (tests/test_cca.py:148-150), the transform's taken relative to its
# largest value (|X_b proj| reaches ~20 here, O(1) in that test). They
# are held on pairs whose smallest float64 canonical correlation is at
# least GRAM_FLOOR = sqrt(K eps_f32): below it s^2 < K eps, the float32
# eigenvalue of g^T g on the chol/gram route carries no digit of it, and
# the JAX package drops or mis-resolves such a direction by design
# (cca.py:234-240, 253). Pairs below the floor are reported, not held.
# The chol and gram routes whiten through the float32 Gram G = L^T L and
# lose ~eps cond(G) (cca.py:201-206): their canonical correlations are
# held to max(5e-4, 2 eps_f32 cond(G)) with cond(G) of the pair in
# float64 (4e3-8e3 here, so 1e-3-2e-3); svd keeps 5e-4.
ORACLE_CORR_ATOL = 5e-4
ORACLE_TRANSFORM_RTOL = 5e-3
ORACLE_PAIRS = 4
ORACLE_SCAN = 32
EPS_F32 = 2.0 ** -23
GRAM_FLOOR = (AL_K * EPS_F32) ** 0.5
# MCCA / joint PCA, card vs CPU, relative to the largest value: float32
# eighs and SVDs of another library; each view's whitener loses
# ~eps cond(G) and L L^T carries two, so max(1e-3, 4 eps cond(G)) with
# cond(G) the largest of the views' class-average Grams in float64
MCCA_RTOL = 1e-3
# Jacobi kernel vs plain (tests/test_jacobi.py bounds for full solves)
JAC_SWEEP1_RTOL = 1e-5  # x ||A||_F, after exactly one sweep
JAC_EIG_RTOL = 2e-4  # x max |w|: eigenvalues and reconstruction
JAC_ORTH_ATOL = 5e-5
JAC_HETERO_RTOL = 5e-6
# ... and, since the kernel rounds every operation as the plain version's
# tensor ops do, bit for bit equal to it (w, V, sweep counts) and between
# two launches, on every case and at every Kp; a batch wider than the
# card's 132 SMs
JAC_WIDE_BATCH = 133
# the Jacobi kernel's time: launches back to back a timed run
JAC_INNER = 20
# the CTC experiment driver (cli/experiments.py:run_train_ctc): the aligned
# context at the reference's production scale (the JAX package's
# utils/config.py:338-347: 8 patients, 243 trials of 27 classes, T=600)
# and fig_5 width (bench.py:section_ctc), the reference YAML's batch of
# 512 (utils/config.py:292-297) and augmentations; only the epochs cut
DRV_CFG = dict(context="aligned", synth_patients=8, synth_trials=250,
               synth_T=600, hidden=H, n_layers=N_LAYERS, win_size=WIN,
               stride=STRIDE, batch_size=512, augmentations="all",
               decode="beam", beam_size=100, dropout=0.3, n_iter=1,
               epochs=2, seed=0, save_logits=True)
DRV_JACOBI = 7  # one chol CCA fit a cross patient, K = 32, batch 1
DRV_BEAM_ROWS = 8  # test rows decoded by the native and the Python search
# small depth on the card and on the CPU from the same data and weights
DRV_SMALL = dict(context="aligned", synth_patients=3, synth_T=200,
                 hidden=64, n_layers=2, epochs=1, n_iter=1, dropout=0.0,
                 augmentations="", seed=0)
DRV_PCA_RTOL = 2e-4  # latents, tests/test_torch_alignment.py's PCA bound
DRV_ALIGNED_RTOL = 1e-3  # CCA-mapped latents, its projection bound
DRV_VAL_RTOL = 1e-3  # per-epoch validation loss, card vs CPU
FIR_RTOL = 1e-5  # fir_filter under the caller's TF32, card vs CPU
# the CTC sweep (cli/experiments.py:run_tune_ctc) on the CTC driver's data
# (8 synthetic patients x 243 trials, T=600, aligned): BOHB with TPE over
# rungs of 1 and 2 epochs (the reference's budget: 30 trials, rungs 30 and
# 100); the sampler draws the widths from the reference's space
TUNE_CFG = dict(sampler="tpe", n_trials=4, rungs="1,2", eta=3)
# the fig_5-width bucket on that run's held-out train and validation sets
TUNE_FIG5_ARCH = dict(hidden=H, n_layers=N_LAYERS, dropout=0.3)
TUNE_FIG5_OPT = ((1e-3, 1e-4), (3e-4, 1e-5))  # (lr, weight decay) a trial
TUNE_FIG5_EPOCHS = 2
# the CV trainable: 5 folds, each fold's prep refitted (7 chol fits a fold)
TUNE_CV_CFG = dict(cv_folds=5, model_chunk=1, n_trials=2, rungs="1")
# make-xforms card vs CPU: each source's proj_b_to_a, x its largest value
# (tests/test_torch_alignment.py's projection bound)
XF_PROJ_RTOL = 1e-3
# realtime-sim from a fig_5-width checkpoint; p50 must stay below the bin
TUNE_RT = dict(n_bins=400, per_step_samples=100, per_step_chain=20, seed=0)
TUNE_RT_P50_MS = 10.0
# small depth, card vs CPU: two trials of one bucket from the same data and
# initial weights. Adam makes an update ~lr whatever the gradient's size,
# so a gradient entry whose sign the two devices' rounding decides moves
# its weight by up to 2 lr a step: the largest error is held to
# 2 x max lr x epochs, and 99 % of the weights to 1e-4
TUNE_SMALL_DATA = dict(synth_patients=3, synth_T=200, seed=0)
TUNE_SMALL_ARCH = dict(hidden=16, n_layers=2, dropout=0.0)
TUNE_SMALL_OPT = ((1e-3, 1e-4), (2e-3, 1e-5))
TUNE_SMALL_EPOCHS = 2
TUNE_SMALL_W_ATOL = 2 * 2e-3 * TUNE_SMALL_EPOCHS
TUNE_SMALL_W_P99 = 1e-4
TUNE_DECIDED = 1e-4  # a window's decode counts where the CPU's top two
                     # logits differ by more than this much of the top one
# one train-ctc init_ckpt iteration from a small checkpoint (hidden 16 x 2
# on the synthetic target's 64 channels), card vs CPU
TUNE_CKPT_CHANNELS = 64
TUNE_INIT_CKPT = dict(context="patient", synth_patients=3, synth_T=200,
                      n_iter=1, epochs=1, dropout=0.0, seed=0)
# the classical decoder (cli/experiments.py:run_svm_decode, sep_align, rbf)
# at the reference's scale: 8 patients of 9 classes x 15 trials (135
# each, a pooled training set of 1080), T=200, max_k 32, 20 folds in one
# batch (docs/ARCHITECTURE.md:109's (20, 1080, 1080) systems); cut: 2
# iterations (the reference runs 50), and the nested search to 2 TPE
# rounds of 5 points over 5 inner folds (the reference: 5 rounds)
SVM_CFG = dict(strategy="sep_align", synth_patients=8, synth_trials=15,
               synth_T=200, max_k=32, kernel="rbf", n_folds=20,
               fold_batch=20, iter_batch=1, n_iter=2, seed=0)
SVM_NESTED = dict(SVM_CFG, nested=True, n_iter=1, nested_rounds=2,
                  nested_points=5, nested_inner=5)
SVM_FIT_BATCH = 100  # nested_cv_decode_bayes's fit_batch, the driver's
# small depth on the card and on the CPU from the same data and seed
SVM_SMALL = dict(synth_patients=3, synth_trials=15, synth_T=40, n_folds=4,
                 max_k=32, seed=0)
SVM_SMALL_NOISE = (0.6, 8.0)  # the driver's; one that leaves hard trials
SVM_FULL_NOISE = 16.0  # at SVM_CFG's scale: mean accuracy ~0.6 (chance 1/7)
SVM_DECIDED = 1e-4  # a prediction counts where its top two scores differ
                    # by more than this much of their magnitude
# the seq2seq experiment driver (cli/experiments.py:run_train_seq2seq,
# fold-parallel) at the reference's width (utils/config.py's
# TrainSeq2SeqConfig: 100 filters of width 10, hidden 500, one encoder and
# one decoder layer, dropout 0.3, teacher forcing 0.5, AdamW) and data
# scale (8 patients of 9 classes x 17 trials: 153 each, the reference's
# ~150; a pooled set of 1224; T=200; 20 folds in one chunk). Cut: one
# iteration of 2 epochs (the reference: 50 iterations of 500)
S2S_DRV_CFG = dict(synth_patients=8, synth_trials=17, synth_T=200,
                   n_filters=100, hidden=500, kernel_size=10, n_folds=20,
                   fold_chunk=0, n_iter=1, epochs=2, seed=0)
# small depth on the card and on the CPU from the same data and weights,
# at dropout 0 and teacher forcing 1
S2S_SMALL = dict(synth_patients=3, synth_trials=12, synth_T=40, hidden=32,
                 n_filters=8, n_folds=4, n_iter=1, epochs=3, seed=0)
S2S_AUGS = "time_shifting,noise_jitter,scaling"  # train_seq2seq.py:91
S2S_LOSS_RTOL = 1e-3  # every fold-epoch's training loss, card vs CPU
S2S_DECIDED = 1e-4  # a test trial counts where its top two logits differ
                    # by more than this much of their magnitude
# the subsample sweeps (cli/subsample_experiments.py) at the reference's
# scale: the eight paper patients of 9 classes x 15 trials (135 each;
# SURVEY.md), T=200, the port's synthetic widths with S26 at its 111
# significant channels, from the port's host generator, written as the
# reference's pt_decoding_data and pt_savg_data pickles and
# {pt}_channelMap.mat / {pt}_sigChannel.mat files (the figure notebooks'
# channel maps); target S26; SubsampleConfig's defaults (5 folds, max_k
# 24, n_comp 0.8, sep_align). Cut: 2 iterations a sweep point (the
# reference: 10, or every target sub-grid), the nested point to 2 TPE
# rounds of 3 points x 3 inner folds
SUB_PTS = ("S14", "S22", "S23", "S26", "S33", "S39", "S58", "S62")
SUB_CHANNELS = (96, 80, 64, 111, 128, 72, 56, 104)
SUB_TARGET = "S26"
SUB_TRIALS, SUB_T = 15, 200
SUB_NOISE = 8.0  # 4-wide windows and 4 mm pitches decode at ~0.7, the
                 # full arrays at ~1.0: the sweeps' curves are not flat
SUB_SMALL_PTS, SUB_SMALL_T = ("S14", "S26", "S33", "S58"), 40
SUB_BASE = dict(target_pt=SUB_TARGET, n_iter=2, seed=0)
SUB_RUNS = {
    "trials": ("run_trial_subsample", dict(k_start=5, k_step=25)),
    "grid": ("run_grid_subsample", dict(win_sizes=(2, 4, 8))),
    "spatial": ("run_spatial_avg", dict(contact_sizes=(2, 4))),
    "pitch": ("run_pitch_subsample", dict(pitches=(1.5, 2.5, 4.0))),
    "nested": ("run_trial_subsample", dict(
        k_start=130, k_step=25, n_iter=1, nested=True, nested_rounds=2,
        nested_points=3, nested_inner=3)),
}
# svm-decode's surrogate controls at the svm_decode phase's scale, one
# iteration; the TME fit is the driver's 1000 steps a cross patient
SUB_SVM = dict(SVM_CFG, n_iter=1)
TME_CRITERION = 0.05  # implied vs data eigenvalues x the data's largest
                      # (tests/test_surrogates_and_utils.py)
TME_CMP_STEPS = 200  # one patient's fit, card vs CPU
TME_CMP_RTOL = 1e-3  # log-parameters (absolute), implied eigenvalues (x
                     # their largest), final loss (relative): float32 sums
                     # of 10^4-10^5 terms in another order, over 200 steps
TME_DRAWS = 20  # samples of the statistical check
SUB_SHUFFLE_CPU = 2  # shuffle surrogates redrawn on the CPU, bit for bit
# the NN-classifier decode driver (cli/experiments.py:run_train_nn, cpsd
# train-nn) at TrainNNConfig's widths (100 filters of width 10, hidden 128,
# d_model 64, 4 heads, 2 layers, dim_ff 256, dropout 0.3, max_k 24; batch
# 5000, above the ~1,073 pooled rows: one full-batch step an epoch) on a
# pt_decoding_data pickle of the eight paper patients at the subsample
# phase's scale (9 classes x 15 trials, T=200), target S26, for each of
# the four families. Cut: 1 iteration of 20 folds x 2 epochs (the
# reference: 50 iterations of 20 folds x 100 epochs)
NN_CFG = dict(target_pt=SUB_TARGET, n_iter=1, n_folds=20, epochs=2, seed=0)
# small depth on the card and on the CPU from the same file and weights
NN_SMALL_PTS = ("S14", "S26", "S33")
NN_SMALL = dict(n_iter=1, n_folds=4, epochs=2, n_filters=8, hidden=16,
                d_model=16, n_heads=2, n_layers=2, dim_ff=32, kernel_size=4,
                dropout=0.0, seed=0)
NN_LOSS_RTOL = 1e-3  # every fold-epoch's training loss, card vs CPU
NN_DECIDED = 1e-4  # a test trial counts where its top two logits differ
                   # by more than this much of their magnitude
# the paper-matrix runner (cli/reproduce.py, cpsd reproduce) over jobs of
# manifests/paper.yaml at target S26, each at the data scale and widths of
# the earlier phase for its driver: svm-decode (sep_align, joint_pca and
# the chance control) at the svm_decode phase's (8 patients x 135 trials,
# T=200, 20 folds), on a decoding pickle of the eight paper patients at
# REPRO_SVM_NOISE, where sep_align and joint_pca decode below 1 and vary
# between iterations (on the driver's own synthetic data both decode at
# 1.000 in every iteration, and the statistics over them are degenerate),
# train-seq2seq (pooled,
# fold_chunk 4, rnn_impl pallas) at the seq2seq_driver phase's, train-nn
# conv_rnn on the train_nn phase's file at TrainNNConfig's widths,
# train-ctc aligned at fig_5 width on the ctc_driver phase's data with the
# TensorBoard log. Cut: iterations, epochs and the matrix (REPRO_REDUCED)
REPRO_TARGET = SUB_TARGET
REPRO_SVM = dict(n_folds=20, n_iter=10)
# the lowest of 16, 24, 32, 48, 64 at which a Wilcoxon row lies above the
# least p (my chip run): sep_align 0.244, joint_pca 0.532, chance 0.218,
# sep_align against chance p = 0.0165; at 16 sep_align 0.428, joint_pca
# 0.928, chance 0.216, every difference of one sign
REPRO_SVM_NOISE = 24.0
REPRO_S2S = dict(synth_patients=8, synth_trials=17, synth_T=200, n_folds=20,
                 n_iter=1, epochs=2, fold_chunk=4, rnn_impl="pallas")
REPRO_NN = dict(n_iter=1, n_folds=20, epochs=2)
REPRO_CTC = dict(synth_patients=8, synth_trials=250, synth_T=600,
                 batch_size=512, hidden=H, n_layers=N_LAYERS, n_iter=1,
                 epochs=2, log_format="tb")
REPRO_REDUCED = [
    "matrix: target S26 alone (paper.yaml: 3-6 targets a family)",
    "svm-decode: strategies sep_align and joint_pca of 4, the chance "
    "control; 10 iterations of 50",
    "train-seq2seq: pooled true of [true, false]; 1 iteration of 50, 2 "
    "epochs of 500",
    "train-nn: conv_rnn of 4 families; 1 iteration of 50, 2 epochs of 100",
    "train-ctc: context aligned of 4; 1 iteration of 50, 2 epochs of 300",
    "left out: the subsample sweeps, tune-ctc (hparam_out needs h5py) and "
    "realtime-sim, which keep their own phases",
]
REPRO_RESUME_S = 2.0  # run 2 resumes every job within this
REPRO_ANALYSIS_RTOL = 1e-4  # cluster scores, pt_corr r and p, card vs CPU
                            # (silhouettes: of their range [-1, 1])
REPRO_TSNE_ITERS = 500
REPRO_TSNE_STEPS = 10  # first steps of the card from the CPU's state
REPRO_TSNE_STEP_TOL = 1e-4  # x max |y|
# t-SNE affinities card vs CPU, x max P: float32's own error on these
# 6400-wide latents is 5.1e-5 against float64 (a CPU run)
REPRO_TSNE_P_TOL = 1e-3
REPRO_TSNE_KL_RTOL = 0.02  # the final KL divergence, card vs CPU


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def main(argv=()) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # the port itself, from the checkout this script lies in: fails in a
    # directory that holds the script alone, even where another copy of
    # the port is importable
    import cross_patient_speech_decoding_tpu_torch as port
    from cross_patient_speech_decoding_tpu_torch.ops import _ext, gru, jacobi

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
          "cuda": torch.version.cuda, "capability": list(cap),
          "packages": _packages()})
    if tuple(cap) != (9, 0):
        raise RuntimeError(f"need compute capability (9, 0), got {cap}")

    # 2. build
    build_s = _ext.build(verbose=True)
    _ext.lib()
    emit({"phase": "build", "seconds": build_s,
          "libraries": [_ext.library_path(s).name for s in _ext.SOURCES]})
    if list(argv) == ["gru_wbwd_dx"]:
        emit({"kernels": [phase_kernel_wbwd_dx(torch, dev, gru)[0]]})
        return 0
    if list(argv) == ["fwd_split"]:
        emit({"kernels": phase_kernels_fwd_split(torch, dev, gru)})
        return 0
    if list(argv) == ["bwd_split"]:
        emit({"kernels": phase_kernels_bwd_split(torch, dev, gru)})
        return 0
    if list(argv) == ["wbidir"]:
        emit({"kernels": [phase_kernel_wbidir(torch, dev, gru)]})
        return 0
    if argv:
        raise SystemExit(f"chip_smoke: unknown arguments {list(argv)}")

    model, batch = phase_ctc_eval(torch, dev, gru)
    train_res = phase_ctc_train(torch, dev, gru, batch)
    phase_ctc_driver(torch, dev, gru, jacobi, smi)
    tune_launches = phase_tune_ctc(torch, dev, gru, jacobi, smi)
    phase_streaming(torch, dev, gru, model)
    del model
    bidir_rows = phase_ctc_bidir(torch, dev, gru, jacobi, batch)
    del batch
    s2s_model, s2s_batch, s2s_launches = phase_seq2seq_train(torch, dev, gru)
    phase_seq2seq_eval(torch, dev, gru, s2s_model, s2s_batch)
    del s2s_model, s2s_batch
    s2s_drv_launches = phase_seq2seq_driver(torch, dev, gru, jacobi, smi)
    nn_launches = phase_train_nn(torch, dev, gru, jacobi, smi)
    repro_launches = phase_reproduce(torch, dev, gru, jacobi, smi)
    par_launches = phase_parallel(torch, dev, gru, jacobi, smi)
    align = phase_alignment(torch, dev, jacobi)
    svm_launches = phase_svm_decode(torch, dev, gru, jacobi, smi)
    sub_launches = phase_subsample(torch, dev, gru, jacobi, smi)
    kernels = phase_kernels(torch, dev, gru, train_res["launches"],
                            s2s_launches)
    kernels.append({**phase_kernel_jacobi(torch, dev, jacobi, align),
                    **svm_launches, **sub_launches})
    for row in kernels:
        if row["name"] in s2s_drv_launches:
            row["launches_seq2seq_driver_iteration"] = s2s_drv_launches[
                row["name"]]
        row.update(tune_launches.get(row["name"], {}))
        row.update(nn_launches.get(row["name"], {}))
        row.update(repro_launches.get(row["name"], {}))
        row.update(par_launches.get(row["name"], {}))
        row.update(bidir_rows.get(row["name"], {}))
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def _packages() -> dict:
    """Installed versions (None where absent) of the packages that the
    port reads lazily: PyYAML (``cpsd reproduce``'s manifest), tensorboard
    (the event-file check), scipy (p-values), matplotlib
    (``utils/visualization.py``), h5py (results .h5 files), scikit-learn
    (``decoders/sklearn_compat.py``)."""
    import importlib.metadata
    import importlib.util

    out = {}
    for mod, dist in (("yaml", "PyYAML"), ("tensorboard", "tensorboard"),
                      ("scipy", "scipy"), ("numpy", "numpy"),
                      ("matplotlib", "matplotlib"), ("h5py", "h5py"),
                      ("sklearn", "scikit-learn")):
        out[dist] = (importlib.metadata.version(dist)
                     if importlib.util.find_spec(mod) else None)
    return out


def cuda_ms(torch, fn, reps: int = REPS, inner: int = 1) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs after one warm-up,
    from CUDA events; with ``inner`` > 1 each run is that many calls back
    to back, divided by ``inner``, so that a call's host time overlaps the
    card's work on the one before (a kernel of a fraction of a millisecond
    waits on its wrapper's host time otherwise)."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
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
        l0.bi, l0.wh, l0.bh, model.win_size, model.stride, False, True)
    for i in range(1, model.n_layers):
        li = model.rnn.layer(i)
        hs = GRULayerFn.apply(hs, h0[i].contiguous(), li.wi, li.bi, li.wh,
                              li.bh, False, True)
    return model.head(hs.transpose(0, 1))


def _fig5_batch(torch, dev, rows: int):
    """The first ``rows`` rows of the fig_5 batch (B x T x C random frames,
    labels 10 10 d d d 10 10 of seed 0, full lengths) on ``dev``."""
    import numpy as np

    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((B, T, C), generator=gen, device=dev)
    rng = np.random.default_rng(0)
    labels = torch.as_tensor(np.concatenate(
        [np.full((B, 2), 10), rng.integers(1, 10, (B, 3)),
         np.full((B, 2), 10)], axis=1).astype(np.int32), device=dev)
    il = torch.full((B,), T, dtype=torch.int32, device=dev)
    ll = torch.full((B,), 7, dtype=torch.int32, device=dev)
    return tuple(a[:rows] for a in (x, labels, il, ll))


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

    batch = _fig5_batch(torch, dev, B)
    x, labels, il, ll = batch

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
    _, prof = profile_call(torch, lambda: step(batch))

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
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "profile": prof}
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
    """'void (anonymous namespace)::step_grad_kernel(float*, ...)' ->
    'step_grad_kernel': no namespace, template or arguments; the tensor-core
    product keeps its tile, A type and operand layouts, which tell the
    backward's phases apart ('mma_gemm_kernel<128x128,bf16,MK,KN>'), and
    the wgmma product its A type ('wgmma_gemm_kernel<f32>')."""
    import re

    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    m = re.match(r"mma_gemm_kernel<MmaCfg<(\d+), (\d+),[^>]*>, (\w+), "
                 r"(\w+), (\w+)>", name)
    if m:
        bm, bn, ta, km, kn = m.groups()
        return (f"mma_gemm_kernel<{bm}x{bn},"
                f"{'bf16' if 'bfloat16' in ta else 'f32'},"
                f"{'KM' if km == 'true' else 'MK'},"
                f"{'KN' if kn == 'true' else 'NK'}>")
    m = re.match(r"wgmma_gemm_kernel<(\w+)>", name)
    if m:
        return (f"wgmma_gemm_kernel<"
                f"{'bf16' if 'bfloat16' in m.group(1) else 'f32'}>")
    return name.split("(")[0].split("<")[0].split("::")[-1].strip()


def profile_call(torch, fn, cpu: bool = True, match: str | None = None):
    """``fn()`` once under ``torch.profiler``: device time summed by kernel
    name, the device's busy time (one stream, so kernels do not overlap)
    against the call's host-clock time, and its idle share. ``cpu=False``
    records the CUDA activity alone, for a call of ~10^5 kernels whose
    host-side events would take minutes to summarise. ``match`` adds the
    device time of every kernel whose name holds it (any case). Returns
    (fn's result, that summary)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] if cpu else []
    with profile(activities=acts + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
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
    summary = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
               "device_idle_share": 1.0 - busy_ms / wall_ms
               if busy_ms else None,
               "device_ms_by_kernel": top}
    if match is not None:
        hits = {k: v for k, v in by_kernel.items()
                if match.lower() in k.lower()}
        summary[f"device_ms_{match}"] = sum(hits.values())
        summary[f"kernels_{match}"] = hits
    return out, summary


def profile_step(torch, step, state, batch, gen):
    """One more train step under ``torch.profiler`` (:func:`profile_call`);
    the host-clock time is reported as ``step_ms``."""
    (state, _), prof = profile_call(torch, lambda: step(state, batch, gen))
    prof["step_ms"] = prof.pop("wall_ms")
    return state, prof


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


class _NoPlainOnCuda:
    """Within the block, the plain GRU and Jacobi versions raise when given
    a CUDA tensor: the driver's path must take the kernels."""

    PLAIN = ("gru_layer_plain", "gru_layer_windowed_plain",
             "gru_layer_bidir_plain", "gru_backward_plain",
             "gru_win_backward_plain")

    def __init__(self, torch, gru, jacobi):
        self.torch = torch
        self.saved = [(gru, n, getattr(gru, n)) for n in self.PLAIN]
        self.saved.append((jacobi, "jacobi_eigh_plain",
                           jacobi.jacobi_eigh_plain))

    @contextlib.contextmanager
    def lifted(self):
        """The plain versions themselves within the inner block: for a
        check of the kernels inside the outer one."""
        self.__exit__()
        try:
            yield
        finally:
            self.__enter__()

    def __enter__(self):
        torch = self.torch
        for mod, name, fn in self.saved:
            def guard(*args, _fn=fn, _name=name, **kw):
                if any(torch.is_tensor(a) and a.is_cuda for a in args):
                    raise RuntimeError(f"{_name} ran on a CUDA tensor")
                return _fn(*args, **kw)
            setattr(mod, name, guard)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


class _DriverProbe:
    """Counting and timing wrappers around what ``run_train_ctc`` calls,
    installed for a block: train steps (each synchronised and timed, its
    loss and row count kept), eval steps (validation and test, timed),
    model forwards by mode, PCA and CCA fits of the prep (timed), and the
    beam rescoring (timed). ``fit`` is wrapped to keep its last arguments,
    for the profiled epoch after the counted run."""

    def __init__(self, torch, exp):
        import cross_patient_speech_decoding_tpu_torch.train as train
        from cross_patient_speech_decoding_tpu_torch.models import (
            RealtimeRNN,
        )
        from cross_patient_speech_decoding_tpu_torch.train import loops

        self.torch, self.exp, self.train, self.loops = torch, exp, train, loops
        self.rnn = RealtimeRNN
        self.steps = self.rows = self.evals = 0
        self.fwd = {"train": 0, "eval": 0}
        self.step_s, self.eval_s, self.losses = [], [], []
        self.pca_s, self.cca_s, self.beam_s, self.data_s = [], [], [], []
        self.fit_args = None

    def _timed(self, fn, store):
        torch = self.torch

        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            store.append(time.perf_counter() - t0)
            return out
        return run

    def __enter__(self):
        exp, train, loops = self.exp, self.train, self.loops
        self.saved = [(train, "make_ctc_train_step"),
                      (train, "make_ctc_eval_step"), (loops, "fit"),
                      (self.rnn, "forward"), (exp, "_pca_fit_lat"),
                      (exp, "_cca_align_lat"), (exp, "_beam_rescore_per"),
                      (exp, "make_synthetic_patients_device")]
        self.saved = [(m, n, getattr(m, n)) for m, n in self.saved]
        orig = {n: f for _, n, f in self.saved}
        probe = self

        def make_train(model, tx):
            step = orig["make_ctc_train_step"](model, tx)

            def counted(state, batch, gen=None):
                probe.steps += 1
                probe.rows += int(batch[0].shape[0])
                out = probe._timed(step, probe.step_s)(state, batch, gen)
                probe.losses.append(float(out[1]["loss"]))
                return out
            return counted

        def make_eval(model):
            step = orig["make_ctc_eval_step"](model)

            def counted(batch):
                probe.evals += 1
                return probe._timed(step, probe.eval_s)(batch)
            return counted

        def fit(*a, **k):
            probe.fit_args = (a, k)
            return orig["fit"](*a, **k)

        def forward(model, *a, **k):
            probe.fwd["train" if model.training else "eval"] += 1
            return orig["forward"](model, *a, **k)

        train.make_ctc_train_step = make_train
        train.make_ctc_eval_step = make_eval
        self.loops.fit = fit
        self.rnn.forward = forward
        exp._pca_fit_lat = self._timed(orig["_pca_fit_lat"], self.pca_s)
        exp._cca_align_lat = self._timed(orig["_cca_align_lat"], self.cca_s)
        exp._beam_rescore_per = self._timed(orig["_beam_rescore_per"],
                                            self.beam_s)
        exp.make_synthetic_patients_device = self._timed(
            orig["make_synthetic_patients_device"], self.data_s)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def _launch_counts(gru, jacobi) -> dict:
    return {**gru.LAUNCHES, "jacobi_eigh": jacobi.LAUNCHES["jacobi_eigh"]}


def _reset_counts(gru, jacobi) -> None:
    gru.reset_launch_counts()
    jacobi.reset_launch_counts()


def _history(out: str, context: str) -> list:
    import csv

    path = Path(out).parent / "logs" / f"S14_{context}_ctcRnn" / "iter000.csv"
    with open(path) as f:
        return [{k: float(v) for k, v in r.items()} for r in csv.DictReader(f)]


def _rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


def phase_ctc_driver(torch, dev, gru, jacobi, smi):
    """The CTC experiment driver end to end at full width, then a
    small-depth run on the card and on the CPU from the same data."""
    import tempfile

    import numpy as np

    from cross_patient_speech_decoding_tpu_torch.cli import experiments as exp
    from cross_patient_speech_decoding_tpu_torch.data.loaders import load_pkl
    from cross_patient_speech_decoding_tpu_torch.ops.ctc import (
        prefix_beam_search as py_beam,
    )
    from cross_patient_speech_decoding_tpu_torch.realtime import beam
    from cross_patient_speech_decoding_tpu_torch.utils.config import (
        TrainCTCConfig,
    )

    if not beam.native_available():
        raise RuntimeError("the native beam search did not build")
    try:
        import h5py  # noqa: F401  (results_h5 needs it)
        have_h5 = True
    except ImportError:
        have_h5 = False
    tmp = tempfile.TemporaryDirectory()
    out = str(Path(tmp.name) / "full" / "ctc.pkl")
    cfg = TrainCTCConfig(**DRV_CFG, out=out, results_h5=(
        str(Path(tmp.name) / "full" / "r.h5") if have_h5 else ""))
    n_win = (cfg.synth_T - WIN) // STRIDE + 1

    # (a) one full-width iteration, counts zeroed just before
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(gru, jacobi)
    with _NoPlainOnCuda(torch, gru, jacobi), _DriverProbe(torch, exp) as pr:
        t0 = time.perf_counter()
        pers = exp.run_train_ctc(cfg, verbose=True, device=dev)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    launches = _launch_counts(gru, jacobi)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_fwd = pr.fwd["train"] + pr.fwd["eval"]
    want = {"gru_wfwd": n_fwd, "gru_fwd": 2 * n_fwd,
            "gru_wbwd": pr.steps, "gru_bwd": 2 * pr.steps,
            "gru_bifwd": 0, "jacobi_eigh": DRV_JACOBI}

    # (b) the native beam search against the Python one on test rows
    lp = load_pkl(out)["extra"][0]["logits"]
    t0 = time.perf_counter()
    nat = [beam.prefix_beam_search(lp[i], cfg.beam_size)
           for i in range(DRV_BEAM_ROWS)]
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pyb = [py_beam(lp[i], cfg.beam_size) for i in range(DRV_BEAM_ROWS)]
    python_s = time.perf_counter() - t0
    beam_same = [a[0] for a in nat] == [b[0] for b in pyb]
    h5_back = None
    if have_h5:
        with h5py.File(cfg.results_h5, "r") as f:
            h5_back = np.asarray(f["phoneme_error_rate"]).tolist()

    # (c) the same call again resumes: the stored PER, no launch
    _reset_counts(gru, jacobi)
    again = exp.run_train_ctc(cfg, verbose=True, device=dev)
    torch.cuda.synchronize()
    resume_launches = _launch_counts(gru, jacobi)

    # (d) one more epoch of the same training set, profiled
    from cross_patient_speech_decoding_tpu_torch.train import (
        create_train_state,
        make_ctc_eval_step,
        make_ctc_train_step,
        make_optimizer,
    )
    from cross_patient_speech_decoding_tpu_torch.train.loops import fit

    (_, _, _, train_b, val_b), _ = pr.fit_args
    pr.fit_args = None
    model = exp._init_model(cfg, train_b[0].shape[-1], 0, dev)
    tx = make_optimizer(cfg.lr, cfg.weight_decay, cfg.decay_steps,
                        clip=cfg.clip)
    gen = torch.Generator(device=dev).manual_seed(1)
    _, prof = profile_call(torch, lambda: fit(
        create_train_state(model, tx), make_ctc_train_step(model, tx),
        make_ctc_eval_step(model), train_b, val_b, epochs=1, generator=gen,
        batch_size=cfg.batch_size))
    del train_b, val_b, model

    epoch_s = sum(pr.step_s) / cfg.epochs
    res = {"phase": "ctc_driver", "nvidia_smi": smi,
           "config": {k: v for k, v in DRV_CFG.items()},
           "note": ("batch_size 512, the reference YAML's: full-batch "
                    "training of the ~11,100 augmented rows would need "
                    "several times the B=2000 step's 8.8 GB"),
           "per": pers.tolist(), "launches": launches,
           "launches_expected": want, "train_steps": pr.steps,
           "eval_steps": pr.evals, "forwards": pr.fwd,
           "train_rows_per_epoch": pr.rows // cfg.epochs,
           "losses_first_last": [pr.losses[0], pr.losses[-1]],
           "losses_finite": bool(np.isfinite(pr.losses).all()),
           "data_ms": sum(pr.data_s) * 1e3,
           "prep_ms": {"pca": sum(pr.pca_s) * 1e3, "cca": sum(pr.cca_s) * 1e3,
                       "pca_fit_ms": [t * 1e3 for t in pr.pca_s],
                       "cca_fit_ms": [t * 1e3 for t in pr.cca_s]},
           "ms_per_epoch": epoch_s * 1e3,
           "train_samples_per_s": pr.rows / sum(pr.step_s),
           "train_step_ms_median": statistics.median(pr.step_s) * 1e3,
           "validation_ms": sum(pr.eval_s[:-1]) * 1e3,
           "test_eval_ms": pr.eval_s[-1] * 1e3,
           "beam_ms": sum(pr.beam_s) * 1e3,
           "iteration_wall_s": wall_s, "peak_mem_gb": peak_gb,
           "beam_native": beam.native_available(),
           "beam_native_vs_python_same_prefixes": beam_same,
           "beam_rows_s": {"native": native_s, "python": python_s},
           "results_h5_read_back": (h5_back if have_h5 else
                                    "not checked: h5py is not installed "
                                    "on this machine"),
           "resume_per": again.tolist(), "resume_launches": resume_launches,
           "epoch_profile": prof}
    small = _driver_small(torch, dev, exp, tmp.name)
    small["fir"] = _check_fir_tf32(torch, dev)
    res["small_depth_card_vs_cpu"] = small
    emit(res)
    tmp.cleanup()

    if launches != want:
        raise RuntimeError(f"driver launched {launches}, expected {want}")
    if pr.fwd["train"] != pr.steps or pr.steps == 0:
        raise RuntimeError(f"train forwards {pr.fwd} vs steps {pr.steps}")
    if not res["losses_finite"]:
        raise RuntimeError(f"non-finite training loss: {pr.losses}")
    if not all(0.0 <= p <= 100.0 * n_win / 3 for p in pers):
        raise RuntimeError(f"PER out of range: {pers}")
    if not beam_same:
        raise RuntimeError(f"native beam {nat} vs Python {pyb}")
    if have_h5 and h5_back != pers.tolist():
        raise RuntimeError(f"results_h5 read back {h5_back} != {pers}")
    if again.tolist() != pers.tolist() or any(resume_launches.values()):
        raise RuntimeError(f"resume returned {again} with launches "
                           f"{resume_launches}")
    bad = {k: v for k, v in small.items()
           if k.endswith("_ok") and v is not True}
    if bad:
        raise RuntimeError(f"small-depth card vs CPU: {bad}")
    return res


def _synth_cache_to_cpu(exp) -> None:
    """Put the one synthetic CTC data set the driver cached for the card
    under the CPU's key, so that a CPU run reads the card's data."""
    (key, data), = exp._SYNTH_CTC_CACHE.items()
    exp._SYNTH_CTC_CACHE.clear()
    exp._SYNTH_CTC_CACHE[key[:-1] + ("cpu",)] = [
        (X.cpu(),) + tuple(rest) for X, *rest in data]


def _driver_small(torch, dev, exp, tmp):
    """Small depth on the card, then on the CPU from the card's synthetic
    data (copied into the CPU's cache entry) and the same initial weights
    (``RealtimeRNN`` draws them on the CPU from the seed): prepared
    latents, validation losses and PER."""
    import numpy as np

    from cross_patient_speech_decoding_tpu_torch.data.splits import (
        train_val_test_masks,
    )
    from cross_patient_speech_decoding_tpu_torch.utils.config import (
        TrainCTCConfig,
    )

    def cfg_on(name):
        return TrainCTCConfig(**DRV_SMALL,
                              out=str(Path(tmp) / name / "ctc.pkl"))

    cfg = cfg_on("card")
    rng = np.random.default_rng(cfg.seed)  # the driver's iteration 0
    tr, _, _ = train_val_test_masks(exp._synthetic_ctc_n_trials(cfg), rng,
                                    cfg.val_frac, cfg.test_frac)

    def prep(d):
        return exp._prep_ctc_context(cfg, rng, tar_train_mask=tr,
                                     device=d)[0]

    prep_card = prep(dev)
    pers_card = exp.run_train_ctc(cfg, verbose=False, device=dev)
    _synth_cache_to_cpu(exp)
    with _CardCcaRoute():
        prep_cpu = prep(torch.device("cpu"))
        pers_cpu = exp.run_train_ctc(cfg_on("cpu"), verbose=False,
                                     device="cpu")
    exp._SYNTH_CTC_CACHE.clear()

    sep = _separated(prep_cpu[0][0])
    lat_errs = [_rel(c[0].cpu()[..., sep], g[0][..., sep])
                for c, g in zip(prep_card, prep_cpu)]
    lat_ok = all(e <= (DRV_ALIGNED_RTOL if i else DRV_PCA_RTOL)
                 for i, e in enumerate(lat_errs))
    h_card = _history(cfg.out, "aligned")
    h_cpu = _history(cfg_on("cpu").out, "aligned")
    val_errs = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
                for a, b in zip(h_card, h_cpu)]
    # one edit of the test set's 22 rows x 3 labels
    one_edit = 100.0 / (3 * round(exp._synthetic_ctc_n_trials(cfg)
                                  * cfg.test_frac))
    return {"config": DRV_SMALL, "latent_rel_errs": lat_errs,
            "latent_columns_compared": int(sep.sum()),
            "latents_ok": lat_ok, "val_history_card": h_card,
            "val_history_cpu": h_cpu, "val_loss_rel_errs": val_errs,
            "val_ok": len(h_card) == len(h_cpu) == cfg.epochs
            and all(e <= DRV_VAL_RTOL for e in val_errs),
            "per_card": pers_card.tolist(), "per_cpu": pers_cpu.tolist(),
            "per_ok": bool(np.abs(pers_card - pers_cpu).max()
                           <= one_edit + 1e-9)}


class _CardCcaRoute:
    """Within the block, the CCA's small SVD takes the Gram route on CPU
    tensors too, as it does on the card (``cca._svd_small``: eigh of
    g^T g, near-zero canonical directions dropped); on the CPU it runs
    ``torch.linalg.svd`` and keeps them, which moves the projection."""

    def __enter__(self):
        from cross_patient_speech_decoding_tpu_torch.ops import cca

        self.cca, self.svd = cca, cca._svd_small
        svd = self.svd
        cca._svd_small = lambda g, method, force_gram=None: svd(
            g, method, True if method == "gram" else force_gram)

    def __exit__(self, *exc):
        self.cca._svd_small = self.svd


def _separated(lat):
    """Latent columns whose singular value (a PCA latent's column norm)
    stands apart from its neighbours by 1 % of the largest, the alignment
    tests' rule (tests/test_torch_alignment.py:_check_pca): near-equal
    noise directions turn within their span between two eigensolvers."""
    s = lat.reshape(-1, lat.shape[-1]).double().norm(dim=0)
    apart = (s[1:] - s[:-1]).abs() > 1e-2 * s.max()
    sep = s > 0
    sep[:-1] &= apart
    sep[1:] &= apart
    return sep


def _check_fir_tf32(torch, dev):
    """``fir_filter`` on the card with TF32 switched on by the caller
    (cuDNN's legacy switch and the conv's own) against the CPU: 128
    channels, 2,000 samples, 8 bands of 65 taps."""
    from cross_patient_speech_decoding_tpu_torch.ops.signal import fir_filter

    gen = torch.Generator().manual_seed(5)
    data = torch.randn(128, 2000, generator=gen)
    coefs = torch.randn(8, 65, generator=gen) / 65
    conv = torch.backends.cudnn.conv
    before = (torch.backends.cudnn.allow_tf32, conv.fp32_precision)
    torch.backends.cudnn.allow_tf32 = True
    conv.fp32_precision = "tf32"
    try:
        got = fir_filter(data.to(dev), coefs.to(dev))
        # the same convolution without the pin, for scale
        raw = torch.nn.functional.conv1d(
            torch.nn.functional.pad(data.to(dev), (64, 0))[:, None],
            coefs.flip(-1)[:, None].to(dev)).transpose(1, 2)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = before[0]
        conv.fp32_precision = before[1]
    want = fir_filter(data, coefs)
    err = _rel(got.cpu(), want)
    return {"rel_err": err, "unpinned_conv_rel_err": _rel(raw.cpu(), want),
            "fir_ok": err <= FIR_RTOL}


# ---------------------------------------------------------------------------
# tune_ctc: the CTC sweep, make-xforms and realtime-sim drivers
# ---------------------------------------------------------------------------


class _TuneProbe:
    """Wrappers around what the CTC sweep trains, for a block: each model
    of a bucket (its layers, epochs and synchronised time), each
    validation (synchronised time), and the train and validation sets the
    held-out trainer is built on."""

    def __init__(self, torch):
        from cross_patient_speech_decoding_tpu_torch.sweep import ctc

        self.torch, self.ctc = torch, ctc
        self.models, self.train_s, self.eval_s, self.rows = [], [], [], []
        self.holdout = None

    def _sync_time(self, fn, store, *a, **k):
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        self.torch.cuda.synchronize()
        store.append(time.perf_counter() - t0)
        return out

    def __enter__(self):
        ctc, probe = self.ctc, self
        self.saved = [(ctc._Bucket, "train", ctc._Bucket.train),
                      (ctc, "_val_per", ctc._val_per),
                      (ctc, "make_ctc_bucket_trainer",
                       ctc.make_ctc_bucket_trainer)]
        orig = {n: f for _, n, f in self.saved}

        def train(bucket, i, lr, wd, epochs, x, *a, **k):
            probe.models.append((bucket.arch["n_layers"], epochs))
            probe.rows.append(int(x.shape[0]) * epochs)
            return probe._sync_time(orig["train"], probe.train_s, bucket, i,
                                    lr, wd, epochs, x, *a, **k)

        def val_per(*a, **k):
            return probe._sync_time(orig["_val_per"], probe.eval_s, *a, **k)

        def make(train_batch, val_batch, *a, **k):
            probe.holdout = (train_batch, val_batch)
            return orig["make_ctc_bucket_trainer"](train_batch, val_batch,
                                                   *a, **k)

        ctc._Bucket.train = train
        ctc._val_per = val_per
        ctc.make_ctc_bucket_trainer = make
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)

    def expected(self, jacobi: int) -> dict:
        """Exact launches of the models trained: per model of L layers and
        E epochs, E + 1 windowed forwards (the train steps and one
        validation) and (E + 1)(L - 1) layer forwards, E windowed
        backwards and E (L - 1) layer backwards."""
        want = {"gru_wfwd": 0, "gru_fwd": 0, "gru_wbwd": 0, "gru_bwd": 0,
                "gru_bifwd": 0, "jacobi_eigh": jacobi}
        for L, E in self.models:
            want["gru_wfwd"] += E + 1
            want["gru_fwd"] += (E + 1) * (L - 1)
            want["gru_wbwd"] += E
            want["gru_bwd"] += E * (L - 1)
        return want

    def summary(self) -> dict:
        n = sum(E for _, E in self.models)
        return {"models": len(self.models),
                "model_epochs": [E for _, E in self.models],
                "model_layers": [L for L, _ in self.models],
                "ms_per_trial_epoch": (sum(self.train_s) / n * 1e3
                                       if n else None),
                "train_samples_per_s": (sum(self.rows) / sum(self.train_s)
                                        if n else None),
                "eval_ms_median": (statistics.median(self.eval_s) * 1e3
                                   if self.eval_s else None)}


def _tune_results_ok(results, n_win: int) -> bool:
    """JAX's order (full budgets first, then by metric) and finite PERs in
    [0, 100 x n_win / 3] (a decode of n_win symbols against 3 labels)."""
    keys = [(-r["epochs"], r["metric"]) for r in results]
    return bool(results) and keys == sorted(keys) and all(
        math.isfinite(r["metric"]) and 0.0 <= r["metric"] <= 100.0 * n_win / 3
        for r in results)


def xform_jacobi_launches(jacobi, widths: list) -> int:
    """``jacobi_eigh`` launches of make-xforms: one gram CCA fit per source
    (batch 1) into the target's latents. The fit whitens both Grams (one
    eigh of the two stacked where the widths are equal, else one each),
    then takes the eigh of g^T g at the source's width; ``batched_eigh``
    sends a batch of 1 or 2 to the kernel where ANY_BATCH_K <= K <= MAX_K."""
    def kernel(K):
        return int(jacobi.ANY_BATCH_K <= K <= jacobi.MAX_K)

    k_t = widths[0]
    return sum((kernel(k_t) if k_s == k_t else kernel(k_t) + kernel(k_s))
               + kernel(k_s) for k_s in widths[1:])


def _stream_steps(first_bin: int, n: int, win: int, stride: int) -> int:
    """GRU steps of the streaming loop over bins first_bin .. first_bin +
    n - 1 (counting from 1): one where the ring is full and the stride
    divides the bins since."""
    return sum(b >= win and (b - win) % stride == 0
               for b in range(first_bin, first_bin + n))


def _write_rt_ckpt(torch, path, C_, H_, L_, K_, win, stride, seed):
    """A Lightning checkpoint in the reference's key layout
    (realtime_nn_model.py:122-147), random weights from ``seed``."""
    torch.manual_seed(seed)
    gru_ = torch.nn.GRU(win * C_, H_, num_layers=L_, batch_first=True)
    head = torch.nn.Linear(H_, K_)
    sd = {f"rnn.rnn.{k}": v for k, v in gru_.state_dict().items()}
    sd["h0"] = torch.randn(L_, 1, H_)
    sd.update({f"classifier.fc.{k}": v for k, v in head.state_dict().items()})
    torch.save({"state_dict": sd, "hyper_parameters": dict(
        input_size=win * C_, hidden_size=H_, n_layers=L_, n_classes=K_,
        dropout=0.3, win_size=win, stride=stride, bidirectional=False,
        blank=0)}, path)


class _StreamRecord:
    """Within the block, keep what ``run_realtime_sim``'s
    ``simulate_stream`` calls were given and returned (the last one is the
    timed stream)."""

    def __enter__(self):
        from cross_patient_speech_decoding_tpu_torch import realtime

        self.mod, self.fn, self.calls = realtime, realtime.simulate_stream, []

        def record(model, state, chunks, b, a, cfg=None):
            out = self.fn(model, state, chunks, b, a, cfg)
            self.calls.append((model, chunks, b, a, out))
            return out

        realtime.simulate_stream = record
        return self

    def __exit__(self, *exc):
        self.mod.simulate_stream = self.fn


def _tune_cfg(**kw):
    from cross_patient_speech_decoding_tpu_torch.utils.config import (
        TuneCTCConfig,
    )

    scale = {k: DRV_CFG[k] for k in ("synth_patients", "synth_trials",
                                     "synth_T", "seed")}
    return TuneCTCConfig(**scale, align_train=True, **kw)


def phase_tune_ctc(torch, dev, gru, jacobi, smi):
    """The CTC sweep (holdout TPE and 5-fold CV), a fig_5-width bucket,
    make-xforms and realtime-sim from a checkpoint at the CTC driver's
    scale, then small depth card vs CPU. In the sweep, the bucket and the
    CV run, the first GRU launch of each shape is held against its plain
    version on the same inputs. Returns the launches of each run by
    kernel."""
    import tempfile

    from cross_patient_speech_decoding_tpu_torch.cli import experiments as exp
    from cross_patient_speech_decoding_tpu_torch.models import RealtimeRNN
    from cross_patient_speech_decoding_tpu_torch.sweep import ctc
    from cross_patient_speech_decoding_tpu_torch.utils.config import (
        RealtimeSimConfig,
    )

    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    n_win = (DRV_CFG["synth_T"] - WIN) // STRIDE + 1
    res = {"phase": "tune_ctc", "nvidia_smi": smi}
    launches, peaks, fails = {}, {}, []
    res["path_gru"] = {}

    def counted(name, fn, want_fn, record=False):
        """Run ``fn`` with the counts zeroed before and read after. With
        ``record``, the first GRU launch of each shape is kept and then
        held against its plain version on the same inputs; the copies are
        taken out of the run's peak memory and freed."""
        _reset_counts(gru, jacobi)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with (_RecordGru(torch, gru) if record
              else contextlib.nullcontext()) as rec:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        got = _launch_counts(gru, jacobi)
        peaks[name] = (torch.cuda.max_memory_allocated()
                       - (rec.nbytes if record else 0)) / 1e9
        want = want_fn()
        launches[name] = got
        if got != want:
            fails.append(f"{name} launched {got}, expected {want}")
        if record:
            with guard.lifted():
                checked = _check_path_gru(gru, rec)
            res["path_gru"][name] = checked
            bad = {k: v for k, v in checked.items() if not v["ok"]}
            if bad:
                fails.append(f"{name}: GRU kernels vs plain {bad}")
            del rec
        return out, wall, got, want

    with _NoPlainOnCuda(torch, gru, jacobi) as guard:
        # (1) the holdout sweep, aligned, TPE through rungs 1 and 2
        cfg = _tune_cfg(**TUNE_CFG, manifest=str(root / "m.jsonl"))
        with _TuneProbe(torch) as pr:
            results, wall, got, want = counted(
                "tune_ctc", lambda: exp.run_tune_ctc(cfg, device=dev),
                lambda: pr.expected(DRV_JACOBI), record=True)
        train_b, val_b = pr.holdout
        res["sweep"] = {"config": TUNE_CFG, "wall_s": wall,
                        "peak_mem_gb": peaks["tune_ctc"], "launches": got,
                        "launches_expected": want,
                        "results": results, **pr.summary(),
                        "results_ok": _tune_results_ok(results, n_win),
                        "manifest_wall_s": [
                            json.loads(x).get("wall_s")
                            for x in open(cfg.manifest)]}
        if not res["sweep"]["results_ok"]:
            fails.append(f"sweep results {results}")
        again, _, got, _ = counted(
            "tune_ctc_resume", lambda: exp.run_tune_ctc(cfg, device=dev),
            lambda: {k: 0 for k in want})
        res["sweep"]["resume_launches"] = got
        first = {json.dumps(r, sort_keys=True) for r in results}
        res["sweep"]["resume_ok"] = bool(again) and all(
            json.dumps(r, sort_keys=True) in first for r in again)
        if not res["sweep"]["resume_ok"]:
            fails.append(f"resume returned {again}")

        # (2) the fig_5-width bucket on that run's train and validation sets
        cfgs = [dict(TUNE_FIG5_ARCH, lr=lr, weight_decay=wd)
                for lr, wd in TUNE_FIG5_OPT]
        trainer = ctc.make_ctc_bucket_trainer(train_b, val_b, n_classes=11,
                                              seed=0)
        with _TuneProbe(torch) as pb:
            pers, wall, got, want = counted(
                "tune_ctc_fig5_bucket",
                lambda: trainer(cfgs, TUNE_FIG5_EPOCHS),
                lambda: pb.expected(0), record=True)
        _, prof = profile_call(torch, lambda: trainer(cfgs[:1], 1))
        # a model's construction: weights drawn on the host, then copied
        build_s = []
        for i in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            RealtimeRNN(train_b[0].shape[-1], H, N_LAYERS, N_CLASSES,
                        seed=i, device=dev)
            torch.cuda.synchronize()
            build_s.append(time.perf_counter() - t0)
        res["fig5_bucket"] = {
            "configs": cfgs, "epochs": TUNE_FIG5_EPOCHS,
            "train_rows": int(train_b[0].shape[0]),
            "val_rows": int(val_b[0].shape[0]), "pers": pers,
            "wall_s": wall, "peak_mem_gb": peaks["tune_ctc_fig5_bucket"],
            "launches": got, "launches_expected": want, **pb.summary(),
            "one_trial_epoch_profile": prof,
            "model_build_ms": [t * 1e3 for t in build_s]}
        if not all(math.isfinite(p) for p in pers):
            fails.append(f"fig5 bucket PERs {pers}")
        del trainer, train_b, val_b

        # (3) the CV path: every fold's prep refitted, B x F models in turn
        cv_cfg = _tune_cfg(**TUNE_CV_CFG, manifest=str(root / "cv.jsonl"))
        with _TuneProbe(torch) as pc:
            cv_results, wall, got, want = counted(
                "tune_ctc_cv", lambda: exp.run_tune_ctc(cv_cfg, device=dev),
                lambda: pc.expected(DRV_JACOBI * TUNE_CV_CFG["cv_folds"]),
                record=True)
        res["cv"] = {"config": TUNE_CV_CFG, "wall_s": wall,
                     "peak_mem_gb": peaks["tune_ctc_cv"],
                     "launches": got, "launches_expected": want,
                     "results": cv_results, **pc.summary(),
                     "results_ok": _tune_results_ok(cv_results, n_win)}
        if not res["cv"]["results_ok"]:
            fails.append(f"cv results {cv_results}")

        # (4) make-xforms at the same scale
        res["make_xforms"] = _tune_xforms(torch, dev, exp, jacobi, root,
                                          counted, fails)

        # (5) realtime-sim from a fig_5-width checkpoint
        ck = root / "rt.ckpt"
        _write_rt_ckpt(torch, ck, C, H, N_LAYERS, N_CLASSES, WIN, STRIDE, 0)
        rt_cfg = RealtimeSimConfig(ckpt=str(ck), out=str(root / "rt.pkl"),
                                   **TUNE_RT)
        steps = (2 * _stream_steps(1, rt_cfg.n_bins, WIN, STRIDE)
                 + _stream_steps(1, rt_cfg.per_step_chain
                                 * (1 + rt_cfg.per_step_samples), WIN,
                                 STRIDE))
        with _StreamRecord() as rec:
            rt, wall, got, want = counted(
                "realtime_sim",
                lambda: exp.run_realtime_sim(rt_cfg, device=dev),
                lambda: {"gru_wfwd": 0, "gru_fwd": N_LAYERS * steps,
                         "gru_wbwd": 0, "gru_bwd": 0, "gru_bifwd": 0,
                         "jacobi_eigh": 0})
        res["realtime_sim"] = _tune_stream_checks(torch, rt, rec, rt_cfg,
                                                  wall, got, want, fails)

    # (6) small depth, card vs CPU
    res["small_depth_card_vs_cpu"] = _tune_small(torch, dev, exp, ctc, root)
    bad = {k: v for k, v in res["small_depth_card_vs_cpu"].items()
           if k.endswith("_ok") and v is not True}
    if bad:
        fails.append(f"small-depth card vs CPU: {bad}")
    res["fails"] = fails
    emit(res)
    fig5 = res["fig5_bucket"]
    emit({"phase": "tune_ctc_times",
          "sweep_wall_s": res["sweep"]["wall_s"],
          "sweep_ms_per_trial_epoch": res["sweep"]["ms_per_trial_epoch"],
          "fig5_ms_per_trial_epoch": fig5["ms_per_trial_epoch"],
          "fig5_train_samples_per_s": fig5["train_samples_per_s"],
          "fig5_eval_ms": fig5["eval_ms_median"],
          "fig5_idle_share": fig5["one_trial_epoch_profile"].get(
              "device_idle_share"),
          "fig5_model_build_ms": fig5["model_build_ms"],
          "cv_wall_s": res["cv"]["wall_s"],
          "make_xforms_wall_s": res["make_xforms"]["wall_s"],
          "realtime_amortized_ms": res["realtime_sim"][
              "amortized_ms_per_bin"],
          "realtime_p50_ms": res["realtime_sim"]["p50_ms"],
          "realtime_p99_ms": res["realtime_sim"]["p99_ms"],
          "realtime_max_ms": res["realtime_sim"]["max_ms"],
          "path_gru_launches_checked": sum(
              len(v) for v in res["path_gru"].values()),
          "path_gru_max_abs_err": max(
              [c["max_abs_err"] for v in res["path_gru"].values()
               for c in v.values() if "max_abs_err" in c], default=None),
          "path_gru_max_rel_err_backward": max(
              [c["max_rel_err"] for v in res["path_gru"].values()
               for c in v.values() if "max_rel_err" in c], default=None)})
    tmp.cleanup()
    if fails:
        raise RuntimeError(f"tune_ctc: {fails}")
    out = {}
    for run, counts in launches.items():
        if run.endswith("_resume"):
            continue
        for k, v in counts.items():
            out.setdefault(k, {})[f"launches_{run}"] = v
    return out


def _tune_xforms(torch, dev, exp, jacobi, root, counted, fails) -> dict:
    """make-xforms at the CTC driver's data scale (MakeXformsConfig, like
    JAX's, has no synth_* fields: the instance carries them for
    ``_synthetic_ctc_cfg``), then the card's transforms against the CPU's
    from the same host data."""
    import numpy as np

    from cross_patient_speech_decoding_tpu_torch.utils.config import (
        MakeXformsConfig,
    )

    cfg = MakeXformsConfig(pca_out=str(root / "pca.h5"),
                           cca_out=str(root / "cca.h5"))
    for k in ("synth_patients", "synth_trials", "synth_T"):
        setattr(cfg, k, DRV_CFG[k])
    try:
        import h5py  # noqa: F401
        have_h5 = True
    except ImportError:
        have_h5 = False
    widths = []

    def run():
        if have_h5:
            out = exp.run_make_xforms(cfg, device=dev)
        else:
            out = exp.compute_xforms(cfg, device=dev)
        widths.extend(W.shape[0] for W in out["pca"].values())
        return out

    card, wall, got, want = counted(
        "make_xforms", run,
        lambda: {"gru_wfwd": 0, "gru_fwd": 0, "gru_wbwd": 0, "gru_bwd": 0,
                 "gru_bifwd": 0,
                 "jacobi_eigh": xform_jacobi_launches(jacobi, widths)})
    _synth_cache_to_cpu(exp)
    with _CardCcaRoute():
        cpu = exp.compute_xforms(cfg, device="cpu")
    exp._SYNTH_CTC_CACHE.clear()
    pca_same = all(np.array_equal(card["pca"][k], cpu["pca"][k])
                   for k in cpu["pca"])
    errs = {f"{s}->{t}": float(np.abs(card["cca"][(s, t)] - M).max()
                               / np.abs(M).max())
            for (s, t), M in cpu["cca"].items()}
    out = {"wall_s": wall, "latent_widths": widths, "launches": got,
           "launches_expected": want,
           "h5": ("written and read back" if have_h5
                  else "not written: no h5py"),
           "pca_card_vs_cpu_bitwise": pca_same,
           "proj_b_to_a_rel_errs": errs,
           "proj_ok": all(e <= XF_PROJ_RTOL for e in errs.values())}
    if have_h5:
        from cross_patient_speech_decoding_tpu_torch.data.loaders import (
            load_cca_xform,
            load_pca_xform,
        )

        names = list(card["pca"])
        out["h5_ok"] = all(
            np.array_equal(load_pca_xform(cfg.pca_out, n), card["pca"][n].T)
            for n in names) and all(
            np.array_equal(load_cca_xform(cfg.cca_out, t, s), M)
            for (s, t), M in card["cca"].items())
        if not out["h5_ok"]:
            fails.append("make-xforms files differ from the transforms")
    if not pca_same or not out["proj_ok"]:
        fails.append(f"make-xforms card vs CPU: pca {pca_same}, {errs}")
    return out


def _tune_stream_checks(torch, rt, rec, cfg, wall, got, want, fails):
    """The timed stream's online logits against the imported model's
    offline forward of the same features; latency and the out pickle."""
    import pickle

    import numpy as np
    import scipy.signal as sps

    from cross_patient_speech_decoding_tpu_torch.ops import signal

    model, chunks, b, a, (_, (emitted, logits, did_run)) = rec.calls[-1]
    bs, as_ = [], []
    for lo, hi in ((0.35, 0.5), (0.5, 0.65), (0.65, 0.8)):
        b_, a_ = sps.butter(2, [lo, hi], btype="band")
        bs.append(b_)
        as_.append(a_)
    st = signal.init_stream_state(np.stack(bs), np.stack(as_),
                                  chunks.shape[1], device=chunks.device)
    powers = []
    with torch.no_grad():
        for ch in chunks:
            p, st = signal.process_hg_chunk(ch, b, a, st)
            powers.append(p)
        offline = model(torch.stack(powers)[None])[0]
    err = float((logits[did_run] - offline).abs().max())
    with open(cfg.out, "rb") as f:
        stored = pickle.load(f)
    keys = {"params", "amortized_ms", "p50_ms", "p99_ms", "max_ms",
            "samples_ms"}
    out = {"config": TUNE_RT, "channels": cfg.n_channels,
           "hidden": cfg.hidden, "n_layers": cfg.n_layers, "wall_s": wall,
           "launches": got, "launches_expected": want,
           "gru_steps_timed_stream": int(did_run.sum()),
           "symbols_emitted": int((emitted >= 0).sum()),
           "amortized_ms_per_bin": rt["amortized_ms"],
           "p50_ms": rt["p50_ms"], "p99_ms": rt["p99_ms"],
           "max_ms": rt["max_ms"],
           "online_vs_offline_max_abs_err": err,
           "out_keys_ok": set(stored) == keys
           and len(stored["samples_ms"]) == cfg.per_step_samples}
    if not err <= STREAM_ATOL:
        fails.append(f"realtime-sim online vs offline {err}")
    if not rt["p50_ms"] < TUNE_RT_P50_MS:
        fails.append(f"realtime-sim p50 {rt['p50_ms']} ms")
    if not out["out_keys_ok"]:
        fails.append(f"realtime-sim out pickle keys {sorted(stored)}")
    return out


def _tune_small(torch, dev, exp, ctc, root) -> dict:
    """Two trials of one bucket (hidden 16 x 2, dropout 0, 2 epochs) on the
    card and on the CPU from the same data and initial weights, then one
    ``run_train_ctc init_ckpt=`` iteration from a small checkpoint on
    both."""
    import numpy as np

    from cross_patient_speech_decoding_tpu_torch.data.splits import (
        train_val_test_masks,
    )
    from cross_patient_speech_decoding_tpu_torch.models import RealtimeRNN
    from cross_patient_speech_decoding_tpu_torch.utils.config import (
        TrainCTCConfig,
    )

    small = TrainCTCConfig(**TUNE_SMALL_DATA)
    X, y, il, ll = exp._synthetic_ctc_cfg(small, dev)[0]
    tr, va, _ = train_val_test_masks(len(y), np.random.default_rng(0))
    tr_i, va_i = np.where(tr > 0)[0], np.where(va > 0)[0]

    def sets(d):
        Xd = X.to(d)
        return [tuple([Xd[torch.as_tensor(i, device=d)]]
                      + [a[i] for a in (y, il, ll)]) for i in (tr_i, va_i)]

    cfgs = [dict(TUNE_SMALL_ARCH, lr=lr, weight_decay=wd)
            for lr, wd in TUNE_SMALL_OPT]
    init = [RealtimeRNN(X.shape[-1], TUNE_SMALL_ARCH["hidden"],
                        TUNE_SMALL_ARCH["n_layers"], 11, dropout=0.0,
                        seed=100 + i, device="cpu").state_dict()
            for i in range(len(cfgs))]
    weights = {}
    orig_sync = ctc._sync_tiny

    def run(d):
        weights[str(d)] = []

        def keep(model):
            weights[str(d)].append({k: v.detach().cpu().clone()
                                    for k, v in model.state_dict().items()})
            return orig_sync(model)

        ctc._sync_tiny = keep
        try:
            tr_set, va_set = sets(d)
            pers = ctc.make_ctc_bucket_trainer(tr_set, va_set, 11, seed=0)(
                cfgs, TUNE_SMALL_EPOCHS, init_params=init)
            model_logits = []
            for w in weights[str(d)]:
                m = RealtimeRNN(X.shape[-1], TUNE_SMALL_ARCH["hidden"],
                                TUNE_SMALL_ARCH["n_layers"], 11,
                                dropout=0.0, device=d)
                m.load_state_dict(w)
                with torch.no_grad():
                    model_logits.append(m.eval()(va_set[0]).cpu())
            return pers, model_logits
        finally:
            ctc._sync_tiny = orig_sync

    pers_card, lg_card = run(dev)
    pers_cpu, lg_cpu = run(torch.device("cpu"))
    w_errs = [max(float((a[k] - b[k]).abs().max()) for k in a)
              for a, b in zip(weights[str(dev)], weights["cpu"])]
    w_p99 = [float(torch.cat([(a[k] - b[k]).abs().flatten() for k in a])
                   .quantile(0.99))
             for a, b in zip(weights[str(dev)], weights["cpu"])]
    # a window's decode may differ only where the CPU's top two logits lie
    # within TUNE_DECIDED of each other
    flips, decided_same = [], []
    for c, g in zip(lg_cpu, lg_card):
        top2 = c.topk(2, dim=-1).values
        tie = (top2[..., 0] - top2[..., 1]) <= TUNE_DECIDED * top2[
            ..., 0].abs().clamp(min=1.0)
        diff = c.argmax(-1) != g.argmax(-1)
        flips.append(int(diff.sum()))
        decided_same.append(bool((~diff | tie).all()))
    out = {"config": {"data": TUNE_SMALL_DATA, "arch": TUNE_SMALL_ARCH,
                      "opt": TUNE_SMALL_OPT, "epochs": TUNE_SMALL_EPOCHS},
           "pers_card": pers_card, "pers_cpu": pers_cpu,
           "weight_max_abs_errs": w_errs, "weight_p99_abs_errs": w_p99,
           "weights_ok": all(e <= TUNE_SMALL_W_ATOL for e in w_errs)
           and all(e <= TUNE_SMALL_W_P99 for e in w_p99),
           "window_decodes_differing": flips,
           "decodes_ok": all(decided_same),
           "per_ok": all(p == q or n > 0 for p, q, n in
                         zip(pers_card, pers_cpu, flips))}
    out.update(_tune_init_ckpt(torch, dev, exp, root))
    exp._SYNTH_CTC_CACHE.clear()
    return out


def _tune_init_ckpt(torch, dev, exp, root) -> dict:
    """One ``run_train_ctc init_ckpt=`` iteration (patient context, T=200)
    from a small checkpoint on the card, then on the CPU from the card's
    data: validation losses and test PER."""
    import numpy as np

    from cross_patient_speech_decoding_tpu_torch.utils.config import (
        TrainCTCConfig,
    )

    ck = root / "small.ckpt"
    _write_rt_ckpt(torch, ck, TUNE_CKPT_CHANNELS, 16, 2, N_CLASSES, WIN,
                   STRIDE, 1)

    def cfg_on(name):
        return TrainCTCConfig(**TUNE_INIT_CKPT, init_ckpt=str(ck),
                              out=str(root / name / "ctc.pkl"))

    pers_card = exp.run_train_ctc(cfg_on("card"), verbose=False, device=dev)
    _synth_cache_to_cpu(exp)
    pers_cpu = exp.run_train_ctc(cfg_on("cpu"), verbose=False, device="cpu")
    h_card = _history(cfg_on("card").out, "ptSpecific")
    h_cpu = _history(cfg_on("cpu").out, "ptSpecific")
    val_errs = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
                for a, b in zip(h_card, h_cpu)]
    n_test = round(exp._synthetic_ctc_n_trials(cfg_on("x"))
                   * cfg_on("x").test_frac)
    one_edit = 100.0 / (3 * n_test)
    return {"init_ckpt_per_card": pers_card.tolist(),
            "init_ckpt_per_cpu": pers_cpu.tolist(),
            "init_ckpt_val_loss_rel_errs": val_errs,
            "init_ckpt_ok": len(h_card) == len(h_cpu) > 0
            and all(e <= DRV_VAL_RTOL for e in val_errs)
            and bool(np.abs(pers_card - pers_cpu).max() <= one_edit + 1e-9)}


class _SvmProbe:
    """Wrappers around what one ``run_svm_decode`` iteration runs, for a
    block: the decoder returned by ``make_cv_decoder`` (each call
    synchronised and timed, with the Jacobi launches it made), and, with
    ``breakdown``, the fold program's parts, each synchronised and timed:
    PCA (``pooled._pca_latents``), CCA (``fit_cca_aligner`` and
    ``transform_b_to_a``), the classifier fit and the prediction with its
    balanced accuracy."""

    PARTS = {"pca": ("_pca_latents",),
             "cca": ("fit_cca_aligner", "transform_b_to_a"),
             "fit": ("kernel_classifier_fit",),
             "predict": ("kernel_classifier_predict", "balanced_accuracy")}

    def __init__(self, torch, jacobi, breakdown=False):
        from cross_patient_speech_decoding_tpu_torch.decoders import pooled

        self.torch, self.jacobi, self.pooled = torch, jacobi, pooled
        self.breakdown = breakdown
        self.calls = []  # (seconds, jacobi launches) per decoder call
        self.parts = {k: 0.0 for k in self.PARTS}

    def _sync_timed(self, fn, part):
        torch = self.torch

        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            self.parts[part] += time.perf_counter() - t0
            return out
        return run

    def __enter__(self):
        torch, jacobi, pooled = self.torch, self.jacobi, self.pooled
        self.saved = [(pooled, "make_cv_decoder", pooled.make_cv_decoder)]
        make = pooled.make_cv_decoder

        def make_timed(*a, **k):
            dec = make(*a, **k)

            def run(*args):
                torch.cuda.synchronize()
                n0 = jacobi.LAUNCHES["jacobi_eigh"]
                t0 = time.perf_counter()
                out = dec(*args)
                torch.cuda.synchronize()
                self.calls.append((time.perf_counter() - t0,
                                   jacobi.LAUNCHES["jacobi_eigh"] - n0))
                return out
            return run

        pooled.make_cv_decoder = make_timed
        if self.breakdown:
            for part, names in self.PARTS.items():
                for n in names:
                    fn = getattr(self.pooled, n)
                    self.saved.append((self.pooled, n, fn))
                    setattr(self.pooled, n, self._sync_timed(fn, part))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def svm_jacobi_launches(cfg: dict, fit_batch: int = SVM_FIT_BATCH) -> int:
    """``jacobi_eigh`` launches of one svm-decode iteration of sep_align:
    one a source patient and fold batch (the batched chol CCA fit's Gram
    SVD, K = max_k >= ANY_BATCH_K). Fixed parameters: the iteration's
    folds in batches of ``fold_batch``. Nested: each TPE round scores its
    outer folds max(1, fit_batch // (points x inner)) at a time
    (``nested_cv.make_candidate_scorer``), then one refit batch of
    min(n_folds, fit_batch) folds."""
    n_src = cfg["synth_patients"] - 1
    n = cfg["n_folds"]
    if not cfg.get("nested"):
        return n_src * math.ceil(n / cfg["fold_batch"])
    bs = max(1, fit_batch // (cfg["nested_points"] * cfg["nested_inner"]))
    return n_src * (cfg["nested_rounds"] * math.ceil(n / bs)
                    + math.ceil(n / min(n, fit_batch)))


def _svm_run(torch, exp, jacobi, gru, cfg, dev):
    """One counted ``run_svm_decode`` call on the card (counts zeroed just
    before, read just after), keeping the first batch of each shape that
    the Jacobi kernel gets, then the same call again, which must resume
    with no launch. Returns the phase's figures."""
    import numpy as np

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(gru, jacobi)
    with _NoPlainOnCuda(torch, gru, jacobi), _SvmProbe(torch, jacobi) as pr, \
            _RecordJacobi(jacobi, first_per_shape=True) as rec:
        t0 = time.perf_counter()
        accs = exp.run_svm_decode(cfg, verbose=True, device=dev)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    launches = _launch_counts(gru, jacobi)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    _reset_counts(gru, jacobi)
    again = exp.run_svm_decode(cfg, verbose=True, device=dev)
    torch.cuda.synchronize()
    return {"accs": accs, "again": again, "wall_s": wall_s,
            "launches": launches, "resume_launches": _launch_counts(gru,
                                                                   jacobi),
            "peak_mem_gb": peak_gb, "decoder_calls": pr.calls,
            "jacobi_batches": rec.batches,
            "accs_finite": bool(np.isfinite(accs).all())}


def _svm_iteration(torch, exp, spec, dev):
    """A function that runs the device work of the driver's first
    iteration for ``spec`` (the fold program over its folds, or the nested
    search), on data and masks made once, as ``run_svm_decode`` makes
    them, and the data's number of classes."""
    from cross_patient_speech_decoding_tpu_torch.data.splits import (
        repeated_stratified_kfold_masks,
    )
    from cross_patient_speech_decoding_tpu_torch.decoders import pooled
    from cross_patient_speech_decoding_tpu_torch.decoders.nested_cv import (
        nested_cv_decode_bayes,
    )

    tar, cross, n_y, n_a = exp.patients_from_config(
        "synthetic", "S14", seed=spec["seed"],
        trials_per_class=spec["synth_trials"],
        n_patients=spec["synth_patients"], T=spec["synth_T"], device=dev)
    dcfg = pooled.DecodeConfig(max_k=spec["max_k"], n_classes=n_y,
                               n_align_classes=n_a, kernel=spec["kernel"],
                               seed=spec["seed"])
    if spec.get("nested"):
        return lambda: nested_cv_decode_bayes(
            tar, cross, dcfg, n_folds=spec["n_folds"],
            n_rounds=spec["nested_rounds"], n_points=spec["nested_points"],
            n_inner=spec["nested_inner"], strategy=spec["strategy"],
            seed=spec["seed"], return_preds=True), n_y
    tr, te = repeated_stratified_kfold_masks(tar.y.cpu().numpy(),
                                             spec["n_folds"], 1,
                                             seed=spec["seed"])
    tr, te = (torch.as_tensor(m, dtype=torch.float32, device=dev)
              for m in (tr, te))
    dec = pooled.make_cv_decoder(spec["strategy"], dcfg,
                                 fold_batch=spec["fold_batch"],
                                 return_preds=True)
    return lambda: dec(tar, cross, tr, te), n_y


def _svm_breakdown(torch, exp, jacobi, spec, dev):
    """One iteration's work with its parts synchronised and timed
    (:class:`_SvmProbe`), then once more under ``torch.profiler``."""
    fn, n_y = _svm_iteration(torch, exp, spec, dev)
    fn()
    torch.cuda.synchronize()
    with _SvmProbe(torch, jacobi, breakdown=True) as pr:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        probed_s = time.perf_counter() - t0
    _, prof = profile_call(torch, fn)
    return {"probed_wall_s": probed_s, "n_classes": n_y,
            "parts_ms": {k: v * 1e3 for k, v in pr.parts.items()},
            "profile": prof}


def phase_svm_decode(torch, dev, gru, jacobi, smi):
    """The classical decoder end to end at the reference's scale: a
    fixed-parameter decode of 2 iterations and one nested iteration, each
    with exact Jacobi launches, a resume with none, times, idle share and
    peak memory, and the kernel against its plain version bit for bit on
    the first batch of each shape it got; then one fold batch at that
    scale and small depth on the card and on the CPU."""
    import tempfile

    from cross_patient_speech_decoding_tpu_torch.cli import experiments as exp
    from cross_patient_speech_decoding_tpu_torch.utils.config import (
        SVMDecodeConfig,
    )

    tmp = tempfile.TemporaryDirectory()
    res = {"phase": "svm_decode", "nvidia_smi": smi}
    bad = {}
    for name, spec, n_iter in (("fixed", SVM_CFG, SVM_CFG["n_iter"]),
                               ("nested", SVM_NESTED, 1)):
        cfg = SVMDecodeConfig(**spec, out=str(Path(tmp.name) / name
                                              / "svm.pkl"))
        want = svm_jacobi_launches(spec)
        r = _svm_run(torch, exp, jacobi, gru, cfg, dev)
        r.update(_svm_breakdown(torch, exp, jacobi, spec, dev))
        it_s = ([s for s, _ in r["decoder_calls"]] if name == "fixed"
                else [r["wall_s"]])
        per_it = [n for _, n in r["decoder_calls"]]
        launches = r.pop("launches")
        accs = r.pop("accs")
        checks = {}
        for A in r.pop("jacobi_batches"):
            key = "x".join(map(str, A.shape))
            checks[key] = _check_jacobi(torch, jacobi, A)
            if not _jacobi_ok(key, checks[key]):
                bad[f"{name}_jacobi_{key}"] = checks[key]
        res[name] = {
            "config": spec,
            "jacobi_launches_per_iteration_expected": want,
            "jacobi_launches": launches["jacobi_eigh"],
            "jacobi_launches_per_decoder_call": per_it,
            "other_launches": {k: v for k, v in launches.items()
                               if k != "jacobi_eigh"},
            "iteration_s": it_s,
            "folds_per_s": [spec["n_folds"] / s for s in it_s],
            "run_wall_s": r["wall_s"], "peak_mem_gb": r["peak_mem_gb"],
            "parts_ms": r["parts_ms"],
            "probed_iteration_s": r["probed_wall_s"],
            "iteration_profile": r["profile"],
            "note": "parts_ms and the profile are of one more iteration's "
                    "device work (data made before); parts each "
                    "synchronised",
            "jacobi_path_batches": checks,
            "mean_acc": float(accs.mean()), "chance": 1.0 / r["n_classes"],
            "accs_shape": list(accs.shape),
            "resume_launches": r["resume_launches"],
        }
        if launches["jacobi_eigh"] != want * n_iter or any(
                v for k, v in launches.items() if k != "jacobi_eigh"):
            bad[f"{name}_launches"] = launches
        if name == "fixed" and per_it != [want] * n_iter:
            bad["fixed_launches_per_iteration"] = per_it
        if not checks:
            bad[f"{name}_jacobi_batches"] = "none recorded"
        if not (r["accs_finite"] and accs.shape == (n_iter, spec["n_folds"])
                and 0.0 <= accs.min() and accs.max() <= 1.0):
            bad[f"{name}_accs"] = accs.tolist()
        if (r["again"].tolist() != accs.tolist()
                or any(r["resume_launches"].values())):
            bad[f"{name}_resume"] = r["resume_launches"]
    full = _svm_full(torch, exp, dev)
    res["full_scale_card_vs_cpu"] = full
    small = _svm_small(torch, exp, dev)
    res["small_depth_card_vs_cpu"] = small
    emit(res)
    tmp.cleanup()
    if not full["ok"]:
        bad["full_scale_card_vs_cpu"] = full
    bad.update({k: v for k, v in small.items()
                if k.endswith("_ok") and v is not True})
    if bad:
        raise RuntimeError(f"svm_decode checks failed: {list(bad)}")
    return {"launches_svm_decode_iteration":
            res["fixed"]["jacobi_launches_per_decoder_call"][0],
            "launches_svm_nested_iteration":
            res["nested"]["jacobi_launches"]}


class _ScoreProbe:
    """Records the decision scores of every prediction of the fold
    program (summed over a bagged ensemble) and, with ``latents``, the
    target's PCA latents and the CCA-mapped source latents."""

    def __init__(self, latents=False):
        from cross_patient_speech_decoding_tpu_torch.decoders import pooled
        from cross_patient_speech_decoding_tpu_torch.ops import classifiers

        self.pooled, self.cl = pooled, classifiers
        self.latents = latents
        self.scores, self.tar, self.aligned = [], [], []

    def __enter__(self):
        pooled, cl = self.pooled, self.cl
        self.saved = [(pooled, n, getattr(pooled, n)) for n in (
            "kernel_classifier_predict", "bagged_classifier_predict")
            + (("_pca_latents", "transform_b_to_a") if self.latents else ())]
        orig = {n: f for _, n, f in self.saved}

        def predict(clf, X, kernel):
            self.scores.append(cl.kernel_classifier_decision(clf, X, kernel))
            return orig["kernel_classifier_predict"](clf, X, kernel)

        def bagged(clf, X, kernel):
            self.scores.append(cl.kernel_classifier_decision(
                clf, X[..., None, :, :], kernel).sum(-3))
            return orig["bagged_classifier_predict"](clf, X, kernel)

        def pca_lat(X, n_comp, max_k, sample_mask=None, **kw):
            st, lat = orig["_pca_latents"](X, n_comp, max_k, sample_mask,
                                           **kw)
            if sample_mask is not None:
                self.tar.append(lat)
            return st, lat

        def aligned(al, X):
            out = orig["transform_b_to_a"](al, X)
            self.aligned.append(out)
            return out

        pooled.kernel_classifier_predict = predict
        pooled.bagged_classifier_predict = bagged
        if self.latents:
            pooled._pca_latents = pca_lat
            pooled.transform_b_to_a = aligned
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


class _PlainJacobiOnCpu:
    """Within the block, ``batched_eigh`` sends a CPU batch down the
    kernel's route to its plain version (bit for bit the kernel), and the
    CCA's small SVD takes the card's Gram route (:class:`_CardCcaRoute`)."""

    def __enter__(self):
        from cross_patient_speech_decoding_tpu_torch.ops import jacobi

        self.jacobi, self.route = jacobi, jacobi._route
        route = self.route
        jacobi._route = lambda A: "plain" if A.device.type == "cpu" \
            else route(A)
        self.cca = _CardCcaRoute()
        self.cca.__enter__()

    def __exit__(self, *exc):
        self.cca.__exit__(*exc)
        self.jacobi._route = self.route


def _undecided(scores, rtol=SVM_DECIDED):
    """(B, N0) trials whose top two scores differ by at most ``rtol`` of
    their magnitude."""
    top2 = scores.double().topk(2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]) <= rtol * top2.abs().amax(-1)


def _held(torch, y, te, card, cpu, cpu_scores, unstable=None) -> dict:
    """Card against CPU for one decoder call: ``card``/``cpu`` its (accs
    (B,), preds (B, N0)). Predictions equal on the trials the CPU's scores
    decide (:func:`_undecided`) and, where given, that are not
    ``unstable`` (B, N0); fold accuracies equal where all test trials are
    decided and within the balanced weight of the undecided ones
    elsewhere."""
    import numpy as np

    (a_g, p_g), (a_c, p_c) = ((a.cpu().numpy(), p.cpu().numpy())
                              for a, p in (card, cpu))
    und = _undecided(torch.cat(cpu_scores)).numpy()
    if unstable is not None:
        und = und | unstable
    slack = []
    for f in range(len(te)):
        cls, sup = np.unique(y[te[f] > 0], return_counts=True)
        w = dict(zip(cls, 1.0 / (len(cls) * sup)))
        slack.append(float(sum(w[y[i]] for i in
                               np.where((te[f] > 0) & und[f])[0])))
    r = {"accs_card": a_g.tolist(), "accs_cpu": a_c.tolist(),
         "undecided_trials": int(und.sum()),
         "pred_mismatch_decided": int((p_g != p_c)[~und].sum()),
         "acc_slack": slack}
    r["ok"] = (r["pred_mismatch_decided"] == 0
               and all(abs(g - h) <= s + 1e-6
                       for g, h, s in zip(a_g, a_c, slack)))
    return r


def _svm_full(torch, exp, dev):
    """One fold batch at the timed scale (SVM_CFG: 8 patients x 135
    trials, T=200, max_k 32, 20 folds) on the card and on the CPU from the
    same data and seed, at a noise at which the decode is far from perfect
    (SVM_FULL_NOISE), the CPU's Jacobi on the kernel's route through its
    plain version; held as :func:`_held` holds it."""
    from cross_patient_speech_decoding_tpu_torch.data.splits import (
        repeated_stratified_kfold_masks,
    )
    from cross_patient_speech_decoding_tpu_torch.decoders import pooled

    c = SVM_CFG
    tar, cross, n_y, n_a = exp.patients_from_config(
        "synthetic", "S14", seed=c["seed"], noise=SVM_FULL_NOISE,
        trials_per_class=c["synth_trials"], n_patients=c["synth_patients"],
        T=c["synth_T"], device=dev)
    tar_c = pooled.PatientArrays(*(t.cpu() for t in tar))
    cross_c = tuple(pooled.PatientArrays(*(t.cpu() for t in p))
                    for p in cross)
    y = tar_c.y.numpy()
    tr, te = repeated_stratified_kfold_masks(y, c["n_folds"], 1,
                                             seed=c["seed"])
    dcfg = pooled.DecodeConfig(max_k=c["max_k"], n_classes=n_y,
                               n_align_classes=n_a, kernel=c["kernel"],
                               seed=c["seed"])
    dec = pooled.make_cv_decoder(c["strategy"], dcfg,
                                 fold_batch=c["fold_batch"],
                                 return_preds=True)
    with _ScoreProbe():
        card = dec(tar, cross, *(torch.as_tensor(m, dtype=torch.float32,
                                                 device=dev)
                                 for m in (tr, te)))
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _PlainJacobiOnCpu(), _ScoreProbe() as cpu:
        got = dec(tar_c, cross_c, *(torch.as_tensor(m, dtype=torch.float32)
                                    for m in (tr, te)))
    cpu_s = time.perf_counter() - t0
    return {"config": c, "noise": SVM_FULL_NOISE,
            "decided_rtol": SVM_DECIDED, "chance": 1.0 / n_y,
            "mean_acc_card": float(card[0].mean()), "cpu_s": cpu_s,
            **_held(torch, y, te, card, got, cpu.scores)}


def _svm_small(torch, exp, dev):
    """Small depth (3 patients, T=40, 4 folds) on the card and on the CPU
    from the same data and seed, at the driver's noise and at a noise no
    strategy decodes perfectly, the CPU's Jacobi on the kernel's route
    through its plain version: predictions equal on the trials the CPU's
    scores decide (:func:`_undecided`), fold accuracies equal where all
    test trials are decided and within the weight of the undecided ones
    elsewhere; for sep_align the target's and the mapped sources' latents
    on the target's separated columns (``_separated``, per fold): two
    target components of near-equal variance turn within their span
    between the two eigensolvers, and the sources mapped into the target's
    space turn with them."""
    from cross_patient_speech_decoding_tpu_torch.data.splits import (
        repeated_stratified_kfold_masks,
    )
    from cross_patient_speech_decoding_tpu_torch.decoders import pooled

    c = SVM_SMALL

    def data(noise):
        tar, cross, n_y, n_a = exp.patients_from_config(
            "synthetic", "S14", seed=c["seed"], noise=noise,
            trials_per_class=c["synth_trials"],
            n_patients=c["synth_patients"], T=c["synth_T"], device=dev)
        return (tar, cross, pooled.PatientArrays(*(t.cpu() for t in tar)),
                tuple(pooled.PatientArrays(*(t.cpu() for t in p))
                      for p in cross), n_y, n_a)

    # the driver's noise, and a noise at which no strategy decodes every
    # trial, so that predictions are held where they are not easy
    sets = {"": data(SVM_SMALL_NOISE[0]), "_noisy": data(SVM_SMALL_NOISE[1])}
    y = sets[""][2].y.numpy()
    tr, te = repeated_stratified_kfold_masks(y, c["n_folds"], 1,
                                             seed=c["seed"])
    out = {"config": c, "noise": SVM_SMALL_NOISE,
           "decided_rtol": SVM_DECIDED,
           "latent_rtol": [DRV_PCA_RTOL, DRV_ALIGNED_RTOL]}
    for (name, strategy, bag), (suffix, ds) in itertools.product(
            (("sep_align", "sep_align", 0), ("sep_dimred", "sep_dimred", 0),
             ("joint_pca", "joint_pca", 0), ("mcca", "mcca", 0),
             ("bagging3", "sep_align", 3)), sets.items()):
        tar, cross, tar_c, cross_c, n_y, n_a = ds
        name += suffix
        dcfg = pooled.DecodeConfig(max_k=c["max_k"], n_classes=n_y,
                                   n_align_classes=n_a, bagging=bag,
                                   seed=c["seed"])
        dec = pooled.make_cv_decoder(strategy, dcfg, return_preds=True)
        with _ScoreProbe(latents=True) as card:
            a_g, p_g = dec(tar, cross,
                           torch.as_tensor(tr, dtype=torch.float32,
                                           device=dev),
                           torch.as_tensor(te, dtype=torch.float32,
                                           device=dev))
            torch.cuda.synchronize()
        with _PlainJacobiOnCpu(), _ScoreProbe(latents=True) as cpu:
            a_c, p_c = dec(tar_c, cross_c,
                           torch.as_tensor(tr, dtype=torch.float32),
                           torch.as_tensor(te, dtype=torch.float32))
        r = _held(torch, y, te, (a_g, p_g), (a_c, p_c), cpu.scores)
        if name == "sep_align":
            # the target's latent columns: a fold's separated ones for its
            # target latents and for the sources mapped into its space (at
            # the driver's noise; at the high one few columns stand apart)
            errs = []
            for b in range(c["n_folds"]):
                sep = _separated(cpu.tar[0][b])
                for lg, lc, tol in ([(card.tar[0], cpu.tar[0], DRV_PCA_RTOL)]
                                    + [(g, h, DRV_ALIGNED_RTOL) for g, h in
                                       zip(card.aligned, cpu.aligned)]):
                    # no separated column: nothing to hold, a failure
                    errs.append((_rel(lg[b].cpu()[..., sep], lc[b][..., sep])
                                 if sep.any() else float("inf"), tol,
                                 int(sep.sum())))
            r["latent_rel_errs"] = [e for e, _, _ in errs]
            r["latent_columns_compared"] = [n for _, _, n in errs]
            r["latents_ok"] = all(e <= t for e, t, _ in errs)
            out["latents_ok"] = r["latents_ok"]
        out[name] = r
        out[f"{name}_ok"] = r["ok"]
    return out


# --------------------------------------------------------------- subsample --

def _reference_entry(np, X, y_seq, class_ids, pre_pts) -> dict:
    """One patient's ``pt_decoding_data`` entry in the reference layout
    (alignment_utils.py:127-184): ``X1..X3`` three blocks of trials,
    ``X_collapsed`` their concatenation, ``y_full_phon`` one block's
    sequences (the reader tiles them x3). Each block holds a third of
    every class's trials in one class order, so the tiled sequences are
    each collapsed trial's own; the labels are the sequences' first
    phonemes (the synthetic data's class target)."""
    per = np.bincount(class_ids) // 3
    blocks = [np.concatenate([np.where(class_ids == c)[0][b * n:(b + 1) * n]
                              for c, n in enumerate(per)])
              for b in range(3)]
    d = {"y_full_phon": y_seq[blocks[0]], "pre_pts": list(pre_pts)}
    for p, idx in enumerate(blocks, 1):
        d[f"X{p}"] = np.asarray(X[idx], np.float32)
        d[f"y{p}"] = y_seq[idx, 0]
    d["X_collapsed"] = np.concatenate([d[f"X{p}"] for p in (1, 2, 3)])
    d["y_phon_collapsed"] = np.concatenate([d[f"y{p}"] for p in (1, 2, 3)])
    return d


def _sub_files(root: Path) -> dict:
    """The sweeps' files in ``root``: each paper patient's geometry
    (``canonical_channel_map`` and a seeded sorted significant-channel
    subset as long as its data's channel axis), and at full and at small
    depth a decoding pickle (the port's host generator) and a savg pickle
    (``spatial_avg_data`` at contact sizes 2 and 4 on that geometry)."""
    import numpy as np

    from cross_patient_speech_decoding_tpu_torch.data import (
        loaders,
        subsample,
        synthetic,
    )

    widths = dict(zip(SUB_PTS, SUB_CHANNELS))
    rng = np.random.default_rng(0)
    geom = root / "geometry"
    for pt in SUB_PTS:
        cmap = loaders.canonical_channel_map(pt)
        loaders.save_geometry_mat(geom, pt, cmap, np.sort(
            rng.choice(cmap.ravel(), widths[pt], replace=False)))
    out = {"geometry": str(geom)}
    for key, pts, T in (("full", SUB_PTS, SUB_T),
                        ("small", SUB_SMALL_PTS, SUB_SMALL_T)):
        ds = synthetic.make_synthetic_patients(
            seed=0, n_patients=len(pts), n_classes=9,
            trials_per_class=SUB_TRIALS, T=T,
            channels=tuple(widths[pt] for pt in pts), latent_dim=10,
            noise=SUB_NOISE)
        data, savg = {}, {}
        for i, pt in enumerate(pts):
            d = _reference_entry(np, ds.X[i], ds.y_seq[i], ds.class_ids[i],
                                 [p for p in pts if p != pt])
            data[pt] = d
            cmap, _ = loaders.load_channel_map(geom, pt)
            sig = loaders.load_sig_channels(geom, pt)
            savg[pt] = {**d, "X_collapsed": {
                f"cs_{c}x{c}": subsample.spatial_avg_data(
                    d["X_collapsed"], subsample.spatial_avg_groups(cmap, c),
                    channel_ids=sig).astype(np.float32)
                for c in (2, 4)}}
        for name, obj in (("pkl", data), ("savg", savg)):
            path = root / f"pt_{name}_{key}.pkl"
            loaders.save_pkl(obj, path)
            out[f"{name}_{key}"] = str(path)
    return out


def _sub_cfg(sub, files: dict, name: str, depth: str, out: str = "", **kw):
    fn, spec = SUB_RUNS[name]
    data = files[("savg_" if name == "spatial" else "pkl_") + depth]
    return fn, sub.SubsampleConfig(**{**SUB_BASE, **spec, **kw}, data=data,
                                   geometry_dir=files["geometry"], out=out)


def sweep_jacobi_launches(jacobi, latent_widths, n_folds: int,
                          nested: dict | None = None,
                          fit_batch: int = SVM_FIT_BATCH) -> int:
    """``jacobi_eigh`` launches of one sweep-point decode of sep_align:
    each source's chol CCA fit solves the eigh of its (K_s, K_s) Gram
    g^T g over a batch of fits (``cca._svd_small``), which
    ``batched_eigh`` sends to the kernel where ANY_BATCH_K <= K_s <= MAX_K
    or the batch holds MIN_BATCH matrices. K_s = min(max_k, N_s T, C_s),
    the source's PCA width. A fixed decode is one batch of its folds; a
    nested one scores each TPE round's outer folds
    max(1, fit_batch // (points x inner)) at a time (points x inner fits
    each), then refits min(n_folds, fit_batch) folds a batch."""
    if nested is None:
        batches = [n_folds]
    else:
        per = nested["n_points"] * nested["n_inner"]
        bs = max(1, fit_batch // per)
        rb = min(n_folds, fit_batch)
        batches = ([min(bs, n_folds - o) * per
                    for o in range(0, n_folds, bs)] * nested["n_rounds"]
                   + [min(rb, n_folds - o) for o in range(0, n_folds, rb)])
    return sum(K <= jacobi.MAX_K and (K >= jacobi.ANY_BATCH_K
                                      or b >= jacobi.MIN_BATCH)
               for K in latent_widths for b in batches)


class _SweepProbe:
    """Wrappers around what a subsample sweep runs, for a block: the fold
    masks, trial indices and channel indices it draws, and each decode
    (the decoder of ``make_cv_decoder``, or ``nested_cv_decode_bayes``),
    synchronised and timed, with its sources' PCA widths, its Jacobi
    launches, its fold accuracies, test masks and target labels. Keeps
    the last fixed decode's arguments (``last``)."""

    NAMES = ("stratified_kfold_masks", "trial_subsample_indices",
             "_gather_channels", "make_cv_decoder", "nested_cv_decode_bayes")

    def __init__(self, torch, jacobi):
        from cross_patient_speech_decoding_tpu_torch.cli import (
            subsample_experiments,
        )

        self.torch, self.jacobi = torch, jacobi
        self.sub = subsample_experiments
        self.masks, self.trials, self.channels, self.decodes = [], [], [], []
        self.last = None

    def _decode(self, fn, tar, cross, nested):
        torch, jacobi = self.torch, self.jacobi
        if tar.X.is_cuda:
            torch.cuda.synchronize()
        n0 = jacobi.LAUNCHES["jacobi_eigh"]
        t0 = time.perf_counter()
        out = fn()
        if tar.X.is_cuda:
            torch.cuda.synchronize()
        self.decodes.append({
            "s": time.perf_counter() - t0,
            "jacobi": jacobi.LAUNCHES["jacobi_eigh"] - n0,
            "latent_widths": [min(self.max_k, c.X.shape[0] * c.X.shape[1],
                                  c.X.shape[2]) for c in cross],
            "nested": nested, "y": tar.y.cpu().numpy()})
        return out

    def __enter__(self):
        import numpy as np

        sub = self.sub
        self.saved = [(n, getattr(sub, n)) for n in self.NAMES]
        orig = dict(self.saved)

        def masks(y, n, rng):
            out = orig["stratified_kfold_masks"](y, n, rng)
            self.masks.append(out)
            return out

        def trials(y, k, rng):
            out = orig["trial_subsample_indices"](y, k, rng)
            self.trials.append(out)
            return out

        def channels(pt, idx):
            self.channels.append(np.asarray(idx))
            return orig["_gather_channels"](pt, idx)

        def make(strategy, dcfg, **kw):
            dec = orig["make_cv_decoder"](strategy, dcfg, **kw)
            self.max_k = dcfg.max_k

            def run(tar, cross, tr, te):
                self.last = (strategy, dcfg, tar, tuple(cross), tr, te)
                accs = self._decode(lambda: dec(tar, cross, tr, te), tar,
                                    cross, None)
                self.decodes[-1].update(accs=accs.cpu().numpy(),
                                        te=te.cpu().numpy())
                return accs
            return run

        def nested(tar, cross, dcfg, **kw):
            self.max_k = dcfg.max_k
            spec = {k: kw[k] for k in ("n_folds", "n_rounds", "n_points",
                                       "n_inner")}
            out = self._decode(lambda: orig["nested_cv_decode_bayes"](
                tar, cross, dcfg, **kw), tar, cross, spec)
            self.decodes[-1].update(accs=np.asarray(out[0]))
            return out

        for name, fn in (("stratified_kfold_masks", masks),
                         ("trial_subsample_indices", trials),
                         ("_gather_channels", channels),
                         ("make_cv_decoder", make),
                         ("nested_cv_decode_bayes", nested)):
            setattr(sub, name, fn)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved:
            setattr(self.sub, name, fn)


def _same_draws(a: _SweepProbe, b: _SweepProbe) -> bool:
    """Both runs drew the same fold masks, trial and channel indices."""
    import numpy as np

    def flat(xs):
        return [y for x in xs for y in (x if isinstance(x, tuple) else (x,))]

    return all(len(flat(getattr(a, n))) == len(flat(getattr(b, n)))
               and all(np.array_equal(x, y) for x, y in
                       zip(flat(getattr(a, n)), flat(getattr(b, n))))
               for n in ("masks", "trials", "channels"))


def _sub_results_ok(np, sub, name: str, res, cfg, n_decodes: int) -> dict:
    """The sweep's return and its results pickle as JAX's driver gives
    them: accuracies finite in [0, 1], one a decode; the pickle's keys."""
    from cross_patient_speech_decoding_tpu_torch.data import loaders

    if isinstance(res, tuple):
        accs = res[1].ravel()
        keys = ["ks", "accs"]
    else:
        accs = np.concatenate([np.asarray(v) for v in res.values()])
        keys = list(res)
    store = loaders.load_pkl(cfg.out)
    return {
        "accs_ok": bool(accs.size == n_decodes and np.isfinite(accs).all()
                        and 0.0 <= accs.min() and accs.max() <= 1.0),
        "pickle_ok": (set(store) == {"params", "sweep", "results"}
                      and list(store["results"]) == keys
                      and store["params"] == vars(cfg)),
        "mean_acc": float(accs.mean()), "accs": accs.tolist()}


def _sub_sweep(torch, sub, jacobi, gru, name, files, dev, root):
    """One sweep at full depth on the card (counts zeroed just before,
    read just after): its figures and checks."""
    import numpy as np

    fn, cfg = _sub_cfg(sub, files, name, "full",
                       out=str(root / "out" / f"{name}.pkl"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(gru, jacobi)
    with _NoPlainOnCuda(torch, gru, jacobi), _SweepProbe(torch,
                                                         jacobi) as pr:
        t0 = time.perf_counter()
        out = getattr(sub, fn)(cfg, verbose=True, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = _launch_counts(gru, jacobi)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = [sweep_jacobi_launches(jacobi, d["latent_widths"], cfg.n_folds,
                                  d["nested"]) for d in pr.decodes]
    got = [d["jacobi"] for d in pr.decodes]
    decode_s = [d["s"] for d in pr.decodes]
    r = {"config": {k: v for k, v in vars(cfg).items()
                    if k not in ("data", "geometry_dir", "out")},
         "decodes": len(pr.decodes), "wall_s": wall,
         "decodes_per_s": len(pr.decodes) / wall,
         "ms_per_decode": 1e3 * statistics.median(decode_s),
         "decode_ms": [1e3 * s for s in decode_s],
         "jacobi_launches": launches["jacobi_eigh"],
         "jacobi_launches_per_decode": got,
         "jacobi_launches_expected": want,
         "source_latent_widths": [d["latent_widths"] for d in pr.decodes],
         "other_launches": {k: v for k, v in launches.items()
                            if k != "jacobi_eigh"},
         "peak_mem_gb": peak_gb,
         **_sub_results_ok(np, sub, name, out, cfg, len(pr.decodes))}
    r["launches_ok"] = (got == want and sum(want) == launches["jacobi_eigh"]
                        and not any(r["other_launches"].values()))
    return r, pr


def _sub_profile(torch, pr):
    """One more decode of the probe's last fixed decode (its data and
    masks) under ``torch.profiler``: its device idle share."""
    from cross_patient_speech_decoding_tpu_torch.decoders import pooled

    strategy, dcfg, tar, cross, tr, te = pr.last
    dec = pooled.make_cv_decoder(strategy, dcfg)
    dec(tar, cross, tr, te)
    torch.cuda.synchronize()
    _, prof = profile_call(torch, lambda: dec(tar, cross, tr, te))
    return {"trials_per_source": int(cross[0].X.shape[0]), **prof}


class _RoundedCcaProducts:
    """Within the block, every product of the CCA (``cca.hdot``) is formed
    in float64 and rounded once to float32: a twin of a CPU run whose
    predictions differ from the run's own only where one float32 rounding
    of the alignment's products moves them. The chol CCA squares its
    canonical correlations on the Gram route, so a weakly correlated
    direction magnifies such a rounding into the mapped sources (1e-2 of
    the largest decision score on the small pitch sweep's first decode,
    PERF.md §6)."""

    def __init__(self, torch):
        self.torch = torch

    def __enter__(self):
        from cross_patient_speech_decoding_tpu_torch.ops import cca

        torch = self.torch
        self.cca, self.hdot = cca, cca.hdot
        cca.hdot = lambda a, b: torch.matmul(a.double(), b.double()).float()

    def __exit__(self, *exc):
        self.cca.hdot = self.hdot


def _sub_small(torch, sub, jacobi, files, dev) -> dict:
    """Each sweep at small depth (4 patients, T=40, one iteration a point)
    on the card and on the CPU from the same files, the CPU's Jacobi on
    the kernel's route through its plain version: the same masks and
    indices; per decode predictions equal on the trials the CPU's scores
    decide and fold accuracies within the weight of the undecided ones
    (:func:`_held`). A trial also counts as undecided where the CPU run's
    twin with its CCA products rounded once more
    (:class:`_RoundedCcaProducts`) predicts another class: the card's
    products round differently, so such a trial's class is the
    function's rounding, not the card's fault."""
    out = {}
    for name in ("trials", "grid", "spatial", "pitch"):
        fn, cfg = _sub_cfg(sub, files, name, "small", n_iter=1)
        with _SweepProbe(torch, jacobi) as card, _ScoreProbe() as card_sc:
            getattr(sub, fn)(cfg, verbose=False, device=dev)
            torch.cuda.synchronize()
        with _PlainJacobiOnCpu(), _SweepProbe(torch, jacobi) as cpu, \
                _ScoreProbe() as cpu_sc:
            getattr(sub, fn)(cfg, verbose=False, device="cpu")
        with _PlainJacobiOnCpu(), _RoundedCcaProducts(torch), \
                _SweepProbe(torch, jacobi) as twin, _ScoreProbe() as twin_sc:
            getattr(sub, fn)(cfg, verbose=False, device="cpu")
        r = {"decodes": len(card.decodes), "draws_equal":
             _same_draws(card, cpu) and _same_draws(twin, cpu)}
        held, dev_card, dev_twin = [], [], []
        if len(card.decodes) == len(cpu.decodes) == len(cpu_sc.scores) \
                == len(card_sc.scores) == len(twin_sc.scores):
            for g, c, sg, sc, st in zip(card.decodes, cpu.decodes,
                                        card_sc.scores, cpu_sc.scores,
                                        twin_sc.scores):
                held.append(_held(
                    torch, c["y"], c["te"],
                    (torch.as_tensor(g["accs"]), sg.argmax(-1)),
                    (torch.as_tensor(c["accs"]), sc.argmax(-1)), [sc],
                    unstable=(sc.argmax(-1) != st.argmax(-1)).numpy()))
                dev_card.append(_rel(sg.cpu(), sc))
                dev_twin.append(_rel(st, sc))
        r["score_rel_dev_card_cpu"] = dev_card
        r["score_rel_dev_twin_cpu"] = dev_twin
        r["undecided_trials"] = sum(h["undecided_trials"] for h in held)
        r["accs_card"] = [h["accs_card"] for h in held]
        r["accs_cpu"] = [h["accs_cpu"] for h in held]
        r["ok"] = bool(r["draws_equal"] and held and len(held)
                       == len(card.decodes) and all(h["ok"] for h in held))
        out[name] = r
    return out


class _SurrogateProbe:
    """Records, for a block, each ``fit_tme`` (synchronised and timed,
    its input and fit), each ``mode_shuffle_surrogate`` (its input, the
    generator's state before and its output) and each TME sample."""

    def __init__(self, torch):
        from cross_patient_speech_decoding_tpu_torch.data import surrogates

        self.torch, self.mod = torch, surrogates
        self.fits, self.shuffles, self.samples = [], [], []

    def __enter__(self):
        import copy

        torch, mod = self.torch, self.mod
        self.saved = [(n, getattr(mod, n)) for n in (
            "fit_tme", "mode_shuffle_surrogate", "sample_tme")]
        orig = dict(self.saved)

        def fit(X, steps=2000, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            f = orig["fit_tme"](X, steps=steps, **kw)
            torch.cuda.synchronize()
            self.fits.append({"X": X, "fit": f, "steps": steps,
                              "s": time.perf_counter() - t0})
            return f

        def shuffle(X, rng):
            state = copy.deepcopy(rng.bit_generator.state)
            out = orig["mode_shuffle_surrogate"](X, rng)
            self.shuffles.append((X, state, out))
            return out

        def sample(f, n_samples=None, seed=0, device=None):
            out = orig["sample_tme"](f, n_samples, seed, device)
            self.samples.append(out)
            return out

        mod.fit_tme, mod.mode_shuffle_surrogate, mod.sample_tme = (
            fit, shuffle, sample)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved:
            setattr(self.mod, name, fn)


def _tme_criterion(fit) -> float:
    """max over modes of max |implied - data| / max data eigenvalue (JAX's
    test: < 5 %)."""
    return max(float(abs(m - d).max() / max(d.max(), 1e-6))
               for d, m in zip(fit["data_eigs"], fit["implied_eigs"]))


def _tme_checks(torch, surrogates, rec, dev) -> dict:
    """The TME fits of the run against JAX's criterion; one patient's fit
    on the card against the same fit on the CPU (TME_CMP_STEPS steps); the
    mean mode-1 scatter of TME_DRAWS card samples projected on Q1 against
    the implied eigenvalues (tests/test_surrogates_and_utils.py's
    Gaussian tolerance)."""
    import numpy as np

    crit = [_tme_criterion(f["fit"]) for f in rec.fits]
    X = rec.fits[0]["X"]
    card = surrogates.fit_tme(X, steps=TME_CMP_STEPS, device=dev)
    t0 = time.perf_counter()
    cpu = surrogates.fit_tme(X.cpu(), steps=TME_CMP_STEPS, device="cpu")
    cpu_s = time.perf_counter() - t0
    log_err = max(float(np.abs(a - b).max())
                  for a, b in zip(card["log_abc"], cpu["log_abc"]))
    eig_err = max(float(np.abs(a - b).max() / np.abs(b).max())
                  for a, b in zip(card["implied_eigs"], cpu["implied_eigs"]))
    loss_err = abs(card["final_loss"] - cpu["final_loss"]) / abs(
        cpu["final_loss"])
    fit = rec.fits[0]["fit"]
    acc = None
    for s in range(TME_DRAWS):
        x = surrogates.sample_tme(fit, seed=100 + s, device=dev).double()
        xc = (x - x.mean(0, keepdim=True)).reshape(x.shape[0], -1)
        sc = xc @ xc.T
        acc = sc if acc is None else acc + sc
    Q1 = torch.as_tensor(np.array(fit["Qs"][0], np.float64), device=dev)
    proj = torch.diagonal(Q1.T @ (acc / TME_DRAWS) @ Q1).cpu().numpy()
    m1 = fit["implied_eigs"][0].astype(np.float64)
    la, lb, lc = (v.astype(np.float64) for v in fit["log_abc"])
    v = 1.0 / (np.exp(la)[:, None, None] + np.exp(lb)[None, :, None]
               + np.exp(lc)[None, None, :])
    std = np.sqrt(2.0 * (v ** 2).sum((1, 2))) / np.sqrt(TME_DRAWS)
    k = 3
    stat_err = np.abs(proj[:k] - m1[:k])
    stat_tol = 4.0 * std[:k] + 0.02 * m1.max()
    return {"criterion": crit, "criterion_max": TME_CRITERION,
            "criterion_ok": bool(crit) and max(crit) < TME_CRITERION,
            "card_vs_cpu": {"steps": TME_CMP_STEPS, "shape": list(X.shape),
                            "log_abc_max_abs_err": log_err,
                            "implied_eigs_err_over_max": eig_err,
                            "final_loss_rel_err": loss_err,
                            "cpu_fit_s": cpu_s, "rtol": TME_CMP_RTOL},
            "card_vs_cpu_ok": max(log_err, eig_err, loss_err)
            <= TME_CMP_RTOL,
            "draws": TME_DRAWS, "mode1_proj_err": stat_err.tolist(),
            "mode1_proj_tol": stat_tol.tolist(),
            "statistics_ok": bool((stat_err < stat_tol).all())}


def _sub_svm(torch, exp, jacobi, gru, surrogate, dev, root):
    """``run_svm_decode`` with a surrogate control at svm_decode's scale on
    the card (counts zeroed just before, read just after), with its TME
    fits or shuffles recorded; then the control's checks."""
    import numpy as np

    from cross_patient_speech_decoding_tpu_torch.data import surrogates
    from cross_patient_speech_decoding_tpu_torch.utils.config import (
        SVMDecodeConfig,
    )

    cfg = SVMDecodeConfig(**SUB_SVM, surrogate=surrogate,
                          out=str(root / "out" / f"svm_{surrogate}.pkl"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(gru, jacobi)
    with _NoPlainOnCuda(torch, gru, jacobi), _SurrogateProbe(torch) as rec:
        t0 = time.perf_counter()
        accs = exp.run_svm_decode(cfg, verbose=True, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = _launch_counts(gru, jacobi)
    want = svm_jacobi_launches(SUB_SVM)
    n_src = SUB_SVM["synth_patients"] - 1
    r = {"config": {**SUB_SVM, "surrogate": surrogate}, "wall_s": wall,
         "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
         "jacobi_launches": launches["jacobi_eigh"],
         "jacobi_launches_expected": want,
         "other_launches": {k: v for k, v in launches.items()
                            if k != "jacobi_eigh"},
         "mean_acc": float(accs.mean()), "accs_shape": list(accs.shape)}
    r["launches_ok"] = (launches["jacobi_eigh"] == want
                        and not any(r["other_launches"].values()))
    r["accs_ok"] = bool(accs.shape == (1, SUB_SVM["n_folds"])
                        and np.isfinite(accs).all() and 0.0 <= accs.min()
                        and accs.max() <= 1.0)
    if surrogate == "tme":
        fit_s = [f["s"] for f in rec.fits]
        r.update(fits=len(rec.fits), fit_ms_per_patient=[
            1e3 * s for s in fit_s],
            fit_us_per_step=[1e6 * s / f["steps"]
                             for s, f in zip(fit_s, rec.fits)],
            samples_finite=all(bool(torch.isfinite(s).all())
                               for s in rec.samples))
        r["tme"] = _tme_checks(torch, surrogates, rec, dev)
        r["ok"] = (len(rec.fits) == len(rec.samples) == n_src
                   and r["samples_finite"] and r["tme"]["criterion_ok"]
                   and r["tme"]["card_vs_cpu_ok"]
                   and r["tme"]["statistics_ok"])
    else:
        same = []
        for X, state, out in rec.shuffles[:SUB_SHUFFLE_CPU]:
            rng = np.random.default_rng()
            rng.bit_generator.state = state
            same.append(bool(torch.equal(
                out.cpu(), surrogates.mode_shuffle_surrogate(X.cpu(), rng))))
        r.update(shuffles=len(rec.shuffles), card_vs_cpu_bitwise=same)
        r["ok"] = len(rec.shuffles) == n_src and bool(same) and all(same)
    return r


def phase_subsample(torch, dev, gru, jacobi, smi):
    """The subsample sweeps and the surrogate controls end to end at the
    reference's scale: each sweep with exact Jacobi launches from its
    shapes, times, peak memory and results pickles; one profiled
    trial-sweep decode; the Jacobi kernel bit for bit its plain version
    on the first batch of each shape the phase gave it; ``svm-decode``
    with ``surrogate=tme`` and ``shuffle``; then the sweeps at small depth
    on the card and on the CPU. Returns the kernels line's
    ``launches_subsample_*`` keys."""
    import tempfile

    from cross_patient_speech_decoding_tpu_torch.cli import experiments as exp
    from cross_patient_speech_decoding_tpu_torch.cli import (
        subsample_experiments as sub,
    )

    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    t0 = time.perf_counter()
    files = _sub_files(root)
    res = {"phase": "subsample", "nvidia_smi": smi,
           "data": {"patients": dict(zip(SUB_PTS, SUB_CHANNELS)),
                    "target": SUB_TARGET, "trials": 9 * SUB_TRIALS,
                    "T": SUB_T, "noise": SUB_NOISE,
                    "write_s": time.perf_counter() - t0}}
    bad = {}
    launches = {}
    with _RecordJacobi(jacobi, first_per_shape=True) as rec:
        for name in SUB_RUNS:
            r, pr = _sub_sweep(torch, sub, jacobi, gru, name, files, dev,
                               root)
            if name == "trials":
                r["decode_profile"] = _sub_profile(torch, pr)
            del pr
            res[name] = r
            launches[f"launches_subsample_{name}"] = r["jacobi_launches"]
            bad.update({f"{name}_{k}": r for k in ("launches_ok", "accs_ok",
                                                   "pickle_ok")
                        if r[k] is not True})
        for surrogate in ("tme", "shuffle"):
            r = _sub_svm(torch, exp, jacobi, gru, surrogate, dev, root)
            res[f"svm_{surrogate}"] = r
            launches[f"launches_subsample_svm_{surrogate}"] = r[
                "jacobi_launches"]
            bad.update({f"svm_{surrogate}_{k}": r for k in (
                "launches_ok", "accs_ok", "ok") if r[k] is not True})
    checks = {}
    for A in rec.batches:
        key = "x".join(map(str, A.shape))
        checks[key] = _check_jacobi(torch, jacobi, A)
        if not _jacobi_ok(key, checks[key]):
            bad[f"jacobi_{key}"] = checks[key]
    res["jacobi_path_batches"] = checks
    if not checks:
        bad["jacobi_batches"] = "none recorded"
    for name in ("trials", "grid"):
        if not res[name]["jacobi_launches"]:
            bad[f"{name}_no_jacobi"] = 0
    small = _sub_small(torch, sub, jacobi, files, dev)
    res["small_depth_card_vs_cpu"] = small
    bad.update({f"small_{k}": v for k, v in small.items() if not v["ok"]})
    emit(res)
    tmp.cleanup()
    if bad:
        raise RuntimeError(f"subsample checks failed: {list(bad)}")
    return launches


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


# ---------------------------------------------------------------------------
# bidirectional RealtimeRNN, LSTM, seq2seq checkpoints
# ---------------------------------------------------------------------------


def ctc_bidir_flops_per_step(B, T, C, H, NL, n_cls, win, stride):
    """Model FLOPs of one bidirectional RealtimeRNN train step (forward +
    ~2x backward), counted as :func:`ctc_flops_per_step` counts the
    unidirectional one: both directions' windowed layer-0 projection, the
    upper layers' projections of 2H features, both directions'
    recurrences and the 2H-wide head."""
    n_win = (T - win) // stride + 1
    l0 = 2 * 2 * B * n_win * (win * C) * 3 * H
    rest = (NL - 1) * 2 * 2 * B * n_win * 2 * H * 3 * H
    rec = NL * 2 * 2 * B * n_win * H * 3 * H
    head = 2 * B * n_win * 2 * H * n_cls
    return 3 * (l0 + rest + rec + head)


def _ctc_loss_grads(torch, model, batch):
    """CTC loss of the model's forward in its current mode, and its
    gradient per parameter name."""
    from cross_patient_speech_decoding_tpu_torch.models import (
        adjusted_input_lengths,
    )
    from cross_patient_speech_decoding_tpu_torch.ops.ctc import ctc_loss_mean

    x, labels, il, ll = batch
    loss = ctc_loss_mean(model(x), adjusted_input_lengths(il, WIN, STRIDE),
                         labels, ll)
    names, params = zip(*model.named_parameters())
    return (float(loss.detach()),
            dict(zip(names, torch.autograd.grad(loss, params))))


def _timed(torch, fn, n: int = 3):
    """(last result, host-clock seconds of each of n synchronised calls)."""
    out, times = None, []
    for _ in range(n):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return out, times


def phase_ctc_bidir(torch, dev, gru, jacobi, batch):
    """The bidirectional RealtimeRNN at fig_5 width through
    ``make_ctc_eval_step`` and ``make_ctc_train_step`` (exact launches,
    logits and gradients against the plain versions on the card), its
    layer-0 ``gru_bifwd`` and reversed ``gru_bwd`` (bf16, no dx) against
    their plain versions, timed beside cuDNN; then the LSTM Seq2SeqRNN
    against ``torch.nn.LSTM`` and a ``seq2seq_from_ckpt`` round trip of a
    GRU and an LSTM checkpoint. Returns the kernels line's extra keys by
    kernel name."""
    import numpy as np

    from cross_patient_speech_decoding_tpu_torch.models import (
        RealtimeRNN,
        adjusted_input_lengths,
    )
    from cross_patient_speech_decoding_tpu_torch.ops.ctc import ctc_loss_mean
    from cross_patient_speech_decoding_tpu_torch.train import (
        create_train_state,
        make_ctc_eval_step,
        make_ctc_train_step,
        make_optimizer,
    )

    x, labels, il, ll = batch
    model = RealtimeRNN(C, H, N_LAYERS, N_CLASSES, dropout=0.3,
                        win_size=WIN, stride=STRIDE, bidirectional=True,
                        seed=0, device=dev)
    fails = {}

    # eval step: launches of the first, median of 3
    model.eval()
    step = make_ctc_eval_step(model)
    step(batch)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with _NoPlainOnCuda(torch, gru, jacobi):
        gru.reset_launch_counts()
        t0 = time.perf_counter()
        out = step(batch)
        torch.cuda.synchronize()
        eval_times = [time.perf_counter() - t0]
        eval_launches = dict(gru.LAUNCHES)
        eval_times += _timed(torch, lambda: step(batch), 2)[1]
    eval_peak = torch.cuda.max_memory_allocated() / 1e9
    with torch.no_grad():
        logits_k = model(x)
        with _PlainGRU(gru):
            logits_p = model(x)
        loss_p = float(ctc_loss_mean(
            logits_p, adjusted_input_lengths(il, WIN, STRIDE), labels, ll))
    logit_err = float((logits_k - logits_p).abs().max())
    eval_loss, eval_per = float(out["loss"]), float(out["per"])
    eval_s = statistics.median(eval_times)
    ev = {"loss": eval_loss, "per": eval_per, "loss_plain": loss_p,
          "launches": eval_launches,
          "logits_max_abs_err_vs_plain": logit_err,
          "logits_shape": list(logits_k.shape), "step_s": eval_s,
          "step_s_runs": eval_times, "samples_per_s": B / eval_s,
          "peak_mem_gb": eval_peak}
    if eval_launches != BIDIR_EVAL_LAUNCHES:
        fails["eval_launches"] = eval_launches
    if not logit_err <= LOGITS_ATOL:
        fails["eval_logits"] = logit_err
    if not abs(eval_loss - loss_p) <= LOSS_RTOL * abs(loss_p):
        fails["eval_loss"] = (eval_loss, loss_p)
    if not (np.isfinite(eval_loss) and np.isfinite(eval_per)
            and bool(torch.isfinite(logits_k).all())
            and tuple(logits_k.shape) == (B, N_WIN, N_CLASSES)):
        fails["eval_output"] = (eval_loss, eval_per, list(logits_k.shape))
    del logits_k, logits_p

    # train: (a) dropout 0, loss and gradients, kernels vs plain
    loss_k, grads_k = _ctc_loss_grads(torch, model, batch)
    with _PlainGRU(gru):
        loss_p0, grads_p = _ctc_loss_grads(torch, model, batch)
    grad_errs = _rel_errs(grads_k, grads_p)
    del grads_k, grads_p
    # (b) one step at dropout 0.3 with AdamW, launches counted; 3 more
    model.train()
    tx = make_optimizer(1e-3, 1e-5, 100)
    state = create_train_state(model, tx)
    tstep = make_ctc_train_step(model, tx)
    gen = torch.Generator(device=dev).manual_seed(3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []

    def one():
        nonlocal state
        state, m = tstep(state, batch, gen)
        losses.append(float(m["loss"]))

    with _NoPlainOnCuda(torch, gru, jacobi):
        gru.reset_launch_counts()
        _, first = _timed(torch, one, 1)
        train_launches = dict(gru.LAUNCHES)
        _, step_times = _timed(torch, one, 3)
    step_s = statistics.median(step_times)
    train_peak = torch.cuda.max_memory_allocated() / 1e9
    state, profile = profile_step(torch, tstep, state, batch, gen)
    flops = ctc_bidir_flops_per_step(B, T, C, H, N_LAYERS, N_CLASSES, WIN,
                                     STRIDE)
    finite = all(np.isfinite(losses)) and all(
        bool(torch.isfinite(p).all()) for p in model.parameters())
    tr = {"dropout": 0.3,
          "optimizer": "AdamW lr 1e-3 wd 1e-5, linear decay over 100",
          "loss_dropout0": loss_k, "loss_dropout0_plain": loss_p0,
          "grad_max_rel_err_vs_plain": grad_errs,
          "grad_tolerance": GRAD_RTOL, "launches": train_launches,
          "first_step_s": first[0], "step_s": step_s,
          "step_s_runs": step_times, "samples_per_s": B / step_s,
          "model_tflops_per_s": flops / step_s / 1e12,
          "model_flops_per_step": flops, "losses": losses,
          "steps": state.step, "finite": finite, "peak_mem_gb": train_peak,
          "profile": profile}
    if not abs(loss_k - loss_p0) <= LOSS_RTOL * abs(loss_p0):
        fails["train_loss"] = (loss_k, loss_p0)
    bad = {k: v for k, v in grad_errs.items() if not v <= GRAD_RTOL}
    if bad:
        fails["train_grads"] = bad
    if train_launches != BIDIR_TRAIN_LAUNCHES:
        fails["train_launches"] = train_launches
    if not finite:
        fails["train_finite"] = losses

    # the layer-0 kernels alone, on the model's own windows and weights
    with torch.no_grad():
        l0 = _bidir_layer0_kernels(torch, gru, dev, model, x)
    del model, state, tstep
    fails.update({f"layer0_{k}": v for k, v in l0.pop("fails").items()})
    lstm = _lstm_vs_cudnn(torch, dev, gru, jacobi)
    fails.update({f"lstm_{k}": v for k, v in lstm.pop("fails").items()})
    ckpt = _s2s_ckpt_round_trip(torch, dev)
    fails.update({f"ckpt_{k}": v for k, v in ckpt.pop("fails").items()})
    emit({"phase": "ctc_bidir", "B": B, "T": T, "C": C, "hidden": H,
          "n_layers": N_LAYERS, "n_win": N_WIN, "bidirectional": True,
          "eval": ev, "train": tr, "layer0_kernels": l0, "lstm": lstm,
          "ckpt": ckpt, "failed": sorted(fails)})
    if fails:
        raise RuntimeError(f"ctc_bidir checks failed: {fails}")
    bi, bw = l0["gru_bifwd"], l0["gru_bwd"]
    return {"gru_bifwd": {
                "launches_ctc_bidir_eval_step": eval_launches["gru_bifwd"],
                "launches_ctc_bidir_train_step": train_launches["gru_bifwd"],
                **{f"{k}_ctc_bidir_layer0": bi[k] for k in (
                    "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                    "max_abs_err")}},
            "gru_bwd": {
                "launches_ctc_bidir_train_step": train_launches["gru_bwd"],
                **{f"{k}_ctc_bidir_layer0_reversed": bw[k] for k in (
                    "ms", "plain_ms", "library_ms", "bound_ms",
                    "max_abs_err")}}}


def _bidir_layer0_kernels(torch, gru, dev, model, x):
    """``gru_bifwd`` at the bidirectional model's layer-0 shape (n_win x B
    windows of WIN x C bf16 features, as the model hands them over: a
    (T, B, F) view of the batch-major windows) against its plain version
    and timed beside the plain version and cuDNN's bidirectional GRU (on
    the same windows in float32); then ``gru_bwd`` reversed over them,
    bf16 with no dx, against its plain version (relative error per output,
    two runs bit for bit)."""
    xw = gru.reformat_time_windows(x.to(torch.bfloat16), WIN,
                                   STRIDE).transpose(0, 1)
    f, b = model.rnn.layer(0), model.rnn.layer(0, "bwd")
    ws = [t.detach() for t in (f.wi, f.bi, f.wh, f.bh,
                               b.wi, b.bi, b.wh, b.bh)]
    h0s = [model.h0[d, 0].detach().expand(B, H).contiguous()
           for d in range(2)]
    args = (xw, *h0s, *ws)
    F0 = WIN * C
    fails = {}

    def kernel():
        return gru.gru_bifwd_cuda(*args)

    def plain():
        return gru.gru_layer_bidir_plain(*args)

    lib = _library_bigru(torch, ws)
    lib_x = xw.float().contiguous()
    h0l = torch.stack(h0s)
    got, again, want = kernel(), kernel(), plain()
    lib_out, _ = lib(lib_x, h0l)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    lib_err = float((lib_out - torch.cat(want, -1)).abs().max())
    repeat = all(torch.equal(g, a) for g, a in zip(got, again))
    del got, again, want, lib_out
    times = (cuda_ms(torch, kernel), cuda_ms(torch, plain),
             cuda_ms(torch, lambda: lib(lib_x, h0l)))
    del lib_x
    N = N_WIN * B
    flops = {"projection": (2 * 2 * N * F0 * 3 * H, PEAK_2XTF32),
             "recurrent": (2 * 2 * N * H * 3 * H, PEAK_3XTF32)}
    bytes_ = xw.numel() * 2 + _nbytes(*h0s, *ws) + 2 * N * H * 4
    row, _ = _row("gru_bifwd", "gru_fwd.cu", "", None, err, times, flops,
                  bytes_)
    bifwd = {k: row[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                 "bound_by", "max_abs_err")}
    bifwd.update({"library_max_abs_err_vs_plain": lib_err,
                  "bitwise_repeat": repeat, "tolerance": KERNEL_ATOL,
                  "shapes": {"x": [N_WIN, B, F0], "dtype": "bf16",
                             "hs": [2, N_WIN, B, H]},
                  "library_note": "torch.nn.GRU(bidirectional=True) "
                                  "forward (cuDNN) on the windows in "
                                  "float32"})
    if not err <= KERNEL_ATOL:
        fails["gru_bifwd"] = err
    if not repeat:
        fails["gru_bifwd_repeat"] = False

    gen = torch.Generator(device=dev).manual_seed(5)
    hprev = torch.rand((N_WIN, B, H), generator=gen, device=dev) * 2 - 1
    dhs = torch.randn((N_WIN, B, H), generator=gen, device=dev) * 1e-3
    wb = ws[4:]

    def bkernel():
        return gru.gru_bwd_cuda(xw, hprev, dhs, *wb, True, False)

    def bplain():
        return gru.gru_backward_plain(xw, hprev, dhs, *wb, True, False)

    got = bkernel()
    brepeat = _bitwise_repeat(torch, got, bkernel())
    want = bplain()
    errs = _bwd_errs(got, want)
    abs_err = max(float((g - w).abs().max())
                  for g, w in zip(got, want) if w is not None)
    del got, want
    # cuDNN's backward of the same layer (torch.nn.GRU in float32, TF32
    # off): forward once over the windows in reverse order, then the
    # backward alone, without dx, as the kernel runs it
    lib_b = _library_gru(torch, *wb)
    with torch.enable_grad():
        xl = xw.flip(0).float().contiguous()
        h0l = h0s[1][None].detach().clone().requires_grad_()
        hs_l, _ = lib_b(xl, h0l)
        wrt = [h0l, *lib_b.parameters()]
        dhs_l = dhs.flip(0).contiguous()
        lib_ms = cuda_ms(torch, lambda: torch.autograd.grad(
            hs_l, wrt, dhs_l, retain_graph=True))
    del hs_l, xl, dhs_l, lib_b
    btimes = (cuda_ms(torch, bkernel), cuda_ms(torch, bplain), lib_ms)
    brow, _ = _row("gru_bwd", "gru_bwd.cu", "", None, abs_err, btimes,
                   _bwd_flops(N, F0, H, x_bf16=True, need_dx=False),
                   xw.numel() * 2 + _nbytes(hprev, dhs) + 2 * _nbytes(*wb)
                   + B * H * 4)
    bwd = {k: brow[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                "bound_by", "max_abs_err")}
    bwd.update({"max_rel_err": errs, "tolerance_rel": GRAD_RTOL,
                "bitwise_repeat": brepeat,
                "library_note": "torch.nn.GRU backward (cuDNN, float32) "
                                "over the reversed windows, no dx",
                "shapes": {"x": [N_WIN, B, F0], "dtype": "bf16",
                           "reverse": True, "need_dx": False}})
    bad = {k: v for k, v in errs.items() if not v <= GRAD_RTOL}
    if bad:
        fails["gru_bwd"] = bad
    if not brepeat:
        fails["gru_bwd_repeat"] = False
    return {"gru_bifwd": bifwd, "gru_bwd": bwd, "fails": fails}


def _library_lstm(torch, stack, F):
    """``torch.nn.LSTM`` (cuDNN) holding a ``StackedRNN(cell="lstm")``'s
    function: weight_ih = wi^T, weight_hh = wh^T, bias_ih = b, bias_hh =
    0 (the same (i, f, g, o) order)."""
    n_dir = 2 if stack.bidirectional else 1
    g = torch.nn.LSTM(F, stack.hidden, num_layers=stack.n_layers,
                      bidirectional=stack.bidirectional,
                      batch_first=True).to(stack.layer(0).wi.device)
    with torch.no_grad():
        for k in range(stack.n_layers):
            for d, sfx in (("fwd", ""), ("bwd", "_reverse"))[:n_dir]:
                cell = stack.layer(k, d)
                getattr(g, f"weight_ih_l{k}{sfx}").copy_(cell.wi.t())
                getattr(g, f"weight_hh_l{k}{sfx}").copy_(cell.wh.t())
                getattr(g, f"bias_ih_l{k}{sfx}").copy_(cell.b)
                getattr(g, f"bias_hh_l{k}{sfx}").zero_()
    g.flatten_parameters()
    return g


def _lstm_grads_as_port(stack, prefix: str, grads: dict) -> dict:
    """The cuDNN LSTM's weight gradients under the port's names:
    wi = weight_ih^T, wh = weight_hh^T, b = bias_ih (bias_hh's is the
    same)."""
    n_dir = 2 if stack.bidirectional else 1
    out = {}
    for k in range(stack.n_layers):
        for d, sfx in (("fwd", ""), ("bwd", "_reverse"))[:n_dir]:
            name = f"{prefix}.{d}{k}"
            out[f"{name}.wi"] = grads[f"weight_ih_l{k}{sfx}"].t()
            out[f"{name}.wh"] = grads[f"weight_hh_l{k}{sfx}"].t()
            out[f"{name}.b"] = grads[f"bias_ih_l{k}{sfx}"]
    return out


def _teacher_forced(torch, embed, dec, head, hidden, y, n_cls):
    """The reference decoder loop at teacher forcing 1: start token n_cls,
    then each step's label; (B, L, n_cls) logits."""
    token = torch.full((y.shape[0],), n_cls, dtype=torch.long,
                       device=y.device)
    outs = []
    for i in range(y.shape[1]):
        o, hidden = dec(embed(token)[:, None], hidden)
        outs.append(head(o[:, 0]))
        token = y[:, i].long()
    return torch.stack(outs, dim=1)


def _lstm_vs_cudnn(torch, dev, gru, jacobi):
    """An LSTM Seq2SeqRNN at the seq2seq bench geometry, dropout 0,
    teacher forcing 1, train mode: logits, loss and every parameter's
    gradient against the same model with its encoder and decoder replaced
    by ``torch.nn.LSTM`` (cuDNN) on the same weights; then one
    ``make_seq2seq_train_step`` step at dropout 0.3 (it launches no GRU
    kernel) and the median of 3 more."""
    import torch.nn.functional as F

    from cross_patient_speech_decoding_tpu_torch.models import Seq2SeqRNN
    from cross_patient_speech_decoding_tpu_torch.train import (
        create_train_state,
        make_optimizer,
        make_seq2seq_train_step,
    )

    x, y = _s2s_batch(torch, dev)
    model = Seq2SeqRNN(S2S_C, S2S_F, S2S_H, S2S_CLS, kernel_size=S2S_K,
                       seq_length=S2S_L, cnn_dropout=0.0, rnn_dropout=0.0,
                       cell="lstm", seed=0, device=dev).train()
    enc = _library_lstm(torch, model.encoder.rnn, S2S_F)
    dec = _library_lstm(torch, model.decoder.rnn, S2S_H)
    fails = {}

    def loss_of(logits):
        return F.cross_entropy(logits.reshape(-1, S2S_CLS), y.reshape(-1))

    logits = model(x, y, 1.0)
    loss = loss_of(logits)
    names, params = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, params)))
    # the reference: the same conv, embedding and head, cuDNN's LSTMs
    h = model.conv(x)
    _, (hn, cn) = enc(h)
    hidden = tuple((s[-2] + s[-1])[None].expand(
        model.n_dec_layers, -1, -1).contiguous() for s in (hn, cn))
    ref = _teacher_forced(torch, model.decoder.embed, dec,
                          model.decoder.head, hidden, y, S2S_CLS)
    ref_loss = loss_of(ref)
    # gradients by name: the model's own for the shared modules, cuDNN's
    # LSTM weights as "<stack>/<torch name>"
    named = [(n, p) for n, p in model.named_parameters() if ".rnn." not in n]
    libs = {"encoder.rnn": (enc, model.encoder.rnn),
            "decoder.rnn": (dec, model.decoder.rnn)}
    named += [(f"{k}/{n}", p) for k, (m, _) in libs.items()
              for n, p in m.named_parameters()]
    lib_grads = dict(zip([n for n, _ in named], torch.autograd.grad(
        ref_loss, [p for _, p in named])))
    want = {n: g for n, g in lib_grads.items() if "/" not in n}
    for k, (_, stack) in libs.items():
        want.update(_lstm_grads_as_port(stack, k, {
            n.split("/", 1)[1]: g for n, g in lib_grads.items()
            if n.startswith(k + "/")}))
    logit_err = float((logits - ref).detach().abs().max()
                      / ref.detach().abs().max())
    loss_k, loss_ref = float(loss.detach()), float(ref_loss.detach())
    # the conv bias's exact gradient is 0 under the BatchNorm: held against
    # the conv weight's scale, as _s2s_grad_errs does
    grad_errs = _s2s_grad_errs(grads, want)
    del grads, want, lib_grads, logits, ref
    if not logit_err <= LSTM_LOGITS_RTOL:
        fails["logits"] = logit_err
    if not abs(loss_k - loss_ref) <= LOSS_RTOL * abs(loss_ref):
        fails["loss"] = (loss_k, loss_ref)
    bad = {k: v for k, v in grad_errs.items() if not v <= GRAD_RTOL}
    if bad:
        fails["grads"] = bad

    model.conv.dropout = 0.3
    tx = make_optimizer(1e-3, 1e-5, 100)
    state = create_train_state(model, tx)
    step = make_seq2seq_train_step(model, tx, teacher_forcing=0.5)
    gen = torch.Generator(device=dev).manual_seed(3)
    losses = []

    def one():
        nonlocal state
        state, m = step(state, (x, y), gen)
        losses.append(float(m["loss"]))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with _NoPlainOnCuda(torch, gru, jacobi):
        gru.reset_launch_counts()
        _, first = _timed(torch, one, 1)
        launches = dict(gru.LAUNCHES)
        _, step_times = _timed(torch, one, 3)
    step_s = statistics.median(step_times)
    if any(launches.values()):
        fails["launches"] = launches
    if not all(math.isfinite(v) for v in losses):
        fails["finite"] = losses
    return {"B": S2S_B, "T": S2S_T, "C": S2S_C, "filters": S2S_F,
            "kernel_size": S2S_K, "hidden": S2S_H, "seq_length": S2S_L,
            "cell": "lstm", "reference": "torch.nn.LSTM (cuDNN), same "
            "weights, bias_hh 0", "logits_max_rel_err": logit_err,
            "logits_tolerance": LSTM_LOGITS_RTOL, "loss": loss_k,
            "loss_reference": loss_ref, "grad_max_rel_err": grad_errs,
            "grad_tolerance": GRAD_RTOL, "launches": launches,
            "train_first_step_s": first[0], "train_step_s": step_s,
            "train_step_s_runs": step_times,
            "train_samples_per_s": S2S_B / step_s, "losses": losses,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "fails": fails}


def _s2s_ckpt_modules(torch, cell: str):
    """The reference ``Seq2SeqRNN``'s torch modules (nn_models/models.py:
    235-251) at the seq2seq widths, random from a seed, the BatchNorm's
    affine parameters and running statistics off their init."""
    torch.manual_seed(11 if cell == "gru" else 12)
    Rnn = torch.nn.GRU if cell == "gru" else torch.nn.LSTM
    mods = {"temporal_conv.conv": torch.nn.Conv1d(S2S_C, S2S_F, S2S_K),
            "temporal_conv.bn": torch.nn.BatchNorm1d(S2S_F),
            "encoder.rnn": Rnn(S2S_F, S2S_H, batch_first=True,
                               bidirectional=True),
            "decoder.embedding": torch.nn.Embedding(S2S_CLS + 1, S2S_H),
            "decoder.rnn": Rnn(S2S_H, S2S_H, batch_first=True),
            "decoder.fc_out": torch.nn.Linear(S2S_H, S2S_CLS)}
    bn = mods["temporal_conv.bn"]
    with torch.no_grad():
        bn.running_mean.uniform_(-0.2, 0.2)
        bn.running_var.uniform_(0.5, 1.5)
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.uniform_(-0.2, 0.2)
    return mods


def _s2s_ckpt_round_trip(torch, dev):
    """For a GRU and an LSTM cell: the reference modules written as a
    Lightning checkpoint, read back by ``seq2seq_from_ckpt`` onto the
    card, and the imported model's eval-mode logits at teacher forcing 1
    against the modules' own forward on the card (CKPT_B trials)."""
    import tempfile

    from cross_patient_speech_decoding_tpu_torch.models.torch_import import (
        seq2seq_from_ckpt,
    )

    gen = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn((CKPT_B, S2S_T, S2S_C), generator=gen, device=dev)
    y = torch.randint(0, S2S_CLS, (CKPT_B, S2S_L), generator=gen,
                      device=dev)
    out, fails = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for cell in ("gru", "lstm"):
            mods = _s2s_ckpt_modules(torch, cell)
            sd = {f"{p}.{k}": v for p, m in mods.items()
                  for k, v in m.state_dict().items()}
            path = Path(tmp) / f"s2s_{cell}.ckpt"
            torch.save({"state_dict": sd, "hyper_parameters": {
                "n_filters": S2S_F, "hidden_size": S2S_H,
                "num_classes": S2S_CLS, "kernel_size": S2S_K,
                "seq_length": S2S_L, "model_type": cell, "padding": 0}},
                path)
            t0 = time.perf_counter()
            model = seq2seq_from_ckpt(path, device=dev).eval()
            load_s = time.perf_counter() - t0
            ref_mods = {k: m.to(dev).eval() for k, m in mods.items()}
            with torch.no_grad():
                got = model(x, y, 1.0)
                h = torch.relu(ref_mods["temporal_conv.bn"](
                    ref_mods["temporal_conv.conv"](x.transpose(1, 2))))
                _, hn = ref_mods["encoder.rnn"](h.transpose(1, 2))
                hidden = tuple((s[-2] + s[-1])[None].contiguous()
                               for s in (hn if cell == "lstm" else (hn,)))
                want = _teacher_forced(
                    torch, ref_mods["decoder.embedding"],
                    ref_mods["decoder.rnn"], ref_mods["decoder.fc_out"],
                    hidden if cell == "lstm" else hidden[0], y, S2S_CLS)
            err = float((got - want).abs().max() / want.abs().max())
            out[cell] = {"tensors": len(sd), "load_s": load_s,
                         "device": str(model.device),
                         "logits_max_rel_err": err}
            if not (err <= CKPT_LOGITS_RTOL and model.device == dev):
                fails[cell] = out[cell]
    out.update({"B": CKPT_B, "tolerance": CKPT_LOGITS_RTOL, "fails": fails})
    return out


# ---------------------------------------------------------------------------
# seq2seq (slice 4)
# ---------------------------------------------------------------------------


def seq2seq_flops_per_step(B, T, C, F, H, K, L, n_cls):
    """Model FLOPs of one Seq2SeqRNN train step (forward + ~2x backward),
    the JAX package's analytic count (bench.py:_seq2seq_flops_per_step),
    so that model TFLOP/s compare across the two."""
    Tc = T - K + 1  # VALID conv shrink
    conv = 2 * B * Tc * K * C * F
    enc = 2 * (2 * B * Tc * F * 3 * H + 2 * B * Tc * H * 3 * H)  # bidir
    dec = L * (2 * B * H * 3 * H * 2 + 2 * B * H * n_cls)
    return 3 * (conv + enc + dec)


class _PlainGRU:
    """Within the block, the GRU ops take their plain versions (forward
    and backward) on CUDA tensors too: the route hook, the reference path
    of the seq2seq checks."""

    def __init__(self, gru):
        self.gru = gru

    def __enter__(self):
        self.route = self.gru._route
        self.gru._route = lambda x: "cpu"

    def __exit__(self, *exc):
        self.gru._route = self.route


def _s2s_batch(torch, dev):
    import numpy as np

    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((S2S_B, S2S_T, S2S_C), generator=gen, device=dev)
    y = np.random.default_rng(0).integers(0, S2S_CLS, (S2S_B, S2S_L))
    return x, torch.as_tensor(y, device=dev)


def _s2s_loss_grads(torch, model, x, y):
    """Train-mode loss (teacher forcing 1: no coin decides a token) and
    its gradient per parameter name; the BatchNorm's running averages are
    put back after the forward."""
    import torch.nn.functional as F

    saved = [b.clone() for b in model.buffers()]
    logits = model(x, y, 1.0)
    loss = F.cross_entropy(logits.reshape(-1, S2S_CLS), y.reshape(-1))
    names, params = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, params)))
    with torch.no_grad():
        for b, s in zip(model.buffers(), saved):
            b.copy_(s)
    return float(loss.detach()), grads


def _s2s_grad_errs(grads_k, grads_p) -> dict:
    """max |kernel - plain| / max |plain| per parameter; the conv bias's
    gradient is 0 in exact arithmetic (the BatchNorm removes any
    per-filter shift), so it is taken over the conv weight's largest."""
    errs = {}
    for name, want in grads_p.items():
        scale = grads_p["conv.weight" if name == "conv.bias" else name]
        errs[name] = float((grads_k[name] - want).abs().max()
                           / scale.abs().max().clamp(min=1e-30))
    return errs


def _check_conv_tf32(torch, model, x) -> dict:
    """The model's conv (forward and gradients) with TF32 switched on by the
    caller through both of PyTorch's APIs, against TF32 off; a plain
    ``F.conv1d`` under TF32 for contrast, against float64."""
    import torch.nn.functional as F

    from cross_patient_speech_decoding_tpu_torch.models.layers import (
        Conv1dF32,
    )

    conv = model.conv
    xt = x[:256].transpose(1, 2)

    def run():  # what TemporalConv runs, forward and weight gradient
        w = conv.weight.detach().requires_grad_()
        y = Conv1dF32.apply(xt, w, conv.bias.detach(), conv.stride)
        (gw,) = torch.autograd.grad(y, w, torch.ones_like(y))
        return y.detach(), gw

    off = run()
    cudnn = torch.backends.cudnn
    cudnn.allow_tf32 = True
    cudnn.conv.fp32_precision = "tf32"
    try:
        on = run()
        raw = F.conv1d(xt, conv.weight.detach(), conv.bias.detach())
        kept = cudnn.conv.fp32_precision == "tf32" and cudnn.allow_tf32
    finally:
        cudnn.allow_tf32 = False
    ref = F.conv1d(xt.double(), conv.weight.detach().double(),
                   conv.bias.detach().double())
    scale = float(ref.abs().max())
    return {"caller_setting_kept": kept,
            "out_rel_diff_vs_tf32_off": float((on[0] - off[0]).abs().max())
            / scale,
            "wgrad_rel_diff_vs_tf32_off": float(
                (on[1] - off[1]).abs().max() / off[1].abs().max()),
            "out_rel_err_vs_float64": float((on[0].double() - ref).abs()
                                            .max()) / scale,
            "plain_conv1d_tf32_rel_err_vs_float64": float(
                (raw.double() - ref).abs().max()) / scale}


def phase_seq2seq_train(torch, dev, gru):
    import numpy as np

    from cross_patient_speech_decoding_tpu_torch.models import Seq2SeqRNN
    from cross_patient_speech_decoding_tpu_torch.train import (
        create_train_state,
        make_optimizer,
        make_seq2seq_train_step,
    )

    x, y = _s2s_batch(torch, dev)
    model = Seq2SeqRNN(S2S_C, S2S_F, S2S_H, S2S_CLS, kernel_size=S2S_K,
                       seq_length=S2S_L, seed=0, device=dev)

    # (a) dropout 0: loss and gradients, kernels vs plain
    model.train()
    model.conv.dropout = 0.0  # the one dropout of this one-layer model
    loss_k, grads_k = _s2s_loss_grads(torch, model, x, y)
    with _PlainGRU(gru):
        loss_p, grads_p = _s2s_loss_grads(torch, model, x, y)
    grad_errs = _s2s_grad_errs(grads_k, grads_p)
    del grads_k, grads_p
    model.conv.dropout = 0.3
    conv_tf32 = _check_conv_tf32(torch, model, x)

    # (b) one train step at dropout 0.3, teacher forcing 0.5, launches
    tx = make_optimizer(1e-3, 1e-5, 100)
    state = create_train_state(model, tx)
    step = make_seq2seq_train_step(model, tx, teacher_forcing=0.5)
    gen = torch.Generator(device=dev).manual_seed(3)
    batch = (x, y)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gru.reset_launch_counts()
    t0 = time.perf_counter()
    state, m = step(state, batch, gen)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(gru.LAUNCHES)
    losses, accs = [float(m["loss"])], [float(m["acc"])]

    # (c) 3 more steps
    step_times = []
    for _ in range(3):
        t0 = time.perf_counter()
        state, m = step(state, batch, gen)
        torch.cuda.synchronize()
        step_times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        accs.append(float(m["acc"]))
    step_s = statistics.median(step_times)
    state, profile = profile_step(torch, step, state, batch, gen)
    flops = seq2seq_flops_per_step(S2S_B, S2S_T, S2S_C, S2S_F, S2S_H, S2S_K,
                                   S2S_L, S2S_CLS)
    finite = all(np.isfinite(losses)) and all(
        bool(torch.isfinite(t).all()) for t in model.state_dict().values())
    res = {"phase": "seq2seq_train", "B": S2S_B, "T": S2S_T, "C": S2S_C,
           "filters": S2S_F, "kernel_size": S2S_K, "hidden": S2S_H,
           "seq_length": S2S_L, "classes": S2S_CLS, "encoder_steps": S2S_TC,
           "dropout": 0.3, "teacher_forcing": 0.5,
           "optimizer": "AdamW lr 1e-3 wd 1e-5, linear decay over 100",
           "loss_dropout0": loss_k, "loss_dropout0_plain": loss_p,
           "grad_max_rel_err_vs_plain": grad_errs,
           "grad_tolerance": GRAD_RTOL, "conv_tf32_on": conv_tf32,
           "launches": launches, "first_step_s": first_s, "step_s": step_s,
           "step_s_runs": step_times, "samples_per_s": S2S_B / step_s,
           "model_tflops_per_s": flops / step_s / 1e12,
           "model_flops_per_step": flops, "losses": losses, "accs": accs,
           "steps": state.step, "finite": finite,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "profile": profile}
    emit(res)
    if abs(loss_k - loss_p) > LOSS_RTOL * abs(loss_p):
        raise RuntimeError(f"seq2seq loss {loss_k} vs plain {loss_p}")
    bad = {k: v for k, v in grad_errs.items() if not v <= GRAD_RTOL}
    if bad:
        raise RuntimeError(f"seq2seq gradients differ from plain: {bad}")
    if not (conv_tf32["caller_setting_kept"]
            and conv_tf32["out_rel_diff_vs_tf32_off"] <= CONV_TF32_RTOL
            and conv_tf32["wgrad_rel_diff_vs_tf32_off"] <= CONV_TF32_RTOL):
        raise RuntimeError(f"conv under the caller's TF32: {conv_tf32}")
    if launches != SEQ2SEQ_TRAIN_LAUNCHES:
        raise RuntimeError(f"seq2seq train step launched {launches}, "
                           f"expected {SEQ2SEQ_TRAIN_LAUNCHES}")
    if not (finite and all(0.0 <= a <= 1.0 for a in accs)):
        raise RuntimeError(f"seq2seq: non-finite or bad {losses} {accs}")
    return model, batch, launches


def _feedback_flips(torch, logits_k, logits_p):
    """Samples whose fed-back tokens (the argmax of steps 0..L-2) differ
    between two eval runs, and the largest top-2 margin at each such
    sample's first differing step (a flip is only admissible within a
    tie)."""
    tok_k = logits_k[:, :-1].argmax(-1)
    tok_p = logits_p[:, :-1].argmax(-1)
    differ = (tok_k != tok_p).any(-1)
    margin = 0.0
    for b in differ.nonzero()[:, 0].tolist():
        i = int((tok_k[b] != tok_p[b]).nonzero()[0, 0])
        top2 = logits_p[b, i].topk(2).values
        margin = max(margin, float(top2[0] - top2[1]))
    return differ, margin


def phase_seq2seq_eval(torch, dev, gru, model, batch):
    import numpy as np

    from cross_patient_speech_decoding_tpu_torch.train import (
        make_seq2seq_eval_step,
    )

    step = make_seq2seq_eval_step(model)
    step(batch)  # warm-up
    torch.cuda.synchronize()
    gru.reset_launch_counts()
    t0 = time.perf_counter()
    out = step(batch)
    torch.cuda.synchronize()
    step_times = [time.perf_counter() - t0]
    launches = dict(gru.LAUNCHES)
    for _ in range(2):
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        step_times.append(time.perf_counter() - t0)
    step_s = statistics.median(step_times)
    loss, acc = float(out["loss"]), float(out["acc"])
    with _PlainGRU(gru):
        out_p = step(batch)
    loss_p, acc_p = float(out_p["loss"]), float(out_p["acc"])
    x, _ = batch
    model.eval()
    try:
        with torch.no_grad():
            logits_k = model(x, None, 0.0)
            with _PlainGRU(gru):
                logits_p = model(x, None, 0.0)
    finally:
        model.train()
    differ, flip_margin = _feedback_flips(torch, logits_k, logits_p)
    same = ~differ
    logit_err = float((logits_k[same] - logits_p[same]).abs().max())
    res = {"phase": "seq2seq_eval", "B": S2S_B, "loss": loss, "acc": acc,
           "loss_plain": loss_p, "acc_plain": acc_p,
           "logits_max_abs_err_vs_plain": logit_err,
           "feedback_flips": int(differ.sum()),
           "flip_max_top2_margin": flip_margin, "launches": launches,
           "step_s": step_s, "step_s_runs": step_times,
           "samples_per_s": S2S_B / step_s}
    emit(res)
    if tuple(logits_k.shape) != (S2S_B, S2S_L, S2S_CLS) or not (
            bool(torch.isfinite(logits_k).all()) and np.isfinite(loss)
            and 0.0 <= acc <= 1.0):
        raise RuntimeError(f"seq2seq eval output: {res}")
    if launches != SEQ2SEQ_EVAL_LAUNCHES:
        raise RuntimeError(f"seq2seq eval step launched {launches}, "
                           f"expected {SEQ2SEQ_EVAL_LAUNCHES}")
    if not logit_err <= LOGITS_ATOL:
        raise RuntimeError(f"seq2seq logits differ from plain: {logit_err}")
    if not flip_margin <= 2 * LOGITS_ATOL:
        raise RuntimeError(f"a fed-back token flipped outside a tie: {res}")
    if not differ.any() and not (abs(loss - loss_p) <= LOSS_RTOL * abs(loss_p)
                                 and acc == acc_p):
        raise RuntimeError(f"seq2seq eval loss/acc vs plain: {res}")


class _S2sProbe:
    """Wrappers around what one ``run_train_seq2seq`` call runs, for a
    block: the data (timed), the PCA fits (``exp._seq2seq_pca``: the
    sources' once a run, the target's per-fold batch an iteration) and the
    batched CCA fits (``exp._seq2seq_align``), each synchronised and timed
    with its latents kept where ``keep`` is set; every fold-epoch and fold
    evaluation of the fold trainer (synchronised and timed where ``timed``
    is set, each loss kept); the pooled arrays; with ``cpu_slack`` the
    share of each fold's test
    rows whose top two logits lie within S2S_DECIDED of their magnitude
    (trials that may flip between two devices)."""

    def __init__(self, torch, exp, timed=True, keep=False, cpu_slack=False):
        from cross_patient_speech_decoding_tpu_torch.train import (
            fold_parallel,
        )

        self.torch, self.exp, self.fp = torch, exp, fold_parallel
        self.timed, self.keep, self.cpu_slack = timed, keep, cpu_slack
        self.data_s, self.pca_src_s, self.pca_tar_s = [], [], []
        self.cca_s = []
        self.epoch_s, self.eval_s, self.losses, self.slack = [], [], [], []
        self.tar_lat, self.aligned, self.pooled = [], [], []
        self.data = None

    def _timed(self, fn, store):
        torch = self.torch

        def run(*a, **k):
            if not self.timed:
                return fn(*a, **k)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            store.append(time.perf_counter() - t0)
            return out
        return run

    def __enter__(self):
        exp, fp, probe = self.exp, self.fp, self
        self.saved = [(exp, n, getattr(exp, n)) for n in (
            "_seq2seq_arrays", "_seq2seq_pca", "_seq2seq_align")]
        self.saved += [(fp, n, getattr(fp, n)) for n in (
            "_fold_epoch", "_fold_eval", "pooled_fold_arrays")]
        orig = {n: f for _, n, f in self.saved}

        def arrays(*a, **k):
            out = probe._timed(orig["_seq2seq_arrays"], probe.data_s)(*a, **k)
            probe.data = out
            return out

        def pca(X, mask, max_k):
            store = probe.pca_src_s if mask is None else probe.pca_tar_s
            lat = probe._timed(orig["_seq2seq_pca"], store)(X, mask, max_k)
            if probe.keep and mask is not None:
                probe.tar_lat.append(lat)
            return lat

        def align(*a, **k):
            out = probe._timed(orig["_seq2seq_align"], probe.cca_s)(*a, **k)
            if probe.keep:
                probe.aligned.append(out)
            return out

        def epoch(*a, **k):
            loss = probe._timed(orig["_fold_epoch"], probe.epoch_s)(*a, **k)
            probe.losses.append(loss)
            return loss

        def evaluate(model, x, y, test_mask):
            acc = probe._timed(orig["_fold_eval"], probe.eval_s)(
                model, x, y, test_mask)
            if probe.cpu_slack:
                with probe.torch.no_grad():
                    und = _undecided(model(x, None, 0.0),
                                     S2S_DECIDED).any(-1)
                rows = test_mask > 0
                probe.slack.append(float((und & rows).sum())
                                   / max(1, int(rows.sum())))
            return acc

        def pooled(*a, **k):
            out = orig["pooled_fold_arrays"](*a, **k)
            probe.pooled.append(out)
            return out

        exp._seq2seq_arrays, exp._seq2seq_pca = arrays, pca
        exp._seq2seq_align = align
        fp._fold_epoch, fp._fold_eval = epoch, evaluate
        fp.pooled_fold_arrays = pooled
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


class _RecordGru:
    """Within the block, keep a copy of the arguments and of the result of
    the first launch of each GRU kernel at each shape, dtype, direction
    and ``need_dx`` (launch counts are the wrappers' own); ``nbytes`` is
    what the copies hold on the device."""

    PLAIN = {"gru_bifwd_cuda": "gru_layer_bidir_plain",
             "gru_fwd_cuda": "gru_layer_plain",
             "gru_bwd_cuda": "gru_backward_plain",
             "gru_wfwd_cuda": "gru_layer_windowed_plain",
             "gru_wbwd_cuda": "gru_win_backward_plain"}

    def __init__(self, torch, gru):
        self.torch, self.gru = torch, gru
        self.calls, self.nbytes = {}, 0

    def _copy(self, v):
        if self.torch.is_tensor(v):
            self.nbytes += v.numel() * v.element_size()
            return v.clone()
        if isinstance(v, tuple):
            return tuple(self._copy(t) for t in v)
        return v

    def __enter__(self):
        import inspect

        self.saved = {n: getattr(self.gru, n) for n in self.PLAIN}
        for name, fn in self.saved.items():
            sig = inspect.signature(fn)

            def record(*args, _name=name, _fn=fn, _sig=sig, **kw):
                out = _fn(*args, **kw)
                bound = _sig.bind(*args, **kw)
                bound.apply_defaults()
                a = bound.arguments
                x = a["x"]
                label = "_".join(
                    [_name[:-5], "x".join(map(str, x.shape)),
                     str(x.dtype).rsplit(".", 1)[-1]]
                    + [f"{k}{int(a[k])}" for k in ("reverse", "need_dx")
                       if k in a])
                if label not in self.calls:
                    self.calls[label] = (_name, self._copy(bound.args),
                                         self._copy(out))
                return out
            setattr(self.gru, name, record)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.gru, name, fn)


def _check_path_gru(gru, rec) -> dict:
    """Each recorded launch's result against the plain version on its
    recorded arguments, on the card: the forwards' hs to KERNEL_ATOL, the
    backwards' outputs to GRAD_RTOL relative (``_bwd_errs``)."""
    out = {}
    for label, (name, args, got) in rec.calls.items():
        want = getattr(gru, _RecordGru.PLAIN[name])(*args)
        if name in ("gru_bwd_cuda", "gru_wbwd_cuda"):
            err = max(_bwd_errs(got, want).values())
            out[label] = {"max_rel_err": err, "ok": err <= GRAD_RTOL}
        else:
            if name in ("gru_fwd_cuda", "gru_wfwd_cuda"):
                got, want = (got,), (want,)
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            out[label] = {"max_abs_err": err, "ok": err <= KERNEL_ATOL}
        del want
    return out


def s2s_driver_launches(cfg: dict) -> dict:
    """Launches of one fold-parallel ``run_train_seq2seq`` iteration: one
    ``jacobi_eigh`` per source patient (its chol CCA fit batched over the
    folds, K = S2S_MAX_K); per fold, each epoch one train step
    (SEQ2SEQ_TRAIN_LAUNCHES) and after the last one evaluation
    (SEQ2SEQ_EVAL_LAUNCHES)."""
    F, E = cfg["n_folds"], cfg["epochs"]
    return {k: F * (E * SEQ2SEQ_TRAIN_LAUNCHES[k] + SEQ2SEQ_EVAL_LAUNCHES[k])
            for k in SEQ2SEQ_TRAIN_LAUNCHES} | {
                "jacobi_eigh": cfg["synth_patients"] - 1}


def _s2s_cfg(spec: dict, out: str, **kw):
    from cross_patient_speech_decoding_tpu_torch.utils.config import (
        TrainSeq2SeqConfig,
    )

    return TrainSeq2SeqConfig(**{**spec, **kw}, out=out)


def phase_seq2seq_driver(torch, dev, gru, jacobi, smi):
    """The seq2seq experiment driver end to end at the reference's width
    and data scale: exact launches, the kernels' launches of that run
    against their plain versions, a resume with none, times, idle shares
    and peak memory; then small depth on the card and on the CPU,
    with augmentations on the card, and the prewarm command."""
    import tempfile

    import numpy as np

    from cross_patient_speech_decoding_tpu_torch.cli import experiments as exp
    from cross_patient_speech_decoding_tpu_torch.data.loaders import load_pkl
    from cross_patient_speech_decoding_tpu_torch.train import (
        create_train_state,
        fold_parallel,
        make_optimizer,
    )

    tmp = tempfile.TemporaryDirectory()
    cfg = _s2s_cfg(S2S_DRV_CFG, str(Path(tmp.name) / "full" / "s2s.csv"))
    want = s2s_driver_launches(S2S_DRV_CFG)

    # (a) one iteration at full width, counts zeroed just before; the
    # Jacobi kernel's batches and the first GRU launch of each shape are
    # kept for (a') (copies held on the card from fold 0's first step on,
    # so the peak they add is taken out of peak_mem_gb)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(gru, jacobi)
    with _NoPlainOnCuda(torch, gru, jacobi), _S2sProbe(torch, exp) as pr, \
            _RecordJacobi(jacobi) as jrec, _RecordGru(torch, gru) as grec:
        t0 = time.perf_counter()
        accs = exp.run_train_seq2seq(cfg, verbose=True, device=dev)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    launches = _launch_counts(gru, jacobi)
    kept = grec.nbytes + sum(A.numel() * A.element_size()
                             for A in jrec.batches)
    peak_raw = torch.cuda.max_memory_allocated()
    peak_gb = (peak_raw - kept) / 1e9

    # (a') every kernel launch kept from (a) against its plain version on
    # the same inputs: the Jacobi batches (20 x 24 x 24) bit for bit, the
    # GRU kernels at the fold's B = 1224 (encoder and decoder)
    path_jacobi = {f"batch{i}_{'x'.join(map(str, A.shape))}":
                   _check_jacobi(torch, jacobi, A)
                   for i, A in enumerate(jrec.batches)}
    path_gru = _check_path_gru(gru, grec)
    del grec, jrec
    (X, y, w, te), = pr.pooled
    n_rows = int(X.shape[1])
    csv_back = np.loadtxt(cfg.out, delimiter=",").tolist()
    progress = load_pkl(str(Path(cfg.out).with_suffix(".progress.pkl")))

    # (b) the same call again resumes: the stored accuracies, no launch
    _reset_counts(gru, jacobi)
    again = exp.run_train_seq2seq(cfg, verbose=True, device=dev)
    torch.cuda.synchronize()
    resume_launches = _launch_counts(gru, jacobi)

    # (c) one fold-epoch and one whole iteration under torch.profiler
    model = exp._seq2seq_model(cfg)(X.shape[-1], seed=0, device=dev)
    tx = make_optimizer(cfg.lr, cfg.weight_decay, cfg.decay_iters,
                        end_factor=0.01, clip=cfg.clip)
    state = create_train_state(model, tx)
    gen = torch.Generator(device=dev).manual_seed(1)

    def one_epoch():
        return fold_parallel._fold_epoch(state, tx, X[0], y, w[0], 0.5, gen)

    one_epoch()
    torch.cuda.synchronize()
    _, epoch_prof = profile_call(torch, one_epoch)
    del model, state, X, y, w, te, pr.pooled
    cfg_p = _s2s_cfg(S2S_DRV_CFG, str(Path(tmp.name) / "prof" / "s2s.csv"))
    t0 = time.perf_counter()
    _, iter_prof = profile_call(
        torch, lambda: exp.run_train_seq2seq(cfg_p, verbose=False,
                                             device=dev), cpu=False)
    iter_prof["profiled_call_s"] = time.perf_counter() - t0
    for p in (epoch_prof, iter_prof):
        p["device_ms_by_kernel"] = dict(list(
            p["device_ms_by_kernel"].items())[:6])

    fold_epoch_ms = statistics.median(pr.epoch_s) * 1e3
    losses = [float(v) for v in pr.losses]
    res = {"phase": "seq2seq_driver", "nvidia_smi": smi,
           "config": S2S_DRV_CFG,
           "cut": "1 iteration of 2 epochs (the reference: 50 of 500)",
           "pooled_rows": n_rows, "accs": accs.tolist(),
           "mean_acc": float(accs.mean()), "chance": 1.0 / 9,
           "launches": launches, "launches_expected": want,
           "fold_epochs": len(pr.epoch_s), "fold_evals": len(pr.eval_s),
           "losses_first_last": [losses[0], losses[-1]],
           "losses_finite": bool(np.isfinite(losses).all()),
           "iteration_wall_s": wall_s, "data_ms": sum(pr.data_s) * 1e3,
           "source_pca_ms": sum(pr.pca_src_s) * 1e3,
           "fold_features_ms": {"pca": sum(pr.pca_tar_s) * 1e3,
                                "cca": sum(pr.cca_s) * 1e3,
                                "cca_fit_ms": [t * 1e3 for t in pr.cca_s]},
           "ms_per_fold_epoch": fold_epoch_ms,
           "fold_epoch_ms_min_max": [min(pr.epoch_s) * 1e3,
                                     max(pr.epoch_s) * 1e3],
           "train_samples_per_s": n_rows / (fold_epoch_ms / 1e3),
           "eval_ms_per_fold": statistics.median(pr.eval_s) * 1e3,
           "eval_ms": sum(pr.eval_s) * 1e3, "peak_mem_gb": peak_gb,
           "peak_mem_gb_with_kept_copies": peak_raw / 1e9,
           "path_kernels_vs_plain": {
               "jacobi_eigh": path_jacobi, "gru": path_gru,
               "tolerance": {"jacobi": "bit for bit (_jacobi_ok)",
                             "gru_fwd_abs": KERNEL_ATOL,
                             "gru_bwd_rel": GRAD_RTOL}},
           "results_csv_read_back": csv_back == accs.tolist(),
           "progress_iterations": len(progress["accs"]),
           "resume_accs_same": again.tolist() == accs.tolist(),
           "resume_launches": resume_launches,
           "fold_epoch_profile": epoch_prof,
           "iteration_profile": iter_prof,
           "note": "times of (a), each part synchronised; the profiles are "
                   "of one more fold-epoch and one more whole iteration"}
    t0 = time.perf_counter()
    small = _s2s_small(torch, dev, exp)
    small["s"] = time.perf_counter() - t0
    res["small_depth_card_vs_cpu"] = small
    _reset_counts(gru, jacobi)
    t0 = time.perf_counter()
    warm = exp.run_prewarm_seq2seq(_s2s_cfg(S2S_SMALL, ""), verbose=True,
                                   device=dev)
    torch.cuda.synchronize()
    res["prewarm"] = {"s": time.perf_counter() - t0,
                      "launches": _launch_counts(gru, jacobi),
                      "returned": list(np.shape(warm))}
    emit(res)
    tmp.cleanup()

    bad = {}
    if launches != want:
        bad["launches"] = launches
    bad.update({f"path_{k}": v for k, v in path_jacobi.items()
                if not _jacobi_ok(k, v)})
    bad.update({f"path_{k}": v for k, v in path_gru.items() if not v["ok"]})
    # kept: every Jacobi batch, the encoder's gru_bifwd, the decoder's
    # gru_fwd, gru_bwd over the encoder both ways and over a decoder step
    kinds = [label.split("_")[1] for label in path_gru]
    if (len(path_jacobi) != want["jacobi_eigh"] or "bifwd" not in kinds
            or "fwd" not in kinds or kinds.count("bwd") < 3):
        bad["path_recorded"] = [len(path_jacobi), list(path_gru)]
    if not (res["losses_finite"] and accs.shape == (cfg.n_folds,)
            and np.isfinite(accs).all() and 0.0 <= accs.min()
            and accs.max() <= 1.0):
        bad["accs"] = accs.tolist()
    if not (res["results_csv_read_back"] and res["progress_iterations"] == 1):
        bad["results_files"] = [csv_back, res["progress_iterations"]]
    if not res["resume_accs_same"] or any(resume_launches.values()):
        bad["resume"] = resume_launches
    if res["prewarm"]["returned"] != [0] or not res["prewarm"]["launches"][
            "gru_bifwd"]:
        bad["prewarm"] = res["prewarm"]
    bad.update({k: v for k, v in small.items()
                if k.endswith("_ok") and v is not True})
    if bad:
        raise RuntimeError(f"seq2seq_driver checks failed: {list(bad)}")
    return {k: v for k, v in launches.items() if v}


def _s2s_small(torch, dev, exp):
    """Small depth (S2S_SMALL) at dropout 0 and teacher forcing 1 on the
    card, then on the CPU from the card's data and the same initial weights
    (``Seq2SeqRNN`` draws them on the host from the seed), the CPU's Jacobi
    on the kernel's route through its plain version: per-fold latents on
    the target's separated columns (PCA 2e-4, mapped sources 1e-3, as
    svm_decode's small depth), every fold-epoch loss within S2S_LOSS_RTOL,
    accuracies equal up to the test rows whose top two logits the CPU's
    model leaves within S2S_DECIDED. Then the card with the reference's
    post-alignment augmentations: the pooled masks tiled over the copies."""
    import functools

    import numpy as np

    from cross_patient_speech_decoding_tpu_torch.models import Seq2SeqRNN
    from cross_patient_speech_decoding_tpu_torch.train import fold_parallel

    fp = fold_parallel
    saved = [(exp, "_seq2seq_model", exp._seq2seq_model),
             (exp, "_seq2seq_arrays", exp._seq2seq_arrays),
             (fp, "make_seq2seq_fold_trainer_fn",
              fp.make_seq2seq_fold_trainer_fn)]
    make_fn = fp.make_seq2seq_fold_trainer_fn
    exp._seq2seq_model = lambda cfg: functools.partial(
        Seq2SeqRNN, n_filters=cfg.n_filters, hidden=cfg.hidden,
        num_classes=9, kernel_size=cfg.kernel_size, cnn_dropout=0.0,
        rnn_dropout=0.0)
    fp.make_seq2seq_fold_trainer_fn = lambda m, **k: make_fn(
        m, **{**k, "teacher_forcing": 1.0})
    out = {"config": S2S_SMALL, "dropout": 0.0, "teacher_forcing": 1.0,
           "latent_rtol": [DRV_PCA_RTOL, DRV_ALIGNED_RTOL],
           "loss_rtol": S2S_LOSS_RTOL, "decided_rtol": S2S_DECIDED}
    try:
        with _S2sProbe(torch, exp, timed=False, keep=True) as card:
            acc_g = exp.run_train_seq2seq(_s2s_cfg(S2S_SMALL, ""), False, dev)
            torch.cuda.synchronize()
        Xs, ys = card.data
        exp._seq2seq_arrays = lambda cfg, device=None: (
            [X.cpu() for X in Xs], ys)
        t0 = time.perf_counter()
        with _PlainJacobiOnCpu(), _S2sProbe(torch, exp, timed=False,
                                            keep=True, cpu_slack=True) as cpu:
            acc_c = exp.run_train_seq2seq(_s2s_cfg(S2S_SMALL, ""), False,
                                          "cpu")
        out["cpu_s"] = time.perf_counter() - t0
        exp._seq2seq_arrays = saved[1][2]
        with _S2sProbe(torch, exp, timed=False) as aug:
            acc_a = exp.run_train_seq2seq(_s2s_cfg(
                S2S_SMALL, "", augmentations=S2S_AUGS), False, dev)
            torch.cuda.synchronize()
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)

    # latents: each fold's separated target columns
    errs = []
    tar_c = cpu.tar_lat[0]
    for b in range(S2S_SMALL["n_folds"]):
        sep = _separated(tar_c[b])
        for lg, lc, tol in ([(card.tar_lat[0], tar_c, DRV_PCA_RTOL)]
                            + [(g, h, DRV_ALIGNED_RTOL) for g, h in
                               zip(card.aligned, cpu.aligned)]):
            errs.append((_rel(lg[b].cpu()[..., sep], lc[b][..., sep])
                         if sep.any() else float("inf"), tol,
                         int(sep.sum())))
    out["latent_rel_errs"] = [e for e, _, _ in errs]
    out["latent_columns_compared"] = [n for _, _, n in errs]
    out["latents_ok"] = all(e <= t for e, t, _ in errs)
    l_g = np.asarray([float(v) for v in card.losses])
    l_c = np.asarray([float(v) for v in cpu.losses])
    out["loss_rel_errs"] = (np.abs(l_g - l_c) / np.abs(l_c)).tolist()
    out["final_losses_card"] = l_g[S2S_SMALL["epochs"] - 1::
                                   S2S_SMALL["epochs"]].tolist()
    out["final_losses_cpu"] = l_c[S2S_SMALL["epochs"] - 1::
                                  S2S_SMALL["epochs"]].tolist()
    out["losses_ok"] = (len(l_g) == len(l_c) > 0
                        and max(out["loss_rel_errs"]) <= S2S_LOSS_RTOL)
    out["accs_card"], out["accs_cpu"] = acc_g.tolist(), acc_c.tolist()
    out["acc_slack"] = cpu.slack
    out["accs_ok"] = bool(len(acc_g) == len(cpu.slack) and all(
        abs(g - c) <= s + 1e-6 for g, c, s in zip(acc_g, acc_c, cpu.slack)))

    # augmentations: train masks tiled over the copies, test rows only
    # on the originals
    (X, _, w, te), = aug.pooled
    n0 = len(Xs[0])
    reps = len(S2S_AUGS.split(",")) + 1
    w_t = w[:, : n0 * reps].reshape(len(w), reps, n0)
    out["augmented"] = {"augmentations": S2S_AUGS, "pooled_shape":
                        list(X.shape), "accs": acc_a.tolist()}
    out["augmented_ok"] = bool(
        X.shape[1] == reps * sum(len(x) for x in Xs)
        and (w_t == w_t[:, :1]).all() and (w[:, n0 * reps:] == 1).all()
        and (te[:, n0:] == 0).all() and (te[:, :n0] == 1 - w[:, :n0]).all()
        and np.isfinite(acc_a).all() and 0.0 <= acc_a.min()
        and acc_a.max() <= 1.0)
    return out


class _NNProbe:
    """Wrappers around what ``run_train_nn`` calls, for a block: the PCA
    fits (``exp._nn_pca``: the sources' once a run, the target's once a
    fold) and the CCA fits (``exp._cca_align_lat``), each synchronised and
    timed where ``timed`` is set; every train step (timed, its loss and
    row count kept, the last one's step, state, batch and generator kept
    for a profiled fold-epoch) and every evaluation (timed); with
    ``cpu_slack`` the share of each fold's test rows whose top two logits
    lie within NN_DECIDED of their magnitude (trials that may flip between
    two devices)."""

    def __init__(self, torch, exp, timed=True, cpu_slack=False):
        import cross_patient_speech_decoding_tpu_torch.train as train

        self.torch, self.exp, self.train = torch, exp, train
        self.timed, self.cpu_slack = timed, cpu_slack
        self.pca_src_s, self.pca_tar_s, self.cca_s = [], [], []
        self.step_s, self.eval_s, self.losses, self.rows = [], [], [], []
        self.slack, self.last = [], None

    def _timed(self, fn, store):
        torch = self.torch

        def run(*a, **k):
            if not self.timed:
                return fn(*a, **k)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            store.append(time.perf_counter() - t0)
            return out
        return run

    def __enter__(self):
        exp, train, probe = self.exp, self.train, self
        self.saved = [(exp, "_nn_pca"), (exp, "_cca_align_lat"),
                      (train, "make_classifier_train_step"),
                      (train, "make_classifier_eval_step")]
        self.saved = [(m, n, getattr(m, n)) for m, n in self.saved]
        orig = {n: f for _, n, f in self.saved}

        def pca(X, mask, n_comp, max_k):
            store = probe.pca_src_s if mask is None else probe.pca_tar_s
            return probe._timed(orig["_nn_pca"], store)(X, mask, n_comp,
                                                        max_k)

        def make_train(model, tx):
            step = orig["make_classifier_train_step"](model, tx)

            def counted(state, batch, gen=None):
                probe.rows.append(int(batch[0].shape[0]))
                out = probe._timed(step, probe.step_s)(state, batch, gen)
                probe.losses.append(out[1]["loss"])
                probe.last = (step, state, batch, gen)
                return out
            return counted

        def make_eval(model):
            step = orig["make_classifier_eval_step"](model)

            def counted(batch):
                if probe.cpu_slack:
                    model.eval()
                    with probe.torch.no_grad():
                        und = _undecided(model(batch[0]), NN_DECIDED)
                    probe.slack.append(float(und.float().mean()))
                return probe._timed(step, probe.eval_s)(batch)
            return counted

        exp._nn_pca = pca
        exp._cca_align_lat = self._timed(orig["_cca_align_lat"], self.cca_s)
        train.make_classifier_train_step = make_train
        train.make_classifier_eval_step = make_eval
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def _decoding_pkl(root: Path, key: str, pts, T: int, noise: float) -> str:
    """A ``pt_decoding_data`` pickle ``root/pt_decoding_data_{key}.pkl``
    of the patients ``pts`` (the subsample phase's widths, 9 classes x
    SUB_TRIALS, latent width 10) from the port's host generator, in the
    reference's layout (``_reference_entry``)."""
    import numpy as np

    from cross_patient_speech_decoding_tpu_torch.data import (
        loaders,
        synthetic,
    )

    widths = dict(zip(SUB_PTS, SUB_CHANNELS))
    ds = synthetic.make_synthetic_patients(
        seed=0, n_patients=len(pts), n_classes=9,
        trials_per_class=SUB_TRIALS, T=T,
        channels=tuple(widths[pt] for pt in pts), latent_dim=10,
        noise=noise)
    data = {pt: _reference_entry(np, ds.X[i], ds.y_seq[i], ds.class_ids[i],
                                 [p for p in pts if p != pt])
            for i, pt in enumerate(pts)}
    out = str(root / f"pt_decoding_data_{key}.pkl")
    loaders.save_pkl(data, out)
    return out


def _nn_files(root: Path) -> dict:
    """``pt_decoding_data`` pickles in ``root``: at full depth the eight
    paper patients (the subsample phase's widths and noise, T=200), at
    small depth NN_SMALL_PTS (T=40)."""
    return {"full": _decoding_pkl(root, "full", SUB_PTS, SUB_T, SUB_NOISE),
            "small": _decoding_pkl(root, "small", NN_SMALL_PTS, SUB_SMALL_T,
                                   SUB_NOISE)}


def nn_driver_launches(jacobi, cfg, widths) -> dict:
    """Launches of one ``run_train_nn`` iteration: per fold, each source's
    chol CCA fit solves its (K, K) between-view Gram (K = min(max_k, its
    channels), ``sweep_jacobi_launches``) on one matrix; for ``conv_rnn``
    per fold, every GRU layer forward in each of ``epochs`` full-batch
    train steps and the evaluation, and backward (dx formed) in each train
    step."""
    F, E, L = cfg.n_folds, cfg.epochs, cfg.n_layers
    gru = cfg.model == "conv_rnn"
    return {"gru_fwd": F * L * (E + 1) if gru else 0, "gru_wfwd": 0,
            "gru_bifwd": 0, "gru_bwd": F * L * E if gru else 0,
            "gru_wbwd": 0, "jacobi_eigh": F * sweep_jacobi_launches(
                jacobi, [min(cfg.max_k, c) for c in widths], 1)}


def _no_encoder_dropout(exp):
    """``exp._make_nn_classifier`` with the CNN-transformer's encoder
    dropout (fixed at 0.1 by the model switch) set to 0; returns the
    original."""
    make = exp._make_nn_classifier

    def make0(*a, **k):
        m = make(*a, **k)
        for block in getattr(m, "blocks", ()):
            block.dropout = block.attn.dropout = 0.0
        return m

    exp._make_nn_classifier = make0
    return make


def phase_train_nn(torch, dev, gru, jacobi, smi):
    """The NN-classifier decode driver end to end at TrainNNConfig's
    widths on the reference's data scale, for each model family: exact
    launches, the kernels' first launch of each shape against their plain
    versions, a resume with none, times, peak memory and, for conv_rnn,
    the idle share of a fold-epoch; then small depth on the card and on
    the CPU for all four families."""
    import dataclasses
    import tempfile

    import numpy as np

    from cross_patient_speech_decoding_tpu_torch.cli import experiments as exp
    from cross_patient_speech_decoding_tpu_torch.data.loaders import load_pkl
    from cross_patient_speech_decoding_tpu_torch.utils.config import (
        TrainNNConfig,
    )

    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    t0 = time.perf_counter()
    files = _nn_files(root)
    data_s = time.perf_counter() - t0
    widths = [c for pt, c in zip(SUB_PTS, SUB_CHANNELS) if pt != SUB_TARGET]
    res = {"phase": "train_nn", "nvidia_smi": smi, "config": NN_CFG,
           "widths": {f.name: f.default for f in
                      dataclasses.fields(TrainNNConfig)
                      if f.name in ("n_filters", "hidden", "d_model",
                                    "n_heads", "n_layers", "dim_ff",
                                    "kernel_size", "dropout", "max_k",
                                    "batch_size")},
           "data": "8 paper patients x 135 trials, T=200, 9 classes, "
                   "target S26 (pt_decoding_data pickle)",
           "cut": "1 iteration of 20 folds x 2 epochs (the reference: 50 "
                  "of 20 x 100)", "data_write_s": data_s, "models": {}}
    bad, all_launches = {}, {}
    for model in exp.NN_MODELS:
        cfg = TrainNNConfig(**NN_CFG, model=model, data=files["full"],
                            out=str(root / model / "nn.pkl"))
        want = nn_driver_launches(jacobi, cfg, widths)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts(gru, jacobi)
        with _NoPlainOnCuda(torch, gru, jacobi), \
                _NNProbe(torch, exp) as pr, \
                _RecordJacobi(jacobi, first_per_shape=True) as jrec, \
                _RecordGru(torch, gru) as grec:
            t0 = time.perf_counter()
            accs = exp.run_train_nn(cfg, verbose=True, device=dev)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        launches = _launch_counts(gru, jacobi)
        kept = grec.nbytes + sum(A.numel() * A.element_size()
                                 for A in jrec.batches)
        peak_raw = torch.cuda.max_memory_allocated()
        path_jacobi = {f"batch{i}_{'x'.join(map(str, A.shape))}":
                       _check_jacobi(torch, jacobi, A)
                       for i, A in enumerate(jrec.batches)}
        path_gru = _check_path_gru(gru, grec)
        del grec, jrec
        store = load_pkl(cfg.out)

        _reset_counts(gru, jacobi)
        again = exp.run_train_nn(cfg, verbose=True, device=dev)
        torch.cuda.synchronize()
        resume_launches = _launch_counts(gru, jacobi)

        step, state, batch, gen = pr.last
        prof = None
        if model == "conv_rnn":
            _, prof = profile_call(torch, lambda: step(state, batch, gen))
            prof["device_ms_by_kernel"] = dict(list(
                prof["device_ms_by_kernel"].items())[:6])
        pr.last = None
        del step, state, batch, gen
        losses = [float(v) for v in pr.losses]
        step_ms = statistics.median(pr.step_s) * 1e3
        r = {"accs": accs[0].tolist(), "mean_acc": float(accs.mean()),
             "chance": 1.0 / 9, "launches": launches,
             "launches_expected": want, "iteration_wall_s": wall_s,
             "pooled_rows_min_max": [min(pr.rows), max(pr.rows)],
             "fold_epochs": len(pr.step_s), "fold_evals": len(pr.eval_s),
             "ms_per_fold_epoch": step_ms,
             "fold_epoch_ms_min_max": [min(pr.step_s) * 1e3,
                                       max(pr.step_s) * 1e3],
             "train_samples_per_s": statistics.median(pr.rows)
             / (step_ms / 1e3),
             "source_pca_ms": sum(pr.pca_src_s) * 1e3,
             "fold_features_ms": {
                 "pca": sum(pr.pca_tar_s) * 1e3 / cfg.n_folds,
                 "cca": sum(pr.cca_s) * 1e3 / cfg.n_folds},
             "eval_ms": statistics.median(pr.eval_s) * 1e3,
             "peak_mem_gb": (peak_raw - kept) / 1e9,
             "peak_mem_gb_with_kept_copies": peak_raw / 1e9,
             "losses_first_last": [losses[0], losses[-1]],
             "path_kernels_vs_plain": {
                 "jacobi_eigh": path_jacobi, "gru": path_gru,
                 "tolerance": {"jacobi": "bit for bit (_jacobi_ok)",
                               "gru_fwd_abs": KERNEL_ATOL,
                               "gru_bwd_rel": GRAD_RTOL}},
             "results_keys": sorted(store),
             "results_params_are_the_config": set(store["params"]) == {
                 f.name for f in dataclasses.fields(TrainNNConfig)},
             "resume_accs_same": np.array_equal(again, accs),
             "resume_launches": resume_launches}
        if prof is not None:
            r["fold_epoch_profile"] = prof
        res["models"][model] = r
        all_launches[model] = launches
        b = {}
        if launches != want:
            b["launches"] = launches
        b.update({f"path_{k}": v for k, v in path_jacobi.items()
                  if not _jacobi_ok(k, v)})
        b.update({f"path_{k}": v for k, v in path_gru.items()
                  if not v["ok"]})
        kinds = sorted({label.split("_")[1] for label in path_gru})
        dx = all(label.endswith("need_dx1") for label in path_gru
                 if label.startswith("gru_bwd"))
        if (len(path_jacobi) != 1
                or kinds != (["bwd", "fwd"] if want["gru_fwd"] else [])
                or not dx):
            b["path_recorded"] = [len(path_jacobi), list(path_gru)]
        if not (np.isfinite(losses).all() and accs.shape == (1, cfg.n_folds)
                and np.isfinite(accs).all() and 0.0 <= accs.min()
                and accs.max() <= 1.0):
            b["accs"] = accs.tolist()
        if not (r["results_keys"] == ["accs", "params"]
                and r["results_params_are_the_config"]
                and len(store["accs"]) == 1):
            b["results"] = r["results_keys"]
        if not r["resume_accs_same"] or any(resume_launches.values()):
            b["resume"] = resume_launches
        bad.update({f"{model}_{k}": v for k, v in b.items()})
        del pr
    t0 = time.perf_counter()
    small = _nn_small(torch, dev, exp, files["small"])
    small["s"] = time.perf_counter() - t0
    res["small_depth_card_vs_cpu"] = small
    emit(res)
    tmp.cleanup()
    bad.update({k: v for k, v in small.items()
                if k.endswith("_ok") and v is not True})
    if bad:
        raise RuntimeError(f"train_nn checks failed: {list(bad)}")
    return {name: {f"launches_train_nn_{m}_iteration": n[name]
                   for m, n in all_launches.items() if n[name]}
            for name in ("gru_fwd", "gru_bwd", "jacobi_eigh")}


def _nn_small(torch, dev, exp, data):
    """Small depth (NN_SMALL, dropout 0, the CNN-transformer's encoder
    dropout 0 too) for each family on the card, then on the CPU from the
    same file and the same initial weights (the models draw them on the
    host from the seed), the CPU's Jacobi on the kernel's route through
    its plain version: every fold-epoch's training loss within
    NN_LOSS_RTOL, fold accuracies equal up to the test rows whose top two
    logits the CPU's model leaves within NN_DECIDED."""
    import numpy as np

    from cross_patient_speech_decoding_tpu_torch.utils.config import (
        TrainNNConfig,
    )

    out = {"config": NN_SMALL, "patients": list(NN_SMALL_PTS),
           "loss_rtol": NN_LOSS_RTOL, "decided_rtol": NN_DECIDED}
    make = _no_encoder_dropout(exp)
    try:
        for model in exp.NN_MODELS:
            cfg = TrainNNConfig(**NN_SMALL, model=model, data=data,
                                target_pt=SUB_TARGET, out="")
            with _NNProbe(torch, exp, timed=False) as card:
                acc_g = exp.run_train_nn(cfg, False, dev)
                torch.cuda.synchronize()
            with _PlainJacobiOnCpu(), _NNProbe(torch, exp, timed=False,
                                               cpu_slack=True) as cpu:
                acc_c = exp.run_train_nn(cfg, False, "cpu")
            l_g = np.asarray([float(v) for v in card.losses])
            l_c = np.asarray([float(v) for v in cpu.losses])
            rel = (np.abs(l_g - l_c) / np.abs(l_c)).tolist()
            r = {"loss_rel_err_max": max(rel), "accs_card": acc_g.tolist(),
                 "accs_cpu": acc_c.tolist(), "acc_slack": cpu.slack}
            r["losses_ok"] = (len(l_g) == len(l_c) > 0
                              and max(rel) <= NN_LOSS_RTOL)
            r["accs_ok"] = bool(len(cpu.slack) == acc_g.size and all(
                abs(g - c) <= s + 1e-6 for g, c, s in
                zip(acc_g.ravel(), acc_c.ravel(), cpu.slack)))
            out[model] = r
            out[f"{model}_ok"] = r["losses_ok"] and r["accs_ok"]
    finally:
        exp._make_nn_classifier = make
    return out


class _ReproProbe:
    """Wrappers around what one ``cpsd reproduce`` call runs, for a block:
    every driver a job calls (synchronised and timed, with the launch
    counts it added), ``run_manifest``'s summary, the per-epoch records
    handed to ``append_metrics`` for a TensorBoard log, and, once, the
    pooled features and labels of the first fold of the first sep_align
    decode (``pooled._pool_and_classify``: the target's PCA latents and
    each source's CCA-mapped latents, flattened)."""

    DRIVERS = ("run_svm_decode", "run_train_seq2seq", "run_train_nn",
               "run_train_ctc")

    def __init__(self, torch, gru, jacobi, capture=False):
        from cross_patient_speech_decoding_tpu_torch.cli import (
            experiments,
            reproduce,
        )
        from cross_patient_speech_decoding_tpu_torch.decoders import pooled
        from cross_patient_speech_decoding_tpu_torch.train import loops

        self.torch, self.gru, self.jacobi = torch, gru, jacobi
        self.exp, self.rep, self.pooled, self.loops = (
            experiments, reproduce, pooled, loops)
        self.capture = capture
        self.jobs, self.summaries, self.tb_records = [], [], []
        self.pooled_feats = None
        self._sep_align = False

    def __enter__(self):
        torch, probe = self.torch, self
        self.saved = [(self.exp, n) for n in self.DRIVERS] + [
            (self.rep, "run_manifest"), (self.loops, "append_metrics"),
            (self.pooled, "_pool_and_classify")]
        self.saved = [(m, n, getattr(m, n)) for m, n in self.saved]
        orig = {n: f for _, n, f in self.saved}

        def driver(name):
            def run(cfg, verbose=True, device=None):
                probe._sep_align = (name == "run_svm_decode"
                                    and cfg.strategy == "sep_align"
                                    and not cfg.chance)
                torch.cuda.synchronize()
                n0 = _launch_counts(probe.gru, probe.jacobi)
                t0 = time.perf_counter()
                out = orig[name](cfg, verbose=verbose, device=device)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                n1 = _launch_counts(probe.gru, probe.jacobi)
                probe.jobs.append({"driver": name, "out": cfg.out,
                                   "wall_s": wall, "device": str(device),
                                   "launches": {k: n1[k] - n0[k]
                                                for k in n1}})
                probe._sep_align = False
                return out
            return run

        def run_manifest(*a, **k):
            s = orig["run_manifest"](*a, **k)
            probe.summaries.append(s)
            return s

        def append_metrics(path, rec, fmt="csv"):
            if fmt == "tb":
                probe.tb_records.append((path, dict(rec)))
            return orig["append_metrics"](path, rec, fmt)

        def pool(tar_feats, tar_y, train_mask, test_mask, cross_feats,
                 cross_ys, cfg, **kw):
            if probe.capture and probe._sep_align and \
                    probe.pooled_feats is None:
                probe.pooled_feats = (
                    torch.cat([tar_feats[0]] + [f[0] for f in cross_feats]),
                    torch.cat([tar_y] + list(cross_ys)))
            return orig["_pool_and_classify"](
                tar_feats, tar_y, train_mask, test_mask, cross_feats,
                cross_ys, cfg, **kw)

        for name in self.DRIVERS:
            setattr(self.exp, name, driver(name))
        self.rep.run_manifest = run_manifest
        self.loops.append_metrics = append_metrics
        self.pooled._pool_and_classify = pool
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def _repro_manifest(root: Path, svm_data: str, nn_data: str) -> dict:
    """The phase's manifest: jobs of manifests/paper.yaml at target S26
    (svm-decode sep_align and joint_pca and svm-chance on ``svm_data``,
    train-seq2seq pooled, train-nn conv_rnn on ``nn_data``, train-ctc
    aligned), each at the data scale of the earlier phase for its driver;
    results under ``root``."""
    res = str(root / "results")
    pt = {"target_pt": [REPRO_TARGET]}
    return {
        "defaults": {"data": "synthetic", "seed": 0},
        "jobs": [
            {"command": "svm-decode",
             "matrix": {**pt, "strategy": ["sep_align", "joint_pca"]},
             "overrides": {**REPRO_SVM, "data": svm_data,
                           "out": res + "/svm/{target_pt}_{strategy}.pkl"}},
            {"command": "svm-decode", "name": "svm-chance", "matrix": pt,
             "overrides": {**REPRO_SVM, "data": svm_data, "chance": True,
                           "out": res + "/svm/{target_pt}_chance.pkl"}},
            {"command": "train-seq2seq",
             "matrix": {**pt, "pooled": [True]},
             "overrides": {**REPRO_S2S, "out": res + "/seq2seq/"
                           "{target_pt}_pooled_{pooled}.pkl"}},
            {"command": "train-nn", "matrix": {**pt, "model": ["conv_rnn"]},
             "overrides": {**REPRO_NN, "data": nn_data,
                           "out": res + "/nn/{target_pt}_{model}.pkl"}},
            {"command": "train-ctc",
             "matrix": {**pt, "context": ["aligned"]},
             "overrides": {**REPRO_CTC,
                           "out": res + "/ctc/{target_pt}_{context}.pkl"}},
        ],
    }


def _repro_want(jacobi, cfg, widths, ctc_probe) -> dict:
    """Launches of one job's run, as the earlier phases derive them:
    svm-decode 7 ``jacobi_eigh`` an iteration of sep_align (and of its
    chance control: the same decode on permuted labels), none for
    joint_pca (its PCA is one SVD); the seq2seq iteration's
    (``s2s_driver_launches``); the NN iteration's (``nn_driver_launches``);
    the CTC driver's one ``gru_wfwd`` and n_layers - 1 ``gru_fwd`` a
    forward, one ``gru_wbwd`` and n_layers - 1 ``gru_bwd`` a train step,
    one ``jacobi_eigh`` a cross patient (``_DriverProbe``'s counts)."""
    from cross_patient_speech_decoding_tpu_torch.utils import config as C

    zero = dict.fromkeys(("gru_fwd", "gru_wfwd", "gru_bifwd", "gru_bwd",
                          "gru_wbwd", "jacobi_eigh"), 0)
    if isinstance(cfg, C.SVMDecodeConfig):
        per_it = (0 if cfg.strategy == "joint_pca" else svm_jacobi_launches(
            {"synth_patients": len(SUB_PTS), "n_folds": cfg.n_folds,
             "fold_batch": cfg.fold_batch}))
        return {**zero, "jacobi_eigh": per_it * cfg.n_iter}
    if isinstance(cfg, C.TrainSeq2SeqConfig):
        return {**zero, **s2s_driver_launches(
            {"n_folds": cfg.n_folds, "epochs": cfg.epochs,
             "synth_patients": cfg.synth_patients})}
    if isinstance(cfg, C.TrainNNConfig):
        return nn_driver_launches(jacobi, cfg, widths)
    n_fwd = ctc_probe.fwd["train"] + ctc_probe.fwd["eval"]
    return {**zero, "gru_wfwd": n_fwd,
            "gru_fwd": (cfg.n_layers - 1) * n_fwd,
            "gru_wbwd": ctc_probe.steps,
            "gru_bwd": (cfg.n_layers - 1) * ctc_probe.steps,
            "jacobi_eigh": cfg.synth_patients - 1}


def _tb_frames(path) -> list:
    """The payloads of a TFRecord file, with both CRCs of each record
    checked (tests/test_tb_events.py:_read_records)."""
    import struct

    from cross_patient_speech_decoding_tpu_torch.utils.tb_events import (
        _masked_crc,
    )

    data = Path(path).read_bytes()
    out, i = [], 0
    while i < len(data):
        (ln,) = struct.unpack("<Q", data[i:i + 8])
        (crc_len,) = struct.unpack("<I", data[i + 8:i + 12])
        if crc_len != _masked_crc(data[i:i + 8]):
            raise ValueError(f"{path}: length CRC at byte {i}")
        payload = data[i + 12:i + 12 + ln]
        (crc_pay,) = struct.unpack("<I", data[i + 12 + ln:i + 16 + ln])
        if crc_pay != _masked_crc(payload):
            raise ValueError(f"{path}: payload CRC at byte {i}")
        out.append(payload)
        i += 16 + ln
    return out


def _tb_check(np, probe, ctc_out: str, run_name: str) -> dict:
    """The CTC job's event file holds the file-version record and one
    record an epoch run, each with both CRCs right; TensorBoard's own
    reader (``EventAccumulator``) gives, for every tag of the records
    ``append_metrics`` was handed, one scalar an epoch at that epoch's
    step with that record's value rounded to float32."""
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    run_dir = Path(ctc_out).parent / "logs" / run_name / "iter000"
    files = sorted(run_dir.glob("events.out.tfevents.*"))
    recs = [r for p, r in probe.tb_records if Path(p) == run_dir]
    r = {"files": [f.name for f in files], "records": len(recs)}
    if len(files) != 1 or not recs:
        r["ok"] = False
        return r
    frames = _tb_frames(files[0])
    acc = EventAccumulator(str(run_dir))
    acc.Reload()
    got = {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
           for tag in acc.Tags()["scalars"]}
    want = {tag: [(int(rec["epoch"]), float(np.float32(rec[tag])))
                  for rec in recs]
            for tag, v in recs[0].items()
            if tag != "epoch" and isinstance(v, (int, float))}
    r["frames"] = len(frames)
    r["tags"] = sorted(got)
    r["steps"] = sorted({s for v in got.values() for s, _ in v})
    r["ok"] = (len(frames) == 1 + len(recs)
               and b"brain.Event:2" in frames[0] and got == want
               and r["steps"] == list(range(len(recs))))
    return r


def _snapshot(root: Path) -> dict:
    """Every file under ``root``: (bytes, mtime in ns)."""
    return {str(p): (p.read_bytes(), p.stat().st_mtime_ns)
            for p in sorted(root.rglob("*")) if p.is_file()}


def _repro_run(torch, gru, jacobi, main, argv, capture=False):
    """One ``cpsd reproduce`` call (``cli.main.main(argv)``) with the
    launch counts zeroed just before and read just after. Returns (probe,
    wall s, launches)."""
    torch.cuda.synchronize()
    _reset_counts(gru, jacobi)
    with _ReproProbe(torch, gru, jacobi, capture) as pr:
        t0 = time.perf_counter()
        rc = main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"cpsd {argv} returned {rc}")
    return pr, wall, _launch_counts(gru, jacobi)


def _kl(np, p, y) -> float:
    """KL(P || Q) of an embedding ``y`` (float64 on the host)."""
    p = np.asarray(p, np.float64)
    y = np.asarray(y, np.float64)
    d2 = ((y[:, None, :] - y[None, :, :]) ** 2).sum(-1)
    w = 1.0 / (1.0 + d2)
    np.fill_diagonal(w, 0.0)
    q = w / w.sum()
    m = ~np.eye(len(y), dtype=bool)
    return float((p[m] * np.log(p[m] / np.maximum(q[m], 1e-300))).sum())


def _repro_analysis(torch, np, dev, x, labels) -> dict:
    """The analysis library on the card against the CPU from the same
    pooled features: cluster scores, alignment quality of each source's
    condition averages against the target's, and t-SNE (affinities, the
    first steps from the CPU's state, the whole run's final KL, with its
    time and idle share)."""
    from cross_patient_speech_decoding_tpu_torch.analysis import cluster
    from cross_patient_speech_decoding_tpu_torch.ops import metrics

    xc, yc = x.cpu(), labels.cpu()
    out = {"points": list(x.shape), "rtol": REPRO_ANALYSIS_RTOL}

    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-30)

    for name in ("calinski_harabasz", "davies_bouldin"):
        fn = getattr(cluster, name)
        g, c = fn(x, labels, device=dev), fn(xc, yc, device="cpu")
        out[name] = {"card": g, "cpu": c, "rel_err": rel(g, c)}
        out[f"{name}_ok"] = rel(g, c) <= REPRO_ANALYSIS_RTOL
    # the silhouette samples and the reference's score (the mean of the
    # positive samples) to REPRO_ANALYSIS_RTOL of the silhouette's range
    # [-1, 1] (tests/test_torch_analysis.py's bound for a sample): a sample
    # is (b - a) / max(a, b), and the card's and the CPU's float32 mean
    # distances a and b part at a fixed share of max(a, b), whatever the
    # sample's size (on these noisy latents the samples lie within
    # +-0.005, so an error relative to them measures the cancellation of b
    # - a, not the card). Which samples are positive is not continuous: a
    # sample whose sign differs must lie within the samples' error of 0,
    # and the score is compared over the CPU's positive samples
    s_g = cluster.silhouette_samples(x, labels, device=dev)
    s_c = cluster.silhouette_samples(xc, yc, device="cpu")
    err = float(np.abs(s_g - s_c).max())
    flips = (s_g > 0) != (s_c > 0)
    pos = s_c > 0
    g = cluster.silhouette_positive_mean(x, labels, device=dev)
    c = cluster.silhouette_positive_mean(xc, yc, device="cpu")
    out["silhouette_samples"] = {
        "max_abs_err": err, "cpu_range": [float(s_c.min()),
                                          float(s_c.max())],
        "sign_flips": int(flips.sum()),
        "flips_max_abs_cpu": float(np.abs(s_c[flips]).max(initial=0.0))}
    out["silhouette_samples_ok"] = (
        err <= REPRO_ANALYSIS_RTOL
        and bool((np.abs(s_c[flips]) <= err).all()))
    same_set = abs(float(s_g[pos].mean()) - float(s_c[pos].mean()))
    out["silhouette_positive_mean"] = {"card": g, "cpu": c,
                                       "abs_err": abs(g - c),
                                       "cpu_positive_set_abs_err": same_set}
    out["silhouette_positive_mean_ok"] = same_set <= REPRO_ANALYSIS_RTOL

    # alignment quality: class-averaged (T, K) trajectories of each
    # patient, each source against the target at the matched conditions
    # and at mismatched ones (source condition c + 1 against target c, the
    # null: its r lie near 0 and its p spread over (0, 1); on cleanly
    # aligned latents the matched p-values of 6400 points are 0 in
    # float64)
    n_pt = len(SUB_PTS)
    per = xc.shape[0] // n_pt
    T = SUB_T
    X3 = xc.reshape(xc.shape[0], T, -1)
    n_cls = int(yc.max()) + 1
    cav = torch.stack([torch.stack([
        X3[i * per:(i + 1) * per][yc[i * per:(i + 1) * per] == c].mean(0)
        for c in range(n_cls)]) for i in range(n_pt)])  # (P, C, T, K)
    r_g, p_g = metrics.pt_corr_multi(cav[0].to(dev),
                                     [v.to(dev) for v in cav[1:]],
                                     p_vals=True)
    r_c, p_c = metrics.pt_corr_multi(cav[0], list(cav[1:]), p_vals=True)
    null = [v.roll(1, 0) for v in cav[1:]]
    rn_g, pn_g = metrics.pt_corr_multi(cav[0].to(dev),
                                       [v.to(dev) for v in null],
                                       p_vals=True)
    rn_c, pn_c = metrics.pt_corr_multi(cav[0], null, p_vals=True)
    d_g = torch.stack([metrics.pt_corr_dims(cav[0].to(dev), v.to(dev))
                       for v in cav[1:]])
    d_c = torch.stack([metrics.pt_corr_dims(cav[0], v) for v in cav[1:]])
    for name, g, c in (("pt_corr_r", r_g, r_c), ("pt_corr_p", p_g, p_c),
                       ("pt_corr_null_r", rn_g, rn_c),
                       ("pt_corr_null_p", pn_g, pn_c),
                       ("pt_corr_dims", d_g, d_c)):
        err = float((g.cpu() - c).abs().max())
        scale = 1.0 if name.endswith("_p") else float(c.abs().max())
        out[name] = {"max_abs_err": err, "scale": scale,
                     "cpu_range": [float(c.min()), float(c.max())]}
        out[f"{name}_ok"] = err <= REPRO_ANALYSIS_RTOL * scale
    inside = [float(v) for v in torch.cat([p_c.flatten(), pn_c.flatten()])
              if 0.0 < v < 1.0]
    out["pt_corr_p_inside"] = {"n": len(inside), "of": p_c.numel() * 2,
                               "min": min(inside, default=None),
                               "max": max(inside, default=None)}
    out["pt_corr_p_inside_ok"] = len(inside) > 0

    # t-SNE: the affinities, each of the first steps from the CPU's state
    # (the free-running loops part within ~10 steps: float32 rounding grows
    # ~1000x every 10 iterations), the whole run's final KL
    n = x.shape[0]
    perp = min(30.0, (n - 1) / 3.0)
    lr = max(n / 48.0, 50.0)
    ex = max(50, REPRO_TSNE_ITERS // 4)
    p_c = cluster._tsne_p(xc, perp)
    p_g = cluster._tsne_p(x, perp)
    p_err = float((p_g.cpu() - p_c).abs().max() / p_c.abs().max())
    out["tsne_p_rel_err"] = p_err
    out["tsne_p_ok"] = p_err <= REPRO_TSNE_P_TOL
    y0 = cluster._tsne_y0(n, 2, 0)
    off_c = 1.0 - torch.eye(n)
    off_g = off_c.to(dev)
    state = (y0, torch.zeros_like(y0), torch.ones_like(y0))
    p_ex, step_err, free_err = p_c * 12.0, [], []
    for k in range(REPRO_TSNE_STEPS):
        nxt = cluster._tsne_step(*state, p_ex, off_c, 0.5, lr)
        got = cluster._tsne_step(*(s.to(dev) for s in state), p_ex.to(dev),
                                 off_g, 0.5, lr)
        step_err.append(float((got[0].cpu() - nxt[0]).abs().max()
                              / nxt[0].abs().max()))
        state = nxt
        free = cluster._tsne_run(p_g, y0.to(dev), k + 1, ex, lr).cpu()
        free_err.append(float((free - nxt[0]).abs().max()
                              / nxt[0].abs().max()))
    out["tsne_step_rel_err"] = step_err
    out["tsne_free_running_rel_err"] = free_err
    out["tsne_steps_ok"] = max(step_err) <= REPRO_TSNE_STEP_TOL
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y_g = cluster.tsne_embed(x, n_iter=REPRO_TSNE_ITERS, device=dev)
    tsne_ms = (time.perf_counter() - t0) * 1e3
    _, prof = profile_call(torch, lambda: cluster.tsne_embed(
        x, n_iter=REPRO_TSNE_ITERS, device=dev))
    t0 = time.perf_counter()
    y_c = cluster.tsne_embed(xc, n_iter=REPRO_TSNE_ITERS, device="cpu")
    cpu_ms = (time.perf_counter() - t0) * 1e3
    kl_g, kl_c = _kl(np, p_g.cpu(), y_g), _kl(np, p_c, y_c)
    out["tsne"] = {"iterations": REPRO_TSNE_ITERS, "ms": tsne_ms,
                   "cpu_ms": cpu_ms, "kl_card": kl_g, "kl_cpu": kl_c,
                   "kl_rel_err": rel(kl_g, kl_c),
                   "idle_share": prof["device_idle_share"],
                   "profiled_wall_ms": prof["wall_ms"],
                   "device_busy_ms": prof["device_busy_ms"],
                   "device_ms_by_kernel": dict(list(
                       prof["device_ms_by_kernel"].items())[:6])}
    out["tsne_kl_ok"] = (bool(np.isfinite(y_g).all())
                         and rel(kl_g, kl_c) <= REPRO_TSNE_KL_RTOL)
    return out


def _repro_analyze(torch, np, exp, svm_outs: dict, root: Path) -> dict:
    """``cpsd analyze`` over the three svm-decode results on the card
    machine, against the same call on a copy of the inputs and against
    ``scipy.stats.wilcoxon`` on the same per-iteration means."""
    import shutil

    from scipy import stats

    from cross_patient_speech_decoding_tpu_torch.cli import main as cli
    from cross_patient_speech_decoding_tpu_torch.utils.config import (
        AnalyzeConfig,
    )

    inputs = ",".join(f"{k}={v}" for k, v in svm_outs.items())
    got = []
    orig = exp.run_analyze

    def keep(cfg, verbose=True):
        got.append(orig(cfg, verbose))
        return got[-1]

    exp.run_analyze = keep
    try:
        t0 = time.perf_counter()
        rc = cli.main(["analyze", f"inputs={inputs}"])
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        exp.run_analyze = orig
    (res,) = got
    copy = root / "cpu_copy"
    copy.mkdir()
    inputs_c = ",".join(f"{k}={shutil.copy(v, copy / f'{k}.pkl')}"
                        for k, v in svm_outs.items())
    again = exp.run_analyze(AnalyzeConfig(inputs=inputs_c), verbose=False)
    rows = [(r.a, r.b, r.statistic, r.pvalue, r.pvalue_fdr, r.significant)
            for r in res["pairwise"]]
    rows_c = [(r.a, r.b, r.statistic, r.pvalue, r.pvalue_fdr, r.significant)
              for r in again["pairwise"]]
    scipy_err = []
    for r in res["pairwise"]:
        a, b = res["groups"][r.a], res["groups"][r.b]
        if np.all(a == b):
            # no nonzero difference: the port gives NaN (tests/
            # test_analysis.py), scipy NaN or, in older versions, raises
            scipy_err.append(0.0 if np.isnan([r.statistic, r.pvalue]).all()
                             else float("inf"))
            continue
        # the port's rule for method "auto" (the JAX package's and older
        # scipy's): exact without ties or zeros up to n = 50, else the
        # tie-corrected normal approximation (newer scipy goes exact with
        # ties too)
        d = a - b
        ad = np.abs(d[d != 0])
        exact = ad.size == d.size <= 50 and np.unique(ad).size == ad.size
        w = stats.wilcoxon(a, b, method="exact" if exact else "approx")
        scipy_err.append(max(abs(r.pvalue - w.pvalue),
                             abs(r.statistic - w.statistic)))

    def same(u, v):
        return np.array_equal(np.asarray(u, np.float64),
                              np.asarray(v, np.float64), equal_nan=True)

    a, ac = res["anova"], again["anova"]
    same_anova = (a is not None and ac is not None
                  and same(a[1:3], ac[1:3])
                  and same(a.tukey_p, ac.tukey_p)
                  and same(a.tukey_statistic, ac.tukey_statistic))
    same_rows = ([r[:2] + r[5:] for r in rows] == [r[:2] + r[5:]
                                                    for r in rows_c]
                 and same([r[2:5] for r in rows], [r[2:5] for r in rows_c]))
    # a row whose p is neither NaN nor the least that n pairs allow (2 /
    # 2^n, every difference of one sign), so that the match with scipy
    # holds the statistic's distribution, not only its tail
    n = min(len(v) for v in res["groups"].values())
    open_rows = [r[:2] for r in rows
                 if np.isfinite(r[3]) and r[3] > 2.0 / 2 ** n * (1 + 1e-9)]
    return {"rc": rc, "ms": ms, "rows": rows,
            "anova": None if a is None else [a.f_statistic, a.anova_p],
            "group_means": {k: float(v.mean())
                            for k, v in res["groups"].items()},
            "groups": {k: [float(x) for x in v]
                       for k, v in res["groups"].items()},
            "rows_above_least_p": open_rows,
            "scipy_wilcoxon_max_err": float(max(scipy_err)),
            "ok": bool(rc == 0 and len(rows) == 3 and same_rows
                       and same_anova and max(scipy_err) <= 1e-12
                       and open_rows)}


def phase_reproduce(torch, dev, gru, jacobi, smi):
    """The paper-matrix runner end to end: ``cpsd reproduce`` over jobs of
    manifests/paper.yaml (every ported driver, so all six kernels) with
    exact launches a job, a resume and a read-only dry run; ``cpsd
    analyze`` over the svm-decode results; the analysis library on the
    card against the CPU."""
    import dataclasses
    import tempfile

    import numpy as np

    from cross_patient_speech_decoding_tpu_torch.cli import experiments as exp
    from cross_patient_speech_decoding_tpu_torch.cli import main as cli
    from cross_patient_speech_decoding_tpu_torch.cli import reproduce as rep
    from cross_patient_speech_decoding_tpu_torch.data.loaders import load_pkl

    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    t0 = time.perf_counter()
    files = _nn_files(root)
    svm_data = _decoding_pkl(root, "svm", SUB_PTS, SUB_T, REPRO_SVM_NOISE)
    data_s = time.perf_counter() - t0
    widths = [c for pt, c in zip(SUB_PTS, SUB_CHANNELS) if pt != SUB_TARGET]
    manifest = _repro_manifest(root, svm_data, files["full"])
    mpath = root / "paper_s26.yaml"
    mpath.write_text(json.dumps(manifest, indent=1))  # PyYAML reads JSON
    jobs = rep.expand_manifest(manifest)
    cfgs = {}
    for job in jobs:
        _, _, cfg = rep._job_config(job["command"], job["values"],
                                    job["soft_keys"])
        cfgs[cfg.out] = (job["label"], cfg)
    argv = ["reproduce", f"manifest={mpath}"]

    # run 1: the matrix, counts zeroed just before and read just after;
    # the Jacobi kernel's first batch of each shape and the first GRU
    # launch of each shape are kept (copies held on the card, so the peak
    # they add is taken out of peak_mem_gb)
    torch.cuda.reset_peak_memory_stats()
    with _NoPlainOnCuda(torch, gru, jacobi), \
            _DriverProbe(torch, exp) as ctc_pr, \
            _RecordJacobi(jacobi, first_per_shape=True) as jrec, \
            _RecordGru(torch, gru) as grec:
        pr, wall_s, launches = _repro_run(torch, gru, jacobi, cli.main, argv,
                                          capture=True)
    kept = grec.nbytes + sum(A.numel() * A.element_size()
                             for A in jrec.batches)
    peak_raw = torch.cuda.max_memory_allocated()
    ctc_pr.fit_args = None
    bad, per_job = {}, {}

    # every kernel launch kept from run 1 against its plain version on the
    # same inputs
    path_jacobi = {f"batch{i}_{'x'.join(map(str, A.shape))}":
                   _check_jacobi(torch, jacobi, A)
                   for i, A in enumerate(jrec.batches)}
    path_gru = _check_path_gru(gru, grec)
    del grec, jrec
    bad.update({f"path jacobi {k}": v for k, v in path_jacobi.items()
                if not _jacobi_ok(k, v)})
    bad.update({f"path gru {k}": v for k, v in path_gru.items()
                if not v["ok"]})
    want_total = dict.fromkeys(launches, 0)
    for rec in pr.jobs:
        label, cfg = cfgs[rec["out"]]
        want = _repro_want(jacobi, cfg, widths, ctc_pr)
        per_job[label] = {"wall_s": rec["wall_s"], "device": rec["device"],
                          "launches": rec["launches"],
                          "launches_expected": want}
        for k in want_total:
            want_total[k] += want[k]
        if rec["launches"] != want:
            bad[f"launches {label}"] = rec["launches"]
    summary = pr.summaries[-1] if pr.summaries else {}
    if not (len(pr.jobs) == len(jobs) == summary.get("ran")
            and not summary.get("failed")):
        bad["run1"] = [summary, len(pr.jobs)]
    if launches != want_total or not all(launches.values()):
        bad["launches"] = launches
    if any(rec["device"] != "cuda:0" for rec in pr.jobs):
        bad["devices"] = [rec["device"] for rec in pr.jobs]
    jobs_s = sum(rec["wall_s"] for rec in pr.jobs)
    svm = {c.strategy if not c.chance else "chance": c.out
           for _, c in cfgs.values() if hasattr(c, "strategy")}
    ctc_cfg = next(c for _, c in cfgs.values() if hasattr(c, "context"))
    tb = _tb_check(np, pr, ctc_cfg.out,
                   f"{ctc_cfg.target_pt}_{exp._CONTEXT_NAMES[ctc_cfg.context]}"
                   "_ctcRnn")
    if not tb["ok"]:
        bad["tb"] = tb
    x, labels = pr.pooled_feats
    del pr

    # the sep_align job against a direct run_svm_decode of its config
    _, sep_cfg = cfgs[svm["sep_align"]]
    direct = exp.run_svm_decode(dataclasses.replace(
        sep_cfg, out=str(root / "direct" / "svm.pkl")), verbose=False,
        device=dev)
    job_accs = np.stack(load_pkl(sep_cfg.out)["accs"])
    same_direct = bool(np.array_equal(direct, job_accs))
    if not same_direct:
        bad["sep_align_vs_direct"] = float(np.abs(direct - job_accs).max())

    # run 2: the same manifest resumes every job, no launch
    pr2, wall2, launches2 = _repro_run(torch, gru, jacobi, cli.main, argv)
    s2 = pr2.summaries[-1] if pr2.summaries else {}
    if (pr2.jobs or any(launches2.values()) or s2.get("skipped") != len(jobs)
            or wall2 >= REPRO_RESUME_S):
        bad["run2"] = [s2, launches2, wall2]

    # run 3: a dry run of the chance job reads and writes nothing
    before = _snapshot(root / "results")
    pr3, wall3, launches3 = _repro_run(
        torch, gru, jacobi, cli.main, argv + ["dry_run=true", "only=chance"])
    s3 = pr3.summaries[-1] if pr3.summaries else {}
    read_only = _snapshot(root / "results") == before
    if (pr3.jobs or any(launches3.values()) or not read_only
            or s3.get("filtered") != len(jobs) - 1 or s3.get("skipped") != 1):
        bad["run3"] = [s3, launches3, read_only]
    del before

    analyze = _repro_analyze(torch, np, exp, svm, root)
    if not analyze["ok"]:
        bad["analyze"] = analyze
    analysis = _repro_analysis(torch, np, dev, x, labels)
    bad.update({k: analysis.get(k[:-3], v) for k, v in analysis.items()
                if k.endswith("_ok") and v is not True})
    res = {"phase": "reproduce", "nvidia_smi": smi,
           "manifest": manifest, "reduced": REPRO_REDUCED,
           "data_write_s": data_s, "jobs": per_job,
           "run_wall_s": wall_s, "jobs_wall_s": jobs_s,
           "matrix_overhead_s": wall_s - jobs_s,
           "matrix_overhead_share": (wall_s - jobs_s) / jobs_s,
           "launches": launches, "launches_expected": want_total,
           "peak_mem_gb": (peak_raw - kept) / 1e9,
           "peak_mem_gb_with_kept_copies": peak_raw / 1e9,
           "path_kernels_vs_plain": {
               "jacobi_eigh": path_jacobi, "gru": path_gru,
               "tolerance": {"jacobi": "bit for bit (_jacobi_ok)",
                             "gru_fwd_abs": KERNEL_ATOL,
                             "gru_bwd_rel": GRAD_RTOL}},
           "tensorboard": tb,
           "sep_align_equals_direct_run": same_direct,
           "resume_wall_s": wall2, "resume_launches": launches2,
           "resume_summary": s2, "dry_run_wall_s": wall3,
           "dry_run_read_only": read_only, "dry_run_summary": s3,
           "analyze": analyze, "analysis_card_vs_cpu": analysis}
    emit(res)
    tmp.cleanup()
    if bad:
        raise RuntimeError(f"reproduce checks failed: {bad}")
    return {k: {"launches_reproduce": v} for k, v in launches.items()}


# ---------------------------------------------------------------------------
# parallel (slice 17): parallel/ over torch.distributed on the one card
# ---------------------------------------------------------------------------

# world size 2 on one card: the fig_5 batch less one row, so rank 1's
# shard holds one zero-weight pad row (1000 rows a rank)
PAR_B2 = B - 1
# svm-decode sep_align at the svm_decode phase's scale (8 patients x 135
# trials, T=200, max_k 32, RBF, 20 folds: 10 a rank, in one batch), one
# fixed iteration, on the reproduce phase's noise-24 decoding pickle
# (target S26), so that accuracies vary and some trials are undecided; the
# predictions kept for the check on the decided trials
PAR_SVM = dict(strategy="sep_align", target_pt=SUB_TARGET, max_k=32,
               kernel="rbf", n_folds=20, fold_batch=20, n_iter=1, seed=0,
               save_preds=True)
PAR_SVM_JACOBI = len(SUB_PTS) - 1  # a rank's: one a source
# train-seq2seq fold-parallel at small depth: 4 folds, 2 a rank
PAR_S2S = dict(S2S_SMALL)
PAR_TIMEOUT_S = 600  # each launch's deadline


def _params_digest(torch, model) -> str:
    import hashlib

    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    return hashlib.sha256(flat.cpu().numpy().tobytes()).hexdigest()


class _TimedReduce:
    """Within the block, the host time of each gradient all-reduce of the
    sharded steps (the card synchronised before and after)."""

    def __init__(self, torch, pm):
        self.torch, self.pm, self.ms = torch, pm, []

    def __enter__(self):
        self.orig = self.pm.all_reduce_sum
        torch, orig = self.torch, self.orig

        def timed(t, mesh):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(t, mesh)
            torch.cuda.synchronize()
            self.ms.append((time.perf_counter() - t0) * 1e3)
            return out
        self.pm.all_reduce_sum = timed
        return self

    def __exit__(self, *exc):
        self.pm.all_reduce_sum = self.orig


def _par_ctc(torch, dev, gru, jacobi, pm, mesh, rows: int) -> dict:
    """The padded data-parallel CTC step at fig_5 width on ``rows`` rows:
    at dropout 0 against the one-device step from the same state (rank 0
    runs it), launches counted just around one step and the first launch
    of each kernel shape against its plain version; then step times at
    dropout 0.3 beside the one-device step's, the reduction's time and a
    profiled step."""
    import copy

    from cross_patient_speech_decoding_tpu_torch.models import RealtimeRNN
    from cross_patient_speech_decoding_tpu_torch.parallel import (
        make_padded_sharded_ctc_train_step,
    )
    from cross_patient_speech_decoding_tpu_torch.train import (
        create_train_state,
        make_ctc_train_step,
        make_optimizer,
    )

    batch = _fig5_batch(torch, dev, rows)
    tx = make_optimizer(1e-3, 1e-5, 100)

    def model(dropout):
        return RealtimeRNN(C, H, N_LAYERS, N_CLASSES, dropout=dropout,
                           win_size=WIN, stride=STRIDE, seed=0, device=dev)

    res = {"rows": rows, "rows_a_rank": -(-rows // mesh.size)}
    m0 = model(0.0)
    if mesh.rank == 0:
        m1 = copy.deepcopy(m0)
        _, met1 = make_ctc_train_step(m1, tx)(create_train_state(m1, tx),
                                              batch, None)
        ref = (float(met1["loss"]),
               {n: p.grad for n, p in m1.named_parameters()})
        del m1
    step = make_padded_sharded_ctc_train_step(m0, tx, mesh)
    torch.cuda.synchronize()
    _reset_counts(gru, jacobi)
    with _NoPlainOnCuda(torch, gru, jacobi), _RecordGru(torch, gru) as rec:
        _, met = step(create_train_state(m0, tx), batch, None)
        torch.cuda.synchronize()
    res["launches"] = _launch_counts(gru, jacobi)
    res["path_vs_plain"] = _check_path_gru(gru, rec)
    del rec
    res["loss"] = float(met["loss"])
    if mesh.rank == 0:
        res["loss_one_device"] = ref[0]
        res["loss_rel_err"] = (abs(res["loss"] - ref[0])
                               / max(abs(ref[0]), 1e-30))
        res["grad_max_rel_err_vs_one_device"] = _rel_errs(
            {n: p.grad for n, p in m0.named_parameters()}, ref[1])
        del ref
    res["params_digest"] = _params_digest(torch, m0)
    del m0, step

    mt = model(0.3)
    state = create_train_state(mt, tx)
    step = make_padded_sharded_ctc_train_step(mt, tx, mesh)
    gen = torch.Generator(device=dev).manual_seed(3)
    state, _ = step(state, batch, gen)  # warm-up
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step(state, batch, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    res["step_ms_runs"] = times
    res["step_ms"] = statistics.median(times)
    res["losses_finite"] = bool(torch.isfinite(met["loss"]))
    with _TimedReduce(torch, pm) as tr:
        state, _ = step(state, batch, gen)
    res["all_reduce_host_ms"] = tr.ms
    (state, _), prof = profile_call(torch, lambda: step(state, batch, gen),
                                    match="nccl")
    res["profile"] = prof
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del state, step, mt
    if mesh.rank == 0:  # the one-device step on the same rows, same card
        m1 = model(0.3)
        s1 = create_train_state(m1, tx)
        step1 = make_ctc_train_step(m1, tx)
        s1, _ = step1(s1, batch, gen)
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s1, _ = step1(s1, batch, gen)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        res["one_device_step_ms_runs"] = times
        res["one_device_step_ms"] = statistics.median(times)
        del s1, step1, m1
    pm.gather_objects(None, mesh)  # rank 1 waits for rank 0's timing
    torch.cuda.empty_cache()
    return res


class _DecoderOutputs:
    """Within the block, every decoder that ``make_cv_decoder`` returns
    keeps its inputs' target labels and test masks and its outputs."""

    def __init__(self):
        from cross_patient_speech_decoding_tpu_torch.decoders import pooled

        self.pooled, self.calls = pooled, []

    def __enter__(self):
        self.make = make = self.pooled.make_cv_decoder

        def wrapped(*a, **k):
            dec = make(*a, **k)

            def run(tar, cross, tr, te):
                out = dec(tar, cross, tr, te)
                self.calls.append((tar.y, te, out))
                return out
            return run
        self.pooled.make_cv_decoder = wrapped
        return self

    def __exit__(self, *exc):
        self.pooled.make_cv_decoder = self.make


def _par_svm(torch, dev, gru, jacobi, mesh, root: Path, data: str) -> dict:
    """``run_svm_decode`` with its 20 folds sharded over the ranks against
    the one-device run on rank 0: predictions equal on the trials the
    one-device scores decide, fold accuracies within the weight of the
    others (:func:`_held`); each rank's Jacobi launches counted just
    around the sharded run, its first Jacobi batch against the plain
    version."""
    from cross_patient_speech_decoding_tpu_torch.cli import experiments as exp
    from cross_patient_speech_decoding_tpu_torch.utils.config import (
        SVMDecodeConfig,
    )

    res = {}
    if mesh.rank == 0:
        with _ScoreProbe() as sp, _DecoderOutputs() as one:
            exp.run_svm_decode(SVMDecodeConfig(
                **PAR_SVM, data=data, out=str(root / "one" / "svm.pkl")),
                False, dev)
    torch.cuda.synchronize()
    _reset_counts(gru, jacobi)
    t0 = time.perf_counter()
    with _NoPlainOnCuda(torch, gru, jacobi), _DecoderOutputs() as two, \
            _RecordJacobi(jacobi, first_per_shape=True) as rj:
        accs = exp.run_svm_decode(SVMDecodeConfig(
            **PAR_SVM, data=data, n_devices=2,
            out=str(root / "two" / "svm.pkl")), False, dev)
        torch.cuda.synchronize()
    res["wall_s"] = time.perf_counter() - t0
    res["launches"] = _launch_counts(gru, jacobi)
    res["jacobi_first_batch"] = {
        "x".join(map(str, A.shape)): _check_jacobi(torch, jacobi, A)
        for A in rj.batches[:1]}
    res["jacobi_first_batch_ok"] = bool(rj.batches) and all(
        _jacobi_ok(k, r) for k, r in res["jacobi_first_batch"].items())
    res["mean_acc"] = float(accs.mean())
    if mesh.rank == 0:
        (y, te, (a1, p1)), = one.calls
        (_, _, (a2, p2)), = two.calls
        res["held_vs_one_device"] = _held(
            torch, y.cpu().numpy(), te.cpu().numpy(), (a2, p2), (a1, p1),
            [s.cpu() for s in sp.scores])
    return res


def _par_s2s(torch, dev, gru, jacobi, mesh, root: Path) -> dict:
    """``run_train_seq2seq`` with its 4 folds sharded over the ranks
    against the one-device run on rank 0: every fold's accuracy and every
    fold-epoch's loss bit for bit (the same folds, seeds and kernels on
    the same card); launches counted just around the sharded run."""
    from cross_patient_speech_decoding_tpu_torch.cli import experiments as exp
    from cross_patient_speech_decoding_tpu_torch.train import fold_parallel
    from cross_patient_speech_decoding_tpu_torch.utils.config import (
        TrainSeq2SeqConfig,
    )

    orig = fold_parallel._fold_epoch
    losses = []

    def recorded(*a, **k):
        loss = orig(*a, **k)
        losses.append(float(loss))
        return loss

    fold_parallel._fold_epoch = recorded
    try:
        res = {}
        if mesh.rank == 0:
            one = exp.run_train_seq2seq(TrainSeq2SeqConfig(
                **PAR_S2S, out=str(root / "one" / "s2s.csv")), False, dev)
            losses_one, losses[:] = list(losses), []
        torch.cuda.synchronize()
        _reset_counts(gru, jacobi)
        with _NoPlainOnCuda(torch, gru, jacobi):
            two = exp.run_train_seq2seq(TrainSeq2SeqConfig(
                **PAR_S2S, n_devices=2, out=str(root / "two" / "s2s.csv")),
                False, dev)
            torch.cuda.synchronize()
        res["launches"] = _launch_counts(gru, jacobi)
    finally:
        fold_parallel._fold_epoch = orig
    from cross_patient_speech_decoding_tpu_torch.parallel import mesh as pm

    every = [x for part in pm.gather_objects(losses, mesh) for x in part]
    res["accs"] = two.tolist()
    if mesh.rank == 0:
        res["accs_equal_one_device"] = one.tolist() == two.tolist()
        res["losses_equal_one_device"] = every == losses_one
        res["fold_epochs"] = len(every)
    return res


def _par_rank(kind: str, rows: int, svm_data: str = ""):
    """A rank of the parallel phase: the data-parallel CTC step, and at
    world size 2 also svm-decode, train-seq2seq and the dry run; returns
    every rank's report (gathered)."""
    import tempfile

    import torch
    import torch.distributed as dist

    from cross_patient_speech_decoding_tpu_torch import parallel
    from cross_patient_speech_decoding_tpu_torch.ops import _ext, gru, jacobi
    from cross_patient_speech_decoding_tpu_torch.parallel import dryrun
    from cross_patient_speech_decoding_tpu_torch.parallel import mesh as pm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _ext.lib()
    mesh = parallel.make_mesh()
    dev = mesh.device
    out = {"rank": mesh.rank, "size": mesh.size, "device": str(dev),
           "backend": dist.get_backend(mesh.group)}
    out["ctc"] = _par_ctc(torch, dev, gru, jacobi, pm, mesh, rows)
    if kind == "ws2":
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            out["svm"] = _par_svm(torch, dev, gru, jacobi, mesh, Path(tmp),
                                  svm_data)
            out["seq2seq"] = _par_s2s(torch, dev, gru, jacobi, mesh,
                                      Path(tmp))
            out["drivers_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["dryrun"] = dryrun.dryrun_multichip(2, verbose=False)
        out["dryrun_s"] = time.perf_counter() - t0
    return pm.gather_objects(out, mesh)


def _par_ctc_fails(name, r, rank0: bool) -> dict:
    fails = {}
    want = {**TRAIN_LAUNCHES, "jacobi_eigh": 0}
    if r["launches"] != want:
        fails[f"{name}_launches"] = r["launches"]
    bad = {k: v for k, v in r["path_vs_plain"].items() if not v["ok"]}
    if bad or not r["path_vs_plain"]:
        fails[f"{name}_path_vs_plain"] = bad or "none recorded"
    if not r["losses_finite"]:
        fails[f"{name}_finite"] = False
    if rank0:
        if not r["loss_rel_err"] <= LOSS_RTOL:
            fails[f"{name}_loss"] = r["loss_rel_err"]
        bad = {k: v for k, v in r["grad_max_rel_err_vs_one_device"].items()
               if not v <= GRAD_RTOL}
        if bad:
            fails[f"{name}_grads"] = bad
    return fails


def phase_parallel(torch, dev, gru, jacobi, smi):
    """``parallel/`` on the one H100: the padded data-parallel CTC step at
    fig_5 width on one NCCL rank, then on two gloo ranks that share the
    card (B - 1 rows: one zero-weight pad row), each against the
    one-device step; at world size 2 also svm-decode and train-seq2seq
    with their folds sharded, against their one-device runs, and the
    dry run of every sharded surface. Exact launches on every rank, every
    first launch against its plain version."""
    import tempfile

    from cross_patient_speech_decoding_tpu_torch import parallel

    tmp = tempfile.TemporaryDirectory()
    svm_data = _decoding_pkl(Path(tmp.name), "svm", SUB_PTS, SUB_T,
                             REPRO_SVM_NOISE)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    (ws1,) = parallel.launch(_par_rank, 1, ("ws1", B), devices=["cuda:0"],
                             backend="nccl", timeout=PAR_TIMEOUT_S)
    ws1_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ws2 = parallel.launch(_par_rank, 2, ("ws2", PAR_B2, svm_data),
                          devices=["cuda:0", "cuda:0"], backend="gloo",
                          timeout=PAR_TIMEOUT_S)
    ws2_s = time.perf_counter() - t0
    tmp.cleanup()
    fails = {}
    if (ws1["size"], ws1["backend"]) != (1, "nccl"):
        fails["ws1_group"] = (ws1["size"], ws1["backend"])
    fails.update(_par_ctc_fails("ws1", ws1["ctc"], True))
    for r in ws2:
        if (r["size"], r["backend"]) != (2, "gloo"):
            fails[f"ws2_rank{r['rank']}_group"] = (r["size"], r["backend"])
        fails.update(_par_ctc_fails(f"ws2_rank{r['rank']}", r["ctc"],
                                    r["rank"] == 0))
        sv, s2 = r["svm"], r["seq2seq"]
        if sv["launches"] != {**{k: 0 for k in gru.LAUNCHES},
                              "jacobi_eigh": PAR_SVM_JACOBI}:
            fails[f"ws2_rank{r['rank']}_svm_launches"] = sv["launches"]
        if not sv["jacobi_first_batch_ok"]:
            fails[f"ws2_rank{r['rank']}_svm_jacobi"] = sv[
                "jacobi_first_batch"]
    if len({r["ctc"]["params_digest"] for r in ws2}) != 1:
        fails["ws2_replicas_differ"] = [r["ctc"]["params_digest"]
                                        for r in ws2]
    r0 = ws2[0]
    if not r0["svm"]["held_vs_one_device"]["ok"]:
        fails["ws2_svm_vs_one_device"] = r0["svm"]["held_vs_one_device"]
    if not (r0["seq2seq"]["accs_equal_one_device"]
            and r0["seq2seq"]["losses_equal_one_device"]):
        fails["ws2_seq2seq_vs_one_device"] = r0["seq2seq"]
    s2s_launches = [r["seq2seq"]["launches"] for r in ws2]
    if s2s_launches[0] != s2s_launches[1] or not s2s_launches[0]["gru_bifwd"]:
        fails["ws2_seq2seq_launches"] = s2s_launches
    c1, c2 = ws1["ctc"], [r["ctc"] for r in ws2]
    res = {"phase": "parallel", "nvidia_smi": smi,
           "ws1_nccl": {**c1, "launch_s": ws1_s,
                        "step_ms_over_one_device":
                            c1["step_ms"] / c1["one_device_step_ms"],
                        "nccl_note": "device_ms_nccl is the profiled "
                                     "step's NCCL kernels: an in-place "
                                     "all-reduce over one rank may "
                                     "launch none"},
           "ws2_gloo_one_card": {
               "launch_s": ws2_s, "ctc": c2,
               "svm": [r["svm"] for r in ws2],
               "seq2seq": [r["seq2seq"] for r in ws2],
               "drivers_s": r0["drivers_s"], "dryrun": r0["dryrun"],
               "dryrun_s": r0["dryrun_s"]},
           "tolerances": {"loss_rel": LOSS_RTOL, "grad_rel": GRAD_RTOL,
                          "gru_fwd_abs": KERNEL_ATOL,
                          "gru_bwd_rel": GRAD_RTOL,
                          "jacobi": "bit for bit (_jacobi_ok)",
                          "svm": "decided trials (_held)",
                          "seq2seq": "bit for bit"},
           "failed": sorted(fails)}
    emit(res)
    if fails:
        raise RuntimeError(f"parallel checks failed: {fails}")
    rows = {k: {"launches_parallel_ctc_step_ws1": c1["launches"][k],
                "launches_parallel_ctc_step_ws2": [c["launches"][k]
                                                   for c in c2],
                "launches_parallel_seq2seq_ws2": [s[k]
                                                  for s in s2s_launches]}
            for k in gru.LAUNCHES}
    rows["jacobi_eigh"] = {
        "launches_parallel_svm_iteration_ws2": [
            r["svm"]["launches"]["jacobi_eigh"] for r in ws2],
        "launches_parallel_seq2seq_ws2": [s["jacobi_eigh"]
                                          for s in s2s_launches]}
    return rows


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
    ``gru_fwd`` (also at T=1 and across its step tile's edges),
    batch-major and time-major frames of ``gru_wfwd``; the
    same for the backward kernels, with and without dx, and ``gru_bwd`` at
    the seq2seq encoder's and decoder's shapes. Returns (forward max abs
    errors, backward max relative errors, backward bitwise repeats)."""
    fwd, bwd, rep = {}, {}, {}

    def check_bwd(key, kernel, plain):
        got = kernel()
        rep[key] = _bitwise_repeat(torch, got, kernel())
        bwd[key] = max(_bwd_errs(got, plain()).values())

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
        check_bwd(f"gru_wbwd_{layout}",
                  lambda: gru.gru_wbwd_cuda(x, hprev, dhs, *w, 6, 2),
                  lambda: gru.gru_win_backward_plain(x, hprev, dhs, *w, 6, 2))
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
                check_bwd(f"gru_bwd_{dt}_rev{int(reverse)}_dx{int(need_dx)}",
                          lambda: gru.gru_bwd_cuda(x, hprev, dhs, *w,
                                                   reverse, need_dx),
                          lambda: gru.gru_backward_plain(x, hprev, dhs, *w,
                                                         reverse, need_dx))
        # the forward's T = 1 (a seq2seq decoder step: B = 1000, F = H =
        # 500) and its step tile's edges (B off the 64-row tile, H = 1 and
        # off the 32-unit tile)
        for Tf, Bf, Ff, Hf in ((1, S2S_B, S2S_H, S2S_H), (3, 131, 33, 1),
                               (2, 65, 70, 97)):
            x = torch.randn((Tf, Bf, Ff), generator=gen, device=dev).to(dtype)
            h0f = torch.randn((Bf, Hf), generator=gen, device=dev) * 0.3
            w = _weights(torch, gen, dev, Ff, Hf)
            fwd[f"gru_fwd_{dt}_T{Tf}_B{Bf}_H{Hf}"] = float(
                (gru.gru_fwd_cuda(x, h0f, *w)
                 - gru.gru_layer_plain(x, h0f, *w)).abs().max())
        # the seq2seq train step's backward shapes: the encoder (T'=191,
        # B=1000, F=100, H=500, 3H=1500) reversed, and a decoder step
        # (T=1, F=H=500), both with dx
        for name, (Tb, Fb, rev) in (
                ("s2s_encoder", (S2S_TC, S2S_F, True)),
                ("s2s_decoder", (1, S2S_H, False))):
            x = (torch.randn((Tb, S2S_B, Fb), generator=gen, device=dev)
                 * 0.5).to(dtype)
            hp = torch.randn((Tb, S2S_B, S2S_H), generator=gen,
                             device=dev) * 0.3
            dh = torch.randn((Tb, S2S_B, S2S_H), generator=gen,
                             device=dev) * 1e-3
            w = _weights(torch, gen, dev, Fb, S2S_H)
            check_bwd(f"gru_bwd_{name}_{dt}",
                      lambda: gru.gru_bwd_cuda(x, hp, dh, *w, rev),
                      lambda: gru.gru_backward_plain(x, hp, dh, *w, rev))
            del x, hp, dh
        # the fused bidirectional forward: one step, B and H at 1 and odd
        for Bb, Hb in ((1, 1), (1, 33), (7, 1), (7, 33)):
            x = torch.randn((1, Bb, 5), generator=gen, device=dev).to(dtype)
            h0s = [torch.randn((Bb, Hb), generator=gen, device=dev) * 0.3
                   for _ in range(2)]
            ws = _weights(torch, gen, dev, 5, Hb) + _weights(torch, gen, dev,
                                                              5, Hb)
            got = gru.gru_bifwd_cuda(x, *h0s, *ws)
            want = gru.gru_layer_bidir_plain(x, *h0s, *ws)
            fwd[f"gru_bifwd_{dt}_B{Bb}_H{Hb}_T1"] = max(
                float((g - w).abs().max()) for g, w in zip(got, want))
    return fwd, bwd, rep


BWD_OUTPUTS = ("dx", "dh0", "dwi", "dwh", "dbi", "dbh")


def _bwd_errs(got, want) -> dict:
    """Relative error (max |diff| / max |plain|) per output of a backward;
    dx must be None on both sides or on neither."""
    if (got[0] is None) != (want[0] is None):
        raise RuntimeError("dx formed on one side only")
    kept = [(k, g, w) for k, g, w in zip(BWD_OUTPUTS, got, want)
            if w is not None]
    return _rel_errs({k: g for k, g, _ in kept}, {k: w for k, _, w in kept})


def phase_kernels(torch, dev, gru, launches, s2s_launches):
    gen = torch.Generator(device=dev).manual_seed(2)
    small, small_bwd, small_rep = _check_small(torch, gru, dev, gen)
    emit({"phase": "kernels_small", "max_abs_err": small,
          "max_rel_err_backward": small_bwd,
          "bitwise_repeat_backward": small_rep})
    bad = {k: v for k, v in small.items() if not v <= KERNEL_ATOL}
    bad.update({k: v for k, v in small_bwd.items() if not v <= GRAD_RTOL})
    bad.update({k: "repeat differs" for k, v in small_rep.items() if not v})
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
            flops=_fwd_flops(N_WIN * B, F0, H, x_bf16=True),
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
            flops=_fwd_flops(N_WIN * B, H, H, x_bf16=False),
            bytes_=_nbytes(x1, h0, *w1) + N_WIN * B * H * 4,
            launches=launches["gru_fwd"],
            shapes={"x": [N_WIN, B, H], "dtype": "f32", "hs": [N_WIN, B, H]}))
        del x1
        out.append(phase_kernel_bifwd(torch, dev, gru, gen,
                                      s2s_launches["gru_bifwd"]))
    out += phase_kernels_backward(torch, dev, gru, gen, h0, launches)
    row, b2t_launches = phase_kernel_wbwd_dx(torch, dev, gru)
    out.append(row)
    out += phase_kernels_fwd_split(torch, dev, gru, b2t_launches, launches)
    out += phase_kernels_bwd_split(torch, dev, gru, b2t_launches, launches)
    out.append(phase_kernel_wbidir(torch, dev, gru))
    return out


def _library_bigru(torch, ws):
    """``torch.nn.GRU(bidirectional=True)`` holding the same function as
    the two directions' (wi, bi, wh, bh)."""
    F, H3 = ws[0].shape
    g = torch.nn.GRU(F, H3 // 3, bidirectional=True).to(ws[0].device)
    with torch.no_grad():
        for sfx, (wi, bi, wh, bh) in (("", ws[:4]), ("_reverse", ws[4:])):
            getattr(g, f"weight_ih_l0{sfx}").copy_(wi.t())
            getattr(g, f"weight_hh_l0{sfx}").copy_(wh.t())
            getattr(g, f"bias_ih_l0{sfx}").copy_(bi)
            getattr(g, f"bias_hh_l0{sfx}").copy_(bh)
    g.flatten_parameters()
    return g


def phase_kernel_bifwd(torch, dev, gru, gen, launches):
    """``gru_bifwd`` at the seq2seq encoder's shapes (T'=191, B=1000,
    F=100, H=500, f32 x): against its plain version (two plain sweeps)
    to KERNEL_ATOL and two ``gru_fwd`` launches (forward and reversed),
    which run the same kernels, bitwise; two runs bitwise equal; timed
    beside the plain version, cuDNN's bidirectional GRU on the same
    weights and the two launches."""
    Tc, Bs, F, Hs = S2S_TC, S2S_B, S2S_F, S2S_H
    x = torch.rand((Tc, Bs, F), generator=gen, device=dev) * 2 - 1
    h0s = [torch.randn((Bs, Hs), generator=gen, device=dev) * 0.3
           for _ in range(2)]
    ws = _weights(torch, gen, dev, F, Hs) + _weights(torch, gen, dev, F, Hs)
    args = (x, *h0s, *ws)
    lib = _library_bigru(torch, ws)
    h0l = torch.stack(h0s)

    def kernel():
        return gru.gru_bifwd_cuda(*args)

    def plain():
        return gru.gru_layer_bidir_plain(*args)

    def two_launches():
        return (gru.gru_fwd_cuda(x, h0s[0], *ws[:4]),
                gru.gru_fwd_cuda(x, h0s[1], *ws[4:], reverse=True))

    got, again, want, unfused = kernel(), kernel(), plain(), two_launches()
    lib_out, _ = lib(x, h0l)
    torch.cuda.synchronize()
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    lib_err = float((lib_out - torch.cat(want, -1)).abs().max())
    repeat = all(torch.equal(g, a) for g, a in zip(got, again))
    # gru_bifwd runs gru_fwd's kernels, forward then reversed
    unfused_err = max(float((g - u).abs().max())
                      for g, u in zip(got, unfused))
    unfused_bitwise = all(torch.equal(g, u) for g, u in zip(got, unfused))
    del got, again, want, unfused, lib_out
    times = (cuda_ms(torch, kernel), cuda_ms(torch, plain),
             cuda_ms(torch, lambda: lib(x, h0l)))
    two_ms = cuda_ms(torch, two_launches)
    N = Tc * Bs
    flops = {"projection": (2 * 2 * N * F * 3 * Hs, PEAK_3XTF32),
             "recurrent": (2 * 2 * N * Hs * 3 * Hs, PEAK_3XTF32)}
    bytes_ = _nbytes(x, *h0s, *ws) + 2 * Tc * Bs * Hs * 4
    row, extra = _row("gru_bifwd", "gru_fwd.cu", "cross_patient_speech_"
                      "decoding_tpu/ops/pallas_gru.py:140", launches, err,
                      times, flops, bytes_)
    emit({"phase": "kernel", **row, **extra,
          "bound_scheme": "3xTF32 tensor cores (495/3 TFLOP/s), both "
                          "directions' projection and recurrence",
          "bitwise_repeat": repeat,
          "library_max_abs_err_vs_plain": lib_err,
          "two_gru_fwd_ms": two_ms,
          "max_abs_err_vs_two_gru_fwd": unfused_err,
          "bitwise_equal_to_two_gru_fwd": unfused_bitwise,
          "library_note": "torch.nn.GRU(bidirectional=True) forward (cuDNN) "
                          "on the same weights",
          "tolerance": KERNEL_ATOL,
          "shapes": {"x": [Tc, Bs, F], "dtype": "f32",
                     "hs": [2, Tc, Bs, Hs]}})
    if not err <= KERNEL_ATOL:
        raise RuntimeError(f"gru_bifwd differs from plain by {err}")
    if not unfused_bitwise:
        raise RuntimeError(f"gru_bifwd differs from two gru_fwd launches by "
                           f"{unfused_err}")
    if not repeat:
        raise RuntimeError("gru_bifwd: two runs are not bitwise equal")
    return row


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
        flops=_bwd_flops(N_WIN * B, H, H, x_bf16=False, need_dx=True),
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
        flops=_bwd_flops(N_WIN * B, F0, H, x_bf16=True, need_dx=False),
        bytes_=frames.numel() * 2 + _nbytes(hprev, dhs) + 2 * _nbytes(*w0)
        + B * H * 4,
        launches=launches["gru_wbwd"],
        shapes={"frames": [T, B, C], "dtype": "bf16", "win": WIN,
                "stride": STRIDE, "need_dx": False}))
    return out


def phase_kernel_wbwd_dx(torch, dev, gru):
    """``gru_wbwd`` with the frames' gradient (``need_dx``), layer 0 of a
    ``BrainToTextGRU``, at the b2t_gru cell's mean padded shape. First one
    ``make_ctc_train_step`` step of the model at the published widths on a
    batch of that shape (after one to warm up), the launch counts zeroed
    just before it and read just after (``B2T_TRAIN_LAUNCHES``; every
    forward step split over ``B2T_STEP_SPLIT`` CTAs). Then the
    kernel on bf16 batch-major frames against its plain version (each
    output within ``B2T_GRAD_RTOL`` x its largest value), one launch a
    call, two calls bitwise equal, the other outputs bit for bit those of
    the call without dx; timed beside the plain version, the call without
    dx and ``torch.nn.GRU``'s backward (cuDNN) over the windows
    materialised in float32, dx formed. Returns the kernels line's row
    ``gru_wbwd_dx`` and the train step's launches by wrapper."""
    from cross_patient_speech_decoding_tpu_torch.models import (
        BrainToTextGRU,
    )
    from cross_patient_speech_decoding_tpu_torch.train import (
        create_train_state,
        make_ctc_train_step,
        make_optimizer,
    )

    gen = torch.Generator(device=dev).manual_seed(22)
    Tb, Bb, Cb, Hb, n_win = B2T_T, B2T_B, B2T_C, B2T_H, B2T_N_WIN
    # one train step of the model, its launches counted by the wrappers
    model = BrainToTextGRU(Cb, Hb, B2T_L, B2T_CLS, n_days=B2T_DAYS,
                           device=dev)
    tx = make_optimizer(0.005, 0.001, 120000, clip=10.0, eps=0.1,
                        warmup_steps=1000, schedule="cosine", min_lr=1e-4,
                        no_decay=("day.",))
    state, step = create_train_state(model, tx), make_ctc_train_step(model,
                                                                     tx)
    n_lab = round(0.2 * n_win)
    batch = (torch.randn((Bb, Tb, Cb), generator=gen, device=dev),
             torch.randint(1, B2T_CLS, (Bb, n_lab), generator=gen,
                           device=dev, dtype=torch.int32),
             torch.full((Bb,), Tb, dtype=torch.int32, device=dev),
             torch.full((Bb,), n_lab, dtype=torch.int32, device=dev),
             torch.tensor([3, 17, 29, 44]).repeat_interleave(Bb // 4))
    state, _ = step(state, batch, gen)
    torch.cuda.synchronize()
    gru.reset_launch_counts()
    state, met = step(state, batch, gen)
    loss = float(met["loss"])
    step_launches = dict(gru.LAUNCHES)
    step_splits = gru.step_counts()
    bwd_splits = gru.bwd_step_counts()
    del model, state, step, batch, met
    torch.cuda.empty_cache()

    frames = torch.randn((Bb, Tb, Cb), generator=gen, device=dev).to(
        torch.bfloat16).transpose(0, 1)
    F0 = WIN * Cb
    w0 = _weights(torch, gen, dev, F0, Hb)
    hprev = torch.rand((n_win, Bb, Hb), generator=gen, device=dev) * 2 - 1
    dhs = torch.randn((n_win, Bb, Hb), generator=gen, device=dev) * 1e-3

    def kernel():
        return gru.gru_wbwd_cuda(frames, hprev, dhs, *w0, WIN, STRIDE,
                                 need_dx=True)

    def no_dx():
        return gru.gru_wbwd_cuda(frames, hprev, dhs, *w0, WIN, STRIDE)

    def plain():
        return gru.gru_win_backward_plain(frames, hprev, dhs, *w0, WIN,
                                          STRIDE, need_dx=True)

    gru.reset_launch_counts()
    got = kernel()
    per_call = gru.LAUNCHES["gru_wbwd"]
    repeat = _bitwise_repeat(torch, got, kernel())
    other = no_dx()
    others_equal = other[0] is None and all(
        torch.equal(a, b) for a, b in zip(got[1:], other[1:]))
    want = plain()
    errs = _bwd_errs(got, want)
    abs_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    del got, other, want
    # cuDNN: forward once over the materialised windows, then the backward
    # alone, dx formed as the kernel forms it
    windows = gru.reformat_time_windows(
        frames.transpose(0, 1), WIN, STRIDE).transpose(0, 1).float()
    windows = windows.contiguous().requires_grad_(True)
    lib = _library_gru(torch, *w0)
    h0l = hprev[0][None].detach().requires_grad_()
    hs_l, _ = lib(windows, h0l)
    wrt = [h0l, *lib.parameters(), windows]
    times = (cuda_ms(torch, kernel), cuda_ms(torch, plain),
             cuda_ms(torch, lambda: torch.autograd.grad(hs_l, wrt, dhs,
                                                        retain_graph=True)))
    no_dx_ms = cuda_ms(torch, no_dx)
    del hs_l, windows
    N = n_win * Bb
    flops = _bwd_flops(N, F0, Hb, x_bf16=True, need_dx=True)
    flops["fold"] = (N * F0, PEAK_F32_SIMT)  # one add a window element
    bytes_ = (frames.numel() * 2 + _nbytes(hprev, dhs) + 2 * _nbytes(*w0)
              + Bb * Hb * 4 + Tb * Bb * Cb * 4)
    row, extra = _row("gru_wbwd_dx", "gru_bwd.cu", "no TPU counterpart (the "
                      "JAX package's windowed frames are data)",
                      step_launches["gru_wbwd"], abs_err, times, flops,
                      bytes_)
    emit({"phase": "kernel", **row, **extra,
          "bound_scheme": "3xTF32 tensor cores (495/3 TFLOP/s); bf16 A "
                          "operands 2xTF32 (495/2); the fold float32 SIMT",
          "max_rel_err": errs, "tolerance_rel": B2T_GRAD_RTOL,
          "bitwise_repeat": repeat, "launches_per_call": per_call,
          "b2t_train_step_launches": step_launches, "b2t_train_loss": loss,
          "b2t_train_step_splits": step_splits,
          "b2t_train_bwd_step_splits": bwd_splits,
          "no_dx_ms": no_dx_ms,
          "others_bitwise_equal_without_dx": others_equal,
          "library_note": "torch.nn.GRU backward (cuDNN) over the windows "
                          "materialised in float32, dx formed",
          "shapes": {"frames": [Tb, Bb, Cb], "dtype": "bf16", "win": WIN,
                     "stride": STRIDE, "H": Hb, "n_win": n_win,
                     "need_dx": True}})
    bad = {k: v for k, v in errs.items() if not v <= B2T_GRAD_RTOL}
    if bad:
        raise RuntimeError(f"gru_wbwd_dx differs from plain: {bad}")
    if not repeat:
        raise RuntimeError("gru_wbwd_dx: two runs are not bitwise equal")
    if not others_equal:
        raise RuntimeError("gru_wbwd_dx: need_dx changed another output")
    if per_call != 1 or step_launches != B2T_TRAIN_LAUNCHES:
        raise RuntimeError(f"gru_wbwd_dx: {per_call} launches a call, "
                           f"{step_launches} a b2t train step")
    # the train step's forward steps: 5 layers of n_win, all split over 8
    want_splits = {s_: B2T_L * n_win if s_ == B2T_STEP_SPLIT else 0
                   for s_ in gru.STEP_SPLITS}
    if step_splits != want_splits:
        raise RuntimeError(f"gru_wbwd_dx: the b2t train step's forward "
                           f"steps by cluster size {step_splits}, not "
                           f"{want_splits}")
    # and its backward sweeps: one launch a step, all in clusters of 16
    want_bwd = {s_: B2T_L * n_win if s_ == B2T_BWD_STEP_SPLIT else 0
                for s_ in gru.BWD_STEP_SPLITS}
    if bwd_splits != want_bwd:
        raise RuntimeError(f"gru_wbwd_dx: the b2t train step's backward "
                           f"steps by cluster size {bwd_splits}, not "
                           f"{want_bwd}")
    if not math.isfinite(loss):
        raise RuntimeError(f"b2t train step loss {loss}")
    return row, step_launches


def _b24_train_step(torch, dev, gru, gen):
    """One train step of the '24 baseline at the published widths on a
    batch of the cell's longest shape, its days scattered over 22 of the
    24 (the shuffled loader's), after one step to warm up: (loss, launches
    by wrapper, forward and backward step launches by cluster size)."""
    from cross_patient_speech_decoding_tpu_torch.models import (
        BrainToTextGRU,
    )
    from cross_patient_speech_decoding_tpu_torch.train import (
        create_train_state,
        make_ctc_train_step,
        make_optimizer,
    )

    model = BrainToTextGRU(B24_C, B24_H, B24_L, B24_CLS, n_days=B24_DAYS,
                           input_dropout=0.0, win_size=B24_WIN,
                           stride=B24_STRIDE, device=dev, bidirectional=True,
                           learned_h0=False, smooth_sigma=2.0)
    tx = make_optimizer(0.02, 1e-5, 10000, end_factor=1.0, eps=0.1,
                        decoupled=False)
    state = create_train_state(model, tx)
    step = make_ctc_train_step(model, tx, augment=(0.8, 0.2))
    n_lab = round(0.25 * B24_N_WIN)
    days = torch.arange(B24_B) % 22
    batch = (torch.randn((B24_B, B24_T, B24_C), generator=gen, device=dev),
             torch.randint(1, B24_CLS, (B24_B, n_lab), generator=gen,
                           device=dev, dtype=torch.int32),
             torch.full((B24_B,), B24_T, dtype=torch.int32, device=dev),
             torch.full((B24_B,), n_lab, dtype=torch.int32, device=dev),
             days[torch.randperm(B24_B, generator=torch.Generator()
                                 .manual_seed(26))])
    state, _ = step(state, batch, gen)
    torch.cuda.synchronize()
    gru.reset_launch_counts()
    state, met = step(state, batch, gen)
    out = (float(met["loss"]), dict(gru.LAUNCHES), gru.step_counts(),
           gru.bwd_step_counts())
    del model, state, step, batch, met
    torch.cuda.empty_cache()
    return out


def _day_layer_ms(torch, dev, gen, n_days, B, T, C, days):
    """Device ms of a DayAffine forward and backward on (B, T, C) frames
    with the row days ``days``."""
    from cross_patient_speech_decoding_tpu_torch.models import DayAffine

    layer = DayAffine(n_days, C).to(dev)
    x = torch.randn((B, T, C), generator=gen, device=dev, requires_grad=True)
    dy = torch.randn((B, T, C), generator=gen, device=dev)
    return cuda_ms(torch, lambda: layer(x, days).backward(dy))


def phase_kernel_wbidir(torch, dev, gru):
    """The bidirectional windowed layer 0 of the Brain-to-Text '24 baseline
    (``gru_layer_bidir_windowed``: the windowed op forward and reversed, a
    ``gru_wfwd`` and a ``gru_wbwd`` with the frames' gradient a direction,
    autograd adding the two folds) at the ``b2t24_bigru`` cell's longest
    batch. First one train step of the model at the published widths
    (``_b24_train_step``: ``B24_TRAIN_LAUNCHES``; the cluster size of every
    sweep step recorded). Then the layer's two Functions on float32 frames
    that train, forward and backward, against their plain versions on the
    card (each output within ``B2T_GRAD_RTOL`` x its largest value), two
    runs bitwise equal, the frames' gradient bit for bit the sum of the two
    directions' ``gru_wbwd`` folds; timed beside the plain versions and
    ``torch.nn.GRU(bidirectional=True)`` (cuDNN) forward and backward over
    the windows materialised in float32, dx formed; the two forward calls
    timed against one ``gru_bifwd`` over the same windows, whose outputs
    must be theirs bit for bit; the fold and the add of the frames'
    gradient timed alone; the day layers' forward and backward timed at
    this cell's batch (rows sorted by day) and at ``b2t_gru``'s (4
    contiguous days). Returns the kernels line's row ``gru_wbidir``."""
    gen = torch.Generator(device=dev).manual_seed(26)
    loss, step_launches, step_splits, bwd_splits = _b24_train_step(
        torch, dev, gru, gen)
    Tb, Bb, Cb, Hb, n_win = B24_T, B24_B, B24_C, B24_H, B24_N_WIN
    win, stride = B24_WIN, B24_STRIDE
    F0 = win * Cb
    frames = torch.randn((Bb, Tb, Cb), generator=gen, device=dev)
    ws = [*_weights(torch, gen, dev, F0, Hb), *_weights(torch, gen, dev, F0,
                                                          Hb)]
    h0 = torch.zeros((Bb, Hb), device=dev)
    dhs = [torch.randn((n_win, Bb, Hb), generator=gen, device=dev) * 1e-3
           for _ in range(2)]

    def run(plain):
        x = frames.clone().requires_grad_(True)
        leaves = [t.clone().requires_grad_(True) for t in (h0, h0, *ws)]
        hs = [gru.GRUWindowedFn.apply(x.transpose(0, 1), h, *w, win, stride,
                                      rev, plain)
              for h, w, rev in ((leaves[0], leaves[2:6], False),
                                (leaves[1], leaves[6:], True))]
        torch.autograd.backward(hs, dhs)
        return [h.detach() for h in hs] + [x.grad] + [t.grad for t in
                                                      leaves]

    gru.reset_launch_counts()
    got = run(False)
    per_call = {k: v for k, v in gru.LAUNCHES.items() if v}
    repeat = _bitwise_repeat(torch, got, run(False))
    xb = frames.to(torch.bfloat16).transpose(0, 1)
    folds = [gru.gru_wbwd_cuda(
        xb, torch.cat([h0[None], got[0][:-1]]), dhs[0], *ws[:4], win,
        stride, need_dx=True)[0], gru.gru_wbwd_cuda(
        xb, torch.cat([got[1][1:], h0[None]]), dhs[1], *ws[4:], win, stride,
        need_dx=True, reverse=True)[0]]
    folds_added = bool(torch.equal(got[2], (folds[0] + folds[1])
                                   .transpose(0, 1)))
    del folds
    # the two windowed forward calls against one gru_bifwd over the windows
    wv = gru._windows(gru._batch_major(xb), win, stride)
    hb = (h0, h0, *ws)
    with torch.no_grad():
        two = (gru.gru_wfwd_cuda(xb, h0, *ws[:4], win, stride),
               gru.gru_wfwd_cuda(xb, h0, *ws[4:], win, stride, reverse=True))
        one = gru.gru_bifwd_cuda(wv, *hb)
        bifwd_same = all(torch.equal(a, b) for a, b in zip(two, one))
        del two, one
        fwd_ms = {
            "two_gru_wfwd": cuda_ms(torch, lambda: (
                gru.gru_wfwd_cuda(xb, h0, *ws[:4], win, stride),
                gru.gru_wfwd_cuda(xb, h0, *ws[4:], win, stride,
                                  reverse=True))),
            "one_gru_bifwd": cuda_ms(torch,
                                     lambda: gru.gru_bifwd_cuda(wv, *hb))}
    want = run(True)
    names = ["hs_f", "hs_b", "dframes", "dh0_f", "dh0_b", "dwi_f", "dbi_f",
             "dwh_f", "dbh_f", "dwi_b", "dbi_b", "dwh_b", "dbh_b"]
    errs = {n: float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
            for n, g, w in zip(names, got, want)}
    abs_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    del got, want
    # cuDNN over the windows materialised beforehand, float32, dx formed
    windows = gru.reformat_time_windows(
        frames.to(torch.bfloat16), win, stride).transpose(0, 1).float()
    windows = windows.contiguous().requires_grad_(True)
    lib = _library_bigru(torch, ws)
    h0l = torch.zeros((2, Bb, Hb), device=dev, requires_grad=True)
    dcat = torch.cat(dhs, dim=-1)

    def library():
        hs_l, _ = lib(windows, h0l)
        torch.autograd.grad(hs_l, [h0l, *lib.parameters(), windows], dcat)

    times = (cuda_ms(torch, lambda: run(False)),
             cuda_ms(torch, lambda: run(True), reps=3),
             cuda_ms(torch, library))
    del windows, lib
    # the frames' gradient's fold (one a direction) and the add, alone
    dxw = torch.randn((n_win, Bb, F0), generator=gen, device=dev)
    dx = torch.empty((Bb, Tb, Cb), device=dev)
    fold_ms = cuda_ms(torch, lambda: gru._call(
        "gru_fold_windows", dev, dxw.data_ptr(), dx.data_ptr(), Tb, Bb, Cb,
        win, stride, n_win), inner=10)
    add_ms = cuda_ms(torch, lambda: dx + dx, inner=10)
    del dxw, dx
    # the day layers: this cell's shuffled rows, b2t_gru's 4 whole days
    day_ms = {
        "b2t24_sorted_22_days": _day_layer_ms(
            torch, dev, gen, B24_DAYS, Bb, Tb, Cb,
            (torch.arange(Bb) % 22)[torch.randperm(
                Bb, generator=torch.Generator().manual_seed(27))]),
        "b2t_gru_4_days": _day_layer_ms(
            torch, dev, gen, B2T_DAYS, B2T_B, B2T_T, B2T_C,
            torch.tensor([3, 17, 29, 44]).repeat_interleave(B2T_B // 4))}
    N = n_win * Bb
    flops = {}
    for d in ("f", "b"):
        flops[f"proj_{d}"] = (2 * N * F0 * 3 * Hb, PEAK_2XTF32)
        flops[f"rec_{d}"] = (2 * N * Hb * 3 * Hb, PEAK_3XTF32)
        for k, v in _bwd_flops(N, F0, Hb, x_bf16=True, need_dx=True).items():
            flops[f"{k}_{d}"] = v
        flops[f"fold_{d}"] = (N * F0, PEAK_F32_SIMT)
    bytes_ = (Bb * Tb * Cb * 2 + 2 * _nbytes(*ws) + 4 * N * Hb * 4
              + Bb * Tb * Cb * 4)
    row, extra = _row("gru_wbidir", "gru_fwd.cu, gru_bwd.cu",
                      "no TPU counterpart (the JAX package's bidirectional "
                      "windows are data)", step_launches["gru_wfwd"],
                      abs_err, times, flops, bytes_)
    emit({"phase": "kernel", **row, **extra,
          "bound_scheme": "3xTF32 tensor cores (495/3 TFLOP/s); bf16 A "
                          "operands 2xTF32 (495/2); the folds float32 SIMT",
          "max_rel_err": errs, "tolerance_rel": B2T_GRAD_RTOL,
          "bitwise_repeat": repeat, "frames_grad_is_folds_added":
          folds_added, "launches_per_call": per_call,
          "forward_ms": fwd_ms, "gru_bifwd_bit_for_bit": bifwd_same,
          "b24_train_step_launches": step_launches, "b24_train_loss": loss,
          "b24_train_step_splits": step_splits,
          "b24_train_bwd_step_splits": bwd_splits,
          "fold_ms_a_direction": fold_ms, "add_ms": add_ms,
          "day_layer_fwd_bwd_ms": day_ms,
          "library_note": "torch.nn.GRU(bidirectional=True) (cuDNN) "
                          "forward and backward over the windows "
                          "materialised in float32, dx formed",
          "shapes": {"frames": [Tb, Bb, Cb], "dtype": "float32 rounded to "
                     "bf16 in the op", "win": win, "stride": stride,
                     "H": Hb, "n_win": n_win}})
    bad = {k: v for k, v in errs.items() if not v <= B2T_GRAD_RTOL}
    if bad:
        raise RuntimeError(f"gru_wbidir differs from plain: {bad}")
    if not (repeat and folds_added and bifwd_same):
        raise RuntimeError(f"gru_wbidir: bitwise repeat {repeat}, frames' "
                           f"gradient the folds added {folds_added}, "
                           f"gru_bifwd's outputs {bifwd_same}")
    if per_call != {"gru_wfwd": 2, "gru_wbwd": 2} or \
            step_launches != B24_TRAIN_LAUNCHES:
        raise RuntimeError(f"gru_wbidir: {per_call} launches a call, "
                           f"{step_launches} a b2t24 train step")
    # every sweep step of the train step: 5 layers x 2 directions x n_win
    for name, got_s in (("forward", step_splits), ("backward", bwd_splits)):
        if sum(got_s.values()) != 2 * B24_L * n_win:
            raise RuntimeError(f"gru_wbidir: the b2t24 train step's {name} "
                               f"steps by cluster size {got_s}")
    if not math.isfinite(loss):
        raise RuntimeError(f"b2t24 train step loss {loss}")
    return row


def phase_kernels_fwd_split(torch, dev, gru, b2t_launches=None,
                            fig5_launches=None):
    """The forward kernels at the shapes whose steps split K over a
    cluster (``gru_fwd.cu``: ``step_split``): ``gru_fwd`` at b2t_gru's
    layers 1-4 (T 244, B 64, F = H = 768, f32 x) and ``gru_wfwd`` at its
    layer 0 (244 windows of 14 x 4 over 988 bf16 frames of 512, H 768),
    both at the cell's mean padded length, and ``gru_fwd`` at fig_5 train's
    layers 1-2 (T 147, B 512, F = H = 512). Each against its plain version
    to KERNEL_ATOL, two calls bitwise equal, the call's step launches all
    of the cluster size the shape takes on the H100 (``step_counts``);
    timed beside the plain version and ``torch.nn.GRU`` (cuDNN), with the
    step kernel's device µs a launch from a profiled call. A row's
    ``launches`` are those of one train step of its cell as this run
    counted them (``b2t_launches``: ``phase_kernel_wbwd_dx``'s;
    ``fig5_launches``: ``phase_ctc_train``'s), null where this run did
    not count them. Returns the kernels line's rows ``gru_fwd_b2t``,
    ``gru_wfwd_b2t`` and ``gru_fwd_fig5_train``."""
    b2t_launches, fig5_launches = b2t_launches or {}, fig5_launches or {}
    gen = torch.Generator(device=dev).manual_seed(23)
    Tb, Bb, Cb, Hb, n_win = B2T_T, B2T_B, B2T_C, B2T_H, B2T_N_WIN
    Bf = FIG5_TRAIN_B
    frames = torch.randn((Bb, Tb, Cb), generator=gen, device=dev).to(
        torch.bfloat16).transpose(0, 1)
    F0 = WIN * Cb
    w0 = _weights(torch, gen, dev, F0, Hb)
    hb = torch.randn((Bb, Hb), generator=gen, device=dev) * 0.3
    xb = torch.rand((n_win, Bb, Hb), generator=gen, device=dev) * 2 - 1
    wb = _weights(torch, gen, dev, Hb, Hb)
    hf = torch.randn((Bf, H), generator=gen, device=dev) * 0.3
    xf = torch.rand((N_WIN, Bf, H), generator=gen, device=dev) * 2 - 1
    wf = _weights(torch, gen, dev, H, H)
    cases = (
        ("gru_fwd_b2t", "pallas_gru.py:80", B2T_STEP_SPLIT,
         b2t_launches.get("gru_fwd"), lambda: gru.gru_fwd_cuda(xb, hb, *wb),
         lambda: gru.gru_layer_plain(xb, hb, *wb), wb, lambda: xb, hb,
         _fwd_flops(n_win * Bb, Hb, Hb, x_bf16=False),
         _nbytes(xb, hb, *wb) + n_win * Bb * Hb * 4,
         {"x": [n_win, Bb, Hb], "dtype": "f32", "hs": [n_win, Bb, Hb]}),
        ("gru_wfwd_b2t", "pallas_gru.py:263", B2T_STEP_SPLIT,
         b2t_launches.get("gru_wfwd"),
         lambda: gru.gru_wfwd_cuda(frames, hb, *w0, WIN, STRIDE),
         lambda: gru.gru_layer_windowed_plain(frames, hb, *w0, WIN, STRIDE),
         w0, lambda: gru.reformat_time_windows(
             frames.transpose(0, 1), WIN, STRIDE).transpose(0, 1).float()
         .contiguous(), hb,
         _fwd_flops(n_win * Bb, F0, Hb, x_bf16=True),
         frames.numel() * 2 + _nbytes(hb, *w0) + n_win * Bb * Hb * 4,
         {"frames": [Tb, Bb, Cb], "dtype": "bf16", "win": WIN,
          "stride": STRIDE, "hs": [n_win, Bb, Hb]}),
        ("gru_fwd_fig5_train", "pallas_gru.py:80", FIG5_TRAIN_STEP_SPLIT,
         fig5_launches.get("gru_fwd"),
         lambda: gru.gru_fwd_cuda(xf, hf, *wf),
         lambda: gru.gru_layer_plain(xf, hf, *wf), wf, lambda: xf, hf,
         _fwd_flops(N_WIN * Bf, H, H, x_bf16=False),
         _nbytes(xf, hf, *wf) + N_WIN * Bf * H * 4,
         {"x": [N_WIN, Bf, H], "dtype": "f32", "hs": [N_WIN, Bf, H]}),
    )
    out = []
    with torch.no_grad():
        for (name, replaces, split, launches, kernel, plain, w, lib_x, h0,
             flops, bytes_, shapes) in cases:
            steps = shapes["hs"][0]
            gru.reset_launch_counts()
            got = kernel()
            splits = gru.step_counts()
            again = kernel()
            want = plain()
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            repeat = bool(torch.equal(got, again))
            del got, again
            lib, xl = _library_gru(torch, *w), lib_x()
            lib_err = float((lib(xl, h0[None])[0] - want).abs().max())
            del want
            times = (cuda_ms(torch, kernel), cuda_ms(torch, plain),
                     cuda_ms(torch, lambda: lib(xl, h0[None])))
            _, prof = profile_call(torch, kernel, cpu=False,
                                   match="gru_step_mma_kernel")
            del lib, xl
            step_us = prof["device_ms_gru_step_mma_kernel"] * 1e3 / steps
            row, extra = _row(name, "gru_fwd.cu", "cross_patient_speech_"
                              f"decoding_tpu/ops/{replaces}", launches, err,
                              times, flops, bytes_)
            row.update({"step_split": max(
                (s_ for s_, n in splits.items() if n), default=0),
                "step_us": step_us})
            want_splits = {s_: steps if s_ == split else 0
                           for s_ in gru.STEP_SPLITS}
            emit({"phase": "kernel", **row, **extra,
                  "bound_scheme": "3xTF32 tensor cores (495/3 TFLOP/s); "
                                  "the projection of bf16 x 2xTF32 (495/2)",
                  "step_launches_by_split": splits,
                  "bitwise_repeat": repeat,
                  "library_max_abs_err_vs_plain": lib_err,
                  "tolerance": KERNEL_ATOL, "shapes": shapes})
            if not err <= KERNEL_ATOL:
                raise RuntimeError(f"{name} differs from plain by {err}")
            if not repeat:
                raise RuntimeError(f"{name}: two runs are not bitwise equal")
            if splits != want_splits:
                raise RuntimeError(f"{name}: step launches by cluster size "
                                   f"{splits}, not {want_splits}")
            out.append(row)
    return out


def phase_kernels_bwd_split(torch, dev, gru, b2t_launches=None,
                            fig5_launches=None):
    """The backward kernels at the train cells' shapes whose sweep steps
    split K = 3H over a cluster (``gru_mma.cuh``: ``step_split``), each step
    one launch that also forms the next step's gate gradients: ``gru_bwd``
    at b2t_gru's layers 1-4 (T 244, B 64, F = H = 768, f32 x, dx formed)
    and ``gru_wbwd`` at its layer 0 with the frames' gradient (244 windows
    of 14 x 4 over 988 bf16 frames of 512, H 768), both at the cell's mean
    padded length, and ``gru_bwd`` at fig_5 train's layers 1-2 (T 147,
    B 512, F = H = 512, dx formed). Each against its plain version (every
    output within ``B2T_GRAD_RTOL`` x its largest value), two calls bitwise
    equal, the call's sweep launches one a step, all of the cluster size
    the shape takes on the H100 (``bwd_step_counts``); timed beside the
    plain version and ``torch.nn.GRU``'s backward (cuDNN), with the step
    kernel's device µs a launch from a profiled call. A row's
    ``launches`` are those of one train step of its cell as this run
    counted them, null where it did not (``phase_kernels_fwd_split``).
    Returns the kernels line's rows ``gru_bwd_b2t``, ``gru_wbwd_b2t`` and
    ``gru_bwd_fig5_train``."""
    b2t_launches, fig5_launches = b2t_launches or {}, fig5_launches or {}
    gen = torch.Generator(device=dev).manual_seed(25)
    Tb, Bb, Cb, Hb, n_win = B2T_T, B2T_B, B2T_C, B2T_H, B2T_N_WIN
    Bf = FIG5_TRAIN_B
    F0 = WIN * Cb
    frames = torch.randn((Bb, Tb, Cb), generator=gen, device=dev).to(
        torch.bfloat16).transpose(0, 1)
    w0 = _weights(torch, gen, dev, F0, Hb)
    hb = torch.rand((n_win, Bb, Hb), generator=gen, device=dev) * 2 - 1
    db = torch.randn((n_win, Bb, Hb), generator=gen, device=dev) * 1e-3
    xb = torch.rand((n_win, Bb, Hb), generator=gen, device=dev) * 2 - 1
    wb = _weights(torch, gen, dev, Hb, Hb)
    hf = torch.rand((N_WIN, Bf, H), generator=gen, device=dev) * 2 - 1
    df = torch.randn((N_WIN, Bf, H), generator=gen, device=dev) * 1e-3
    xf = torch.rand((N_WIN, Bf, H), generator=gen, device=dev) * 2 - 1
    wf = _weights(torch, gen, dev, H, H)

    def windows():
        return gru.reformat_time_windows(
            frames.transpose(0, 1), WIN, STRIDE).transpose(0, 1).float()

    cases = (
        ("gru_bwd_b2t", "pallas_gru.py:569", B2T_BWD_STEP_SPLIT,
         b2t_launches.get("gru_bwd"),
         lambda: gru.gru_bwd_cuda(xb, hb, db, *wb),
         lambda: gru.gru_backward_plain(xb, hb, db, *wb), wb, lambda: xb,
         hb, db, _bwd_flops(n_win * Bb, Hb, Hb, x_bf16=False, need_dx=True),
         _nbytes(xb, hb, db, *wb) * 2 - _nbytes(hb, db) + Bb * Hb * 4,
         {"x": [n_win, Bb, Hb], "dtype": "f32", "need_dx": True}),
        ("gru_wbwd_b2t", "pallas_gru.py:287", B2T_BWD_STEP_SPLIT,
         b2t_launches.get("gru_wbwd"),
         lambda: gru.gru_wbwd_cuda(frames, hb, db, *w0, WIN, STRIDE,
                                   need_dx=True),
         lambda: gru.gru_win_backward_plain(frames, hb, db, *w0, WIN,
                                            STRIDE, need_dx=True),
         w0, lambda: windows().contiguous(), hb, db,
         _bwd_flops(n_win * Bb, F0, Hb, x_bf16=True, need_dx=True),
         frames.numel() * 2 + _nbytes(hb, db) + 2 * _nbytes(*w0)
         + Bb * Hb * 4 + Tb * Bb * Cb * 4,
         {"frames": [Tb, Bb, Cb], "dtype": "bf16", "win": WIN,
          "stride": STRIDE, "H": Hb, "n_win": n_win, "need_dx": True}),
        ("gru_bwd_fig5_train", "pallas_gru.py:569",
         FIG5_TRAIN_BWD_STEP_SPLIT, fig5_launches.get("gru_bwd"),
         lambda: gru.gru_bwd_cuda(xf, hf, df, *wf),
         lambda: gru.gru_backward_plain(xf, hf, df, *wf), wf, lambda: xf,
         hf, df, _bwd_flops(N_WIN * Bf, H, H, x_bf16=False, need_dx=True),
         _nbytes(xf, hf, df, *wf) * 2 - _nbytes(hf, df) + Bf * H * 4,
         {"x": [N_WIN, Bf, H], "dtype": "f32", "need_dx": True}),
    )
    out = []
    for (name, replaces, split, launches, kernel, plain, w, lib_x, hp, dhs,
         flops, bytes_, shapes) in cases:
        steps = hp.shape[0]
        gru.reset_launch_counts()
        got = kernel()
        splits = gru.bwd_step_counts()
        repeat = _bitwise_repeat(torch, got, kernel())
        want = plain()
        errs = _bwd_errs(got, want)
        abs_err = max(float((g - w_).abs().max())
                      for g, w_ in zip(got, want) if w_ is not None)
        del got, want
        # cuDNN: forward once from h_0, then time the backward alone, dx
        # formed as the kernel forms it
        lib = _library_gru(torch, *w)
        xl = lib_x().detach().requires_grad_(True)
        h0l = hp[0][None].detach().requires_grad_()
        hs_l, _ = lib(xl, h0l)
        wrt = [h0l, *lib.parameters(), xl]
        times = (cuda_ms(torch, kernel), cuda_ms(torch, plain),
                 cuda_ms(torch, lambda: torch.autograd.grad(
                     hs_l, wrt, dhs, retain_graph=True)))
        del hs_l, xl, lib
        _, prof = profile_call(torch, kernel, cpu=False,
                               match="bwd_step_kernel")
        step_us = prof["device_ms_bwd_step_kernel"] * 1e3 / steps
        row, extra = _row(name, "gru_bwd.cu", "cross_patient_speech_"
                          f"decoding_tpu/ops/{replaces}", launches, abs_err,
                          times, flops, bytes_)
        row.update({"step_split": max(
            (s_ for s_, n in splits.items() if n), default=0),
            "step_us": step_us})
        want_splits = {s_: steps if s_ == split else 0
                       for s_ in gru.BWD_STEP_SPLITS}
        emit({"phase": "kernel", **row, **extra,
              "bound_scheme": "3xTF32 tensor cores (495/3 TFLOP/s); bf16 A "
                              "operands 2xTF32 (495/2)",
              "step_launches_by_split": splits, "max_rel_err": errs,
              "tolerance_rel": B2T_GRAD_RTOL, "bitwise_repeat": repeat,
              "library_note": "torch.nn.GRU backward (cuDNN), dx formed"
                              + ("" if name.startswith("gru_bwd")
                                 else ", on materialised windows"),
              "shapes": shapes})
        bad = {k: v for k, v in errs.items() if not v <= B2T_GRAD_RTOL}
        if bad:
            raise RuntimeError(f"{name} differs from plain: {bad}")
        if not repeat:
            raise RuntimeError(f"{name}: two runs are not bitwise equal")
        if splits != want_splits:
            raise RuntimeError(f"{name}: sweep launches by cluster size "
                               f"{splits}, not {want_splits}")
        out.append(row)
    return out


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _fwd_flops(N, F, H, x_bf16):
    """The unidirectional forward's products over N = T B rows as
    {product: (FLOPs, peak)}: the input projection x Wi before the sweep
    (2xTF32 for bf16 x) and the sweep's h Wh (3xTF32)."""
    return {"projection": (2 * N * F * 3 * H,
                           PEAK_2XTF32 if x_bf16 else PEAK_3XTF32),
            "recurrent": (2 * N * H * 3 * H, PEAK_3XTF32)}


def _bwd_flops(N, F, H, x_bf16, need_dx):
    """The backward's products over N = T B rows as {product: (FLOPs,
    peak)}: each at the 3xTF32 rate, those whose A operand is x at the
    2xTF32 rate when x is bf16 (gru_mma.cuh skips lo_a hi_b there)."""
    x_peak = PEAK_2XTF32 if x_bf16 else PEAK_3XTF32
    ops = {"recompute_x": (2 * N * F * 3 * H, x_peak),
           "recompute_h": (2 * N * H * 3 * H, PEAK_3XTF32),
           "dh_wh": (2 * N * 3 * H * H, PEAK_3XTF32),
           "dwi": (2 * N * F * 3 * H, x_peak),
           "dwh": (2 * N * H * 3 * H, PEAK_3XTF32)}
    if need_dx:
        ops["dx"] = (2 * N * 3 * H * F, PEAK_3XTF32)
    return ops


def _row(name, source, replaces, launches, err, times, flops, bytes_,
         peak=PEAK_F32_SIMT):
    """The kernels line's row (bound_ms and what this run measured, nothing
    else) and the extra keys of the phase line. ``times`` is (kernel,
    plain, library) ms; ``flops`` a count at ``peak``, the FLOP/s of the
    units the products run on (float32 SIMT: the Jacobi kernel), or
    {product: (FLOPs, peak)} where products run at their own rates (the GRU
    kernels' tensor cores)."""
    ms, plain_ms, library_ms = times
    ops = flops if isinstance(flops, dict) else {"all": (flops, peak)}
    total = sum(f for f, _ in ops.values())
    t_ops = sum(f / p for f, p in ops.values()) * 1e3
    t_bytes = bytes_ / PEAK_HBM * 1e3
    row = {
        "name": name, "route": "cuda",
        "source": f"cross_patient_speech_decoding_tpu_torch/ops/csrc/{source}",
        "replaces": replaces, "launches": launches, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
    }
    extra = {"flops": total, "bytes": bytes_,
             "bound_flops_at_peak": {k: [f, p] for k, (f, p) in ops.items()},
             "bound_ms_f32_simt": max(total / PEAK_F32_SIMT * 1e3, t_bytes),
             "bound_ms_bf16_tensor_core": max(total / PEAK_BF16_TC * 1e3,
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
          "bound_scheme": "3xTF32 tensor cores (495/3 TFLOP/s); the "
                          "projection of bf16 x 2xTF32 (495/2)",
          "library_max_abs_err_vs_plain": lib_err,
          "tolerance": KERNEL_ATOL, "shapes": shapes})
    if not err <= KERNEL_ATOL:
        raise RuntimeError(f"{name} differs from plain by {err}")
    return row


def _bitwise_repeat(torch, got, again) -> bool:
    """Two launches of a backward kernel on the same inputs: every output
    equal bit for bit (dx None on both or on neither)."""
    return all((a is None and b is None)
               or (a is not None and b is not None and torch.equal(a, b))
               for a, b in zip(got, again))


def _measure_bwd(torch, name, replaces, kernel, plain, library, lib_x, h0,
                 dhs, flops, bytes_, launches, shapes):
    got = kernel()
    repeat = _bitwise_repeat(torch, got, kernel())
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
          "bound_scheme": "3xTF32 tensor cores (495/3 TFLOP/s); bf16 A "
                          "operands 2xTF32 (495/2)",
          "max_rel_err": errs, "tolerance_rel": GRAD_RTOL,
          "bitwise_repeat": repeat,
          "library_note": "torch.nn.GRU backward (cuDNN), also forms dx"
                          + ("" if name == "gru_bwd"
                             else " internally, on materialised windows"),
          "shapes": shapes})
    bad = {k: v for k, v in errs.items() if not v <= GRAD_RTOL}
    if bad:
        raise RuntimeError(f"{name} differs from plain: {bad}")
    if not repeat:
        raise RuntimeError(f"{name}: two runs are not bitwise equal")
    return row


# ---------------------------------------------------------------------------
# alignment (slice 3)
# ---------------------------------------------------------------------------


def _oracle_fit(X_a, X_b, y_a, y_b):
    """A copy of the JAX package's bench.py:_numpy_oracle_fit (float64
    numpy: class means, QR, SVD, pinv products), which also returns the
    canonical correlations s[:d] and the larger condition number of the
    two views' Grams beside the b->a projection."""
    import numpy as np

    classes = np.unique(y_a)
    La = np.stack([X_a[y_a == c].mean(0) for c in classes]).reshape(
        -1, X_a.shape[-1])
    Lb = np.stack([X_b[y_b == c].mean(0) for c in classes]).reshape(
        -1, X_b.shape[-1])
    La = La - La.mean(0)
    Lb = Lb - Lb.mean(0)
    d = min(np.linalg.matrix_rank(La.T), np.linalg.matrix_rank(Lb.T))
    qa, ra = np.linalg.qr(La)
    qb, rb = np.linalg.qr(Lb)
    u, s, vt = np.linalg.svd(qa.T @ qb)
    ma = np.linalg.pinv(ra) @ u[:, :d]
    mb = np.linalg.pinv(rb) @ vt.T[:, :d]
    cond = max(np.linalg.cond(La.T @ La), np.linalg.cond(Lb.T @ Lb))
    return mb @ np.linalg.pinv(ma), s[:d], cond


def _alignment_data(torch, dev):
    """The bench's pairs, built on the card: a shared (C, T, 8) latent
    from numpy seed 0, per-pair random mixes to K latents, 0.3 noise; flat
    (pairs, N, T*K) trials of each view, ids (pairs, N)."""
    import numpy as np

    rng = np.random.default_rng(0)
    latent = rng.normal(size=(AL_C, AL_T, AL_LAT)).astype(np.float32)
    ids = np.repeat(np.arange(AL_C), AL_N // AL_C + 1)[:AL_N].astype(np.int32)
    lat = torch.as_tensor(latent[ids], device=dev)  # (N, T, 8)
    gen = torch.Generator(device=dev).manual_seed(5)

    def view():
        mixes = torch.randn((AL_PAIRS, AL_LAT, AL_K), generator=gen,
                            device=dev)
        x = torch.einsum("ntl,blk->bntk", lat, mixes)
        x += 0.3 * torch.randn(x.shape, generator=gen, device=dev)
        return x.reshape(AL_PAIRS, AL_N, AL_T * AL_K)

    xa, xb = view(), view()
    ids_t = torch.as_tensor(np.tile(ids, (AL_PAIRS, 1)), device=dev)
    return xa, xb, ids_t, ids


class _PlainJacobi:
    """Within the block, ``batched_eigh`` sends CUDA batches down the
    kernel's route to the plain Jacobi (the route hook)."""

    def __init__(self, jacobi):
        self.jacobi = jacobi

    def __enter__(self):
        self.route = self.jacobi._route
        self.jacobi._route = lambda A: "plain"

    def __exit__(self, *exc):
        self.jacobi._route = self.route


class _RecordJacobi:
    """Within the block, keep a copy of every batch the kernel wrapper
    gets, or with ``first_per_shape`` of the first batch of each shape
    (launch counts are the wrapper's own)."""

    def __init__(self, jacobi, first_per_shape=False):
        self.jacobi = jacobi
        self.first_per_shape = first_per_shape
        self.batches = []

    def __enter__(self):
        self.cuda = self.jacobi.jacobi_eigh_cuda

        def record(A, *args, **kw):
            if not (self.first_per_shape and any(
                    b.shape == A.shape for b in self.batches)):
                self.batches.append(A.clone())
            return self.cuda(A, *args, **kw)

        self.jacobi.jacobi_eigh_cuda = record
        return self

    def __exit__(self, *exc):
        self.jacobi.jacobi_eigh_cuda = self.cuda


def _route_errs(torch, got, want) -> dict:
    """Two fits of the same pairs: d equal, max |canon_corrs diff|, and
    per pair max |proj diff| / max |proj|."""
    a, b = got.alignment, want.alignment
    proj = max(float(((getattr(a, n) - getattr(b, n)).abs().amax((-2, -1))
                      / getattr(b, n).abs().amax((-2, -1))).max())
               for n in ("proj_b_to_a", "proj_a_to_b"))
    return {"d_equal": bool(torch.equal(a.d, b.d)),
            "corr_max_abs_err": float((a.canon_corrs
                                       - b.canon_corrs).abs().max()),
            "proj_max_rel_err": proj}


def _route_ok(errs) -> bool:
    return (errs["d_equal"] and errs["corr_max_abs_err"] <= ROUTE_CORR_ATOL
            and errs["proj_max_rel_err"] <= ROUTE_PROJ_RTOL)


def _oracle_errs(fit, oracle, gram_route: bool) -> dict:
    """Pairs of a fit against the float64 oracle: d, max |canon corr
    diff| over its bound (see ORACLE_CORR_ATOL), max |X_b proj -
    X_b proj_oracle| absolute and over max |X_b proj_oracle|."""
    import numpy as np

    corr = corr_ratio = trans = trans_rel = 0.0
    d_equal = True
    al = fit.alignment
    for i, xb, proj_o, s_o, cond in oracle:
        d_equal &= int(al.d[i]) == len(s_o)
        err = float(np.abs(
            al.canon_corrs[i].double().cpu().numpy()[:len(s_o)] - s_o).max())
        bound = ORACLE_CORR_ATOL
        if gram_route:
            bound = max(bound, 2 * EPS_F32 * cond)
        corr = max(corr, err)
        corr_ratio = max(corr_ratio, err / bound)
        want = xb @ proj_o
        err = np.abs(xb @ al.proj_b_to_a[i].double().cpu().numpy()
                     - want).max()
        trans = max(trans, float(err))
        trans_rel = max(trans_rel, float(err / np.abs(want).max()))
    return {"d_equal": d_equal, "corr_max_abs_err": corr,
            "corr_err_over_bound": corr_ratio,
            "transform_max_abs_err": trans,
            "transform_max_rel_err": trans_rel}


def _oracle_ok(errs) -> bool:
    return (errs["d_equal"] and errs["corr_err_over_bound"] <= 1.0
            and errs["transform_max_rel_err"] <= ORACLE_TRANSFORM_RTOL)


def phase_alignment(torch, dev, jacobi):
    from cross_patient_speech_decoding_tpu_torch.ops import cca

    xa, xb, ids_t, ids = _alignment_data(torch, dev)

    def fit(method):
        return cca.fit_cca_aligner(xa, xb, ids_t, ids_t, AL_C, method=method,
                                   t_len=AL_T)

    oracle, below = [], []
    for i in range(min(ORACLE_SCAN, AL_PAIRS)):
        a, b = (x[i].reshape(AL_N, AL_T, AL_K).double().cpu().numpy()
                for x in (xa, xb))
        proj_o, s_o, cond = _oracle_fit(a, b, ids, ids)
        if s_o.min() >= GRAM_FLOOR:
            oracle.append((i, b, proj_o, s_o, cond))
        elif not below:
            below.append((i, b, proj_o, s_o, cond))
        if len(oracle) == ORACLE_PAIRS:
            break
    if len(oracle) < ORACLE_PAIRS:
        raise RuntimeError(f"{len(oracle)} of {ORACLE_SCAN} pairs above the "
                           f"Gram floor {GRAM_FLOOR}")

    res = {"phase": "alignment", "pairs": AL_PAIRS, "N": AL_N, "T": AL_T,
           "K": AL_K, "classes": AL_C, "layout": "flat (pairs, N, T*K)",
           "oracle_pairs": [o[0] for o in oracle],
           "oracle_min_canon_corr": [float(o[3].min()) for o in oracle],
           "oracle_gram_cond": [float(o[4]) for o in oracle],
           "gram_floor": GRAM_FLOOR,
           "below_floor_pair": [(o[0], float(o[3].min())) for o in below],
           "methods": {}}
    bad = []
    fits = {}
    for method in ("chol", "gram", "svd"):
        fit(method)  # warm-up: solver handles, allocator
        torch.cuda.synchronize()
        jacobi.reset_launch_counts()
        out = fit(method)
        torch.cuda.synchronize()
        launches = jacobi.LAUNCHES["jacobi_eigh"]
        fits[method] = out
        ms = cuda_ms(torch, lambda: fit(method))
        m = {"launches": launches, "fit_ms": ms,
             "fits_per_s": AL_PAIRS / (ms / 1e3),
             "d_min": int(out.alignment.d.min()),
             "finite": bool(torch.isfinite(out.alignment.proj_b_to_a).all()),
             "vs_oracle_float64": _oracle_errs(out, oracle, method != "svd"),
             "below_floor_pair_vs_oracle":
                 _oracle_errs(out, below, method != "svd") if below else None}
        if launches != AL_LAUNCHES[method]:
            bad.append(f"{method}: {launches} launches")
        if not (m["finite"] and _oracle_ok(m["vs_oracle_float64"])):
            bad.append(f"{method} vs oracle: {m['vs_oracle_float64']}")
        if method != "svd":
            with _PlainJacobi(jacobi):
                plain = fit(method)
                m["plain_route_fit_ms"] = cuda_ms(torch, lambda: fit(method))
            m["vs_plain_route"] = _route_errs(torch, out, plain)
            if not _route_ok(m["vs_plain_route"]):
                bad.append(f"{method} vs plain: {m['vs_plain_route']}")
            del plain
        res["methods"][method] = m

    # TF32 switched on by the caller: hdot and the solves pin float32
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32 = fit("chol")
        kept = torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    res["unbatched"] = _check_unbatched(torch, jacobi, cca, xa, xb, ids_t,
                                        oracle, below)
    if not res["unbatched"]["ok"]:
        bad.append(f"unbatched: {res['unbatched']}")
    res["tf32_on"] = {"caller_setting_kept": kept,
                      "vs_tf32_off": _route_errs(torch, tf32, fits["chol"]),
                      "vs_oracle_float64": _oracle_errs(tf32, oracle, True)}
    if not (kept and _route_ok(res["tf32_on"]["vs_tf32_off"])
            and _oracle_ok(res["tf32_on"]["vs_oracle_float64"])):
        bad.append(f"TF32 on: {res['tf32_on']}")

    _, prof = profile_call(torch, lambda: fit("chol"))
    # the profiler's host overhead inflates wall_ms; against the
    # unprofiled CUDA-event time of a fit the idle share is the card's own
    prof["device_idle_share_vs_event_time"] = (
        1.0 - prof["device_busy_ms"] / res["methods"]["chol"]["fit_ms"])
    res["profile_chol_fit"] = prof
    with _RecordJacobi(jacobi) as rec:
        fit("chol")
        fit("gram")
    res["multiview"] = _check_multiview(torch, xa, ids_t)
    if not res["multiview"]["ok"]:
        bad.append(f"multiview: {res['multiview']}")
    emit(res)
    if bad:
        raise RuntimeError(f"alignment failed: {bad}")
    # the kernel's path batches: the chol fit's g^T g (128), the gram
    # fit's stacked whitening Grams (256)
    return {"chol_128": rec.batches[0], "gram_256": rec.batches[1],
            "launches": {m: res["methods"][m]["launches"] for m in AL_LAUNCHES}}


def _check_unbatched(torch, jacobi, cca, xa, xb, ids_t, oracle, below):
    """The oracle pairs (and the pair below the Gram floor) fitted one at
    a time by chol and gram, as a caller with a single pair of patients
    fits: at K = AL_K >= ANY_BATCH_K the Jacobi kernel solves the chol
    fit's Gram SVD as a batch of 1 and the gram fit's whitening as a batch
    of 2, so the launches must be AL_LAUNCHES a fit; each pair against the
    float64 oracle within the batched fits' bounds."""
    from types import SimpleNamespace

    def fits(method, pairs):
        # indexed by pair, as _oracle_errs reads a batched fit
        got = {i: cca.fit_cca_aligner(xa[i], xb[i], ids_t[i], ids_t[i], AL_C,
                                      method=method, t_len=AL_T).alignment
               for i, *_ in pairs}
        return SimpleNamespace(alignment=SimpleNamespace(**{
            n: {i: getattr(a, n) for i, a in got.items()}
            for n in ("d", "canon_corrs", "proj_b_to_a")}))

    out = {"ok": True}
    for method in ("chol", "gram"):
        jacobi.reset_launch_counts()
        on_oracle = fits(method, oracle)
        torch.cuda.synchronize()
        launches = jacobi.LAUNCHES["jacobi_eigh"]
        m = {"fits": len(oracle), "launches": launches,
             "vs_oracle_float64": _oracle_errs(on_oracle, oracle, True),
             "below_floor_pair_vs_oracle":
                 _oracle_errs(fits(method, below), below, True)
                 if below else None}
        out[method] = m
        out["ok"] &= (launches == AL_LAUNCHES[method] * len(oracle)
                      and _oracle_ok(m["vs_oracle_float64"]))
    return out


def _check_multiview(torch, xa, ids_t) -> dict:
    """fit_mcca_aligner (4 views, 10 components, regs 0.5) and
    joint_pca_fit (8 components, the shared latent's rank) on the card
    against the same functions on the CPU. Comparisons free of signs and
    of turns among near-equal eigenvalues: generalised eigenvalues, the
    products L L^T of each view's top-8 loadings, read-in products
    R R^T."""
    from cross_patient_speech_decoding_tpu_torch.ops import (
        cca,
        joint_pca,
        mcca,
    )

    views = [xa[i].reshape(AL_N, AL_T, AL_K) for i in range(4)]
    ids = [ids_t[0]] * 4
    t0 = time.perf_counter()
    st = mcca.fit_mcca_aligner(views, ids, AL_C, 10, regs=0.5)
    jp = joint_pca.joint_pca_fit(views, ids, AL_C, 8)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    views_c = [v.cpu() for v in views]
    ids_c = [i.cpu() for i in ids]
    st_c = mcca.fit_mcca_aligner(views_c, ids_c, AL_C, 10, regs=0.5)
    jp_c = joint_pca.joint_pca_fit(views_c, ids_c, AL_C, 8)

    def rel(a, b):
        return float((a.cpu() - b).abs().max() / b.abs().max())

    conds = []
    for v in views_c:
        avg, cnt = cca.cnd_avg(v, ids_c[0], AL_C)
        rows = avg[cnt > 0].reshape(-1, AL_K).double()
        rows = rows - rows.mean(0)
        conds.append(float(torch.linalg.cond(rows.T @ rows)))
    tol = max(MCCA_RTOL, 4 * EPS_F32 * max(conds))

    # the top AL_LAT canonical directions span the shared latent: their
    # span is well defined (a wide eigenvalue gap to the noise ones),
    # single directions are not (4 views of one latent give near-equal
    # eigenvalues)
    load = max(rel(L[:, :AL_LAT].cpu() @ L[:, :AL_LAT].cpu().T,
                   L_c[:, :AL_LAT] @ L_c[:, :AL_LAT].T)
               for L, L_c in zip(st.loadings, st_c.loadings))
    out = {"mcca_evals_rel_err": rel(st.evals, st_c.evals),
           "mcca_top_span_rel_err": load,
           "joint_pca_read_in_rel_err": max(
               rel(R @ R.T, R_c @ R_c.T)
               for R, R_c in zip(jp.read_ins, jp_c.read_ins)),
           "joint_pca_n_active": [int(jp.n_active), int(jp_c.n_active)],
           "view_gram_cond": max(conds), "card_s": card_s,
           "tolerance_rel": tol}
    out["ok"] = (out["mcca_evals_rel_err"] <= tol and load <= tol
                 and out["joint_pca_read_in_rel_err"] <= tol
                 and int(jp.n_active) == int(jp_c.n_active)
                 and bool(torch.equal(st.shared_mask.cpu(), st_c.shared_mask)))
    return out


def _sym_batch(torch, dev, seed, b, k, cond=50.0):
    """(b, k, k) float32 symmetric with eigenvalues log-uniform in [1,
    cond] (tests/test_jacobi.py:_sym)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(b, k, k)))
    w = np.exp(rng.uniform(0, np.log(cond), (b, k)))
    A = (q * w[:, None, :]) @ np.swapaxes(q, 1, 2)
    return torch.as_tensor(A.astype(np.float32), device=dev)


def _jacobi_cases(torch, dev, align):
    import numpy as np

    rng = np.random.default_rng(7)
    small = _sym_batch(torch, "cpu", 8, 1, 8)[0].numpy()
    big = 1e4 * (np.diag(rng.uniform(1, 2, 8))
                 + 1e-6 * _sym_batch(torch, "cpu", 9, 1, 8)[0].numpy())
    hetero = np.stack([small, (big + big.T) / 2]).astype(np.float32)
    x = rng.normal(size=(32, 8, 24))
    corr = np.stack([np.corrcoef(a) for a in x]).astype(np.float32)
    return {
        "path_chol_fit": align["chol_128"],
        "path_gram_fit": align["gram_256"],
        "odd_17x41": _sym_batch(torch, dev, 10, 17, 41),
        "odd_300x13": _sym_batch(torch, dev, 11, 300, 13),
        "odd_1x64": _sym_batch(torch, dev, 12, 1, 64),
        "heterogeneous_scale_2x8": torch.as_tensor(hetero, device=dev),
        "correlation_32x8": torch.as_tensor(corr, device=dev),
    }


def _check_jacobi(torch, jacobi, A) -> dict:
    """The kernel against its plain version on A (B, K, K): one sweep
    elementwise, full solves (w, V and sweep counts), and the sorted
    solve against float64 eigvalsh, its reconstruction and V^T V."""
    Ap, K, _ = jacobi._pad_odd(A)
    Ap = Ap.contiguous()
    pairs = jacobi._pairs_on(Ap.shape[-1], Ap.device)
    norm = torch.linalg.matrix_norm(Ap)[:, None]
    out = {}
    for sweeps in (1, 8):
        w, V, n = jacobi.jacobi_eigh_cuda(Ap, sweeps)
        w_p, V_p, n_p = jacobi.jacobi_eigh_plain(Ap, pairs, sweeps)
        err = torch.maximum((w - w_p).abs().amax(-1),
                            (V - V_p).abs().amax((-2, -1)))
        out[f"sweeps{sweeps}_max_abs_err"] = float(err.max())
        out[f"sweeps{sweeps}_max_err_over_norm"] = float(
            (err / norm[:, 0]).max())
        out[f"sweeps{sweeps}_bitwise"] = bool(torch.equal(w, w_p)
                                              and torch.equal(V, V_p))
        out[f"sweeps{sweeps}_counts_equal"] = bool(torch.equal(n, n_p))
    again = jacobi.jacobi_eigh_cuda(Ap, 8)  # the 8-sweep solve once more
    out["repeat_bitwise"] = all(torch.equal(a, b)
                                for a, b in zip((w, V, n), again))
    out["sweeps_run"] = n.tolist() if n.numel() <= 2 else {
        "min": int(n.min()), "max": int(n.max()), "sum": int(n.sum())}
    out["sweeps_sum"] = int(n.sum())
    out["sweeps_max"] = int(n.max())
    ws, Vs = jacobi.jacobi_eigh_pallas(A)
    w64 = torch.linalg.eigvalsh(A.double().cpu())
    scale = w64.abs().amax(-1)
    rec = (Vs @ (ws[..., None] * Vs.mT)).double().cpu()
    out["eig_err_over_max_w"] = float(((ws.double().cpu() - w64).abs()
                                       .amax(-1) / scale).max())
    out["rec_err_over_max_w"] = float(((rec - A.double().cpu()).abs()
                                       .amax((-2, -1)) / scale).max())
    eye = torch.eye(K, device=A.device)
    out["orth_err"] = float((Vs.mT @ Vs - eye).abs().max())
    return out


def _jacobi_ok(name, r) -> bool:
    tol = JAC_HETERO_RTOL if name.startswith("heterogeneous") else JAC_EIG_RTOL
    return (r["sweeps1_max_err_over_norm"] <= JAC_SWEEP1_RTOL
            and r["sweeps1_bitwise"] and r["sweeps8_bitwise"]
            and r["repeat_bitwise"]
            and r["sweeps1_counts_equal"] and r["sweeps8_counts_equal"]
            and r["eig_err_over_max_w"] <= JAC_EIG_RTOL
            and r["rec_err_over_max_w"] <= tol
            and r["orth_err"] <= JAC_ORTH_ATOL)


def _check_every_kp(torch, jacobi, dev) -> dict:
    """The kernel against its plain version at every Kp it takes (every
    even Kp from 2 to 64), at batch 1 and JAC_WIDE_BATCH (more CTAs than
    SMs), 8 sweeps: w, V and sweep counts bit for bit, and a second
    launch bit for bit equal to the first. Returns the cases that fail."""
    bad = {}
    for Kp in range(2, jacobi.MAX_K + 1, 2):
        pairs = jacobi._pairs_on(Kp, dev)
        for b in (1, JAC_WIDE_BATCH):
            A = _sym_batch(torch, dev, 100 + Kp, b, Kp)
            got = jacobi.jacobi_eigh_cuda(A)
            again = jacobi.jacobi_eigh_cuda(A)
            want = jacobi.jacobi_eigh_plain(A, pairs)
            fails = [k for k, g, a, p in zip(("w", "V", "n_sweeps"), got,
                                              again, want)
                     if not (torch.equal(g, p) and torch.equal(g, a))]
            if fails:
                bad[f"{b}x{Kp}"] = fails
    return bad


def phase_kernel_jacobi(torch, dev, jacobi, align):
    """The Jacobi kernel against its plain version on the alignment fit's
    own Gram batches and on odd shapes; times of the kernel, the plain
    version and torch.linalg.eigh on the path batches; the bound from the
    sweeps these inputs ran. Returns the kernels line's row (launches of
    one chol fit)."""
    checks = {name: _check_jacobi(torch, jacobi, A)
              for name, A in _jacobi_cases(torch, dev, align).items()}
    bad = {k: v for k, v in checks.items() if not _jacobi_ok(k, v)}
    every_kp = _check_every_kp(torch, jacobi, dev)
    if every_kp:
        bad["every_kp"] = every_kp
    rows = {}
    for name, A in (("path_chol_fit", align["chol_128"]),
                    ("path_gram_fit", align["gram_256"])):
        B, Kp, _ = A.shape
        pairs = jacobi._pairs_on(Kp, A.device)
        times = (cuda_ms(torch, lambda: jacobi.jacobi_eigh_cuda(A),
                         inner=JAC_INNER),
                 cuda_ms(torch, lambda: jacobi.jacobi_eigh_plain(A, pairs)),
                 cuda_ms(torch, lambda: torch.linalg.eigh(A)))
        flops = 9 * Kp * Kp * (Kp - 1) * checks[name]["sweeps_sum"]
        bytes_ = 2 * B * Kp * Kp * 4 + B * Kp * 4 + B * 4
        err = checks[name]["sweeps8_max_abs_err"]
        row, extra = _row("jacobi_eigh", "jacobi.cu",
                          "cross_patient_speech_decoding_tpu/ops/jacobi.py:216",
                          align["launches"]["chol"], err, times, flops, bytes_)
        rows[name] = row
        steps = checks[name]["sweeps_max"] * (Kp - 1)
        emit({"phase": "kernel", **row, "shape": [B, Kp, Kp],
              "flops": flops, "bytes": bytes_,
              "sweeps_run": checks[name]["sweeps_run"],
              "us_per_step": row["ms"] * 1e3 / steps,
              "ms_one_call": cuda_ms(
                  torch, lambda: jacobi.jacobi_eigh_cuda(A)),
              "launches_per_fit": align["launches"],
              "library_note": "torch.linalg.eigh (cuSOLVER) on the same "
                              "batch; the port never calls it for a batch "
                              "the kernel takes"})
    emit({"phase": "kernel_jacobi_checks", "checks": checks,
          "every_kp": {"kp": [2, jacobi.MAX_K], "batches": [1, JAC_WIDE_BATCH],
                       "failed": every_kp},
          "bitwise_required": True,
          "tolerances": {"sweep1_and_plain_over_norm": JAC_SWEEP1_RTOL,
                         "eig_and_rec_over_max_w": JAC_EIG_RTOL,
                         "hetero_rec_over_max_w": JAC_HETERO_RTOL,
                         "orth": JAC_ORTH_ATOL}})
    if bad:
        raise RuntimeError(f"jacobi kernel checks failed: {list(bad)}")
    return rows["path_chol_fit"]


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
