"""Ops of the port: GRU kernels, CTC, metrics, streaming DSP, and the
alignment core (PCA, CCA, MCCA, joint PCA, the Jacobi eigensolver), and
the kernel ridge classifiers of the classical decoders.

The package re-exports the names of the JAX package's ``ops/__init__.py``.
Importing it imports neither scipy nor h5py: the functions that need them
import them when called."""

from cross_patient_speech_decoding_tpu_torch.ops.cca import (
    CCAAlignment,
    FittedAligner,
    cca_align,
    cnd_avg,
    fit_cca_aligner,
    fit_cca_aligner_trial,
    shared_trial_subselect_indices,
    transform_a_to_b,
    transform_b_to_a,
    transform_shared,
)
from cross_patient_speech_decoding_tpu_torch.ops.classifiers import (
    KernelClassifier,
    bagged_classifier_fit,
    bagged_classifier_predict,
    balanced_sample_weights,
    kernel_classifier_decision,
    kernel_classifier_fit,
    kernel_classifier_predict,
    scale_gamma,
)
from cross_patient_speech_decoding_tpu_torch.ops.convert import state_from_numpy
from cross_patient_speech_decoding_tpu_torch.ops.ctc import (
    ctc_loss_mean,
    greedy_decode,
    prefix_beam_search,
)
from cross_patient_speech_decoding_tpu_torch.ops.jacobi import (
    batched_eigh,
    jacobi_eigh,
    jacobi_eigh_pallas,
)
from cross_patient_speech_decoding_tpu_torch.ops.joint_pca import (
    JointPCAState,
    joint_pca_fit,
    joint_pca_transform,
)
from cross_patient_speech_decoding_tpu_torch.ops.mcca import (
    MCCAState,
    fit_mcca_aligner,
    mcca_fit,
    mcca_transform,
)
from cross_patient_speech_decoding_tpu_torch.ops.metrics import (
    balanced_accuracy,
    cmat_acc,
    confusion_matrix,
    edit_distance,
    pearson_r,
    per_batch,
    pt_corr,
    pt_corr_dims,
    pt_corr_multi,
)
from cross_patient_speech_decoding_tpu_torch.ops.pca import (
    PCAState,
    n_components_for_variance,
    nocenter_pca_fit,
    pca_fit,
    pca_fit_transform,
    pca_inverse_transform,
    pca_transform,
)
from cross_patient_speech_decoding_tpu_torch.ops.precision import hdot, hpinv
from cross_patient_speech_decoding_tpu_torch.ops.signal import (
    car,
    compute_bin_power,
    filter_hg_bin,
    fir_filter,
    iir_filter_stateful,
    init_stream_state,
    lfilter_zi,
    process_hg_chunk,
)

__all__ = [
    "CCAAlignment",
    "FittedAligner",
    "JointPCAState",
    "KernelClassifier",
    "MCCAState",
    "PCAState",
    "bagged_classifier_fit",
    "bagged_classifier_predict",
    "balanced_accuracy",
    "balanced_sample_weights",
    "batched_eigh",
    "car",
    "cca_align",
    "cmat_acc",
    "cnd_avg",
    "compute_bin_power",
    "confusion_matrix",
    "ctc_loss_mean",
    "edit_distance",
    "filter_hg_bin",
    "fir_filter",
    "fit_cca_aligner",
    "fit_cca_aligner_trial",
    "fit_mcca_aligner",
    "greedy_decode",
    "hdot",
    "hpinv",
    "iir_filter_stateful",
    "init_stream_state",
    "jacobi_eigh",
    "jacobi_eigh_pallas",
    "joint_pca_fit",
    "joint_pca_transform",
    "kernel_classifier_decision",
    "kernel_classifier_fit",
    "kernel_classifier_predict",
    "lfilter_zi",
    "mcca_fit",
    "mcca_transform",
    "n_components_for_variance",
    "nocenter_pca_fit",
    "pca_fit",
    "pca_fit_transform",
    "pca_inverse_transform",
    "pca_transform",
    "pearson_r",
    "per_batch",
    "prefix_beam_search",
    "process_hg_chunk",
    "pt_corr",
    "pt_corr_dims",
    "pt_corr_multi",
    "scale_gamma",
    "shared_trial_subselect_indices",
    "state_from_numpy",
    "transform_a_to_b",
    "transform_b_to_a",
    "transform_shared",
]
