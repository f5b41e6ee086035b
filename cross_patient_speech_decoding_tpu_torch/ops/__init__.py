"""Ops of the port: GRU kernels, CTC, metrics, streaming DSP, and the
alignment core (PCA, CCA, MCCA, joint PCA, the Jacobi eigensolver), and
the kernel ridge classifiers of the classical decoders."""

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
    kernel_classifier_decision,
    kernel_classifier_fit,
    kernel_classifier_predict,
)
from cross_patient_speech_decoding_tpu_torch.ops.convert import state_from_numpy
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

__all__ = [
    "CCAAlignment",
    "FittedAligner",
    "JointPCAState",
    "KernelClassifier",
    "MCCAState",
    "PCAState",
    "bagged_classifier_fit",
    "bagged_classifier_predict",
    "batched_eigh",
    "cca_align",
    "cnd_avg",
    "fit_cca_aligner",
    "fit_cca_aligner_trial",
    "fit_mcca_aligner",
    "hdot",
    "hpinv",
    "jacobi_eigh",
    "jacobi_eigh_pallas",
    "kernel_classifier_decision",
    "kernel_classifier_fit",
    "kernel_classifier_predict",
    "joint_pca_fit",
    "joint_pca_transform",
    "mcca_fit",
    "mcca_transform",
    "n_components_for_variance",
    "nocenter_pca_fit",
    "pca_fit",
    "pca_fit_transform",
    "pca_inverse_transform",
    "pca_transform",
    "shared_trial_subselect_indices",
    "state_from_numpy",
    "transform_a_to_b",
    "transform_b_to_a",
    "transform_shared",
]
