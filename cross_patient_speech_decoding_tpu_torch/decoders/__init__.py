"""Cross-patient pooled decoders (the classical path) of the port.

The fold programs (``pooled``) and the nested search (``nested_cv``) are
imported here; the sklearn-surface estimators of ``sklearn_compat`` are
exported lazily, on first access, so that the package imports where
scikit-learn is not installed.
"""

from cross_patient_speech_decoding_tpu_torch.decoders.nested_cv import (
    make_nested_cv_decoder,
    nested_cv_decode,
    sample_candidates,
)
from cross_patient_speech_decoding_tpu_torch.decoders.pooled import (
    DecodeConfig,
    PatientArrays,
    decode_fold_joint_pca,
    decode_fold_mcca,
    decode_fold_sep_align,
    decode_fold_sep_dimred,
    make_cv_decoder,
)

_SKLEARN_COMPAT = (
    "AlignCCA",
    "CrossPtDecoderSepAlign",
    "CrossPtDecoderSepDimRed",
    "CrossPtDecoderJointPCA",
    "CrossPtDecoderMCCA",
    "DimRedReshape",
    "JaxPCA",
    "NoCenterPCA",
)


def __getattr__(name):
    if name in _SKLEARN_COMPAT:
        from cross_patient_speech_decoding_tpu_torch.decoders import (
            sklearn_compat,
        )

        return getattr(sklearn_compat, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
