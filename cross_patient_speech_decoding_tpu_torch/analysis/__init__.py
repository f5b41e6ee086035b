"""Statistics / figure-analysis layer (reference L6) of the port.

Port of ``cross_patient_speech_decoding_tpu/analysis``, with the same
exports.

The reference's 29 notebooks are its de-facto regression harness
(SURVEY.md §2.8): Wilcoxon/ANOVA/Tukey/FDR over 50-iteration decode
distributions (fig_4, fig_5), silhouette/t-SNE latent-space clustering
(fig_2), and representational-similarity analysis (fig_6). This package
provides that machinery as tested, *vectorized* functions: every test
broadcasts over leading batch axes so a whole (contexts x patients x
metrics) table is one call, and the O(N^2) geometry of the cluster scores
and t-SNE runs on the device (``cluster.py``).
"""

from .stats import (
    anova_rm,
    f_oneway,
    fdr_bh,
    mann_whitney_u,
    paired_permutation_test,
    ttest_ind,
    ttest_rel,
    tukey_hsd,
    wilcoxon_signed_rank,
)
from .cluster import (
    calinski_harabasz,
    davies_bouldin,
    pairwise_sq_dists,
    pca_embed,
    silhouette_positive_mean,
    silhouette_samples,
    tsne_embed,
)
from .rsa import compare_rdms, rdm_correlation, subset_rdm
from .contexts import (
    anova_tukey_by_group,
    cmat_accuracy_from_results,
    context_comparison_table,
    prediction_records_from_results,
    rm_anova_followup,
)
from .latency import latency_comparison, latency_report

__all__ = [
    "anova_rm",
    "cmat_accuracy_from_results",
    "prediction_records_from_results",
    "f_oneway",
    "fdr_bh",
    "mann_whitney_u",
    "paired_permutation_test",
    "ttest_ind",
    "ttest_rel",
    "tukey_hsd",
    "wilcoxon_signed_rank",
    "calinski_harabasz",
    "davies_bouldin",
    "pairwise_sq_dists",
    "pca_embed",
    "silhouette_positive_mean",
    "silhouette_samples",
    "tsne_embed",
    "compare_rdms",
    "rdm_correlation",
    "subset_rdm",
    "anova_tukey_by_group",
    "context_comparison_table",
    "rm_anova_followup",
    "latency_comparison",
    "latency_report",
]
