"""Pullback-metric geometry: the pullback SVD, PCA over feature space, mean
bases across samples, parallel transport between samples and the
basis-comparison gate."""

from .mean import frechet_mean_basis, hungarian_mean_basis
from .metrics import BasisComparison, compare_bases, passes_acceptance
from .pca import PCAResult, global_pca, local_pca, pca_to_x_direction
from .pullback import (
    PullbackResult,
    batched_local_pullback,
    local_decoder_pullback,
    local_encoder_pullback,
    local_pullback,
    pullback_covector,
)
from .transport import transport_all, transport_direction

__all__ = ["BasisComparison", "PCAResult", "PullbackResult", "batched_local_pullback",
           "compare_bases", "frechet_mean_basis", "global_pca", "hungarian_mean_basis",
           "local_decoder_pullback", "local_encoder_pullback", "local_pca",
           "local_pullback", "passes_acceptance", "pca_to_x_direction",
           "pullback_covector", "transport_all", "transport_direction"]
