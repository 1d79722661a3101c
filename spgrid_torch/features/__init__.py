"""Structural and value features of a CSR matrix: the port's copies of
``spgrid/features/{structural,values}.py``, which fill a benchmark row's
feature columns."""

from spgrid_torch.features.structural import (
    MatrixFeatures, matrix_features, twin_params,
)
from spgrid_torch.features.values import (
    ValueFeatures, kmeans_1d, value_features,
)

__all__ = ["MatrixFeatures", "ValueFeatures", "kmeans_1d", "matrix_features",
           "twin_params", "value_features"]
