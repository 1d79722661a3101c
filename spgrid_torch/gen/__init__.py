"""Matrix and mask generation: the port's own copies of ``spgrid.gen``."""

from spgrid_torch.gen.artificial import artificial_matrix_generation
from spgrid_torch.gen.masks import create_mask
from spgrid_torch.gen.params import GenParams, read_param_file

__all__ = ["artificial_matrix_generation", "create_mask", "GenParams",
           "read_param_file"]
