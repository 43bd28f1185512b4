"""Ready-made problem configurations."""
from .poisson import (poisson2d, poisson3d, poisson3d_p2,
                      variable_coefficient_2d, variable_coefficient_3d)

__all__ = ["poisson2d", "poisson3d", "poisson3d_p2",
           "variable_coefficient_2d", "variable_coefficient_3d"]
