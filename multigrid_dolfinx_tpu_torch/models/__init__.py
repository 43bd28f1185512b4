"""Ready-made problem configurations."""
from .poisson import poisson2d, poisson3d

__all__ = ["poisson2d", "poisson3d"]
