"""Ready-made problem configurations."""
from .poisson import poisson3d

__all__ = ["poisson3d"]
