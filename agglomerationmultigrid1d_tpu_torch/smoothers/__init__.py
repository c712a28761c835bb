from .smoother import BlockJacobiSmoother, apply_smoother, dg_smoother

__all__ = ["BlockJacobiSmoother", "apply_smoother", "dg_smoother"]
