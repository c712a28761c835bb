from .smoother import (
    BlockJacobiSmoother,
    ChebyshevSmoother,
    JacobiSmoother,
    SchwarzSmoother,
    Smoother,
    apply_smoother,
    cg_smoother,
    dg_smoother,
)

__all__ = [
    "BlockJacobiSmoother",
    "ChebyshevSmoother",
    "JacobiSmoother",
    "SchwarzSmoother",
    "Smoother",
    "apply_smoother",
    "cg_smoother",
    "dg_smoother",
]
