"""Hand-written CUDA kernels (sources in ``csrc/``) and their plain versions.
Importing this package builds nothing: the kernels compile at first launch."""

from .block_kernels import (
    LAUNCHES,
    MAX_SWEEPS,
    bt_matvec_plain,
    chebyshev_coefficients,
    chebyshev_multisweep,
    chebyshev_multisweep_plain,
    chebyshev_multisweep_residual,
    chebyshev_multisweep_residual_plain,
    ff_stencil_mid_defect,
    ff_stencil_mid_defect_plain,
    fused_bt_matvec,
    multisweep,
    multisweep_plain,
    multisweep_residual,
    multisweep_residual_plain,
    reset_launch_counts,
)

__all__ = [
    "LAUNCHES",
    "MAX_SWEEPS",
    "bt_matvec_plain",
    "chebyshev_coefficients",
    "chebyshev_multisweep",
    "chebyshev_multisweep_plain",
    "chebyshev_multisweep_residual",
    "chebyshev_multisweep_residual_plain",
    "ff_stencil_mid_defect",
    "ff_stencil_mid_defect_plain",
    "fused_bt_matvec",
    "multisweep",
    "multisweep_plain",
    "multisweep_residual",
    "multisweep_residual_plain",
    "reset_launch_counts",
]
