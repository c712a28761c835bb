"""The stencil-built flagship at 131,073 DoF (``bench.py:369-394``'s spec:
CG p = 8, 4, 2, 1, 4 agglomerated levels down to 512 blocks, c_dir = 1000 n,
n = 16,384) solved by ``_mixed_loop_ff`` on the JAX package's inputs
(``xl_problem_from_numpy``), beside JAX's ``_mixed_loop_ff(use_pallas=False)``,
on the CPU.

At c_dir = 1000 n the float32 inner V-cycle is noise-dominated, so the
V-cycle count follows its rounding (ROADMAP queue 3, G13): JAX takes 12 / 11
(damped / Chebyshev) on the TPU (``BENCH_r05.json``) and 16 / 14 on its CPU
path.  The port's counts on these shared inputs, ``PORT_CPU_CYCLES``, are the
reference that ``chip_smoke.py`` holds the H100's solve to (within 2).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agglomerationmultigrid1d_tpu.models.solvers import _mixed_loop_ff as jmixed_loop_ff
from agglomerationmultigrid1d_tpu.models.stencil_setup import build_xl_problem as jbuild_xl_problem
from agglomerationmultigrid1d_tpu.ops.df64 import FF as JFF
from agglomerationmultigrid1d_tpu.utils.config import HierarchySpec as JHierarchySpec
from agglomerationmultigrid1d_tpu_torch.models.solvers import _mixed_loop_ff
from agglomerationmultigrid1d_tpu_torch.ops.df64 import FF
from agglomerationmultigrid1d_tpu_torch.utils.convert import xl_problem_from_numpy

N = 16384
SPEC = dict(cg_orders=(8, 4, 2, 1), n_agg_levels=4, p_agg=1, c_dir=1000.0 * N)
LOOP = dict(maxiter=60, tol=1e-10, inner_tol=3.0e-5, max_inner=20)
PORT_CPU_CYCLES = {"damped": 16, "chebyshev": 12}  # chip_smoke.py's FLAGSHIP_XL_PORT_CPU
JAX_CPU_CYCLES = {"damped": 16, "chebyshev": 14}


@functools.lru_cache(maxsize=None)
def _jax_xl(cheb):
    out = jbuild_xl_problem(JHierarchySpec(**SPEC), N, chebyshev=cheb)
    return out, jax.tree_util.tree_map(np.asarray, out[:3])


@pytest.mark.parametrize("tag", ["damped", "chebyshev"])
def test_flagship_mixed_loop_ff_counts_on_shared_inputs(tag):
    (jh, ja, jb, jnb), np_parts = _jax_xl(tag == "chebyshev")
    zero = jnp.zeros_like(jb.hi)
    _, jouter, jcycles, jhist = jmixed_loop_ff(
        jh, ja, JFF(zero, zero), jb, jnp.asarray(1.0 / jnb, jnp.float32), n_pre=3, n_post=3, alpha=2.0 / 3.0,
        use_pallas=False, **LOOP)
    h, a_ff, b, nb = xl_problem_from_numpy(*np_parts, jnb, device="cpu")
    z = torch.zeros_like(b.hi)
    x, outer, cycles, hist = _mixed_loop_ff(h, a_ff, FF(z, z), b, np.float32(1.0 / nb), **LOOP)
    jouter, jcycles = int(jouter), int(jcycles)
    assert hist[outer - 1] < 1e-10 and np.asarray(jhist)[jouter - 1] < 1e-10
    assert abs(jcycles - JAX_CPU_CYCLES[tag]) <= 2, (jouter, jcycles)
    assert abs(cycles - PORT_CPU_CYCLES[tag]) <= 2, (outer, cycles)
    # the noise-dominated inner cycle parts the two packages by up to 3 outer steps and 2 V-cycles here
    assert abs(outer - jouter) <= 3 and abs(cycles - jcycles) <= 2, (outer, cycles, jouter, jcycles)
    assert bool(torch.isfinite(x.hi).all())
