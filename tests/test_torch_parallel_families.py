"""The torch port's sharding of the hierarchy families beyond block-tridiagonal
and CG levels, against the JAX package's ``shard_hierarchy`` on the CPU.

Four chains, each the JAX package's hierarchy carried across with
``utils.convert.hierarchy_from_numpy`` (the same inputs for both packages):

* ``switch``: the mixed-switch chain (``poisson_switch_hierarchy``'s shape at
  n = 256, three 2:1 levels), every level block-pentadiagonal;
* ``scattered``: ``poisson_scattered_hierarchy(n=256, p_dg=1,
  groups_per_level=interleaved_pair_groups(256, 16))``, four block-COO levels
  under ``ScatteredProlong``;
* ``ragged``: ``poisson_dg_hierarchy(n=250, max_p=3, n_dg=2, n_agg=4)``,
  250 -> 62 through ``RaggedBlockProlong`` (on two ranks both sharded, the
  agglomerates straddling the ranks; on four, 250 does not divide and every
  level is whole, as JAX's rule keeps it);
* ``straddle``: ``poisson_dg_hierarchy(n=24, max_p=1, n_dg=1, n_agg=2)``
  (24 -> 6 -> 3 blocks), the uniform 2:1 groups of a sharded level over a
  whole coarse level that the world does not divide;

and, port only, on two ranks a CG-topped chain with a ragged seam (42 CG
elements under 4:1 agglomeration) and on four a 252-element DG chain (252
sharded over 63 whole agglomerates of 4).

One spawned gloo group per world size (``torch_group.run_group``), 2 and 4
ranks, runs every job.  Held: the port's ``layout.sharded`` equals the levels
whose arrays JAX's ``shard_hierarchy`` shards on as many virtual CPU
devices; float64 ``multigrid`` takes JAX's sharded count, its history
within rtol 1e-9 of JAX's above a 1e-12 floor of the first entry, and x
within 1e-12 of max|x| of the port's unsharded x; ``multigrid_mixed`` within
1 outer step and 2 inner cycles of JAX's sharded solve (switch, scattered);
``multigrid_progressive`` on the switch chain the port's unsharded count.
And each new exchange against the unsharded operator on random data from a
numpy seed: the straddling and ragged transfers (with the ragged seam), the
pentadiagonal halo (the matvec and the float-float defect), the block-COO
plan (the matvec and the scattered transfers).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import torch_group as tg
from agglomerationmultigrid1d_tpu import ops as jops
from agglomerationmultigrid1d_tpu.assembly import dg_assembly as jdg_asm
from agglomerationmultigrid1d_tpu.mesh import agg_mesh as jagg_mesh
from agglomerationmultigrid1d_tpu.mesh import dg_mesh as jdg_mesh
from agglomerationmultigrid1d_tpu.mesh import topology as jtopo
from agglomerationmultigrid1d_tpu.models import hierarchy as jhier
from agglomerationmultigrid1d_tpu.models import problems as jproblems
from agglomerationmultigrid1d_tpu.models import solvers as jsolvers
from agglomerationmultigrid1d_tpu.parallel import make_solver_mesh
from agglomerationmultigrid1d_tpu.parallel import shard_hierarchy as jshard_hierarchy
from agglomerationmultigrid1d_tpu.parallel.distributed import shard_vector as jshard_vector
from agglomerationmultigrid1d_tpu_torch.models import (
    build_problem,
    interleaved_pair_groups,
    make_low_precision_hierarchy,
    multigrid,
    multigrid_mixed,
    multigrid_progressive,
)
from agglomerationmultigrid1d_tpu_torch.models.solvers import level_matvec, transfer_prolong, transfer_restrict
from agglomerationmultigrid1d_tpu_torch.ops import BlockPenta
from agglomerationmultigrid1d_tpu_torch.ops.df64 import FF, bp5_split, ff_defect, ff_join, ff_split
from agglomerationmultigrid1d_tpu_torch.utils.config import HierarchySpec
from agglomerationmultigrid1d_tpu_torch.utils.convert import hierarchy_from_numpy

WORLDS = (2, 4)
JAX_CHAINS = ("switch", "scattered", "ragged", "straddle")
PORT_ONLY = {2: "ragged-seam", 4: "ragged-252"}
MIN_BLOCKS = {"straddle": 1, "ragged-seam": 1}  # else 4
SOLVERS = {"switch": ("mixed", "progressive"), "scattered": ("mixed",)}
SEED = 5


def _jax_switch_chain(n, n_coarsen):
    """The JAX package's mixed-switch chain: DG p = 3 -> DG p = 1 -> agg r = 2
    -> ``n_coarsen`` x 2:1, every level pentadiagonal."""
    func, u_ex, ux_ex = jproblems.default_model_problem()
    bc, c_dir = jproblems._default_bc(u_ex, ux_ex), 1000.0 * n
    s = np.array([False] * (n // 2) + [True] * (n - 1 - n // 2))
    mesh = jtopo.create_uniform_mesh(n, 0.0, 1.0)
    meshes = [jdg_mesh.make_dg_mesh(mesh, 3, switch=s), jdg_mesh.make_dg_mesh(mesh, 1, switch=s),
              jagg_mesh.make_agg_mesh(1, mesh, 2, tables=False)]
    for _ in range(n_coarsen):
        meshes.append(jagg_mesh.coarsen_agg_mesh(meshes[-1], 2))
    g, d, c = jdg_asm.dg_flux_operators(meshes[0], bc, c_dir)
    h = jhier.build_dg_hierarchy(meshes, jhier.schur_stiffness(g, d, c, meshes[0].mass_inv, mixed_switch=True),
                                 g, d, c)
    f, r = jdg_asm.dg_flux_rhs(meshes[0], func, bc, c_dir)
    return h, f - jops.bt_matvec(d, jops.bd_matvec(meshes[0].mass_inv, r))


def _jax_chain(name):
    if name == "switch":
        return _jax_switch_chain(256, 3)
    if name == "scattered":
        groups = [g.tolist() for g in interleaved_pair_groups(256, 16)]
        prob = jproblems.poisson_scattered_hierarchy(n=256, p_dg=1, groups_per_level=groups, to_device=False)
    elif name == "ragged":
        prob = jproblems.poisson_dg_hierarchy(n=250, max_p=3, n_dg=2, n_agg=4)
    elif name == "ragged-252":
        prob = jproblems.poisson_dg_hierarchy(n=252, max_p=3, n_dg=2, n_agg=4)
    else:
        prob = jproblems.poisson_dg_hierarchy(n=24, max_p=1, n_dg=1, n_agg=2)
    return prob.hierarchy, prob.b


def _port_chain(name):
    """``(jax hierarchy or None, port hierarchy, b)``."""
    if name == "ragged-seam":
        spec = HierarchySpec(cg_orders=(2, 1), n_agg_levels=1, p_agg=1, c_dir=1e4)
        prob = build_problem(spec, 42, device="cpu")
        return None, prob.hierarchy, prob.b.numpy()
    jh, jb = _jax_chain(name)
    return jh, hierarchy_from_numpy(jax.tree_util.tree_map(np.asarray, jh), device="cpu"), np.array(jb)


def _chains(world):
    return JAX_CHAINS + (PORT_ONLY[world],)


def _random_vecs(h):
    rng = np.random.default_rng(SEED)
    return [rng.standard_normal(lv.a.n_nodes if not hasattr(lv.a, "block_size") else (lv.a.block_size, lv.a.n_blocks))
            for lv in h.levels]


@pytest.fixture(scope="module")
def chains():
    """Every chain once: the JAX hierarchy and rhs, the port's, and the
    port's unsharded float64 solve."""
    out = {}
    for name in set(JAX_CHAINS) | set(PORT_ONLY.values()):
        jh, h, b = _port_chain(name)
        bt = torch.from_numpy(b)
        out[name] = dict(jh=jh, h=h, b=b, ref=multigrid(h, torch.zeros_like(bt), bt, 60, 1e-10, compute_error=False))
    return out


def _spawn(chains, world, tmp_path_factory):
    jobs = []
    for name in _chains(world):
        c = chains[name]
        mb = MIN_BLOCKS.get(name, 4)
        jobs.append((f"solve-{name}", tg.job_family_solves, (c["h"], c["b"], mb, SOLVERS.get(name, ()))))
        jobs.append((f"ops-{name}", tg.job_family_ops, (c["h"], mb, _random_vecs(c["h"]))))
    store = tmp_path_factory.mktemp(f"gloo{world}") / "store"
    return tg.run_group(jobs, world, str(store), timeout_s=240)


@pytest.fixture(scope="module")
def group2(chains, tmp_path_factory):
    return _spawn(chains, 2, tmp_path_factory)


@pytest.fixture(scope="module")
def group4(chains, tmp_path_factory):
    return _spawn(chains, 4, tmp_path_factory)


@pytest.fixture
def group(request):
    return request.getfixturevalue(f"group{request.param}")


def _jax_sharded(jh, jb, world, name):
    mesh = make_solver_mesh(world)
    return mesh, jshard_hierarchy(jh, mesh, min_blocks_per_device=MIN_BLOCKS.get(name, 4)), jshard_vector(jb, mesh)


CASES = [(w, name) for w in WORLDS for name in _chains(w)]
JAX_CASES = [(w, name) for w, name in CASES if name in JAX_CHAINS]


@pytest.mark.parametrize("group,name", JAX_CASES, indirect=["group"], ids=[f"{w}-{n}" for w, n in JAX_CASES])
def test_layout_is_jax_rule(group, chains, name):
    """``layout.sharded`` on every rank: the levels whose arrays JAX's
    ``shard_hierarchy`` shards (its ``mass_inv`` carries the element axis)."""
    jh, jb = chains[name]["jh"], jnp.asarray(chains[name]["b"])
    world = len(group[f"solve-{name}"])
    _, jhs, _ = _jax_sharded(jh, jb, world, name)
    want = tuple(not lv.mass_inv.sharding.is_fully_replicated for lv in jhs.levels)
    for per_rank in tg.check(group[f"solve-{name}"]):
        assert per_rank["flags"] == want


def _history_close(got, want, it):
    got, want = np.asarray(got)[:it], np.asarray(want)[:it]
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12 * want[0])


@pytest.mark.parametrize("group,name", CASES, indirect=["group"], ids=[f"{w}-{n}" for w, n in CASES])
def test_sharded_multigrid_matches(group, chains, name):
    """float64 ``multigrid``: the port's unsharded count and, on the JAX
    chains, JAX's sharded count and history; x within 1e-12 of max|x| of
    the port's unsharded x, on every rank."""
    c = chains[name]
    ref = c["ref"]
    results = tg.check(group[f"solve-{name}"])
    got = results[0]["multigrid"]
    it = got["iterations"]
    assert it == ref.iterations
    _history_close(got["res"], ref.res_history.numpy(), it)
    for per_rank in results:
        x = per_rank["multigrid"]["x"]
        assert np.abs(x - ref.x.numpy()).max() <= 1e-12 * np.abs(ref.x.numpy()).max()
    if c["jh"] is None:
        return
    world = len(results)
    _, jhs, jbs = _jax_sharded(c["jh"], jnp.asarray(c["b"]), world, name)
    jres = jsolvers.multigrid(jhs, jnp.zeros_like(jbs), jbs, 60, 1e-10, compute_error=False)
    assert it == int(jres.iterations)
    _history_close(got["res"], jres.res_history, it)


MIXED_CASES = [(w, n) for w in WORLDS for n in ("switch", "scattered")]


@pytest.mark.parametrize("group,name", MIXED_CASES, indirect=["group"], ids=[f"{w}-{n}" for w, n in MIXED_CASES])
def test_sharded_mixed_matches_jax(group, chains, name):
    """``multigrid_mixed`` on the sharded chain (float32 inner cycles on
    pentadiagonal or block-COO levels, no kernel): within one outer step
    and two inner cycles of JAX's sharded solve, converged."""
    c = chains[name]
    got = tg.check(group[f"solve-{name}"])[0]["mixed"]
    world = len(group[f"solve-{name}"])
    mesh, jhs, jbs = _jax_sharded(c["jh"], jnp.asarray(c["b"]), world, name)
    jh32 = jshard_hierarchy(jsolvers.make_low_precision_hierarchy(c["jh"]), mesh,
                            min_blocks_per_device=MIN_BLOCKS.get(name, 4))
    jres = jsolvers.multigrid_mixed(jhs, jh32, jnp.zeros_like(jbs), jbs, 60, 1e-10, use_pallas=False)
    assert abs(got["iterations"] - int(jres.iterations)) <= 1, (got["iterations"], int(jres.iterations))
    assert abs(got["inner"] - int(jres.inner_cycles)) <= 2, (got["inner"], int(jres.inner_cycles))
    assert got["res"][got["iterations"] - 1] < 1e-10 * np.linalg.norm(c["b"])


@pytest.mark.parametrize("group", WORLDS, indirect=True)
def test_sharded_progressive_switch_chain(group, chains):
    """``multigrid_progressive`` on the sharded mixed-switch chain (the
    float-float pentadiagonal defect reads two columns a side): the port's
    unsharded count, x within 1e-9 of max|x|."""
    c = chains["switch"]
    h, b = c["h"], torch.from_numpy(c["b"])
    ref = multigrid_progressive(h, make_low_precision_hierarchy(h), torch.zeros_like(b), b, 60, 1e-10)
    got = tg.check(group["solve-switch"])[0]["progressive"]
    assert got["iterations"] == ref.iterations
    assert np.abs(got["x"] - ref.x.numpy()).max() <= 1e-9 * np.abs(ref.x.numpy()).max()
    mixed = multigrid_mixed(h, make_low_precision_hierarchy(h), torch.zeros_like(b), b, 60, 1e-10)
    assert abs(tg.check(group["solve-switch"])[0]["mixed"]["iterations"] - mixed.iterations) <= 1


def _whole_ops(h, vecs):
    """``job_family_ops``'s results from the unsharded port."""
    out = {}
    for k, lv in enumerate(h.levels):
        x = torch.from_numpy(vecs[k])
        out[f"matvec{k}"] = level_matvec(lv, x).numpy()
        if isinstance(lv.a, BlockPenta):
            xf, zero = ff_split(x), torch.zeros(x.shape, dtype=torch.float32)
            out[f"ff_defect{k}"] = ff_join(ff_defect(bp5_split(lv.a), xf, FF(zero, zero))).numpy()
    for k, t in enumerate(h.transfers):
        out[f"prolong{k}"] = transfer_prolong(t, torch.from_numpy(vecs[k + 1])).numpy()
        out[f"restrict{k}"] = transfer_restrict(t, torch.from_numpy(vecs[k])).numpy()
    return out


def _ops_close(group, chains, name, keys):
    want = _whole_ops(chains[name]["h"], _random_vecs(chains[name]["h"]))
    checked = 0
    for per_rank in tg.check(group[f"ops-{name}"]):
        for key, w in want.items():
            if key.rstrip("0123456789") in keys:
                np.testing.assert_allclose(per_rank[key], w, rtol=0, atol=1e-13 * np.abs(w).max(), err_msg=key)
                checked += 1
    return checked


STRADDLE_CASES = [(w, n) for w in WORLDS for n in ("ragged", "straddle", PORT_ONLY[w])]


@pytest.mark.parametrize("group,name", STRADDLE_CASES, indirect=["group"], ids=[f"{w}-{n}" for w, n in STRADDLE_CASES])
def test_straddling_transfers_match_whole(group, chains, name):
    """The transfers onto sharded levels whose agglomerates straddle the
    ranks (ragged groups, a coarse count the world does not divide, a ragged
    seam), a whole level below a sharded one and a sharded one below a whole
    one: prolongation and restriction of random vectors, gathered, against
    the unsharded transfers to 1e-13 of their max."""
    assert _ops_close(group, chains, name, ("prolong", "restrict", "matvec")) > 0


@pytest.mark.parametrize("group", WORLDS, indirect=True)
def test_penta_halo_matches_whole(group, chains):
    """Every sharded pentadiagonal level's matvec and float-float defect
    (two columns a side from the neighbours, hi and lo in one exchange), and
    the chain's transfers, against the unsharded ones to 1e-13 of their max."""
    flags = tg.check(group["ops-switch"])[0]["flags"]
    assert sum(flags) >= 3
    assert _ops_close(group, chains, "switch", ("matvec", "ff_defect", "prolong", "restrict")) > 0


@pytest.mark.parametrize("group", WORLDS, indirect=True)
def test_coo_plan_matches_whole(group, chains):
    """Every sharded block-COO level's matvec (its rows' columns read
    through the exchange plan) and the scattered transfers' prolongation
    and restriction (the owners' columns read, the partial sums added at
    the owners), against the unsharded ones to 1e-13 of their max."""
    flags = tg.check(group["ops-scattered"])[0]["flags"]
    assert sum(flags[1:]) >= 3
    assert _ops_close(group, chains, "scattered", ("matvec", "prolong", "restrict")) > 0
