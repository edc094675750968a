"""The kernels' orders of K2–K4 and K12a against the JAX package.

The plain versions in the kernels' orders — ``tree_sweep_blocked_plain``
(the subtree-blocked sweep, block by block from the sweep plan) and
``core_elim_table_plain`` (the min-degree rounds from the packed round
table) — against the JAX functions they replace, on the same inputs made
from a seed, at the tolerances the port's tests already pin: the blocked
sweep's λ and norm at 1e-12·scale (``tests/test_torch_kernels.py``), the
core solve at 1e-10·scale with a dense tail (the reference factors it in
float32 and refines) and 1e-12 without (``tests/test_torch_core_elim.py``).
The forced web48 plans are the reference's array for array.  CPU only;
the card tests of these kernels are in the JAX-free files
``tests/test_torch_blocked_subtree.py`` and ``tests/test_torch_core_rounds.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import networks_fenicsx_tpu as J
import networks_fenicsx_tpu_torch as P
from networks_fenicsx_tpu import solver as JS
from networks_fenicsx_tpu.ops import core_elim as JCE
from networks_fenicsx_tpu_torch import blocked as PB
from networks_fenicsx_tpu_torch.kernels import core_elim
from networks_fenicsx_tpu_torch.kernels import tree_sweep as TS
from networks_fenicsx_tpu_torch.ops import core_elim as PCE

import test_torch_blocked_subtree as BT
import test_torch_core_rounds as CR
from _torch_cases import assert_plans_equal

torch.set_num_threads(1)


@pytest.mark.parametrize("name", sorted(BT.TOPOLOGIES))
def test_blocked_plain_matches_blocked_eliminate(monkeypatch, name):
    graph, consts = BT.TOPOLOGIES[name]
    for k, v in consts.items():
        monkeypatch.setattr(PB, k, v)
    plan = PB._plan_blocked(BT._asm(P, graph))
    w, const, Ftot = BT._inputs(plan)
    lam, norm, *_ = TS.tree_sweep_blocked_plain(PB.device_plan(plan, "cpu"), w, const, Ftot)
    jplan = JS._plan_blocked(BT._asm(J, graph))
    _, lam_j, norm_j = JS._blocked_eliminate(jplan, *(jnp.asarray(t.numpy()) for t in (w, const, Ftot)))
    lam_j, norm_j = np.asarray(lam_j), float(norm_j)
    assert float(np.abs(lam.numpy() - lam_j).max()) <= 1e-12 * max(1.0, float(np.abs(lam_j).max()))
    assert abs(float(norm) - norm_j) <= 1e-12 * max(1.0, norm_j)


@pytest.mark.parametrize("case,tol", [
    ("web2k-default", 1e-10), ("web150-no-tail", 1e-12), ("grid40-nd-tail", 1e-10),
    ("grid40-fronts", 1e-12), ("web48-sparse", 1e-10), ("web48-supernodal", 1e-12),
    ("bed4-default", 1e-10),
])
def test_table_plain_matches_core_factor_and_apply(case, tol):
    name, kw = CR.CASES[case]
    cp, n = CR._core(name)
    kw = kw()
    pj = JCE.plan_core_elimination(cp, n, **kw)
    pp = PCE.plan_core_elimination(cp, n, **kw)
    assert_plans_equal(pj, pp)
    dc, w, rc = CR._system(case, seed=4)
    state = jax.jit(lambda d, ww: JCE._core_factor(pj, d, ww))(jnp.asarray(dc.numpy()),
                                                               jnp.asarray(w.numpy()))
    want = np.asarray(jax.jit(lambda st, r: JCE._core_apply(pj, st, r))(state, jnp.asarray(rc.numpy())))
    got = core_elim.core_elim_table_plain(PCE.device_core_plan(pp, "cpu"), dc, w, rc).numpy()
    assert float(np.abs(got - want).max()) <= tol * max(1.0, float(np.abs(want).max()))
