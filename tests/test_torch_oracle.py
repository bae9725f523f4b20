"""The port's regret oracle (``pivot_tpu_torch/search/oracle.py``):
``tests/test_oracle.py`` on the port — branch-and-bound equal to brute
force, the objective's feasibility check, non-negative regret, the
objective equal to the port's own ensemble bill (``_finalize``) on the
same placement, the two greedy modes — and against ``pivot_tpu``'s
oracle on the same inputs: ``instance_from_wave`` from the same workload
and topology, the optimum, the greedy placements and the regrets.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pivot_tpu.search import oracle as JO
from pivot_tpu_torch.search.oracle import (
    OracleInstance,
    brute_force,
    greedy_placement,
    instance_from_wave,
    placement_objective,
    regret,
    solve_instance,
)
from pivot_tpu_torch.search.weights import DEFAULT_WEIGHTS, PolicyWeights


def _random_instance(seed, T=5, H=4, Z=3, risk_coeff=10.0, penalty=2.0,
                     cap_lo=2.0, cap_hi=6.0):
    rng = np.random.default_rng(seed)
    return OracleInstance(
        avail=rng.uniform(cap_lo, cap_hi, (H, 4)),
        demands=rng.uniform(0.5, 2.5, (T, 4)),
        host_zone=(np.arange(H) % Z).astype(np.int32),
        egress_tz=rng.uniform(0.0, 1.0, (T, Z)),
        hazard=rng.uniform(0.0, 0.02, H),
        risk_coeff=risk_coeff,
        unplaced_penalty=penalty,
        anchor_zone=rng.integers(0, Z, T).astype(np.int32),
        cost_zz=rng.uniform(0.1, 1.0, (Z, Z)),
        bw_zz=rng.uniform(50.0, 150.0, (Z, Z)),
    )


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_bnb_matches_brute_force_and_pivot_tpu(seed):
    inst = _random_instance(seed)
    pb, ob = brute_force(inst)
    ps, os_, stats = solve_instance(inst)
    assert abs(ob - os_) < 1e-12, (ob, os_)
    assert abs(placement_objective(inst, ps) - ob) < 1e-12
    assert stats["nodes"] >= 1
    jinst = JO.OracleInstance(*inst)
    jp, jo, jstats = JO.solve_instance(jinst)
    np.testing.assert_array_equal(ps, jp)
    assert os_ == jo and stats == jstats
    for w in (DEFAULT_WEIGHTS, PolicyWeights(w_cost=2.0, risk_weight=3.0)):
        for mode in ("first-fit", "best-fit"):
            g = greedy_placement(inst, w, bin_pack=mode)
            np.testing.assert_array_equal(
                g, JO.greedy_placement(jinst, w, bin_pack=mode))
            assert regret(inst, g, os_) == JO.regret(jinst, g, jo)


def test_bnb_matches_brute_force_tight_capacity():
    inst = _random_instance(7, T=5, H=3, cap_lo=1.0, cap_hi=2.2,
                            penalty=0.4)
    pb, ob = brute_force(inst)
    ps, os_, _ = solve_instance(inst)
    assert abs(ob - os_) < 1e-12
    assert np.any(np.asarray(ps) < 0) or np.any(np.asarray(pb) < 0)


def test_objective_infeasible_placement_raises():
    inst = _random_instance(3, T=4, H=2, cap_lo=1.0, cap_hi=1.5)
    with pytest.raises(ValueError, match="infeasible"):
        placement_objective(inst, np.zeros(4, dtype=np.int64))
    with pytest.raises(ValueError, match="placement must be"):
        placement_objective(inst, np.zeros(3, dtype=np.int64))


def test_regret_nonnegative_and_zero_at_optimum():
    inst = _random_instance(11)
    p_opt, opt, _ = solve_instance(inst)
    assert regret(inst, p_opt, opt) == 0.0
    assert regret(inst, p_opt) == 0.0
    g = greedy_placement(inst, DEFAULT_WEIGHTS)
    assert regret(inst, g, opt) >= -1e-12
    g2 = greedy_placement(inst, PolicyWeights(w_cost=2.0, risk_weight=3.0))
    assert regret(inst, g2, opt) >= -1e-12


def _wave_world():
    """A 6-host cluster and two two-stage apps in both packages, float64;
    producers round-robin, consumers by a fixed vector."""
    from pivot_tpu.ops.kernels import DeviceTopology as JTopo
    from pivot_tpu.parallel.ensemble import EnsembleWorkload as JW
    from pivot_tpu.utils import reset_ids as jreset
    from pivot_tpu.utils.config import ClusterConfig as JConfig
    from pivot_tpu.utils.config import build_cluster as jbuild
    from pivot_tpu.workload import Application as JApp
    from pivot_tpu.workload import TaskGroup as JGroup
    from pivot_tpu_torch.ops.kernels import DeviceTopology
    from pivot_tpu_torch.parallel.ensemble import EnsembleWorkload
    from pivot_tpu_torch.utils import reset_ids
    from pivot_tpu_torch.utils.config import ClusterConfig, build_cluster
    from pivot_tpu_torch.workload import Application, TaskGroup

    def apps(App, Group):
        return [App(f"a{i}", [
            Group("src", cpus=2, mem=256, runtime=50, output_size=200.0,
                  instances=3),
            Group("dst", cpus=2, mem=256, runtime=30, dependencies=["src"],
                  instances=2)]) for i in range(2)]

    jreset()
    jc = jbuild(JConfig(n_hosts=6, seed=2))
    reset_ids()
    pc = build_cluster(ClusterConfig(n_hosts=6, seed=2))
    jw = JW.from_applications(apps(JApp, JGroup), dtype=jnp.float64)
    pw = EnsembleWorkload.from_applications(apps(Application, TaskGroup),
                                            dtype=torch.float64,
                                            device="cpu")
    return (pc, pw, DeviceTopology.from_cluster(pc, torch.float64, "cpu"),
            jw, JTopo.from_cluster(jc, jnp.float64))


def test_instance_from_wave_matches_pivot_tpu():
    pc, pw, ptopo, jw, jtopo = _wave_world()
    T = pw.n_tasks
    group_of = pw.group_of.numpy()
    is_root = pw.pred_group.numpy().sum(axis=1)[group_of] == 0
    H = len(pc.hosts)
    pp = np.full(T, -1, dtype=np.int64)
    prod = np.nonzero(is_root)[0]
    pp[prod] = np.arange(len(prod)) % H
    avail = pc.availability_matrix()
    hazard = np.linspace(0.0, 0.01, H)
    for w in (DEFAULT_WEIGHTS, PolicyWeights(risk_weight=2.0,
                                             rework_cost=5.0)):
        got = instance_from_wave(pw, ptopo, avail, pp, ~is_root,
                                 hazard=hazard, weights=w)
        want = JO.instance_from_wave(jw, jtopo, avail, pp, ~is_root,
                                     hazard=hazard, weights=w)
        for f in want._fields:
            a, b = getattr(got, f), getattr(want, f)
            if isinstance(b, float):
                assert a == b, f
            else:
                assert np.asarray(a).dtype == np.asarray(b).dtype, f
                np.testing.assert_array_equal(a, b, f)
        _, opt, _ = solve_instance(got)
        _, jopt, _ = JO.solve_instance(want)
        assert opt == jopt


def test_oracle_objective_matches_simulator_egress():
    """The oracle's egress for a consumer wave equals the port's
    ensemble bill (``_finalize``) for the same placement."""
    from pivot_tpu_torch.parallel.ensemble.bill import _finalize
    from pivot_tpu_torch.parallel.ensemble.state import _DONE, RolloutState

    pc, wl, topo, _jw, _jt = _wave_world()
    T = wl.n_tasks
    group_of = wl.group_of.numpy()
    is_root = wl.pred_group.numpy().sum(axis=1)[group_of] == 0
    H = len(pc.hosts)
    pp = np.full(T, -1, dtype=np.int64)
    prod_idx = np.nonzero(is_root)[0]
    pp[prod_idx] = np.arange(len(prod_idx)) % H
    cons_idx = np.nonzero(~is_root)[0]
    cons_place = (np.arange(len(cons_idx)) * 2 + 1) % H
    avail = pc.availability_matrix()
    inst = instance_from_wave(wl, topo, avail, pp, ~is_root,
                              weights=DEFAULT_WEIGHTS, unplaced_penalty=0.0)
    assert inst.risk_coeff == 0.0
    oracle_egress = placement_objective(inst, cons_place)
    full = pp.copy()
    full[cons_idx] = cons_place
    state = RolloutState(
        t=torch.full((1,), 100.0, dtype=torch.float64),
        stage=torch.full((1, T), _DONE, dtype=torch.int64),
        finish=torch.full((1, T), 90.0, dtype=torch.float64),
        place=torch.as_tensor(full)[None],
        avail=torch.as_tensor(avail)[None],
        busy=torch.zeros(1, dtype=torch.float64),
        q=None,
        qpos=torch.full((1, T), -1, dtype=torch.int64),
    )
    sim_egress = float(_finalize(state, wl, topo).egress_cost[0])
    assert sim_egress > 0.0
    np.testing.assert_allclose(oracle_egress, sim_egress, rtol=1e-9)


def test_instance_from_experiment_harness_is_solvable():
    from pivot_tpu_torch.experiments.search import small_oracle_instance

    inst, _env = small_oracle_instance(107, device="cpu")
    _p, opt, _stats = solve_instance(inst)
    assert np.isfinite(opt)
    for w in (DEFAULT_WEIGHTS, PolicyWeights(risk_weight=1.0,
                                             rework_cost=50.0)):
        assert regret(inst, greedy_placement(inst, w), opt) >= -1e-12


def test_greedy_bin_pack_modes_mirror_policy_semantics():
    inst = OracleInstance(
        avail=np.array([[1.0, 1, 1, 1], [5.0, 5, 5, 5]]),
        demands=np.array([[1.0, 1, 1, 1]]),
        host_zone=np.array([0, 1], np.int32),
        egress_tz=np.array([[0.1, 0.9]]),
        hazard=np.zeros(2),
        risk_coeff=0.0,
        unplaced_penalty=5.0,
        anchor_zone=np.array([0], np.int32),
        cost_zz=np.array([[0.1, 1.0], [1.0, 0.1]]),
        bw_zz=np.full((2, 2), 100.0),
    )
    assert greedy_placement(inst, bin_pack="best-fit")[0] == 0
    assert greedy_placement(inst, bin_pack="first-fit")[0] == 1
    with pytest.raises(ValueError, match="bin_pack"):
        greedy_placement(inst, bin_pack="worst-fit")


def test_brute_force_refuses_large_instances():
    with pytest.raises(ValueError, match="shrink the instance"):
        brute_force(_random_instance(0, T=12, H=6))


def test_bnb_node_budget_is_loud():
    with pytest.raises(RuntimeError, match="node budget"):
        solve_instance(_random_instance(1, T=6, H=5), max_nodes=1)
