"""Elastic meshes in the port — the re-layout helpers of
``ops/shard.py``, ``CudaPolicy.reshard`` / ``enable_fault_gate`` and
``serve/elastic.py::ElasticMeshManager`` — against ``pivot_tpu``.

Seven of ``pivot_tpu``'s own elastic cases (``tests/test_elastic.py``)
fail under this jax: they reach ``shard_map(check_rep=)``.  Its contract
(``pivot_tpu/serve/elastic.py:38-48``, ``ops/shard.py:1914-1930``) is that
a shrink changes where state lives, never what is decided, so the port
is held against the reference pieces that run, on the CPU in float64 on
meshes of S logical CPU shards, bit for bit:

  * **helpers** — the ladder and the pad / trim / pad-state helpers
    against the reference's numpy helpers, over H in {1, 10, 16, 600},
    S in {1, 3, 4, 7, 8} and both float dtypes;
  * **padded spans** — every arm's sharded span on operands padded to a
    non-dividing rung's extent (risk rows, a market, a quarantine mask)
    equals the reference's unsharded ``fused_tick_run``; no placement
    names a pad row;
  * **folded carries** — ``elastic_fold_carry`` along rung paths gives
    back the reference ``resident_carry_init``'s buffers;
  * **DES reshard** — a run resharded mid-run (shrink, regrow, onto a
    padded rung, back to unsharded), resident tier on and off, equals the
    reference's ``_full_sim`` with an UNSHARDED policy;
  * **the policy's surface** — ``reshard``'s guards, ``bind`` on a padded
    policy, the gate at ``place`` / ``place_span``;
  * **the manager** — the port's and the reference's managers driven over
    stub policies through the same gate instants, marks and probe
    verdicts give the same events, counters, ladder and meshes; the real
    shadow probe.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pivot_tpu.infra import faults as jfaults
from pivot_tpu.ops import shard as jsh
from pivot_tpu.ops import tickloop as jt
from pivot_tpu.sched import tpu as jp
from pivot_tpu.serve import elastic as jel
from pivot_tpu_torch.infra import faults as pfaults
from pivot_tpu_torch.ops import shard as sh
from pivot_tpu_torch.ops import tickloop as tt
from pivot_tpu_torch.parallel import mesh as pm
from pivot_tpu_torch.sched import cuda as pc
from pivot_tpu_torch.serve import elastic as pel

from tests import test_elastic as je
from tests import test_resident as jr
from tests.test_torch_shard import (
    _SPAN_CONFIGS,
    _SPAN_FIELDS,
    _bits,
    _span_inputs,
)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _reset_port_ids():
    from pivot_tpu_torch.utils import reset_ids

    reset_ids()
    yield


def mesh(S):
    return pm.host_sharded_mesh(devices=[CPU] * S)


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        _bits(a), _bits(b))


# -- helpers -----------------------------------------------------------------


def test_mesh_shape_ladder_matches_reference():
    for n in range(1, 13):
        ladder = sh.mesh_shape_ladder(n)
        assert ladder == jsh.mesh_shape_ladder(n)
        for n_live in range(0, n + 1):
            try:
                want = jsh.next_ladder_shape(ladder, n_live)
            except ValueError as exc:
                with pytest.raises(ValueError, match="no ladder rung"):
                    sh.next_ladder_shape(ladder, n_live)
                assert n_live == 0, exc
            else:
                assert sh.next_ladder_shape(ladder, n_live) == want
    assert sh.mesh_shape_ladder(8) == (8, 4, 2, 1)
    for bad in (0, -3):
        with pytest.raises(ValueError):
            sh.mesh_shape_ladder(bad)
        with pytest.raises(ValueError):
            jsh.mesh_shape_ladder(bad)


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("S", [1, 3, 4, 7, 8])
@pytest.mark.parametrize("H", [1, 10, 16, 600])
def test_elastic_helpers_match_reference(H, S, dtype):
    """``elastic_host_extent`` / ``_pad_state`` / ``_pad_rows`` /
    ``_trim_rows`` give the reference's arrays: values, dtypes, shapes."""
    rng = np.random.default_rng(H * 10 + S)
    avail = rng.uniform(0.5, 4.0, (H, 4)).astype(dtype)
    counts = rng.integers(0, 3, H)
    live = rng.random(H) > 0.25
    risk = rng.uniform(0.0, 1.0, (3, H)).astype(dtype)
    zone = rng.integers(0, 5, H)
    base = rng.integers(0, 4, H)
    extent = sh.elastic_host_extent(H, S)
    assert extent == jsh.elastic_host_extent(H, S)
    assert extent % S == 0 and H <= extent < H + S
    for live_arg in (None, live):
        for given in (
            dict(avail=avail, counts=counts, live=live_arg, risk_rows=risk,
                 host_zone=zone, base_task_counts=base),
            dict(counts=counts, live=live_arg),
            dict(avail=avail),
        ):
            e, ours = sh.elastic_pad_state(H, S, **given)
            e_ref, ref = jsh.elastic_pad_state(H, S, **given)
            assert e == e_ref == extent
            assert sorted(ours) == sorted(ref)
            for k in ref:
                assert _same(ours[k], ref[k]), (k, given.keys())
    _, st = sh.elastic_pad_state(H, S, avail=avail)
    assert (st["avail"][H:] == sh.DEAD_AVAIL).all()
    if extent > H:
        assert st["live"][:H].all() and not st["live"][H:].any()
    for arr, fill in ((avail, sh.DEAD_AVAIL), (counts, 0), (live, False),
                      (zone.astype(np.int32), 0)):
        got = sh.elastic_pad_rows(arr, extent, fill)
        assert _same(got, jsh.elastic_pad_rows(arr, extent, fill))
        back = sh.elastic_trim_rows(got, H)
        assert _same(back, jsh.elastic_trim_rows(got, H))
        assert _same(back, arr)
    if H > 1:
        with pytest.raises(ValueError, match="exceeds elastic extent"):
            sh.elastic_pad_rows(avail, H - 1, 0.0)
    with pytest.raises(ValueError, match="cannot trim"):
        sh.elastic_trim_rows(avail, H + 1)


def test_elastic_helper_errors_match_reference():
    for H, S in ((0, 4), (4, 0)):
        for mod in (sh, jsh):
            with pytest.raises(ValueError, match="elastic extent needs"):
                mod.elastic_host_extent(H, S)
    avail = np.ones((5, 4))
    for mod in (sh, jsh):
        with pytest.raises(ValueError, match="expected H=6"):
            mod.elastic_pad_state(6, 4, avail=avail)
        with pytest.raises(ValueError, match="trailing axis"):
            mod.elastic_pad_state(5, 4, risk_rows=np.ones((2, 4)))


# -- padded spans --------------------------------------------------------------

#: A host count that no S here divides: every case runs padded.
_PAD_H, _PAD_B, _Z = 10, 32, 3


def _span_case(config, variant, seed=0):
    K = jt.span_bucket(8)
    avail, dem, arrive, norms, uniforms, tables = _span_inputs(
        _PAD_H, _PAD_B, K, seed)
    kw = dict(_SPAN_CONFIGS[config], sort_norm=norms)
    host = {}
    if kw["policy"] == "opportunistic":
        kw["uniforms"] = uniforms
    if kw["policy"] == "cost-aware":
        kw.update({k: tables[k] for k in ("cost_zz", "bw_zz", "anchor_zone",
                                          "bucket_id")})
        host.update(host_zone=tables["host_zone"],
                    base_task_counts=tables["base_task_counts"])
    rng = np.random.default_rng(41)
    live = None
    if variant != "plain":
        live = np.ones(_PAD_H, bool)
        live[[2, 7]] = False
        host["risk_rows"] = rng.choice([0.0, 0.3, 1.0], size=(K, _PAD_H))
    if variant == "market" and kw["policy"] == "cost-aware":
        kw.update(cost_stack=rng.uniform(0.01, 0.3, (3, _Z, _Z)),
                  cost_seg=np.clip(np.arange(K) // 3, 0, 2).astype(np.int32))
    return K, avail, dem, arrive, live, kw, host


def _port_kw(kw):
    return {k: (torch.from_numpy(np.array(v))
                if isinstance(v, np.ndarray) and k != "cost_seg" else v)
            for k, v in kw.items()}


@pytest.mark.parametrize("S", [3, 4, 7])
@pytest.mark.parametrize("variant", ["plain", "risk", "market"])
@pytest.mark.parametrize("config", sorted(_SPAN_CONFIGS))
def test_padded_span_equals_unsharded_reference(config, variant, S):
    """The inertness referee (``tests/test_elastic.py::
    test_padded_span_placements_bit_identical``) for every arm: the
    port's sharded span on operands padded to the rung's extent equals
    ``pivot_tpu``'s unsharded ``fused_tick_run`` on the true operands;
    the pad rows keep their dead-sentinel availability."""
    K, avail, dem, arrive, live, kw, host = _span_case(config, variant)
    want = jt.fused_tick_run(
        jnp.asarray(avail), jnp.asarray(dem), jnp.asarray(arrive),
        jnp.asarray(8, jnp.int32), n_ticks=K,
        live=None if live is None else jnp.asarray(live),
        **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in {**kw, **host}.items()})
    extent, st = sh.elastic_pad_state(_PAD_H, S, avail=avail, live=live,
                                      **host)
    assert extent > _PAD_H
    got = sh.sharded_fused_tick_run(
        mesh(S), torch.from_numpy(st.pop("avail")), torch.from_numpy(dem),
        torch.from_numpy(arrive), 8, n_ticks=K, **_port_kw(st),
        **_port_kw(kw))
    ticks_run = int(want.ticks_run)
    for f in _SPAN_FIELDS:
        a, b = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        if f == "n_ready":
            a, b = a[:ticks_run], b[:ticks_run]
        if f == "avail":
            assert (b[_PAD_H:] == sh.DEAD_AVAIL).all()
            b = sh.elastic_trim_rows(b, _PAD_H)
        assert np.array_equal(_bits(a), _bits(b)), f
    placed = got.placements.numpy()
    assert placed.max() < _PAD_H and (placed >= 0).any()


# -- folded carries ------------------------------------------------------------


@pytest.mark.parametrize("path", [(8, 4, 8, None), (8, 3, 7, None),
                                  (None, 4, None), (4, 7, 8, 3, None)],
                         ids=lambda p: "-".join(map(str, p)))
def test_elastic_fold_carry_matches_reference(path):
    """A carry folded along a rung path keeps the reference
    ``resident_carry_init``'s buffers on its true rows and dead sentinels
    on its pad rows; back on the unsharded layout it equals it exactly,
    as does the reference's own fold onto ``None``."""
    H = 16
    rng = np.random.default_rng(1)
    avail = rng.uniform(1.0, 5.0, (H, 4))
    counts = rng.integers(0, 3, H).astype(np.int32)
    live = rng.random(H) > 0.2
    ref = jt.resident_carry_export(jt.resident_carry_init(
        jnp.asarray(avail), counts=counts, live=live))
    carry = (tt.resident_carry_init(avail, counts, live, device=CPU)
             if path[0] is None else sh.sharded_resident_carry_init(
                 mesh(path[0]), *(v for v in sh.elastic_pad_state(
                     H, path[0], avail=avail, counts=counts,
                     live=live)[1].values())))
    for S in path[1:]:
        carry = sh.elastic_fold_carry(carry, H, None if S is None
                                      else mesh(S))
        snap = tt.resident_carry_export(carry)
        extent = H if S is None else sh.elastic_host_extent(H, S)
        for k, fill in (("avail", sh.DEAD_AVAIL), ("counts", 0),
                        ("live", False)):
            assert snap[k].shape[0] == extent
            assert _same(snap[k][:H], ref[k]), (S, k)
            assert (snap[k][H:] == fill).all()
    assert carry.avail.device == CPU
    again = jt.resident_carry_export(
        jsh.elastic_fold_carry(jt.resident_carry_init(
            jnp.asarray(avail), counts=counts, live=live), H, None))
    for k in ("avail", "counts", "live"):
        assert _same(snap[k], again[k])


# -- DES reshard ---------------------------------------------------------------


def _f64(pol):
    pol.dtype = torch.float64
    return pol


_PORT_ARMS = {
    "first_fit": lambda: _f64(pc.CudaFirstFitPolicy(device="cpu")),
    "cost_aware": lambda: _f64(pc.CudaCostAwarePolicy(
        sort_tasks=True, sort_hosts=True, device="cpu")),
}
_REF_ARMS = {
    "first_fit": lambda: jp.TpuFirstFitPolicy(),
    "cost_aware": lambda: jp.TpuCostAwarePolicy(sort_tasks=True,
                                                sort_hosts=True),
}


def _ref_f64(make, **kw):
    def mk():
        pol = make(**kw)
        pol.dtype = jnp.float64
        return pol

    return mk


@functools.lru_cache(maxsize=None)
def _ref_full_sim(arm, n_hosts, resident):
    """``tests/test_elastic.py::_full_sim`` with an UNSHARDED policy."""
    return je._full_sim(_ref_f64(_REF_ARMS[arm]), n_hosts=n_hosts,
                        resident=resident)


def _port_full_sim(policy_fn, n_hosts=16, reshard_at=None,
                   reshard_mesh=None, resident=True, chaos=False,
                   market=False):
    """``tests/test_elastic.py::_full_sim`` (with ``tests/
    test_resident.py::_run_full_sim``'s chaos and market) from the
    port's modules.  Returns ``_full_sim``'s (placements, ends), the
    ``_run_full_sim`` summary and the policy."""
    from pivot_tpu_torch.des import Environment
    from pivot_tpu_torch.infra import Cluster, Host, Storage
    from pivot_tpu_torch.infra.locality import ResourceMetadata
    from pivot_tpu_torch.infra.market import MarketSchedule
    from pivot_tpu_torch.infra.meter import Meter
    from pivot_tpu_torch.sched import GlobalScheduler
    from pivot_tpu_torch.utils import reset_ids
    from pivot_tpu_torch.workload import Application, TaskGroup

    reset_ids()
    env = Environment()
    meta = ResourceMetadata(seed=0)
    meter = Meter(env, meta)
    zones = meta.zones
    hosts = [Host(env, 4.0, 1024, 100, 1, locality=zones[i % 2],
                  meter=meter, id=f"h{i}") for i in range(n_hosts)]
    storage = [Storage(env, z)
               for z in dict.fromkeys(h.locality for h in hosts)]
    cluster = Cluster(env, hosts=hosts, storage=storage, meta=meta,
                      meter=meter, route_mode="meta", seed=0,
                      executor_backend="fast")
    policy = policy_fn()
    if resident:
        policy.enable_resident(splice=True)
    mkt = None
    if market:
        mkt = MarketSchedule.generate(
            meta, seed=5, horizon=400.0, n_segments=4, hot_fraction=0.3,
            hot_hazard=1e-2, base_hazard=1e-4)
    sched = GlobalScheduler(env, cluster, policy, seed=3, meter=meter,
                            fuse_spans=True, market=mkt)
    cluster.start()
    sched.start()
    if chaos:
        pfaults.FaultInjector(cluster, seed=0).preempt_host(
            cluster.hosts[1].id, at=27.0, lead=6.0, outage=25.0)
    apps = [
        Application(f"app{i}", [
            TaskGroup("a", cpus=1, mem=64, runtime=17.0, output_size=400,
                      instances=10),
            TaskGroup("b", cpus=2, mem=64, runtime=9.0, dependencies=["a"],
                      instances=6),
            TaskGroup("c", cpus=1, mem=32, runtime=5.0, dependencies=["b"],
                      instances=8),
        ])
        for i in range(3)
    ]
    for a in apps:
        sched.submit(a)
    if reshard_at is not None:
        env.run(until=reshard_at)
        policy.reshard(reshard_mesh)
    sched.stop()
    env.run()
    placements = sorted((t.id, t.placement)
                        for a in apps for g in a.groups for t in g.tasks)
    ends = sorted((a.id, a.end_time) for a in apps)
    summary = (placements, [a.end_time for a in apps], sched._tick_seq,
               meter.total_scheduling_ops, env.now)
    return (placements, ends), summary, policy, dict(sched.span_stats)


#: case → (launch shards or None, shards after the reshard or None, H).
_RESHARDS = {
    "shrink_8_to_4": (8, 4, 16),
    "regrow_4_to_8": (4, 8, 16),
    "unsharded_to_padded_4": (None, 4, 10),
    "shrink_8_to_padded_3": (8, 3, 16),
    "collapse_4_to_unsharded": (4, None, 16),
}


@pytest.mark.parametrize("resident", [True, False],
                         ids=["resident", "restaged"])
@pytest.mark.parametrize("case", sorted(_RESHARDS))
@pytest.mark.parametrize("arm", sorted(_PORT_ARMS))
def test_mid_run_reshard_equals_unsharded_reference(arm, case, resident):
    """``tests/test_elastic.py``'s shrink / regrow / non-dividing-rung
    referees: a DES run whose policy is resharded at t = 12 (the pending
    resident carry folded across) equals the reference's run with an
    UNSHARDED policy in placements and end times."""
    start, after, H = _RESHARDS[case]

    def policy():
        pol = _PORT_ARMS[arm]()
        if start is not None:
            pol.enable_sharding(mesh(start))
        return pol

    got, _summary, pol, spans = _port_full_sim(
        policy, n_hosts=H, reshard_at=12.0,
        reshard_mesh=None if after is None else mesh(after),
        resident=resident)
    assert got == _ref_full_sim(arm, H, resident)
    assert (pol._mesh is None) == (after is None)
    padded = after is not None and H % after
    assert pol._host_extent == (sh.elastic_host_extent(H, after)
                                if padded else None)
    stats = pol.dispatch_stats()
    assert stats["kernel_ticks"] == stats["span_kernel_ticks"] == 0
    if resident:
        assert stats["resident"]["spans"] == spans["fused_spans"]


@pytest.mark.parametrize("after", [3, None], ids=["padded_3", "unsharded"])
def test_resident_carry_folds_between_spans(monkeypatch, after):
    """At H = 4 the Cost-Aware run serves two resident spans.  Resharded
    at instants before, between and after them (2 shards → 3, padded to
    6, or → unsharded), every run equals ``pivot_tpu``'s unsharded
    resident run, and in some run a pending carry is folded and the next
    span is served from the folded carry."""
    folds = []
    real = pc.elastic_fold_carry

    def fold(carry, H, m):
        folds.append(carry.avail.shape[0])
        return real(carry, H, m)

    monkeypatch.setattr(pc, "elastic_fold_carry", fold)
    want, _, _ = jr._run_full_sim(
        _ref_f64(_REF_ARMS["cost_aware"]), fuse=True, resident=True,
        n_hosts=4)
    served_after_fold = 0
    for at in (5.0, 20.0, 35.0, 50.0, 65.0, 80.0):
        folds.clear()

        def policy():
            pol = _PORT_ARMS["cost_aware"]()
            pol.enable_sharding(mesh(2))
            return pol

        _got, summary, pol, spans = _port_full_sim(
            policy, n_hosts=4, reshard_at=at,
            reshard_mesh=None if after is None else mesh(after))
        assert summary == want, at
        rs = pol.dispatch_stats()["resident"]
        assert rs["spans"] == spans["fused_spans"] == 2
        if folds:
            assert folds == [4]
            served_after_fold += pol._resident.carry.avail.shape[0] == (
                4 if after is None else 6)
    assert served_after_fold >= 1


@pytest.mark.parametrize("resident", [True, False],
                         ids=["resident", "restaged"])
def test_padded_reshard_under_chaos_and_a_market(resident):
    """A Cost-Aware run with risk scoring under a spot market and a host
    preemption, resharded onto a padded rung mid-run: the padded risk
    rows / risk table, host zones, counts and live mask give
    ``pivot_tpu``'s unsharded run (``tests/test_resident.py::
    _run_full_sim``) in placements, end times, ticks, meter operations
    and ``env.now``."""
    def policy():
        return _f64(pc.CudaCostAwarePolicy(
            sort_tasks=True, sort_hosts=True, risk_weight=0.5, device="cpu"))

    _got, summary, pol, _spans = _port_full_sim(
        policy, n_hosts=10, reshard_at=12.0, reshard_mesh=mesh(3),
        resident=resident, chaos=True, market=True)
    want, _, _ = jr._run_full_sim(
        _ref_f64(jp.TpuCostAwarePolicy, sort_tasks=True, sort_hosts=True,
                 risk_weight=0.5),
        fuse=True, resident=resident, chaos=True, market=True, n_hosts=10)
    assert summary == want
    assert pol._host_extent == 12
    if resident:
        assert pol._resident.risk_table_dev.shape[-1] == 12


# -- the policy's elastic surface ----------------------------------------------


def test_reshard_guards_match_reference():
    """``tests/test_elastic.py::test_reshard_guards`` and the rest of the
    reference's guards, with the port's names (``use_kernel`` for
    ``use_pallas``); each refusal is the reference's ``ValueError``."""
    m4 = mesh(4)
    with pytest.raises(ValueError, match="adaptive"):
        jp.TpuFirstFitPolicy(adaptive=True).reshard(je.MESH4)
    with pytest.raises(ValueError, match="adaptive"):
        pc.CudaFirstFitPolicy(adaptive=True, device="cpu").reshard(m4)
    ref = jp.TpuFirstFitPolicy()
    ref.use_pallas = True
    with pytest.raises(ValueError, match="[Pp]allas"):
        ref.reshard(je.MESH4)
    ff = pc.CudaFirstFitPolicy(device="cpu")
    ff.use_kernel = True
    with pytest.raises(ValueError, match="greedy_place"):
        ff.reshard(m4)
    ff.reshard(None)  # the unsharded layout needs no sharded form
    with pytest.raises(ValueError, match="greedy_place"):
        pc.CudaCostAwarePolicy(use_kernel=True, device="cpu").reshard(m4)
    with pytest.raises(ValueError, match="realtime_bw"):
        pc.CudaCostAwarePolicy(realtime_bw=True, device="cpu").reshard(m4)
    with pytest.raises(ValueError, match="batcher"):
        pol = pc.CudaFirstFitPolicy(device="cpu")
        pol.enable_batching(object())
        pol.reshard(m4)
    empty = pm.Mesh(np.empty((1, 0), dtype=object), ("replica", "host"))
    with pytest.raises(ValueError, match="empty host axis"):
        pc.CudaFirstFitPolicy(device="cpu").reshard(empty)
    with pytest.raises(NotImplementedError, match="several cards"):
        pc.CudaFirstFitPolicy(device="cpu").reshard(
            pm.host_sharded_mesh(devices=[CPU, torch.device("meta")]))
    with pytest.raises(ValueError, match="shards live on"):
        pc.CudaFirstFitPolicy(device="cpu").reshard(
            pm.host_sharded_mesh(devices=[torch.device("meta")] * 2))
    with pytest.raises(ValueError, match="score exponents"):
        pc.CudaCostAwarePolicy(weights=np.array(
            [1.5, 1.0, 1.0, 0.0, 1.0]), device="cpu").reshard(m4)


def _bound_policy(n_hosts, make=None):
    from pivot_tpu_torch.sched import GlobalScheduler
    from pivot_tpu_torch.utils.config import ClusterConfig, build_cluster

    cluster = build_cluster(ClusterConfig(n_hosts=n_hosts, seed=0))
    pol = (make or _PORT_ARMS["first_fit"])()
    sched = GlobalScheduler(cluster.env, cluster, pol, seed=0)
    pol.bind(sched)
    return pol, sched


def test_bind_on_a_padded_policy_rederives_the_extent():
    """``bind`` on a resharded (padded) policy re-derives the extent for
    the new host count (``pivot_tpu/sched/tpu.py:521-527``); a policy
    sharded by ``enable_sharding`` still demands divisibility."""
    pol, _ = _bound_policy(10)
    pol.reshard(mesh(4))
    assert pol._host_extent == 12
    for H, extent in ((9, 12), (13, 16), (8, None)):
        _, sched = _bound_policy(H)
        pol.bind(sched)
        assert pol._host_extent == extent, H
    # Back on a dividing count the extent is off, and a rebind checks
    # divisibility again, as the reference's does.
    _, sched = _bound_policy(10)
    with pytest.raises(ValueError, match="not divisible"):
        pol.bind(sched)
    sharded, _ = _bound_policy(8)
    sharded.enable_sharding(mesh(4))
    _, sched = _bound_policy(10)
    with pytest.raises(ValueError, match="not divisible"):
        sharded.bind(sched)
    sharded.reshard(mesh(4))  # the elastic path: padded, not refused
    sharded.bind(sched)
    assert sharded._host_extent == 12
    sharded.reshard(None)
    assert sharded._host_extent is None and sharded._mesh is None


def test_fault_gate_runs_first_and_passes_the_degrade_guard():
    """The gate runs with ``ctx.env_now`` at the top of ``place`` and
    ``place_span`` (``pivot_tpu/sched/tpu.py:1039-1040``, ``:1409-1410``);
    its :class:`DeviceLostError` passes the degrade guard untouched (no
    twin serves it, no kernel failure is counted)."""
    from pivot_tpu_torch.sched import TickContext

    pol, sched = _bound_policy(8)
    pol.degrade_after = 1
    seen = []

    def gate(now):
        seen.append(now)
        raise pfaults.DeviceLostError([3], now)

    pol.enable_fault_gate(gate)
    ctx = TickContext(sched, [], 0)
    with pytest.raises(pfaults.DeviceLostError) as err:
        pol.place(ctx)
    assert err.value.ordinals == (3,)
    with pytest.raises(pfaults.DeviceLostError):
        pol.place_span(ctx, None)
    assert seen == [ctx.env_now] * 2
    assert pol.kernel_failures == 0 and not pol.degraded
    assert pol.twin_ticks == 0
    pol.enable_fault_gate(None)
    assert pol._fault_gate is None


# -- the manager -----------------------------------------------------------------


class _PortStub:
    """``tests/test_elastic.py::_StubPolicy`` over a port mesh."""

    def __init__(self, mesh_):
        self._mesh = mesh_
        self.topology = None
        self.dtype = np.float64
        self.resharded = []
        self._gate = None

    def enable_fault_gate(self, gate):
        self._gate = gate

    def reshard(self, mesh_):
        self.resharded.append(mesh_)
        self._mesh = mesh_


def _verdicts(seq):
    it = iter(seq)
    return lambda policy, mesh_: next(it)


def _state(mgr, pols, ordinals):
    return (list(mgr.events), mgr.shrinks, mgr.regrows, mgr.probes,
            mgr.probe_failures, tuple(mgr.ladder),
            [tuple(sorted(ordinals(p._mesh))) for p in pols])


def _apply(mgr, pols, stub, ordinals, op):
    """One step against one manager: ``("attach",)`` adopts a fresh
    launch-mesh stub, ``("gate", i, t)`` runs stub i's gate at t (i = -1:
    the newest), ``("dead", o)`` / ``("restored", o)`` mark an ordinal.
    Returns what it raised and the manager's state after it."""
    raised = None
    try:
        if op[0] == "attach":
            pols.append(stub())
            mgr.attach(pols[-1])
        elif op[0] == "gate":
            pols[op[1]]._gate(op[2])
        elif op[0] == "dead":
            mgr.mark_dead(op[1])
        else:
            mgr.mark_restored(op[1])
    except (pfaults.DeviceLostError, jfaults.DeviceLostError) as exc:
        raised = (exc.ordinals, exc.at)
    return raised, _state(mgr, pols, ordinals)


class _Lockstep:
    """The reference's and the port's managers over stub policies (the
    reference's on its ``MESH8``, the port's on fresh 8-shard CPU meshes),
    driven through the same steps with the same probe verdicts."""

    def __init__(self, config_kw, windows=(), verdicts=None):
        self.ref = jel.ElasticMeshManager(jel.ElasticConfig(
            schedule=_window_schedule(*windows)(jfaults), **config_kw))
        self.port = pel.ElasticMeshManager(pel.ElasticConfig(
            schedule=_window_schedule(*windows)(pfaults), **config_kw))
        if verdicts is not None:
            self.ref.shadow_probe = _verdicts(verdicts)
            self.port.shadow_probe = _verdicts(verdicts)
        self.ref_pols, self.port_pols = [], []

    def step(self, op):
        want = _apply(self.ref, self.ref_pols,
                      lambda: je._StubPolicy(je.MESH8),
                      self.ref._mesh_ordinals, op)
        got = _apply(self.port, self.port_pols, lambda: _PortStub(mesh(8)),
                     self.port._mesh_key, op)
        assert got == want, op
        return got


def _window_schedule(*windows):
    """A schedule factory (either package's faults module) of
    ``device_fault`` windows ``(at, ordinal, duration)``."""
    def make(faults):
        return faults.ChaosSchedule(seed=7, events=[
            faults.ChaosEvent(kind="device_fault", at=at,
                              target=f"device:{o}", duration=d)
            for at, o, d in windows])

    return make


def test_manager_shrink_align_regrow_matches_reference():
    """``test_manager_shrink_align_regrow``'s script."""
    both = _Lockstep({}, [(5.0, 3, 10.0)], verdicts=[True] * 4)
    for op in [("attach",), ("gate", 0, 1.0)]:
        assert both.step(op)[0] is None
    assert both.step(("gate", 0, 6.0))[0] == ((3,), 6.0)
    _, state = both.step(("attach",))
    assert state[-1] == [tuple(range(8)), (0, 1, 2, 4)]
    both.step(("gate", 1, 7.0))
    _, state = both.step(("gate", 1, 20.0))
    assert state[-1][1] == tuple(range(8))
    assert [k for _, k, _ in both.port.events] == ["loss", "regrow"]
    assert both.port.probes == 1 and both.port.regrows == 1


def test_manager_failed_probe_holds_the_shard_out_as_reference():
    """``test_manager_failed_probe_holds_device_out``'s script: a failed
    probe holds the shard out and cools down ``probe_every`` gated
    dispatches; the healed retry promotes."""
    both = _Lockstep(dict(probe_every=2), [(5.0, 3, 10.0)],
                     verdicts=[False, True])
    for op in [("attach",), ("gate", 0, 6.0), ("attach",),
               ("gate", 1, 20.0), ("gate", 1, 20.5), ("gate", 1, 21.0),
               ("gate", 1, 21.5)]:
        both.step(op)
    assert both.port.probes == 2 and both.port.probe_failures == 1
    assert both.port.regrows == 1
    assert both.port._mesh_key(both.port_pols[1]._mesh) == tuple(range(8))


@pytest.mark.parametrize("probe", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_manager_random_script_matches_reference(seed, probe):
    """A seeded run of gate instants over several fault windows, hand
    marks and restores, a replacement policy after every loss (as the
    supervisor builds one) and random probe verdicts: after every step
    the two managers agree — what was raised, events, counters, ladder
    and each policy's mesh ordinals."""
    rng = np.random.default_rng(seed)
    windows, t = [], 2.0
    for o in rng.choice(8, size=3, replace=False):
        at = t + float(rng.uniform(1.0, 6.0))
        windows.append((at, int(o), float(rng.uniform(4.0, 15.0))))
        t = at + float(rng.uniform(0.0, 4.0))
    both = _Lockstep(dict(probe=probe, probe_every=3), windows,
                     verdicts=[bool(v) for v in rng.random(64) < 0.6])
    both.step(("attach",))
    t = 0.0
    for _ in range(80):
        r = rng.random()
        if r < 0.06:
            op = ("dead", int(rng.integers(0, 8)))
        elif r < 0.12:
            op = ("restored", int(rng.integers(0, 8)))
        else:
            t = round(t + float(rng.uniform(0.0, 1.0)), 3)
            op = ("gate", -1, t)
        if both.step(op)[0] is not None:
            both.step(("attach",))
    assert both.port.shrinks >= 2 and both.port.regrows >= 1
    assert (both.port.probes >= 2) == probe


def test_manager_mesh_identity_by_ordinals():
    """The port's mesh identity (``serve/elastic.py`` docstring): a
    factory's fresh launch-shaped mesh covers ``0..n-1``; a rung mesh is
    built once per survivor tuple over the survivors' devices; a mesh
    over other devices is refused; the manager refuses unsharded and 2-D
    policies as the reference does."""
    mgr = pel.ElasticMeshManager(pel.ElasticConfig(
        schedule=_window_schedule((5.0, 3, 10.0))(pfaults)))
    a, b = _PortStub(mesh(8)), _PortStub(mesh(8))
    mgr.attach(a)
    mgr.attach(b)
    assert a._mesh is not b._mesh
    assert mgr._mesh_key(a._mesh) == mgr._mesh_key(b._mesh) == tuple(
        range(8))
    assert not a.resharded and not b.resharded  # both already on target
    with pytest.raises(pfaults.DeviceLostError):
        a._gate(6.0)
    c = _PortStub(mesh(8))
    mgr.attach(c)
    rung = c._mesh
    assert mgr._mesh_key(rung) == (0, 1, 2, 4)
    assert host_axis_size_of(rung) == 4
    d = _PortStub(mesh(8))
    mgr.attach(d)
    assert d._mesh is rung  # one mesh per survivor tuple
    with pytest.raises(ValueError, match="launch devices"):
        mgr.attach(_PortStub(pm.host_sharded_mesh(
            devices=[torch.device("meta")] * 8)))
    with pytest.raises(ValueError, match="enable_sharding"):
        pel.ElasticMeshManager().attach(_PortStub(None))
    with pytest.raises(ValueError, match="enable_sharding"):
        jel.ElasticMeshManager().attach(je._StubPolicy(None))
    with pytest.raises(ValueError, match="replica axis"):
        pel.ElasticMeshManager().attach(_PortStub(pm.build_hybrid_mesh(
            host_parallel=2, devices=[CPU] * 4)))


def host_axis_size_of(m):
    return pm.host_axis_size(m)


def test_shadow_probe_on_real_policies():
    """``test_shadow_probe_real_kernels`` in the port: the probe's
    sharded span equals the unsharded one on every rung of an 8-shard
    ladder, for a stub and for a bound float64 policy (H = 10: a
    non-dividing rung's probe rounds H up); a candidate whose run raises
    fails the probe, and the manager then holds the shard out."""
    mgr = pel.ElasticMeshManager()
    stub = _PortStub(mesh(8))
    mgr.attach(stub)
    pol, _ = _bound_policy(10)
    pol.enable_sharding(mesh(2))
    for S in (8, 4, 2, 1, 3):
        assert mgr.shadow_probe(stub, mesh(S)) is True, S
        assert mgr.shadow_probe(pol, mesh(S)) is True, S
    two = pm.host_sharded_mesh(devices=[CPU, torch.device("meta")])
    assert mgr.shadow_probe(stub, two) is False
    assert mgr.shadow_probe(pol, pm.host_sharded_mesh(
        devices=[torch.device("meta")] * 2)) is False

    sick = pel.ElasticMeshManager(pel.ElasticConfig(
        schedule=_window_schedule((5.0, 3, 10.0))(pfaults), probe_every=2))
    first = _PortStub(mesh(8))
    sick.attach(first)
    with pytest.raises(pfaults.DeviceLostError):
        first._gate(6.0)
    second = _PortStub(mesh(8))
    sick.attach(second)
    real = sick.shadow_probe

    def raising(policy, mesh_):
        def boom(*a, **k):
            raise RuntimeError("candidate shard raised")

        orig = sh.sharded_fused_tick_run
        sh.sharded_fused_tick_run = boom
        try:
            return real(policy, mesh_)
        finally:
            sh.sharded_fused_tick_run = orig

    sick.shadow_probe = raising
    second._gate(20.0)
    assert sick.probe_failures == 1 and sick.regrows == 0
    assert sick._mesh_key(second._mesh) == (0, 1, 2, 4)
    sick.shadow_probe = real
    second._gate(20.5)
    second._gate(21.0)
    second._gate(21.5)
    assert sick.regrows == 1 and sick._mesh_key(second._mesh) == tuple(
        range(8))
    assert [k for _, k, _ in sick.events] == ["loss", "probe_failed",
                                              "regrow"]
