"""The host-sharded resident span carry of the port
(``ops/shard.py::sharded_resident_carry_init`` /
``sharded_resident_span_run``, the policy's ``enable_resident`` beside
``enable_sharding``) against ``pivot_tpu``'s UNSHARDED resident driver.

``pivot_tpu``'s sharded resident cases fail under this jax
(``shard_map(check_rep=)``); its contract is that a sharded resident
span is bit-identical to the unsharded one (``pivot_tpu/ops/
shard.py:1794-1802``).  On the CPU in float64, on meshes of S logical
shards of the CPU:

  * **span parity** — after ``tests/test_resident.py::
    test_sharded_resident_span_parity_quick``: global edit indices (rows
    in two shards and a pad row) projected into each shard's block, risk
    rows gathered per shard from the ``[P, H]`` table; placements,
    availability and the carry equal ``pivot_tpu``'s
    ``resident_span_run`` and the port's re-staged ``fused_tick_run``;
  * **chains** — the shard-local count fold over several spans, foreign
    rows, the flat ``[H]`` layout kept between spans (clone, export,
    restore);
  * **DES** — after ``test_des_sharded_resident_parity``: a full run
    with the sharded carry (chaos edits, a market, mid-span splices)
    equals ``pivot_tpu``'s unsharded resident run and the port's own
    re-staged run.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pivot_tpu.ops import tickloop as jt
from pivot_tpu_torch.ops import shard as sh
from pivot_tpu_torch.ops import tickloop as tt
from pivot_tpu_torch.parallel import mesh as pm

from tests import test_resident as jr
from tests.test_torch_resident import (
    _assert_same,
    _equal,
    _f64,
    _jax_policy,
    _port_kw,
    _port_sim,
    _t,
)

CPU = torch.device("cpu")
#: The reference's sharded-resident host count (``tests/test_resident.py
#: :380``): divisible by every S here.
H16 = 16


@pytest.fixture(autouse=True)
def _reset_port_ids():
    from pivot_tpu_torch.utils import reset_ids

    reset_ids()
    yield


def mesh(S):
    return pm.host_sharded_mesh(devices=[CPU] * S)


def _edits(avail, counts, idx, live_off=()):
    """Edit rows for global host indices ``idx`` (H = a pad row): the
    post-edit availability and counts and the rows that carry them."""
    H = avail.shape[0]
    post, post_counts = avail.copy(), np.asarray(counts).copy()
    post_live = np.ones(H, bool)
    for j, h in enumerate(idx):
        if h < H:
            post[h] += 0.25 * (j + 1)
            post_counts[h] = max(post_counts[h] - 1, 0)
    post_live[list(live_off)] = False
    rows = [h for h in idx]
    edits = dict(
        edit_idx=np.asarray(rows, np.int32),
        edit_avail=np.stack([post[h] if h < H else np.zeros(4)
                             for h in rows]).astype(post.dtype),
        edit_counts=np.asarray([post_counts[h] if h < H else 0
                                for h in rows], np.int32),
        edit_live=np.asarray([post_live[h] if h < H else True
                              for h in rows]),
    )
    return post, post_counts, post_live, edits


@pytest.mark.parametrize("S", [2, 8])
@pytest.mark.parametrize("config", sorted(jr._POLICY_CONFIGS))
def test_sharded_resident_span_parity_quick(config, S):
    """Edits in two shards plus a pad row, the risk table: the sharded
    resident span equals the reference's unsharded resident span and the
    port's re-staged span on the post-edit state, carry included."""
    avail, dem, arrive, norms, uniforms = jr._span_inputs(H16)
    kw, fused_kw, res_kw, counts = jr._split_kw(
        jr._POLICY_CONFIGS[config], 8, "auto", norms, uniforms,
        n_hosts=H16, risk=True)
    post, post_counts, _, edits = _edits(avail, counts, [1, 9, H16])
    want = tt.fused_tick_run(
        _t(post), _t(dem), _t(arrive), 8, n_ticks=8,
        base_task_counts=_t(post_counts), **_port_kw(fused_kw),
        **_port_kw(kw))
    m = mesh(S)
    carry = sh.sharded_resident_carry_init(m, avail, counts)
    got, carry = sh.sharded_resident_span_run(
        m, carry, _t(dem), _t(arrive), 8, n_ticks=8, **_port_kw(edits),
        **_port_kw(res_kw), **_port_kw(kw))
    _assert_same(got, want, carry)
    ref, jcarry = jt.resident_span_run(
        jt.resident_carry_init(jnp.asarray(avail), counts),
        jnp.asarray(dem), jnp.asarray(arrive), jnp.asarray(8, jnp.int32),
        n_ticks=8, **{k: jnp.asarray(v) for k, v in edits.items()},
        **res_kw, **kw)
    _assert_same(got, ref)
    for f in ("avail", "counts", "live"):
        assert _equal(getattr(carry, f), getattr(jcarry, f)), f
        assert getattr(carry, f).shape[0] == H16  # the flat [H] layout


@pytest.mark.parametrize("S", [2, 4, 8])
def test_sharded_resident_foreign_rows_and_live_edits(S):
    """Edit rows spread over every shard, a quarantine flip and pad rows:
    each shard takes only its own rows; the span equals the reference's
    unsharded resident span with the same global edits."""
    avail, dem, arrive, norms, uniforms = jr._span_inputs(H16)
    kw, _f, _r, counts = jr._split_kw(
        jr._POLICY_CONFIGS["cost_aware_ff"], 8, "auto", norms, uniforms,
        n_hosts=H16)
    idx = [0, 3, 7, 8, 12, 15, H16, H16]
    post, post_counts, post_live, edits = _edits(avail, counts, idx,
                                                 live_off=(3, 12))
    m = mesh(S)
    carry = sh.sharded_resident_carry_init(m, avail, counts)
    got, carry = sh.sharded_resident_span_run(
        m, carry, _t(dem), _t(arrive), 8, n_ticks=8, **_port_kw(edits),
        **_port_kw(kw))
    want = tt.fused_tick_run(
        _t(post), _t(dem), _t(arrive), 8, n_ticks=8,
        base_task_counts=_t(post_counts), live=_t(post_live),
        **_port_kw(kw))
    _assert_same(got, want, carry)
    assert carry.live.tolist() == post_live.tolist()
    ref, jcarry = jt.resident_span_run(
        jt.resident_carry_init(jnp.asarray(avail), counts),
        jnp.asarray(dem), jnp.asarray(arrive), jnp.asarray(8, jnp.int32),
        n_ticks=8, **{k: jnp.asarray(v) for k, v in edits.items()}, **kw)
    _assert_same(got, ref)
    assert _equal(carry.counts, jcarry.counts)


def test_sharded_resident_chain_folds_counts_per_shard():
    """Four spans chained through the sharded carry equal four spans of
    the unsharded resident driver: the shard-local histograms fold into
    the same counts; a clone survives its parent, and an exported carry
    restores to the same chain."""
    avail, _, arrive, _, _ = jr._span_inputs(H16)
    dems = np.random.default_rng(3).uniform(0.1, 0.8, (4, jr.B, 4))
    m = mesh(4)
    a = sh.sharded_resident_carry_init(m, avail)
    b = tt.resident_carry_init(avail, device="cpu")
    for i in range(4):
        norms = np.sqrt((dems[i] * dems[i]).sum(1))
        kw, _, _, _ = jr._split_kw(jr._POLICY_CONFIGS["cost_aware_bf_decay"],
                                   8, "auto", norms, jnp.zeros((8, jr.B)),
                                   n_hosts=H16)
        ckpt = tt.resident_carry_clone(a)
        got, a = sh.sharded_resident_span_run(
            m, a, _t(dems[i]), _t(arrive), 8, n_ticks=8, **_port_kw(kw))
        want, b = tt.resident_span_run(b, _t(dems[i]), _t(arrive), 8,
                                       n_ticks=8, **_port_kw(kw))
        _assert_same(got, want, a)
        assert _equal(a.counts, b.counts) and _equal(a.live, b.live)
        again, _ = sh.sharded_resident_span_run(
            m, ckpt, _t(dems[i]), _t(arrive), 8, n_ticks=8, **_port_kw(kw))
        _assert_same(again, got)
    assert int(a.counts.sum()) > 0
    snap = tt.resident_carry_export(a)
    restored = tt.resident_carry_restore(snap["avail"], snap["counts"],
                                         snap["live"], device="cpu")
    x, _ = sh.sharded_resident_span_run(m, a, _t(dems[0] * 0.5), _t(arrive),
                                        8, n_ticks=8, **_port_kw(kw))
    y, _ = sh.sharded_resident_span_run(m, restored, _t(dems[0] * 0.5),
                                        _t(arrive), 8, n_ticks=8,
                                        **_port_kw(kw))
    _assert_same(y, x)


def test_sharded_resident_validation():
    avail = np.ones((12, 4))
    with pytest.raises(ValueError, match="does not divide"):
        sh.sharded_resident_carry_init(mesh(8), avail)
    carry = sh.sharded_resident_carry_init(mesh(4), avail)
    assert carry.avail.device == CPU and carry.counts.dtype == torch.int32
    with pytest.raises(ValueError, match="phase2"):
        sh.sharded_resident_span_run(
            mesh(4), carry, torch.zeros((8, 4), dtype=torch.float64),
            torch.zeros(8, dtype=torch.int32), 1, policy="first-fit",
            n_ticks=1, phase2="bogus")
    distinct = pm.host_sharded_mesh(devices=[CPU, torch.device("meta")])
    with pytest.raises(NotImplementedError, match="several cards"):
        sh.sharded_resident_carry_init(distinct, avail)


# -- DES ---------------------------------------------------------------------


def _sharded(name, S, **kw):
    from tests.test_torch_resident import _port_policy

    make = _port_policy(name, **kw)

    def mk():
        pol = make()
        pol.enable_sharding(mesh(S))
        return pol

    return mk


@pytest.mark.parametrize("S,n_hosts", [(2, 4), (4, 4), (8, H16)])
@pytest.mark.parametrize("name", ["first_fit", "cost_aware"])
def test_des_sharded_resident_parity(name, S, n_hosts):
    """``enable_sharding`` + ``enable_resident`` compose
    (``tests/test_resident.py::test_des_sharded_resident_parity``): the
    carry lives host-sharded between spans, and the run equals the
    port's re-staged sharded run and ``pivot_tpu``'s unsharded resident
    run — at 4 hosts, where the tasks queue and spans ride the carry,
    and at the reference's 16."""
    base, stats0, _ = _port_sim(_sharded(name, S), fuse=True,
                                n_hosts=n_hosts)
    got, stats1, pol = _port_sim(_sharded(name, S), fuse=True, resident=True,
                                 n_hosts=n_hosts)
    assert got == base and stats0 == stats1
    assert pol.dispatch_stats()["resident"]["spans"] == stats1["fused_spans"]
    if n_hosts == 4:
        assert stats1["fused_spans"] > 0
        assert pol._resident.carry.avail.shape == (n_hosts, 4)
    want, _, _ = jr._run_full_sim(_jax_policy(name), fuse=True,
                                  resident=True, n_hosts=n_hosts)
    assert got == want


def test_des_sharded_resident_chaos_and_market():
    """A chaos preemption (mirror-diff edit rows, projected per shard)
    and a market's risk table (gathered per shard) through the sharded
    carry: equal to the unsharded resident runs and ``pivot_tpu``'s."""
    got, _, pol = _port_sim(_sharded("cost_aware", 2), fuse=True,
                            resident=True, chaos=True)
    base, _, _ = _port_sim(_sharded("cost_aware", 2), fuse=True, chaos=True)
    assert got == base
    rs = pol.dispatch_stats()["resident"]
    assert rs["edit_rows"] > 0 and rs["spans"] > 0
    want, _, _ = jr._run_full_sim(_jax_policy("cost_aware"), fuse=True,
                                  resident=True, chaos=True)
    assert got == want
    got, _, pol = _port_sim(_sharded("cost_aware", 4, risk_weight=0.5),
                            fuse=True, resident=True, market=True)
    assert pol._resident.risk_table_np is not None
    want, _, _ = jr._run_full_sim(_jax_policy("cost_aware",
                                              risk_weight=0.5),
                                  fuse=True, resident=True, market=True)
    assert got == want


def test_sharded_resident_splice_parity():
    """Mid-span splices re-run from the sharded span-entry checkpoint:
    every instant equals the ``fuse_spans=False`` referee, and some
    instant splices."""
    total = 0
    for t in jr._SPLICE_INSTANTS:
        plain, _, _ = _port_sim(_sharded("first_fit", 2), fuse=False,
                                late_at=t)
        got, stats, pol = _port_sim(_sharded("first_fit", 2), fuse=True,
                                    resident=True, late_at=t)
        assert got == plain, t
        total += stats["span_splices"]
        if total:
            break
    assert total > 0


def test_enable_resident_and_sharding_compose_in_either_order():
    from pivot_tpu_torch.sched import cuda as pc

    for resident_first in (True, False):
        pol = _f64(pc.CudaFirstFitPolicy(device="cpu"))
        if resident_first:
            pol.enable_resident()
            pol.enable_sharding(mesh(2))
        else:
            pol.enable_sharding(mesh(2))
            pol.enable_resident()
        assert pol._resident is not None and pol._mesh is not None
