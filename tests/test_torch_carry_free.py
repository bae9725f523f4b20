"""The carry-free placement pass (Opportunistic, First-Fit, Best-Fit):
the plain forms of ``carry_free_place`` against ``pivot_tpu``, and the
port's wiring around the kernel.

* **Plain forms vs the reference** — ``opportunistic_plain`` /
  ``first_fit_plain`` / ``best_fit_plain`` (R = 1) and the R-replica
  ``first_fit_plain_batched`` / ``best_fit_plain_batched`` against
  ``pivot_tpu.ops.kernels``' ``*_kernel_ref`` and slim ``*_impl`` (and
  ``jax.vmap`` of them over replicas), on the same numpy inputs: in
  float64 under x64 bitwise; in float32 placements exact and
  availability within rtol 1e-6 / atol 1e-5.  Risk rows, live masks,
  tasks that fit nowhere, interspersed invalid tasks, empty and
  all-invalid streams, zero demands, ties and the stop one past the last
  valid task.
* **The wrappers on the CPU** run the plain forms and count no launch;
  their argument checks refuse what the kernel does not take.
* **The launch shape** (``_cf_config`` over H from 1 to 250,000 at every
  boundary, R = 1 and 256, each arm): every host is owned by exactly
  one (cluster rank, thread), as the kernel computes the ranges; the
  sizer is the kernel's and a CTA's shared memory fits the opt-in; C is
  a power of two up to 16; the register form takes only a built K.
* **Routing** (``sched/cuda.py::_carry_free_serves``) for each
  condition, and the kernel route end to end with the wrappers' plain
  forms standing in (CPU tensors): per-tick and span ticks go through
  the wrappers and the run equals today's torch-form run; a span through
  ``fused_tick_run(carry_free=...)`` equals the span without it.
* **Tooling**: the entry map lists the wrappers, the profiler and cost
  attribution know the route, the kernel-budget pass reads the new
  source and catches drift.

The kernel itself runs on the card only (``chip_smoke.py --phases
19``)."""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pivot_tpu.ops import kernels as jk
from pivot_tpu_torch import analysis as port
from pivot_tpu_torch.analysis import entrymap, kernel_budget
from pivot_tpu_torch.obs import costattr, profiler
from pivot_tpu_torch.ops import cuda_kernels as ck
from pivot_tpu_torch.ops import tickloop as tt
from pivot_tpu_torch.sched import cuda as pc

from tests.test_torch_analysis import _budget_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARMS = ("opportunistic", "first-fit", "best-fit")
CASES = ("plain", "risk", "live", "risk_live", "nofit", "invalid", "zero",
         "ties", "nan_risk")


def make_case(seed, T, H, case, R=None, dtype=np.float64):
    """Seeded tick inputs as numpy: ``avail`` [H, 4] (or [R, H, 4]),
    ``dem`` [T, 4], ``valid``, ``u``, ``live``, ``risk``."""
    rng = np.random.default_rng(seed)
    shape = (H, 4) if R is None else (R, H, 4)
    avail = rng.choice([0.25, 0.5, 0.75, 1.0], size=shape)
    dem = rng.choice([0.0, 0.125, 0.25], size=(T, 4))
    valid = np.ones(T, bool)
    u = rng.uniform(size=T)
    live = risk = None
    if case in ("risk", "risk_live"):
        risk = rng.choice([0.0, -0.0, 0.5, 1.5], size=H)
    if case == "nan_risk":
        risk = rng.choice([0.0, 0.5, np.inf, np.nan], size=H,
                          p=[0.4, 0.4, 0.1, 0.1])
    if case in ("live", "risk_live"):
        live = rng.uniform(size=H) > 0.3
    if case == "nofit":
        dem[::3] = 2.0  # fits nowhere
    if case == "invalid":
        valid = rng.uniform(size=T) > 0.3
        valid[-3:] = False
    if case == "zero":
        dem[:] = 0.0
        avail[..., ::2, :] = 0.0
    if case == "ties":
        avail[...] = 0.5
        dem[:] = 0.125
    cast = (lambda x: None if x is None or x.dtype == bool
            else x.astype(dtype))
    return dict(avail=cast(avail), dem=cast(dem), valid=valid, u=cast(u),
                live=live, risk=cast(risk))


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def jax_ref(arm, x, strict=False, form="ref"):
    """``pivot_tpu``'s pass on ``x``: the scan oracle or the slim impl."""
    kw = dict(live=_j(x["live"]), risk=_j(x["risk"]))
    args = (_j(x["avail"]), _j(x["dem"]), _j(x["valid"]))
    if arm == "opportunistic":
        fn = (jk.opportunistic_kernel_ref if form == "ref"
              else lambda *a, **k: jk.opportunistic_impl(*a, phase2="slim",
                                                         **k))
        return fn(*args, _j(x["u"]), **kw)
    if arm == "first-fit":
        if form == "ref":
            return jk.first_fit_kernel_ref(*args, strict=strict, **kw)
        return jk.first_fit_impl(*args, strict=strict, phase2="slim", **kw)
    if form == "ref":
        return jk.best_fit_kernel_ref(*args, **kw)
    return jk.best_fit_impl(*args, phase2="slim", **kw)


def plain(arm, x, strict=False, n_bound=None, cuda=False):
    """The port's plain form (or, ``cuda``, its wrapper) on ``x``."""
    args = (_t(x["avail"]), _t(x["dem"]), _t(x["valid"]))
    kw = dict(live=_t(x["live"]), risk=_t(x["risk"]), n_bound=n_bound)
    if arm == "opportunistic":
        fn = ck.opportunistic_cuda if cuda else ck.opportunistic_plain
        return fn(*args, _t(x["u"]), **kw)
    if arm == "first-fit":
        fn = ck.first_fit_cuda if cuda else ck.first_fit_plain
        return fn(*args, strict=strict, **kw)
    fn = ck.best_fit_cuda if cuda else ck.best_fit_plain
    return fn(*args, **kw)


def assert_bitwise(want, got, ctx):
    p, a = (np.asarray(w) for w in want)
    assert np.array_equal(p, got[0].numpy()), (ctx, p[:12], got[0][:12])
    a2 = got[1].numpy()
    assert a.dtype == a2.dtype, ctx
    assert np.array_equal(a.view(np.uint8), a2.view(np.uint8)), ctx


def assert_close(want, got, ctx):
    p, a = (np.asarray(w) for w in want)
    assert np.array_equal(p, got[0].numpy()), ctx
    np.testing.assert_allclose(got[1].numpy(), a, rtol=1e-6, atol=1e-5,
                               err_msg=str(ctx))


@pytest.fixture(autouse=True)
def _reset_port_ids():
    from pivot_tpu_torch.utils import reset_ids

    reset_ids()
    yield


# -- plain forms vs the reference --------------------------------------------


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("arm", ARMS)
@pytest.mark.parametrize("T,H", [(23, 7), (61, 33), (40, 129)])
def test_plain_equals_reference_f64(arm, case, T, H):
    x = make_case(T * 31 + H, T, H, case)
    for strict in ((False, True) if arm == "first-fit" else (False,)):
        got = plain(arm, x, strict)
        assert got[0].dtype == torch.int32
        for form in ("ref", "impl"):
            assert_bitwise(jax_ref(arm, x, strict, form), got,
                           (arm, case, strict, form))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("arm", ARMS)
def test_plain_equals_reference_f32(arm, case):
    x = make_case(5, 50, 19, case, dtype=np.float32)
    for strict in ((False, True) if arm == "first-fit" else (False,)):
        got = plain(arm, x, strict)
        assert got[1].dtype == torch.float32
        assert_close(jax_ref(arm, x, strict), got, (arm, case, strict))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", ["plain", "risk", "nofit", "invalid",
                                  "ties"])
@pytest.mark.parametrize("arm", ["first-fit", "best-fit"])
def test_batched_plain_equals_vmap(arm, case, dtype):
    x = make_case(11, 37, 13, case, R=5, dtype=dtype)
    dem, valid, risk = _j(x["dem"]), _j(x["valid"]), _j(x["risk"])
    check = assert_bitwise if dtype == np.float64 else assert_close
    for strict in ((False, True) if arm == "first-fit" else (False,)):
        if arm == "first-fit":
            want = jax.vmap(lambda a: jk.first_fit_kernel_ref(
                a, dem, valid, strict=strict, risk=risk))(_j(x["avail"]))
            got = ck.first_fit_plain_batched(
                _t(x["avail"]), _t(x["dem"]), _t(x["valid"]), strict=strict,
                risk=_t(x["risk"]))
        else:
            want = jax.vmap(lambda a: jk.best_fit_kernel_ref(
                a, dem, valid, risk=risk))(_j(x["avail"]))
            got = ck.best_fit_plain_batched(
                _t(x["avail"]), _t(x["dem"]), _t(x["valid"]),
                risk=_t(x["risk"]))
        assert got[0].shape == (5, 37)
        check(want, got, (arm, case, strict))


@pytest.mark.parametrize("arm", ARMS)
def test_empty_and_all_invalid_streams(arm):
    x = make_case(2, 0, 6, "plain")
    got = plain(arm, x)
    assert got[0].shape == (0,)
    assert torch.equal(got[1], _t(x["avail"]))
    x = make_case(2, 20, 6, "plain")
    x["valid"][:] = False
    got = plain(arm, x)
    assert bool((got[0] == -1).all())
    assert torch.equal(got[1], _t(x["avail"]))
    assert_bitwise(jax_ref(arm, x), got, arm)


@pytest.mark.parametrize("arm", ARMS)
def test_stop_one_past_the_last_valid_task(arm):
    """A host step bound of one past the last valid task gives the
    reference's whole-stream result; the tail stays −1."""
    x = make_case(8, 40, 9, "invalid")
    last = int(np.flatnonzero(x["valid"]).max())
    for bound in (last + 1, last + 5, 40, 1000):
        got = plain(arm, x, n_bound=bound)
        assert_bitwise(jax_ref(arm, x), got, (arm, bound))
        assert bool((got[0][last + 1:] == -1).all())


# -- the wrappers on the CPU ---------------------------------------------------


@pytest.mark.parametrize("arm", ARMS)
def test_wrapper_on_cpu_is_plain_and_counts_nothing(arm):
    x = make_case(4, 30, 11, "risk_live", dtype=np.float32)
    ck.reset_launches()
    assert_bitwise(tuple(t.numpy() for t in plain(arm, x)),
                   plain(arm, x, cuda=True), arm)
    if arm != "opportunistic":
        xr = make_case(4, 30, 11, "risk", R=3, dtype=np.float32)
        args = (_t(xr["avail"]), _t(xr["dem"]), _t(xr["valid"]))
        fns = ((ck.first_fit_cuda_batched, ck.first_fit_plain_batched)
               if arm == "first-fit" else
               (ck.best_fit_cuda_batched, ck.best_fit_plain_batched))
        got, want = (f(*args, risk=_t(xr["risk"])) for f in fns)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert ck.LAUNCHES == {"greedy_place": 0, "carry_free_place": 0,
                           "ensemble_chain": 0}
    assert ck.LAUNCHES_CARRY_FREE == {}


def test_argument_checks():
    x = make_case(1, 10, 5, "plain", dtype=np.float32)
    a, d, v, u = (_t(x[k]) for k in ("avail", "dem", "valid", "u"))
    with pytest.raises(ValueError, match="avail must be"):
        ck.first_fit_plain(a[:, :3].contiguous(), d, v)
    with pytest.raises(TypeError, match="demands must be"):
        ck.first_fit_plain(a, d.double(), v)
    with pytest.raises(TypeError, match="valid must be"):
        ck.best_fit_plain(a, d, v.int())
    with pytest.raises(ValueError, match="valid must have shape"):
        ck.best_fit_plain(a, d[:5], v)
    with pytest.raises(ValueError, match="demands must have shape"):
        ck.best_fit_plain(a, d[:, :3].contiguous(), v)
    with pytest.raises(ValueError, match="needs uniforms"):
        ck.opportunistic_plain(a, d, v, None)
    with pytest.raises(ValueError, match="uniforms must have shape"):
        ck.opportunistic_plain(a, d, v, u[:3])
    with pytest.raises(ValueError, match="live must have shape"):
        ck.first_fit_cuda(a, d, v, live=torch.ones(4, dtype=torch.bool))
    with pytest.raises(TypeError, match="risk must be"):
        ck.first_fit_cuda(a, d, v, risk=torch.zeros(5, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        ck.first_fit_plain(a.t().contiguous().t(), d, v)
    with pytest.raises(ValueError, match="at least one host"):
        ck.first_fit_plain(a[:0], d, v)
    with pytest.raises(ValueError, match="n_bound"):
        ck.best_fit_plain(a, d, v, n_bound=-1)
    with pytest.raises(TypeError, match="float32 or float64"):
        ck.best_fit_plain(a.half(), d.half(), v)
    with pytest.raises(ValueError, match="arm must be"):
        ck._cf_check("vbp", a[None], d, v, None, None, None, None)
    meta = [t.to("meta") for t in (a, d, v)]
    with pytest.raises(ValueError, match="runs on cuda or"):
        ck.best_fit_cuda(*meta)
    with pytest.raises(ValueError, match="runs on cuda or"):
        ck.first_fit_cuda_batched(meta[0][None], *meta[1:])


# -- the launch shape ----------------------------------------------------------


#: Every boundary of the launch-shape rule: the register builds'
#: capacities (1,536, 2,048, 4,096 hosts) and the K switches, the
#: cluster sizes (C = 8 from 4,097, 16 from 8,193), the cluster form's
#: capacity (211,968) and past it.
SHAPE_HS = [1, 5, 31, 32, 33, 127, 128, 129, 600, 767, 768, 769, 1000, 1536,
            1537, 2048, 2049, 4095, 4096, 4097, 8192, 8193, 14096, 14097,
            16384, 16385, 98304, 211968, 211969, 250000]


@pytest.mark.parametrize("H", SHAPE_HS)
@pytest.mark.parametrize("R", [1, 256])
@pytest.mark.parametrize("arm", ARMS)
def test_host_ranges_own_every_host_once(H, arm, R):
    cfg = ck._cf_config(H, arm, R)
    model = kernel_budget.cf_model()
    regs = cfg.form > 0
    assert cfg.threads % 32 == 0 and 32 <= cfg.threads
    assert cfg.threads <= model.form_threads(cfg.form)
    assert cfg.smem_bytes == ck._cf_smem_bytes(H, cfg.form, cfg.warps,
                                               cfg.groups, cfg.cluster)
    assert cfg.smem_bytes == model.smem_bytes(H, cfg.form, cfg.warps,
                                              cfg.groups, cfg.cluster)
    assert cfg.smem_bytes <= ck._SMEM_LIMIT == 232448
    C = cfg.cluster
    assert 1 <= C <= 16 and C & (C - 1) == 0
    assert C * cfg.warps <= model.max_slots
    if regs:  # only a built K, one CTA, the hosts within its threads
        assert cfg.form in model.reg_threads and C == 1
        assert 32 * cfg.warps * cfg.form >= H
        k = ck._CF_REG_K[arm] if R == 1 else ck._CF_REG_K_REPLICAS[arm]
        assert cfg.form >= k
        assert cfg.groups == 1 or (R > 1 and cfg.groups <= 15)
        assert H <= max(K * n for K, n in model.reg_threads.items())
    else:
        assert cfg.groups == 1
        assert H > max(K * n for K, n in model.reg_threads.items())
        assert cfg.state == ("shared" if H <= ck._CF_CLUSTER_MAX_HOSTS
                             else "global")
        assert ck._CF_CLUSTER_MAX_HOSTS == 211968
        if cfg.state == "global":
            assert C == 1
    for threads in {32 * cfg.warps, 32, 96, 512}:
        ranges = model.host_ranges(H, threads, C,
                                   cfg.form if regs else None)
        if regs and threads * cfg.form < H:
            continue  # a register shape covers H at its own warps only
        assert len(ranges) == C * threads
        owned = [h for h0, h1 in ranges for h in range(h0, h1)]
        assert owned == list(range(H))  # each once, in index order
        hc = -(-H // C)
        assert all(h1 - h0 <= (cfg.form if regs else -(-hc // threads))
                   for h0, h1 in ranges)


# -- routing -----------------------------------------------------------------


def _policy(cls=pc.CudaFirstFitPolicy, **kw):
    pol = cls(device="cpu", **kw)
    pol.device = torch.device("cuda")  # the rule's view of a card policy
    return pol


def test_carry_free_serves_each_condition():
    for cls in (pc.CudaOpportunisticPolicy, pc.CudaFirstFitPolicy,
                pc.CudaBestFitPolicy):
        assert _policy(cls)._carry_free_serves()
        assert _policy(cls, phase2="slim")._carry_free_serves()
        assert not _policy(cls, phase2="scan")._carry_free_serves()
        assert not _policy(cls, phase2=8)._carry_free_serves()
        assert not cls(device="cpu")._carry_free_serves()
        pol = _policy(cls)
        pol.dtype = torch.float64
        assert not pol._carry_free_serves()
        pol = _policy(cls)
        pol._mesh = object()
        assert not pol._carry_free_serves()
        pol = _policy(cls)
        pol._batch_client = object()
        assert not pol._carry_free_serves()
    assert not _policy(pc.CudaCostAwarePolicy)._carry_free_serves()


class _Recorder:
    """Stands in for a wrapper in ``sched.cuda``: records the call and
    runs the wrapper (its plain form, on CPU tensors)."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0
        self.__name__ = fn.__name__

    def __call__(self, *a, **k):
        self.calls += 1
        return self.fn(*a, **k)


def _forced(cls):
    class Forced(cls):
        def _carry_free_serves(self):
            return True  # the rule's verdict on a card

    return Forced


@pytest.mark.parametrize("name", ["ff", "bf", "opp"])
def test_kernel_route_equals_the_torch_forms(name, monkeypatch):
    """float32 on CPU tensors, the rule forced on: every per-tick and span
    tick goes through the arm's wrapper (here its plain form), and the
    run's placements, end times, ticks and meters equal the torch-form
    run's."""
    from tests.test_torch_tickloop import _port_full_sim

    cls, wrapper = {"ff": (pc.CudaFirstFitPolicy, "first_fit_cuda"),
                    "bf": (pc.CudaBestFitPolicy, "best_fit_cuda"),
                    "opp": (pc.CudaOpportunisticPolicy,
                            "opportunistic_cuda")}[name]
    rec = _Recorder(getattr(pc, wrapper))
    monkeypatch.setattr(pc, wrapper, rec)
    for fuse in (True, False):
        got, stats, pol = _port_full_sim(
            lambda: _forced(cls)(device="cpu"), fuse=fuse)
        want, _s, ref = _port_full_sim(lambda: cls(device="cpu"), fuse=fuse)
        assert got == want
        d = pol.dispatch_stats()
        assert d["kernel_ticks"] == d["device_ticks"] > 0
        assert d["span_kernel_ticks"] >= stats["fused_ticks"]
        assert (d["span_kernel_ticks"] > 0) == fuse
        assert rec.calls == d["kernel_ticks"] + d["span_kernel_ticks"]
        assert ref.dispatch_stats()["kernel_ticks"] == 0
        rec.calls = 0


@pytest.mark.parametrize("cls,batched", [
    (pc.CudaFirstFitPolicy, "first_fit_cuda_batched"),
    (pc.CudaBestFitPolicy, "best_fit_cuda_batched"),
])
def test_sensitivity_takes_the_replica_form(cls, batched, monkeypatch):
    """``placement_sensitivity`` under the rule is one call of the
    R-replica wrapper, and equals the torch pass."""
    from pivot_tpu_torch.sched import TickContext
    from tests.test_torch_tickloop import _port_full_sim

    ctxs = []

    class Capture(cls):
        def _device_place(self, ctx):
            if ctx.n_tasks > 3 and not ctxs:
                ctxs.append(ctx)
                want = cls.placement_sensitivity(self, ctx, n_replicas=8)
                rec = _Recorder(getattr(pc, batched))
                monkeypatch.setattr(pc, batched, rec)
                self._carry_free_serves = lambda: True  # a card's verdict
                got = self.placement_sensitivity(ctx, n_replicas=8)
                del self._carry_free_serves
                assert rec.calls == 1
                for w, g in zip(want, got):
                    assert np.array_equal(w, g)
            return super()._device_place(ctx)

    _port_full_sim(lambda: Capture(device="cpu"), fuse=False)
    assert ctxs and isinstance(ctxs[0], TickContext)


@pytest.mark.parametrize("config", ["opportunistic", "first_fit",
                                    "best_fit"])
def test_fused_span_with_the_plain_kernel_keyword(config):
    """``fused_tick_run(carry_free=<the plain form>)`` writes the span the
    torch forms write, tick for tick (f32, a risk row per tick, a live
    mask)."""
    from tests.test_torch_tickloop import span_kwargs, to_port

    avail, dem, arrive, kw = span_kwargs(config, 8, "auto")
    pkw = to_port(kw, torch.float32)
    H = avail.shape[0]
    rng = np.random.default_rng(3)
    pkw["risk_rows"] = torch.from_numpy(
        rng.choice([0.0, 0.5], size=(8, H)).astype(np.float32))
    live = torch.from_numpy(rng.uniform(size=H) > 0.2)
    args = (torch.from_numpy(np.asarray(avail, np.float32)),
            torch.from_numpy(np.asarray(dem, np.float32)),
            torch.from_numpy(np.asarray(arrive)))
    fn = {"opportunistic": ck.opportunistic_plain,
          "first-fit": ck.first_fit_plain,
          "best-fit": ck.best_fit_plain}[pkw["policy"]]
    rec = _Recorder(fn)
    want = tt.fused_tick_run(*args, 8, n_ticks=8, live=live, **pkw)
    got = tt.fused_tick_run(*args, 8, n_ticks=8, live=live, carry_free=rec,
                            **pkw)
    assert rec.calls == 8
    assert int((want.placements >= 0).sum()) > 0
    for f in ("placements", "n_ready", "n_placed", "ticks_run",
              "n_stack_final", "stackpos", "avail"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    carry = tt.resident_carry_init(args[0], live=live, device="cpu")
    res, _c = tt.resident_span_run(carry, args[1], args[2], 8, n_ticks=8,
                                   carry_free=rec, **{
                                       k: v for k, v in pkw.items()
                                       if k != "risk_rows"})
    assert rec.calls == 16
    want_nr = tt.fused_tick_run(*args, 8, n_ticks=8, live=live, **{
        k: v for k, v in pkw.items() if k != "risk_rows"})
    assert torch.equal(res.placements, want_nr.placements)


# -- tooling -----------------------------------------------------------------

WRAPPERS = ("best_fit_cuda", "best_fit_cuda_batched", "first_fit_cuda",
            "first_fit_cuda_batched", "opportunistic_cuda")


def test_entry_map_lists_the_carry_free_wrappers():
    entries, findings, _s = entrymap.collect_entries(port._Cache(ROOT))
    assert findings == []
    kernel = {e.name for e in entries["pivot_tpu_torch/ops/cuda_kernels.py"]
              if e.kind == "kernel"}
    assert set(WRAPPERS) <= kernel
    assert {"cost_aware_cuda", "cost_aware_cuda_batched",
            "cost_aware_cuda_rows"} <= kernel
    assert not {"load_carry_free_library", "first_fit_plain"} & kernel


def test_profiler_and_cost_attribution_know_the_route():
    for name, family in (("opportunistic_cuda", "opportunistic"),
                         ("first_fit_cuda", "first_fit"),
                         ("first_fit_cuda_batched", "first_fit"),
                         ("best_fit_cuda", "best_fit"),
                         ("best_fit_cuda_batched", "best_fit")):
        assert profiler.family_of(getattr(ck, name)) == family
        assert profiler._model_kind(family) == "slim"
        kind, key = costattr.ENTRY_POINTS[
            ("pivot_tpu_torch/ops/cuda_kernels.py", name)]
        assert kind == "kernel" and key in costattr._CF_FORMS
    assert costattr.coverage_problems() == []
    o = costattr._operands(32, 16, torch.device("cpu"))
    for key in costattr._CF_FORMS:
        wrapper, plain_fn, args, kw, R = costattr._kernel_form(key, o)
        p1, a1 = wrapper(*args, **kw)
        p2, a2 = plain_fn(*args, **kw)
        assert torch.equal(p1, p2) and torch.equal(a1, a2), key
        assert a1.shape[:-2] == ((R,) if R > 1 else ())


@pytest.mark.parametrize("rel,old,new,expect", [
    (kernel_budget._CF_CU_FILE, "static_cast<size_t>(16) * state_hosts",
     "static_cast<size_t>(20) * state_hosts", "_cf_smem_bytes disagrees"),
    (kernel_budget._CF_CU_FILE, "constexpr int kChunk = 256;",
     "constexpr int kChunk = 128;", "_CF_CHUNK = 256"),
    (kernel_budget._CF_CU_FILE, "form == 2 ? 768",
     "form == 2 ? 2048", "above the card's 1024"),
    (kernel_budget._CF_CU_FILE, "__launch_bounds__(max_threads(kForm), 1)",
     "", "carry_free_kernel lost __launch_bounds__"),
    (kernel_budget._CF_CU_FILE, "constexpr int kMaxSlots = 256;",
     "constexpr int kMaxSlots = 128;", "_CF_MAX_SLOTS = 256"),
    (kernel_budget._CF_CU_FILE, "static_cast<size_t>(48) * chunk_of(W)",
     "sizeof(float4) * 3 * chunk_of(W)", "cannot read"),
    (kernel_budget._WRAPPER_FILE, "_CF_MAX_THREADS = 512",
     "_CF_MAX_THREADS = 256", "_CF_MAX_THREADS = 256"),
    (kernel_budget._CF_CU_FILE, "ceil_div(Hc, nthr)", "Hc / nthr",
     "do not own every host once"),
    (kernel_budget._CF_CU_FILE, "min(h0 + Kt, c1)", "min(h0 + Kt + 1, c1)",
     "do not own every host once"),
    # the formulas of the cluster form and the register builds
    (kernel_budget._CF_CU_FILE, "(a + b - 1) / b", "(a + b - 2) / b",
     "do not own every host once"),
    (kernel_budget._CF_CU_FILE, "min(rank * Hc, H)", "min(rank * Hc + 1, H)",
     "do not own every host once"),
    (kernel_budget._CF_CU_FILE, "form == kRowsShared ? ceil_div(H, C) : 0",
     "form == kRowsGlobal ? ceil_div(H, C) : 0", "_cf_smem_bytes disagrees"),
    (kernel_budget._CF_CU_FILE, "static_cast<size_t>(32) * n_slots",
     "static_cast<size_t>(16) * n_slots", "_cf_smem_bytes disagrees"),
    (kernel_budget._CF_CU_FILE, "form == 2 ? 768", "form == 2 ? 1024",
     "_CF_REG_THREADS = "),
    (kernel_budget._CF_CU_FILE,
     "    case 8: return launch<kArm, kRisk, 8>(p, C, s);\n", "",
     "_CF_REG_THREADS = "),
    (kernel_budget._CF_CU_FILE, "constexpr int kMaxCluster = 16;",
     "constexpr int kMaxCluster = 8;", "kMaxCluster = 8"),
    (kernel_budget._CF_CU_FILE, "constexpr int kRowsGlobal = -1;",
     "constexpr int kRowsGlobal = -2;", "_CF_ROWS_GLOBAL = -1"),
    (kernel_budget._WRAPPER_FILE, "_CF_ROWS_WARPS = (8, 16)",
     "_CF_ROWS_WARPS = (8, 32)", "above kMaxSlots"),
    (kernel_budget._CF_CU_FILE, "max_threads(int form) {",
     "max_threads(int form) { /* */", "cannot read"),
])
def test_kernel_budget_reads_carry_free(tmp_path, rel, old, new, expect):
    root = _budget_tree(tmp_path)
    assert port.run(root=root, rules=["kernel-budget"]) == []
    path = os.path.join(root, rel)
    with open(path) as f:
        text = f.read()
    assert old in text
    with open(path, "w") as f:
        f.write(text.replace(old, new, 1))
    got = port.run(root=root, rules=["kernel-budget"])
    assert any(expect in f.message for f in got), [str(f) for f in got]


def test_kernel_budget_missing_source_and_registers(tmp_path):
    root = _budget_tree(tmp_path)
    os.remove(os.path.join(root, kernel_budget._CF_CU_FILE))
    got = port.run(root=root, rules=["kernel-budget"])
    assert any("carry_free_place.cu is missing" in f.message for f in got)
    assert kernel_budget.cf_register_findings(
        [dict(build="ff/K=2", form=2, registers=80),
         dict(build="ff/shared", form=0, registers=128)], 65536) == []
    bad = kernel_budget.cf_register_findings(
        [dict(build="bf/K=2", form=2, registers=88),
         dict(build="bf/K=8", form=8, registers=128),
         dict(build="opp/shared", form=0, registers=136)], 65536)
    assert len(bad) == 2
    assert "88 registers x 768 threads" in bad[0].message
    assert "136 registers x 512 threads" in bad[1].message
