"""The port's threefry twin and Monte-Carlo draws vs ``jax.random``.

  * ``pivot_tpu_torch.parallel.ensemble.prng`` — ``PRNGKey``, ``split``,
    ``fold_in``, 32/64-bit ``random_bits`` and ``uniform`` in float32 and
    float64 — bitwise equal to ``jax.random`` (partitionable threefry,
    jax's default) over seeds {0, 1, 7, 0xDEADBEEF} and shapes up to the
    ensemble's ``[8, 3631]``;
  * the float32 fused multiply-add emulation on a case where rounding
    through float64 first would round twice;
  * ``draws._perturbations`` and ``draws._opportunistic_uniforms`` bitwise
    equal to ``pivot_tpu``'s, and ``draws._keyed_storage_index`` equal to
    the port's numpy ``keyed_storage_index``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pivot_tpu.parallel.ensemble import draws as jdraws
from pivot_tpu.parallel.ensemble import EnsembleWorkload as JWorkload
from pivot_tpu_torch.parallel.ensemble import draws as pdraws
from pivot_tpu_torch.parallel.ensemble import prng
from pivot_tpu_torch.parallel.ensemble.state import (
    EnsembleWorkload as PWorkload,
)
from pivot_tpu_torch.sched.rand import keyed_storage_index
from pivot_tpu.workload import Application, TaskGroup

SEEDS = (0, 1, 7, 0xDEADBEEF)
SHAPES = ((1,), (7,), (3, 5), (8, 3631))


def _jkey(seed):
    return np.asarray(jax.random.key_data(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_split_fold_in(seed):
    key = prng.PRNGKey(seed)
    np.testing.assert_array_equal(key, _jkey(seed))
    jk = jax.random.PRNGKey(seed)
    for n in (2, 3, 5):
        np.testing.assert_array_equal(
            prng.split(key, n), np.asarray(jax.random.split(jk, n)))
    for data in (0, 1, 5, 0x09901, 0xFFFFFFFF):
        np.testing.assert_array_equal(
            prng.fold_in(key, data),
            np.asarray(jax.random.fold_in(jk, data)))
    # Derived keys derive on: split of a folded key.
    np.testing.assert_array_equal(
        prng.split(prng.fold_in(key, 3), 3),
        np.asarray(jax.random.split(jax.random.fold_in(jk, 3), 3)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits(seed, shape):
    jk = jax.random.PRNGKey(seed)
    key = prng.PRNGKey(seed)
    b32 = np.asarray(jax.random.bits(jk, shape, jnp.uint32))
    np.testing.assert_array_equal(
        prng.random_bits(key, 32, shape).numpy().astype(np.uint32), b32)
    b64 = np.asarray(jax.random.bits(jk, shape, jnp.uint64))
    np.testing.assert_array_equal(
        prng.random_bits(key, 64, shape).numpy().view(np.uint64), b64)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_uniform(seed, shape, dtype):
    jk = jax.random.PRNGKey(seed)
    key = prng.PRNGKey(seed)
    for lo, hi in ((0.0, 1.0), (0.9, 1.1), (0.6, 1.4), (-2.0, 3.0)):
        want = np.asarray(jax.random.uniform(
            jk, shape, dtype=getattr(jnp, dtype), minval=lo, maxval=hi))
        got = prng.uniform(key, shape, getattr(torch, dtype), lo, hi).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def test_fma_float32_rounds_once():
    """8(1 + 2⁻²³) · 8(1 − 2⁻²³) + (2³⁰ + 128) is 2³⁰ + 192 − 2⁻⁴⁰: just
    under a float32 midpoint, so the fused result is 2³⁰ + 128, while a
    float64 sum rounded again to float32 lands on the midpoint and ties
    up to 2³⁰ + 256."""
    a = torch.tensor([8 + 2.0 ** -20], dtype=torch.float32)
    b = torch.tensor([8 * (1 - 2.0 ** -23)], dtype=torch.float32)
    c = torch.tensor([2.0 ** 30 + 128], dtype=torch.float32)
    twice = (a.double() * b.double() + c.double()).float()
    assert twice.item() == 2.0 ** 30 + 256
    assert prng.fma(a, b, c).item() == 2.0 ** 30 + 128
    # float64: the error-free transformations against exact rationals.
    from fractions import Fraction

    rng = np.random.default_rng(3)
    x, y, z = (rng.standard_normal(2000) * 10.0 ** rng.integers(-8, 8, 2000)
               for _ in range(3))
    got = prng.fma(*(torch.from_numpy(v) for v in (x, y, z))).numpy()
    want = [float(Fraction(p) * Fraction(q) + Fraction(r))
            for p, q, r in zip(x, y, z)]
    np.testing.assert_array_equal(got, np.asarray(want))


def _apps(rng, n_apps=4):
    apps = []
    for a in range(n_apps):
        groups = []
        for i in range(int(rng.integers(1, 5))):
            deps = [str(int(rng.integers(0, i)))] if i and rng.random() < 0.6 \
                else []
            groups.append(TaskGroup(
                str(i), cpus=float(rng.choice([0.5, 1, 2])),
                mem=float(rng.choice([128, 512])),
                runtime=float(rng.integers(3, 40)),
                output_size=float(rng.choice([0, 500])),
                instances=int(rng.integers(1, 6)), dependencies=deps))
        apps.append(Application(f"d{a}", groups))
    return apps


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_perturbations_and_opportunistic_uniforms(seed, dtype):
    rng = np.random.default_rng(seed % 1000)
    apps = _apps(rng)
    arrivals = [float(9 * i) for i in range(len(apps))]
    jw = JWorkload.from_applications(apps, arrivals=arrivals)
    pw = PWorkload.from_applications(apps, arrivals=arrivals, device="cpu")
    zones = np.array([3, 7, 11, 19, 30], dtype=np.int32)
    R, T = 9, jw.n_tasks
    jk = jax.random.PRNGKey(seed)
    jt = getattr(jnp, dtype)
    want = jdraws._perturbations(jk, jw, jnp.asarray(zones), R, 0.1, jt)
    got = pdraws._perturbations(prng.PRNGKey(seed), pw,
                                torch.from_numpy(zones), R, 0.1,
                                getattr(torch, dtype))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        if w.dtype.kind == "f":
            assert g.numpy().dtype == w.dtype
            np.testing.assert_array_equal(g.numpy().view(np.uint8),
                                          w.view(np.uint8))
        else:
            np.testing.assert_array_equal(g.numpy(), w)
    ju = np.asarray(jdraws._opportunistic_uniforms(jk, R, T, jt))
    pu = pdraws._opportunistic_uniforms(prng.PRNGKey(seed), R, T,
                                        getattr(torch, dtype), "cpu").numpy()
    np.testing.assert_array_equal(pu.view(np.uint8), ju.view(np.uint8))
    assert pdraws._seed_bits(prng.PRNGKey(seed)) == seed


@pytest.mark.parametrize("seed", SEEDS)
def test_keyed_storage_index_twin(seed):
    apps = np.arange(500)
    for n_storage in (1, 8, 31):
        for salt in (0, 1, 5, 1023):
            want = keyed_storage_index(seed, apps, n_storage, salt=salt)
            got = pdraws._keyed_storage_index(
                seed, torch.from_numpy(apps), n_storage,
                torch.tensor(salt))
            np.testing.assert_array_equal(got.numpy(), want)
