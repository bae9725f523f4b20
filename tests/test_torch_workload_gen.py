"""The port's workload generators, trace converter and sampler vs
``pivot_tpu``'s (``workload/gen.py``, ``workload/convert.py``,
``experiments/sample.py``, copied JAX-free into the port).

``tests/test_workload.py``'s generator cases, ``tests/test_convert.py``
and ``tests/test_experiments.py``'s two sampler cases, each run through
both packages on the same seeds and inputs: the generated applications
are equal group for group (ids aside: they come from each package's own
counter), the converted archives array for array, the sampled windows
job for job.
"""

from __future__ import annotations

import numpy as np
import pytest
import yaml

from pivot_tpu.experiments import sample as jsample
from pivot_tpu.workload import convert as jconv
from pivot_tpu.workload import gen as jgen
from pivot_tpu_torch.experiments import sample as psample
from pivot_tpu_torch.workload import convert as pconv
from pivot_tpu_torch.workload import gen as pgen
from pivot_tpu_torch.workload.trace import load_trace_jobs

from tests.test_convert import _JOBS, _schedule_fingerprint


def _groups(app):
    return [(g.id, g.cpus, g.mem, g.disk, g.gpus, g.runtime, g.output_size,
             g.instances, tuple(sorted(g.dependencies or ())))
            for g in app.groups]


def _spec(mod, **kw):
    return mod._RangeSpec(**kw)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_random_dag_edges_acyclic_and_seeded(seed):
    edges = pgen.random_dag_edges(np.random.default_rng(seed), 20, 0.3)
    assert all(u < v for u, v in edges)
    assert edges == pgen.random_dag_edges(np.random.default_rng(seed), 20,
                                          0.3)
    assert edges == jgen.random_dag_edges(np.random.default_rng(seed), 20,
                                          0.3)


@pytest.mark.parametrize("seed", [7, 8])
def test_random_application_generator(seed):
    kw = dict(cpus=(1, 4), mem=(64, 256), runtime=(1, 100),
              output_size=(0, 50))
    gen = pgen.RandomApplicationGenerator((5, 15), (0.2, 0.5),
                                          _spec(pgen, **kw), seed=seed)
    ref = jgen.RandomApplicationGenerator((5, 15), (0.2, 0.5),
                                          _spec(jgen, **kw), seed=seed)
    for _ in range(3):
        app, want = gen.generate(), ref.generate()
        assert 5 <= len(app.groups) <= 15
        assert app.get_sources()
        for g in app.groups:
            assert 1 <= g.cpus <= 4 and 1 <= g.runtime <= 100
        assert _groups(app) == _groups(want)


def test_sequential_generator_is_chain():
    kw = dict(cpus=(1, 2), mem=(64, 128), runtime=(1, 10))
    app = pgen.SequentialApplicationGenerator((4, 4), _spec(pgen, **kw),
                                              seed=3).generate()
    assert len(app.get_sources()) == 1 and len(app.get_sinks()) == 1
    assert app.critical_path_runtime() == sum(g.runtime for g in app.groups)
    want = jgen.SequentialApplicationGenerator((4, 4), _spec(jgen, **kw),
                                               seed=3).generate()
    assert _groups(app) == _groups(want)


def test_data_parallel_generator_matches_pivot_tpu():
    kw = dict(cpus=(1, 8), mem=(64, 1024), runtime=(5, 60),
              output_size=(10, 500))
    args = ((1, 3), (1, 3), (2, 5))
    gen = pgen.DataParallelApplicationGenerator(*args, _spec(pgen, **kw),
                                                seed=11)
    ref = jgen.DataParallelApplicationGenerator(*args, _spec(jgen, **kw),
                                                seed=11)
    for _ in range(4):
        assert _groups(gen.generate()) == _groups(ref.generate())


def test_yaml_npz_round_trip(tmp_path):
    src = tmp_path / "jobs.yaml"
    src.write_text(yaml.safe_dump(_JOBS))
    dst, ref = tmp_path / "jobs.npz", tmp_path / "ref.npz"
    stats = pconv.convert_yaml_trace(str(src), str(dst))
    assert stats == jconv.convert_yaml_trace(str(src), str(ref))
    assert stats["jobs"] == 2 and stats["tasks"] == 3
    a = load_trace_jobs(str(src), 1000.0)
    b = load_trace_jobs(str(dst), 1000.0)
    assert _schedule_fingerprint(a) == _schedule_fingerprint(b)
    times = [t for t, _ in b.bins]
    assert times == sorted(times)
    with np.load(dst) as p, np.load(ref) as j:
        assert set(p.files) == set(j.files)
        for k in j.files:
            assert p[k].dtype == j[k].dtype, k
            np.testing.assert_array_equal(p[k], j[k], err_msg=k)


def test_converter_cli_main(tmp_path):
    src = tmp_path / "jobs.yaml"
    src.write_text(yaml.safe_dump(_JOBS))
    pconv.main([str(src), "--out-dir", str(tmp_path / "out")])
    out = tmp_path / "out" / "jobs.npz"
    assert out.exists()
    with np.load(out, allow_pickle=False) as f:
        assert f["task_start"].tolist() == [0, 2, 3]
        assert f["dep_start"].tolist() == [0, 0, 1, 1]
        assert f["deps"].tolist() == [1]


@pytest.fixture
def csv_pair(tmp_path):
    """``tests/test_experiments.py``'s synthetic trace CSVs."""
    batch_task = tmp_path / "batch_task.csv"
    batch_task.write_text("\n".join([
        "M1,2,j_1,A,Terminated,1000,1100,100,0.5",
        "M2_1,3,j_1,A,Terminated,1100,1300,200,0.3",
        "M1,1,j_2,A,Terminated,1500,1600,100,0.2",
        "M2_1,1,j_2,A,Terminated,1600,1900,100,0.2",
        "M1,1,j_3,A,Failed,1000,1100,100,0.2",
        "M1,200,j_4,A,Terminated,2000,2100,100,0.2",
        "M2_1,1,j_4,A,Terminated,2100,2200,100,0.2",
    ]) + "\n")
    rows = [("i1", "M1", "j_1", "1000", "1100", "m1"),
            ("i2", "M2_1", "j_1", "1100", "1300", "m2"),
            ("i3", "M1", "j_2", "1500", "1600", "m1"),
            ("i4", "M2_1", "j_2", "1600", "1900", "m3"),
            ("i5", "M1", "j_4", "2000", "2100", "m1"),
            ("i6", "M2_1", "j_4", "2100", "2200", "m1")]
    batch_inst = tmp_path / "batch_instance.csv"
    batch_inst.write_text("\n".join(
        ",".join([i, t, j, "x", "Terminated", s, e, m] + ["0"] * 6)
        for i, t, j, s, e, m in rows) + "\n")
    return str(batch_task), str(batch_inst)


def test_sampler_end_to_end(csv_pair):
    batch_task, batch_inst = csv_pair
    jobs = psample.load_job_dags(batch_task)
    assert jobs == jsample.load_job_dags(batch_task)
    assert set(jobs) == {"j_1", "j_2", "j_4"}
    assert jobs["j_1"]["tasks"][2]["dependencies"] == [1]
    assert jobs["j_1"]["tasks"][1]["cpus"] == 1.0
    kw = dict(n_jobs=10, start=0, interval=1000, min_runtime=100,
              max_runtime=1000, min_deps=1, max_parallel=100)
    windows = psample.sample_windows(batch_inst, jobs, **kw)
    assert windows == jsample.sample_windows(batch_inst, jobs, **kw)
    sampled = {j["id"] for w in windows.values() for j in w}
    assert "j_1" in sampled and "j_2" in sampled and "j_4" not in sampled
    j1 = next(j for w in windows.values() for j in w if j["id"] == "j_1")
    t2 = next(t for t in j1["tasks"] if t["id"] == 2)
    assert t2["runtime"] == 200 and t2["dependencies"] == [1]
    assert any(k == 1000 for k in windows)
    for name in ("M1_2_3", "M4", "task_xyz", "MergeTask", "R2_Stg5_1"):
        assert psample.parse_task_name(name) == jsample.parse_task_name(name)


def test_sampler_runtime_filter(csv_pair):
    batch_task, batch_inst = csv_pair
    jobs = psample.load_job_dags(batch_task)
    kw = dict(n_jobs=10, start=0, interval=1000, min_runtime=10,
              max_runtime=150, min_deps=1, max_parallel=100)
    windows = psample.sample_windows(batch_inst, jobs, **kw)
    assert windows == jsample.sample_windows(batch_inst, jobs, **kw)
    assert "j_1" not in {j["id"] for w in windows.values() for j in w}


def test_sampler_cli_writes_pivot_tpus_files(csv_pair, tmp_path):
    batch_task, batch_inst = csv_pair
    argv = ["-n", "10", "-s", "0", "-i", "1000", "-l", "100", "-u", "1000",
            "--batch-task", batch_task, "--batch-instance", batch_inst,
            "--npz"]
    for mod, out in ((psample, "port"), (jsample, "jax")):
        (tmp_path / out).mkdir()
        mod.main(argv + ["-o", str(tmp_path / out)])
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names and names == sorted(p.name for p in
                                     (tmp_path / "port").iterdir())
    assert {n.rsplit(".", 1)[1] for n in names} == {"yaml", "npz"}
    for name in names:
        port, ref = tmp_path / "port" / name, tmp_path / "jax" / name
        if name.endswith(".yaml"):
            assert port.read_bytes() == ref.read_bytes()
            continue
        with np.load(port) as p, np.load(ref) as j:
            assert set(p.files) == set(j.files)
            for k in j.files:
                np.testing.assert_array_equal(p[k], j[k], err_msg=k)
