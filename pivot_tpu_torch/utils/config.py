"""Typed configuration tree for experiments.

Port of ``pivot_tpu/utils/config.py``; ``make_policy`` builds the torch
device policies for ``device='cuda'``.

The reference scatters configuration across argparse defaults, env vars,
``**kwargs`` popped in scheduler constructors, and class constants
(SURVEY.md §5 "Config / flag system"); here one dataclass tree describes a
whole experiment and every component is constructed from it.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

__all__ = ["HostShape", "ClusterConfig", "PolicyConfig", "ExperimentConfig", "make_policy"]


@dataclasses.dataclass(frozen=True)
class HostShape:
    cpus: int = 16
    mem: int = 128 * 1024  # MB
    disk: int = 100  # GB
    gpus: int = 1


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    n_hosts: int = 100
    shape: HostShape = HostShape()
    uniform: bool = True
    seed: Optional[int] = 0
    #: 'python' serves network chunks on the event kernel; 'native' in
    #: the C++ co-simulator (``pivot_tpu_torch/native``).
    network: str = "python"
    #: 'fast' drives executions with bare callbacks; 'process' mirrors the
    #: reference's one-process-per-execution shape.  Bit-identical runs.
    executor: str = "fast"


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    """Which placement policy, on which backend.

    ``device``: 'cuda' (the default: the torch device policies and the
    hand-written kernel, ``pivot_tpu_torch.sched.cuda``), or the CPU
    policies 'naive' (reference-faithful Python) and 'numpy' (vectorized).
    """

    name: str = "cost-aware"  # opportunistic | first-fit | best-fit | cost-aware
    device: str = "cuda"
    decreasing: bool = False  # first/best-fit
    bin_pack: str = "first-fit"  # cost-aware
    sort_tasks: bool = False
    sort_hosts: bool = False
    realtime_bw: bool = False
    host_decay: bool = False
    #: cuda backend only: route each tick to the device or the in-process
    #: numpy twin, whichever an online latency model predicts faster
    #: (small ticks cannot amortize the fixed per-call device latency).
    #: Off by default: every tick goes to the device.
    adaptive: bool = False
    label: Optional[str] = None

    @property
    def display_label(self) -> str:
        return self.label or f"{self.name}-{self.device}"


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    cluster: ClusterConfig = ClusterConfig()
    policies: Tuple[PolicyConfig, ...] = ()
    trace_files: Tuple[str, ...] = ()
    n_apps: Optional[int] = 100
    output_size_scale_factor: float = 1000.0
    interval: float = 5.0
    seed: Optional[int] = 0
    data_dir: Optional[str] = None


def build_cluster(cfg: ClusterConfig, meta=None):
    """Construct the cluster described by ``cfg`` (deterministic per seed)."""
    from pivot_tpu_torch.des import Environment
    from pivot_tpu_torch.infra.gen import RandomClusterGenerator
    from pivot_tpu_torch.infra.locality import ResourceMetadata

    meta = meta if meta is not None else ResourceMetadata(seed=cfg.seed)
    s = cfg.shape
    gen = RandomClusterGenerator(
        Environment(),
        (s.cpus, s.cpus),
        (s.mem, s.mem),
        (s.disk, s.disk),
        (s.gpus, s.gpus),
        meta=meta,
        seed=cfg.seed,
        network_backend=cfg.network,
        executor_backend=cfg.executor,
    )
    return gen.generate(cfg.n_hosts, uniform=cfg.uniform)


#: The reference's three experiment arms with their exact hyperparameters
#: (``alibaba/sim.py:179-186``), on a chosen device backend.
def reference_policy_set(
    device: str = "cuda", adaptive: bool = False
) -> Tuple[PolicyConfig, ...]:
    return (
        PolicyConfig(
            name="opportunistic", device=device, adaptive=adaptive,
            label="Opportunistic",
        ),
        PolicyConfig(
            name="first-fit", device=device, decreasing=True, adaptive=adaptive,
            label="VBP",
        ),
        PolicyConfig(
            name="cost-aware",
            device=device,
            bin_pack="first-fit",
            sort_tasks=True,
            sort_hosts=True,
            adaptive=adaptive,
            label="Cost-Aware",
        ),
    )


def make_policy(cfg: PolicyConfig, torch_device: str = "cuda",
                dtype: str = "float32"):
    """Instantiate the policy object described by ``cfg``.

    ``device='cuda'`` builds the torch device policies of
    :mod:`pivot_tpu_torch.sched.cuda` on ``torch_device`` (``"cuda"``
    unless the caller asks for ``"cpu"``, as the tests do) in ``dtype``
    (``"float32"`` or ``"float64"``)."""
    if cfg.device == "cuda":
        import torch

        from pivot_tpu_torch.sched import cuda as dev

        if cfg.name == "opportunistic":
            policy = dev.CudaOpportunisticPolicy(
                adaptive=cfg.adaptive, device=torch_device
            )
        elif cfg.name == "first-fit":
            policy = dev.CudaFirstFitPolicy(
                decreasing=cfg.decreasing, adaptive=cfg.adaptive,
                device=torch_device,
            )
        elif cfg.name == "best-fit":
            policy = dev.CudaBestFitPolicy(
                decreasing=cfg.decreasing, adaptive=cfg.adaptive,
                device=torch_device,
            )
        elif cfg.name == "cost-aware":
            policy = dev.CudaCostAwarePolicy(
                bin_pack=cfg.bin_pack,
                sort_tasks=cfg.sort_tasks,
                sort_hosts=cfg.sort_hosts,
                host_decay=cfg.host_decay,
                realtime_bw=cfg.realtime_bw,
                adaptive=cfg.adaptive,
                device=torch_device,
            )
        else:
            raise ValueError(f"unknown policy {cfg.name!r}")
        if dtype not in ("float32", "float64"):
            raise ValueError(f"dtype must be 'float32' or 'float64', "
                             f"got {dtype!r}")
        policy.dtype = getattr(torch, dtype)
        return policy

    from pivot_tpu_torch.sched import policies as cpu

    mode = cfg.device
    if mode not in ("naive", "numpy"):
        raise ValueError(f"unknown device {cfg.device!r}")
    if cfg.name == "opportunistic":
        return cpu.OpportunisticPolicy(mode)
    if cfg.name == "first-fit":
        return cpu.FirstFitPolicy(decreasing=cfg.decreasing, mode=mode)
    if cfg.name == "best-fit":
        return cpu.BestFitPolicy(decreasing=cfg.decreasing, mode=mode)
    if cfg.name == "cost-aware":
        return cpu.CostAwarePolicy(
            bin_pack=cfg.bin_pack,
            sort_tasks=cfg.sort_tasks,
            sort_hosts=cfg.sort_hosts,
            realtime_bw=cfg.realtime_bw,
            host_decay=cfg.host_decay,
            mode=mode,
        )
    raise ValueError(f"unknown policy {cfg.name!r}")
