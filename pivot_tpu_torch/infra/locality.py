"""Geographic locality model and the zone×zone bandwidth / cost matrices.

Capability parity with the reference's ``Cloud``/``Region``/``Zone``/
``Locality`` enums and ``ResourceMetadata`` singleton
(``resources/__init__.py:479-589``), redesigned for the TPU decision
backend:

  * Localities are interned value objects with a **dense integer zone
    index** — the currency of the placement kernels.
  * Bandwidth and egress-cost live as dense ``[Z, Z]`` float arrays
    (``bw_matrix``, ``cost_matrix``) rather than 961-entry dicts; the same
    arrays are pushed to the device once per experiment
    (``pivot_tpu_torch.ops.kernels.DeviceTopology``).
  * No singleton metaclass: ``ResourceMetadata(seed=...)`` is explicit, and
    the reference's ±5 % load-time bandwidth jitter
    (``resources/__init__.py:589``) is reproducible via the seed.

Data: ``data/locality.json`` — 31 AWS+GCP zones and 121 directed
region-pair records (intra-region 15 Gbps / $0, cross-cloud ~50-1120 Mbps at
$0.09-0.11/GB), transcribed from the reference network model
(``resources/locality.yml``).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

__all__ = ["Locality", "ResourceMetadata", "DEFAULT_LOCALITY_FILE"]

DEFAULT_LOCALITY_FILE = os.path.join(os.path.dirname(__file__), "data", "locality.json")


class Locality(NamedTuple):
    """(cloud, region, zone) placement key, e.g. ('aws', 'us-east-1', 'a')."""

    cloud: str
    region: str
    zone: str

    @classmethod
    def parse(cls, text: str) -> "Locality":
        cloud, region, zone = text.split("/")
        return cls(cloud, region, zone)

    def __repr__(self) -> str:
        return f"{self.cloud}/{self.region}/{self.zone}"


class ResourceMetadata:
    """Zone catalog + dense inter-zone bandwidth (Mbps) and cost ($/GB) matrices.

    ``seed`` drives the reference-compatible ±5 % bandwidth jitter applied
    once at load; ``jitter=False`` disables it (used by parity tests).
    """

    def __init__(
        self,
        path: str = DEFAULT_LOCALITY_FILE,
        seed: Optional[int] = None,
        jitter: bool = True,
    ):
        with open(path) as f:
            doc = json.load(f)
        self.zones: List[Locality] = [Locality.parse(z) for z in doc["zones"]]
        self.zone_index: Dict[Locality, int] = {z: i for i, z in enumerate(self.zones)}
        n = len(self.zones)
        region_of = {}  # (cloud, region) -> [zone indices]
        for i, z in enumerate(self.zones):
            region_of.setdefault((z.cloud, z.region), []).append(i)

        cost = np.zeros((n, n), dtype=np.float64)
        bw = np.zeros((n, n), dtype=np.float64)
        rng = np.random.default_rng(seed)
        for rec in doc["region_pairs"]:
            sc, sr = rec["src"].split("/")
            dc, dr = rec["dst"].split("/")
            src_zones = region_of[(sc, sr)]
            dst_zones = region_of[(dc, dr)]
            for si in src_zones:
                for di in dst_zones:
                    cost[si, di] = rec["cost_per_gb"]
                    factor = rng.uniform(0.95, 1.05) if jitter else 1.0
                    bw[si, di] = rec["bw_mbps"] * factor
        self.cost_matrix = cost
        self.bw_matrix = bw

    @property
    def n_zones(self) -> int:
        return len(self.zones)

    def index_of(self, locality: Locality) -> int:
        return self.zone_index[locality]

    def cost(self, src: Locality, dst: Locality) -> float:
        return float(self.cost_matrix[self.zone_index[src], self.zone_index[dst]])

    def bw(self, src: Locality, dst: Locality) -> float:
        return float(self.bw_matrix[self.zone_index[src], self.zone_index[dst]])

    def calc_network_traffic_cost(
        self, src: Locality, dst: Locality, data_size_mb: float
    ) -> float:
        """$ cost of moving ``data_size_mb`` MB from src to dst.

        Same unit convention as the reference
        (``resources/__init__.py:565-569``): size / 8000 converts to GB.
        """
        return self.cost(src, dst) * data_size_mb / 8000.0

    def zone_vector(self, localities: List[Locality]) -> np.ndarray:
        """[N] int32 zone indices for a list of localities (kernel feed)."""
        return np.array([self.zone_index[l] for l in localities], dtype=np.int32)
