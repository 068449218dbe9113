# Frozen copy of src/repro/core/profiles.py at commit 9de379d4b486;
# only the imports changed.
"""Embedded throughput + price grids for AWS / Azure / GCP (paper §3.2).

The paper measures its throughput grid with iperf3 at 64 parallel connections
(~$4000 of egress). That measurement cannot be redone here, so we *embed* a
deterministic grid generated from the paper's own published facts:

  * per-VM egress throttles: AWS caps **all** egress at 5 Gbps for <=32-core
    instances; GCP caps public-IP egress at 7 Gbps; Azure has no cap beyond
    the NIC (16 Gbps for Standard_D32_v5).                      [paper §2, Fig 3]
  * inter-cloud links are consistently slower than intra-cloud links, and some
    inter-cloud pairs have much worse peering than others.       [paper Fig 3]
  * throughput decays with geographic distance (RTT), and intra-cloud GCP
    routes are noisier than AWS routes.                          [paper Figs 3-4]
  * egress is billed per GB per hop; intra-cloud intra-continental is cheap
    (~$0.02/GB), internet egress expensive (~$0.09-0.19/GB), ingress free.
                                                                 [paper §2, §4.1.1]

Region lists match the paper's evaluation scale (20 AWS / 24 Azure / 27 GCP).
Prices approximate 2022 public on-demand pricing for the instance types the
paper uses (m5.8xlarge / Standard_D32_v5 / n2-standard-32).

Everything is deterministic (fixed seed) so tests and benchmarks are stable.
"""

from __future__ import annotations

import functools
import hashlib

import numpy as np

from .topology import Region, Topology, haversine_km

# --------------------------------------------------------------------- regions
# (provider, name, continent, lat, lon)
_AWS = [
    ("us-east-1", "na", 38.9, -77.4), ("us-east-2", "na", 40.0, -83.0),
    ("us-west-1", "na", 37.4, -122.0), ("us-west-2", "na", 45.8, -119.7),
    ("ca-central-1", "na", 45.5, -73.6), ("sa-east-1", "sa", -23.5, -46.6),
    ("eu-west-1", "eu", 53.3, -6.3), ("eu-west-2", "eu", 51.5, -0.1),
    ("eu-west-3", "eu", 48.9, 2.3), ("eu-central-1", "eu", 50.1, 8.7),
    ("eu-north-1", "eu", 59.3, 18.1), ("eu-south-1", "eu", 45.5, 9.2),
    ("ap-northeast-1", "ap", 35.7, 139.7), ("ap-northeast-2", "ap", 37.6, 127.0),
    ("ap-northeast-3", "ap", 34.7, 135.5), ("ap-southeast-1", "ap", 1.3, 103.8),
    ("ap-southeast-2", "oc", -33.9, 151.2), ("ap-south-1", "ap", 19.1, 72.9),
    ("af-south-1", "af", -33.9, 18.4), ("me-south-1", "me", 26.2, 50.6),
]
_AZURE = [
    ("eastus", "na", 37.4, -79.8), ("eastus2", "na", 36.6, -78.4),
    ("centralus", "na", 41.6, -93.6), ("northcentralus", "na", 41.9, -87.6),
    ("southcentralus", "na", 29.4, -98.5), ("westus", "na", 37.4, -122.0),
    ("westus2", "na", 47.2, -119.9), ("westus3", "na", 33.4, -112.0),
    ("canadacentral", "na", 43.7, -79.4), ("canadaeast", "na", 46.8, -71.2),
    ("brazilsouth", "sa", -23.5, -46.6), ("northeurope", "eu", 53.3, -6.3),
    ("westeurope", "eu", 52.4, 4.9), ("uksouth", "eu", 51.5, -0.1),
    ("ukwest", "eu", 51.5, -3.2), ("francecentral", "eu", 48.9, 2.3),
    ("germanywestcentral", "eu", 50.1, 8.7), ("norwayeast", "eu", 59.9, 10.7),
    ("switzerlandnorth", "eu", 47.4, 8.5), ("japaneast", "ap", 35.7, 139.7),
    ("japanwest", "ap", 34.7, 135.5), ("koreacentral", "ap", 37.6, 127.0),
    ("southeastasia", "ap", 1.3, 103.8), ("australiaeast", "oc", -33.9, 151.2),
]
_GCP = [
    ("us-central1", "na", 41.3, -95.9), ("us-east1", "na", 33.2, -80.0),
    ("us-east4", "na", 38.9, -77.4), ("us-west1", "na", 45.6, -121.2),
    ("us-west2", "na", 34.1, -118.2), ("us-west3", "na", 40.8, -111.9),
    ("us-west4", "na", 36.1, -115.2),
    ("northamerica-northeast1", "na", 45.5, -73.6),
    ("northamerica-northeast2", "na", 43.7, -79.4),
    ("southamerica-east1", "sa", -23.5, -46.6),
    ("europe-west1", "eu", 50.4, 3.8), ("europe-west2", "eu", 51.5, -0.1),
    ("europe-west3", "eu", 50.1, 8.7), ("europe-west4", "eu", 53.4, 6.8),
    ("europe-west6", "eu", 47.4, 8.5), ("europe-north1", "eu", 60.6, 27.1),
    ("europe-central2", "eu", 52.2, 21.0), ("asia-east1", "ap", 24.0, 121.0),
    ("asia-east2", "ap", 22.3, 114.2), ("asia-northeast1", "ap", 35.7, 139.7),
    ("asia-northeast2", "ap", 34.7, 135.5), ("asia-northeast3", "ap", 37.6, 127.0),
    ("asia-south1", "ap", 19.1, 72.9), ("asia-south2", "ap", 28.6, 77.2),
    ("asia-southeast1", "ap", 1.3, 103.8), ("asia-southeast2", "ap", -6.2, 106.8),
    ("australia-southeast1", "oc", -33.9, 151.2),
]

# ------------------------------------------------------------------- constants
# Per-VM NIC bandwidth (Gbps) for the paper's instance types (§6).
_NIC = {"aws": 10.0, "azure": 16.0, "gcp": 16.0}
# Per-VM egress throttles (paper §2): AWS 5 Gbps all egress; GCP 7 Gbps to
# public IPs; Azure NIC-limited only.
_EGRESS_CAP = {"aws": 5.0, "azure": 16.0, "gcp": 7.0}
# On-demand $/hr: m5.8xlarge / Standard_D32_v5 / n2-standard-32 (2022 pricing).
_VM_HOURLY = {"aws": 1.536, "azure": 1.520, "gcp": 1.553}

# Internet (inter-cloud) egress $/GB by source provider x source continent.
_INTERNET_EGRESS = {
    "aws": {"na": 0.09, "eu": 0.09, "ap": 0.114, "oc": 0.114, "sa": 0.150,
            "af": 0.154, "me": 0.117},
    "azure": {"na": 0.0875, "eu": 0.0875, "ap": 0.12, "oc": 0.12, "sa": 0.181,
              "af": 0.181, "me": 0.12},
    "gcp": {"na": 0.12, "eu": 0.12, "ap": 0.12, "oc": 0.19, "sa": 0.12,
            "af": 0.12, "me": 0.12},
}
# Intra-cloud inter-region $/GB: (same-continent, cross-continent).
_INTRA_CLOUD_EGRESS = {
    "aws": (0.02, 0.02),   # AWS charges a flat inter-region rate
    "azure": (0.02, 0.05),
    "gcp": (0.02, 0.08),
}

_SEED = 20220415  # deterministic grid

# ------------------------------------------------------- belief drift priors
# Per-(source provider, dest provider) relative drift sigma for the
# calibration plane's BeliefGrid prior: how far the stale embedded grid is
# presumed to sit from current reality, before any probe lands. Cross-cloud
# measurement studies (and the paper's own Fig. 4) show this is NOT one
# number: intra-AWS routes hold steady, intra-GCP routes jitter, and
# inter-cloud peering drifts hardest of all. The table replaces the single
# global ``prior_rel_sigma`` knob; pairs not listed (e.g. the toy test
# provider) fall back to ``DEFAULT_DRIFT_PRIOR`` — the old global value.
PROVIDER_DRIFT_PRIOR: dict[tuple[str, str], float] = {
    ("aws", "aws"): 0.18,
    ("azure", "azure"): 0.20,
    ("gcp", "gcp"): 0.30,  # Fig. 4: GCP route jitter
    ("aws", "azure"): 0.32,
    ("azure", "aws"): 0.32,
    ("aws", "gcp"): 0.35,
    ("gcp", "aws"): 0.35,
    ("azure", "gcp"): 0.35,
    ("gcp", "azure"): 0.35,
}
DEFAULT_DRIFT_PRIOR = 0.25


def prior_rel_sigma_grid(top: Topology) -> np.ndarray:
    """[V, V] per-link prior relative drift sigma from the provider-pair
    table — the BeliefGrid's default prior spread (ordered pairs: egress
    provider rows, ingress provider columns)."""
    providers = [r.provider for r in top.regions]
    v = len(providers)
    out = np.full((v, v), DEFAULT_DRIFT_PRIOR)
    for i, p in enumerate(providers):
        for j, q in enumerate(providers):
            out[i, j] = PROVIDER_DRIFT_PRIOR.get((p, q), DEFAULT_DRIFT_PRIOR)
    return out


def region_list() -> list[Region]:
    out = []
    for provider, entries in (("aws", _AWS), ("azure", _AZURE), ("gcp", _GCP)):
        for name, cont, lat, lon in entries:
            out.append(Region(provider, name, cont, lat, lon))
    return out


def _rtt_ms(a: Region, b: Region) -> float:
    """RTT model: ~1ms/100km of fiber (x1.6 route inflation) + 2ms base."""
    d = haversine_km(a.lat, a.lon, b.lat, b.lon)
    return 2.0 + 0.016 * d


def _egress_price(a: Region, b: Region) -> float:
    if a.provider == b.provider:
        same, cross = _INTRA_CLOUD_EGRESS[a.provider]
        return same if a.continent == b.continent else cross
    return _INTERNET_EGRESS[a.provider][a.continent]


@functools.lru_cache(maxsize=1)
def default_topology() -> Topology:
    """The 71-region AWS+Azure+GCP topology with the embedded grids."""
    regions = region_list()
    v = len(regions)
    rng = np.random.default_rng(_SEED)

    rtt = np.zeros((v, v))
    tput = np.zeros((v, v))
    price = np.zeros((v, v))
    for i, a in enumerate(regions):
        for j, b in enumerate(regions):
            if i == j:
                continue
            rtt[i, j] = _rtt_ms(a, b)
            price[i, j] = _egress_price(a, b)

    # Throughput: start from the source VM's egress ceiling, decay with RTT,
    # apply inter-cloud peering penalties (paper Fig 3), add stable noise.
    # Peering quality is symmetric per unordered pair; intra-GCP routes get
    # extra jitter (paper Fig 4).
    peering = np.ones((v, v))
    for i in range(v):
        for j in range(i + 1, v):
            a, b = regions[i], regions[j]
            if a.provider != b.provider:
                q = rng.uniform(0.35, 0.95)  # some inter-cloud pairs peer badly
            else:
                q = rng.uniform(0.80, 1.00)
            peering[i, j] = peering[j, i] = q

    for i, a in enumerate(regions):
        for j, b in enumerate(regions):
            if i == j:
                continue
            inter_cloud = a.provider != b.provider
            ceiling = min(
                _EGRESS_CAP[a.provider] if inter_cloud else _NIC[a.provider],
                _NIC[b.provider],
            )
            # RTT decay: nearby pairs run at the ceiling; antipodal pairs at
            # roughly a third of it (BDP-limited even with 64 connections).
            geo = 1.0 / (1.0 + (rtt[i, j] / 140.0) ** 1.4)
            noise = float(rng.lognormal(0.0, 0.06))
            if a.provider == "gcp" and b.provider == "gcp":
                noise *= float(rng.lognormal(0.0, 0.08))  # Fig 4: GCP jitter
            val = ceiling * geo * peering[i, j] * noise
            # Inter-cloud flows still hit the hard egress throttle.
            cap = _EGRESS_CAP[a.provider] if inter_cloud else _NIC[a.provider]
            tput[i, j] = float(np.clip(val, 0.05, cap))

    price_vm = np.array([_VM_HOURLY[r.provider] / 3600.0 for r in regions])
    limit_ingress = np.array([_NIC[r.provider] for r in regions])
    limit_egress = np.array(
        [min(_NIC[r.provider], _EGRESS_CAP[r.provider]) for r in regions]
    )
    # NOTE: limit_egress is the *inter-cloud* throttle; intra-cloud flows may
    # exceed it (e.g. Azure 16 Gbps NIC). The MILP uses the conservative
    # per-VM cap; the tput grid itself encodes the per-link reality.
    return Topology(
        regions=regions,
        tput=tput,
        price_egress=price,
        price_vm=price_vm,
        limit_ingress=limit_ingress,
        limit_egress=limit_egress,
        rtt_ms=rtt,
        limit_conn=64,
        limit_vm=8,
    )


def grid_fingerprint(top: Topology) -> str:
    """SHA-256 over the topology's embedded grids, bit-for-bit.

    The whole stack treats the profile grids as a deterministic fixture:
    the same seed must produce bitwise-identical grids in every process
    (tests compare this fingerprint across subprocesses), and the
    calibration plane's drift model keys its true-topology snapshots off
    the same determinism."""
    h = hashlib.sha256()
    for arr in (top.tput, top.price_egress, top.price_vm,
                top.limit_ingress, top.limit_egress):
        h.update(np.ascontiguousarray(arr, dtype=np.float64).tobytes())
    if top.rtt_ms is not None:
        h.update(np.ascontiguousarray(top.rtt_ms, dtype=np.float64).tobytes())
    h.update(",".join(r.key for r in top.regions).encode())
    return h.hexdigest()


def toy_topology(
    n: int = 5, seed: int = 0, limit_vm: int = 4, limit_conn: int = 8
) -> Topology:
    """Small random topology for unit/property tests."""
    rng = np.random.default_rng(seed)
    regions = [
        Region("toy", f"r{i}", "na", float(rng.uniform(-60, 60)),
               float(rng.uniform(-180, 180)))
        for i in range(n)
    ]
    tput = rng.uniform(0.5, 10.0, size=(n, n))
    np.fill_diagonal(tput, 0.0)
    price = rng.uniform(0.01, 0.15, size=(n, n))
    np.fill_diagonal(price, 0.0)
    rtt = rng.uniform(5.0, 250.0, size=(n, n))
    np.fill_diagonal(rtt, 0.0)
    return Topology(
        regions=regions,
        tput=tput,
        price_egress=price,
        price_vm=rng.uniform(2e-4, 6e-4, size=n),
        limit_ingress=rng.uniform(8.0, 16.0, size=n),
        limit_egress=rng.uniform(4.0, 10.0, size=n),
        rtt_ms=rtt,
        limit_conn=limit_conn,
        limit_vm=limit_vm,
    )
