"""Heterogeneous device & cluster model (paper §III-A).

Heterogeneity is three-fold: compute capability, memory capacity, and
pairwise communication bandwidth.  A cluster is a set of devices plus a
(possibly sparse, possibly asymmetric) link-bandwidth matrix; devices that
are not directly connected communicate over a multi-hop channel whose
bandwidth is the minimum along the path (paper Fig. 3).  We close the link
graph into a full mesh with a *widest-path* (max-bottleneck) Floyd–Warshall,
which picks the best multi-hop route — exactly the paper's A→B→D→F example.

Presets copy the paper's Table III testbeds and add an H100 host (the
port's hardware target).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace as _dc_replace
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

GB = 1e9
GBPS = 1e9 / 8.0  # 1 Gbit/s in bytes/s


@dataclass(frozen=True)
class DeviceSpec:
    """One schedulable device (a GPU, or a TPU slice treated as a unit)."""

    name: str
    peak_flops: float          # FLOP/s (dtype-appropriate peak)
    mem_bytes: float           # memory capacity
    hbm_bw: float              # bytes/s local memory bandwidth
    kind: str = "gpu"          # "gpu" | "tpu_slice" | "cpu"

    def derated(self, factor: float) -> "DeviceSpec":
        """A copy of this device running at ``factor``× its nominal speed.

        ``factor`` scales both ``peak_flops`` and ``hbm_bw`` (a thermally
        throttled or contended device loses compute and memory bandwidth
        together); memory *capacity* is untouched — a slow device still
        holds the same weights and KV cache.  ``factor`` must be > 0;
        values < 1 slow the device, 1.0 returns ``self`` unchanged.
        The spec is frozen, so this is the only mutation path — callers
        (``ClusterSpec.with_derate``) always get a fresh object.
        """
        if not (factor > 0.0 and math.isfinite(factor)):
            raise ValueError(f"derate factor must be finite and > 0, got {factor}")
        if factor == 1.0:
            return self
        return _dc_replace(
            self,
            peak_flops=self.peak_flops * factor,
            hbm_bw=self.hbm_bw * factor,
        )


@dataclass
class ClusterSpec:
    """Devices + directed link bandwidths (bytes/s). 0 / missing = no direct link."""

    devices: List[DeviceSpec]
    link_bw: np.ndarray                      # [K, K] direct-link bandwidth, bytes/s
    link_latency: Optional[np.ndarray] = None  # [K, K] seconds, optional
    name: str = "cluster"

    def __post_init__(self):
        k = len(self.devices)
        self.link_bw = np.asarray(self.link_bw, dtype=np.float64)
        assert self.link_bw.shape == (k, k), "link_bw must be KxK"
        if self.link_latency is None:
            self.link_latency = np.zeros((k, k), dtype=np.float64)
        self._closure: Optional[Tuple[np.ndarray, np.ndarray]] = None

    @property
    def k(self) -> int:
        return len(self.devices)

    # ------------------------------------------------------------- closure
    def _widest_path_closure(self) -> Tuple[np.ndarray, np.ndarray]:
        """Full-mesh effective bandwidth/latency via max-bottleneck paths.

        bw[i,j]  = max over paths of (min link bw on path)     (paper §III-C)
        lat[i,j] = latency along the chosen path (sum of hops)
        """
        k = self.k
        bw = self.link_bw.copy()
        lat = np.where(bw > 0, self.link_latency, np.inf)
        np.fill_diagonal(bw, np.inf)
        np.fill_diagonal(lat, 0.0)
        for m in range(k):
            # path i -> m -> j has bottleneck min(bw[i,m], bw[m,j])
            cand = np.minimum(bw[:, m : m + 1], bw[m : m + 1, :])
            cand_lat = lat[:, m : m + 1] + lat[m : m + 1, :]
            better = cand > bw
            bw = np.where(better, cand, bw)
            lat = np.where(better, cand_lat, lat)
        return bw, lat

    def effective_bw(self, src: int, dst: int) -> float:
        """Effective (possibly multi-hop) bandwidth src→dst in bytes/s."""
        if src == dst:
            return math.inf
        if self._closure is None:
            self._closure = self._widest_path_closure()
        return float(self._closure[0][src, dst])

    def effective_latency(self, src: int, dst: int) -> float:
        if src == dst:
            return 0.0
        if self._closure is None:
            self._closure = self._widest_path_closure()
        return float(self._closure[1][src, dst])

    def comm_time(self, nbytes: float, src: int, dst: int) -> float:
        """Transfer time of ``nbytes`` over the (src,dst) channel (paper §III-C)."""
        if src == dst or nbytes <= 0:
            return 0.0
        bw = self.effective_bw(src, dst)
        if bw <= 0:
            return math.inf
        return self.effective_latency(src, dst) + nbytes / bw

    def is_connected(self) -> bool:
        if self._closure is None:
            self._closure = self._widest_path_closure()
        return bool(np.all(self._closure[0] > 0))

    # -------------------------------------------------------------- elastic
    def with_derate(
        self,
        derate: Optional[Mapping[int, float]] = None,
        *,
        links: Optional[Mapping[Tuple[int, int], float]] = None,
    ) -> "ClusterSpec":
        """Clone of the cluster with per-device speed and/or per-link
        bandwidth factors applied.

        ``derate`` maps device index → speed factor (1.0 = nominal, 0.5 =
        half speed); missing devices keep their nominal spec.  Factors scale
        ``peak_flops`` and ``hbm_bw`` (see :meth:`DeviceSpec.derated`).

        ``links`` maps a ``(src, dst)`` device pair → bandwidth factor
        applied to that DIRECT link (1.0 = nominal, 0.125 = an 8×-degraded
        NIC, 0.0 = partitioned — the link drops out of the graph entirely
        and the widest-path closure routes around it if any alternative
        path exists).  A channel is physically one cable, so the factor is
        applied to BOTH directions unless the reverse pair carries its own
        explicit entry.  Factors on pairs with no direct link are ignored —
        a multi-hop channel has no bandwidth of its own to degrade.

        Device indices, link topology, and memory capacities are preserved,
        so placements and cost models over the clone use the SAME indices
        as the original — this is what lets the serving engine re-plan on
        an observed-speed cluster (slow devices AND slow interconnect) and
        still address its original device handles.  The original cluster is
        never mutated.
        """
        derate = derate or {}
        links = links or {}
        if not derate and not links:
            return self
        for i in derate:
            if not 0 <= i < self.k:
                raise ValueError(f"derate index {i} out of range for k={self.k}")
        for (a, b), f in links.items():
            if not (0 <= a < self.k and 0 <= b < self.k) or a == b:
                raise ValueError(
                    f"link derate ({a},{b}) invalid for k={self.k}"
                )
            if not (f >= 0.0 and math.isfinite(f)):
                raise ValueError(
                    f"link derate factor must be finite and >= 0, got {f}"
                )
        devices = [
            d.derated(float(derate.get(i, 1.0))) for i, d in enumerate(self.devices)
        ]
        bw = self.link_bw.copy()
        for (a, b), f in sorted(links.items()):
            bw[a, b] = self.link_bw[a, b] * f
            if (b, a) not in links:
                bw[b, a] = self.link_bw[b, a] * f
        tags = [f"{i}:{derate[i]:.3g}" for i in sorted(derate)]
        tags += [f"{a}-{b}:{links[(a, b)]:.3g}" for a, b in sorted(links)]
        return ClusterSpec(
            devices=devices,
            link_bw=bw,
            link_latency=self.link_latency.copy(),
            name=f"{self.name}@derate[{','.join(tags)}]",
        )

    def without_device(self, idx: int) -> "ClusterSpec":
        """Cluster minus one failed device (elastic re-placement support)."""
        keep = [i for i in range(self.k) if i != idx]
        return ClusterSpec(
            devices=[self.devices[i] for i in keep],
            link_bw=self.link_bw[np.ix_(keep, keep)],
            link_latency=self.link_latency[np.ix_(keep, keep)],
            name=f"{self.name}-dev{idx}",
        )

    def subcluster(self, indices) -> "ClusterSpec":
        """Cluster restricted to ``indices`` (replica-partitioning support).

        Devices are re-indexed in the given order; the link bandwidth and
        latency submatrices between the kept devices are preserved, so a
        placement solved on the subcluster prices communication exactly as
        the full cluster would between those devices.
        """
        idx = list(indices)
        if not idx:
            raise ValueError("subcluster needs at least one device index")
        if len(set(idx)) != len(idx):
            raise ValueError(f"duplicate device indices: {idx}")
        for i in idx:
            if not 0 <= i < self.k:
                raise ValueError(f"device index {i} out of range 0..{self.k - 1}")
        tag = ",".join(str(i) for i in idx)
        return ClusterSpec(
            devices=[self.devices[i] for i in idx],
            link_bw=self.link_bw[np.ix_(idx, idx)],
            link_latency=self.link_latency[np.ix_(idx, idx)],
            name=f"{self.name}[{tag}]",
        )


# --------------------------------------------------------------------------
# Presets
# --------------------------------------------------------------------------


def inter_server_cluster() -> ClusterSpec:
    """Paper Table III, inter-server scenario: 4 GPUs over 100G InfiniBand.

    Asymmetric measured bandwidths (Gbps) copied from the table.
    """
    devices = [
        DeviceSpec("RTX2080Ti", peak_flops=13.45e12, mem_bytes=11 * GB, hbm_bw=616e9),
        DeviceSpec("TeslaT4", peak_flops=8.14e12, mem_bytes=16 * GB, hbm_bw=300e9),
        DeviceSpec("TeslaP4", peak_flops=5.5e12, mem_bytes=8 * GB, hbm_bw=192e9),
        DeviceSpec("RTX3060Ti", peak_flops=16.2e12, mem_bytes=8 * GB, hbm_bw=448e9),
    ]
    bw_gbps = np.array(
        [
            [0.0, 44.26, 32.92, 44.28],
            [42.39, 0.0, 35.32, 44.51],
            [33.20, 35.31, 0.0, 32.95],
            [42.08, 43.22, 33.28, 0.0],
        ]
    )
    lat = np.full((4, 4), 5e-6)
    np.fill_diagonal(lat, 0.0)
    return ClusterSpec(devices, bw_gbps * GBPS, lat, name="inter-server")


def intra_server_cluster() -> ClusterSpec:
    """Paper Table III, intra-server scenario: 2×V100 + 2×P100 over NVLink/NVSwitch."""
    devices = [
        DeviceSpec("V100-a", peak_flops=15.7e12, mem_bytes=32 * GB, hbm_bw=900e9),
        DeviceSpec("V100-b", peak_flops=15.7e12, mem_bytes=32 * GB, hbm_bw=900e9),
        DeviceSpec("P100-a", peak_flops=9.3e12, mem_bytes=16 * GB, hbm_bw=732e9),
        DeviceSpec("P100-b", peak_flops=9.3e12, mem_bytes=16 * GB, hbm_bw=732e9),
    ]
    bw_gbps = np.array(
        [
            [0.0, 1170.04, 626.10, 610.56],
            [1148.16, 0.0, 618.98, 581.09],
            [630.43, 609.82, 0.0, 571.96],
            [622.67, 575.08, 581.35, 0.0],
        ]
    )
    lat = np.full((4, 4), 2e-6)
    np.fill_diagonal(lat, 0.0)
    return ClusterSpec(devices, bw_gbps * GBPS, lat, name="intra-server")


# H100 SXM constants (NVIDIA data sheet; dense bf16, no sparsity)
H100_PEAK_BF16 = 989e12         # FLOP/s per card
H100_HBM_BW = 3.35e12           # bytes/s per card
H100_HBM_BYTES = 80 * GB        # per card
H100_NVLINK_BW = 450e9          # bytes/s per direction, all to all in a host


def h100_cluster(n: int = 1, *, heterogeneous: bool = False) -> ClusterSpec:
    """``n`` H100 SXM cards of one host, joined all to all by NVLink.

    ``heterogeneous=True`` models every odd card at half its peak compute
    and memory bandwidth (a power-capped or older-generation part) — the
    mixed fleet case Moirai targets.
    """
    devices = []
    for i in range(n):
        derate = 0.5 if (heterogeneous and i % 2 == 1) else 1.0
        devices.append(
            DeviceSpec(
                f"h100-{i}",
                peak_flops=H100_PEAK_BF16 * derate,
                mem_bytes=H100_HBM_BYTES,
                hbm_bw=H100_HBM_BW * derate,
                kind="gpu",
            )
        )
    bw = np.full((n, n), H100_NVLINK_BW)
    np.fill_diagonal(bw, 0.0)
    lat = np.full((n, n), 2e-6)
    np.fill_diagonal(lat, 0.0)
    return ClusterSpec(devices, bw, lat, name=f"h100-x{n}")


PRESETS = {
    "inter_server": inter_server_cluster,
    "intra_server": intra_server_cluster,
    "h100": h100_cluster,
}


def get_cluster(name: str, **kw) -> ClusterSpec:
    """Build a preset cluster by name — one of ``inter_server`` /
    ``intra_server`` (paper Table III testbeds) or ``h100`` —
    forwarding ``**kw`` to its factory."""
    return PRESETS[name](**kw)
