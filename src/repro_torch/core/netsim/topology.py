"""Generic link-table fabric models for the Symphony network simulator.

NumPy only: the port keeps its own copy of ``repro.core.netsim.topology``
so that it imports nothing of the JAX package (whose ``__init__`` pulls in
jax).  The arrays it builds are equal to the reference's.

A :class:`Topology` is a flat table of directed links plus enough structure
to (a) enumerate the ECMP candidate paths of any host pair and (b) map every
link to the switch that owns its egress port (for Symphony deployment).

Concrete fabrics:

* :class:`LeafSpine` — the paper's 2-tier fabric (Table 1).  Link indexing is
  arithmetic so flow routes are tiny integer tuples:

    [0,              H)                 host  h -> ToR(h)      (access up)
    [H,              2H)                ToR(h) -> host h       (access down)
    [2H,             2H + T*S)          ToR t -> spine s       (uplink,   t*S+s)
    [2H + T*S,       2H + 2*T*S)        spine s -> ToR t       (downlink, s*T+t)

* :class:`FatTree` — a 3-tier multi-pod fabric: each pod is a leaf-spine
  block; pod spines connect upward to a core tier (spine s owns the core
  group [s*cpg, (s+1)*cpg)), modelling the paper's multi-pod interconnects
  with independent edge and core oversubscription (§4.1 discussion).

Every path is a fixed-width row of link ids padded with the *null link*
``n_links`` (infinite capacity, owned by no switch).  Candidate paths are
returned as ``[N, P, H]`` tables; the ECMP hash picks ``p % n_paths`` so
fabrics with different fan-outs coexist in one workload.

Hosts are assigned to edge switches contiguously.  An optional
oversubscription factor scales fabric capacity down relative to access
links, modeling the paper's 1:2-1:8 multi-pod interconnects (§4.1).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

DEFAULT_LINK_BPS = 10e9 / 8.0  # 10 Gbps in bytes/s (paper §4.1)

# switch levels (Symphony deployment tiers)
LEVEL_TOR = 1      # edge / ToR switches
LEVEL_SPINE = 2    # aggregation / pod-spine switches
LEVEL_CORE = 3     # core switches


@dataclass(frozen=True)
class Topology:
    """Base link-table topology.

    ``link_switch[l]`` is the id of the switch transmitting on link ``l``
    (-1 when the transmitter is a host NIC); ``switch_level[s]`` is that
    switch's tier (LEVEL_TOR/SPINE/CORE).  Subclasses implement
    :meth:`candidate_paths`.
    """

    n_hosts: int
    link_cap: np.ndarray          # [L] bytes/s
    symphony_mask: np.ndarray     # [L] bool — ports running Symphony (ToR egress)
    link_switch: np.ndarray       # [L] egress switch id, -1 = host NIC
    switch_level: np.ndarray      # [n_switches] LEVEL_* per switch

    @property
    def n_links(self) -> int:
        return int(self.link_cap.shape[0])

    @property
    def n_switches(self) -> int:
        return int(self.switch_level.shape[0])

    @property
    def max_hops(self) -> int:
        """Width H of candidate-path rows."""
        raise NotImplementedError

    def candidate_paths(self, src: np.ndarray, dst: np.ndarray
                        ) -> tuple[np.ndarray, np.ndarray]:
        """ECMP candidate paths for each (src, dst) host pair.

        Returns ``(paths [N, P, H] int64, n_paths [N] int64)`` where rows
        ``>= n_paths[i]`` of ``paths[i]`` are unused padding and every hop
        slot that a path does not need holds the null link ``n_links``.
        """
        raise NotImplementedError


@dataclass(frozen=True)
class LeafSpine(Topology):
    n_tors: int = 0
    n_spines: int = 0

    @property
    def hosts_per_tor(self) -> int:
        return self.n_hosts // self.n_tors

    @property
    def max_hops(self) -> int:
        return 4

    # ---- link index helpers (host/tor/spine ids -> link id) ----
    def acc_up(self, host: np.ndarray) -> np.ndarray:
        return np.asarray(host)

    def acc_down(self, host: np.ndarray) -> np.ndarray:
        return self.n_hosts + np.asarray(host)

    def uplink(self, tor: np.ndarray, spine: np.ndarray) -> np.ndarray:
        return 2 * self.n_hosts + np.asarray(tor) * self.n_spines + np.asarray(spine)

    def downlink(self, spine: np.ndarray, tor: np.ndarray) -> np.ndarray:
        return 2 * self.n_hosts + self.n_tors * self.n_spines \
            + np.asarray(spine) * self.n_tors + np.asarray(tor)

    def tor_of(self, host: np.ndarray) -> np.ndarray:
        return np.asarray(host) // self.hosts_per_tor

    def candidate_paths(self, src, dst):
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        N, P, H = src.shape[0], self.n_spines, self.max_hops
        null = self.n_links
        paths = np.full((N, P, H), null, np.int64)
        st, dt = self.tor_of(src), self.tor_of(dst)
        paths[:, :, 0] = self.acc_up(src)[:, None]
        paths[:, :, 3] = self.acc_down(dst)[:, None]
        inter = st != dt
        sp = np.arange(P, dtype=np.int64)
        paths[inter, :, 1] = self.uplink(st[inter, None], sp[None, :])
        paths[inter, :, 2] = self.downlink(sp[None, :], dt[inter, None])
        n_paths = np.where(inter, P, 1).astype(np.int64)
        return paths, n_paths


@dataclass(frozen=True)
class FatTree(Topology):
    """3-tier multi-pod fabric; see the module docstring for link layout:

      [0,      H)            host -> ToR               (acc up)
      [H,      2H)           ToR  -> host              (acc down)
      [2H,     +T*S)         ToR t -> local spine s    (t*S + s)
      [..,     +T*S)         spine (p,s) -> local ToR  ((p*S+s)*Tp + tl)
      [..,     +P*S*cpg)     spine (p,s) -> core       ((p*S+s)*cpg + j)
      [..,     +C*P)         core c -> pod p's spine   (c*P + p)

    with T total ToRs, Tp ToRs/pod, S spines/pod, P pods, C cores and
    cpg = C // S cores per spine group.  Core c attaches to spine c // cpg
    in every pod, so an inter-pod path is fully determined by its core.
    """

    n_pods: int = 0
    tors_per_pod: int = 0
    spines_per_pod: int = 0
    n_cores: int = 0

    @property
    def n_tors(self) -> int:
        return self.n_pods * self.tors_per_pod

    @property
    def hosts_per_tor(self) -> int:
        return self.n_hosts // self.n_tors

    @property
    def cores_per_spine(self) -> int:
        return self.n_cores // self.spines_per_pod

    @property
    def max_hops(self) -> int:
        return 6

    # ---- link index helpers ----
    def acc_up(self, host):
        return np.asarray(host)

    def acc_down(self, host):
        return self.n_hosts + np.asarray(host)

    def tor_of(self, host):
        return np.asarray(host) // self.hosts_per_tor

    def pod_of_tor(self, tor):
        return np.asarray(tor) // self.tors_per_pod

    def uplink(self, tor, spine):
        """ToR t -> spine `spine` (pod-local index) of t's pod."""
        return 2 * self.n_hosts + np.asarray(tor) * self.spines_per_pod \
            + np.asarray(spine)

    def downlink(self, pod, spine, tor):
        """Spine (pod, local s) -> ToR `tor` (global id, must be in pod)."""
        base = 2 * self.n_hosts + self.n_tors * self.spines_per_pod
        tl = np.asarray(tor) % self.tors_per_pod
        return base + (np.asarray(pod) * self.spines_per_pod
                       + np.asarray(spine)) * self.tors_per_pod + tl

    def spine_up(self, pod, spine, core):
        """Spine (pod, local s) -> core (global id, in s's core group)."""
        base = 2 * self.n_hosts + 2 * self.n_tors * self.spines_per_pod
        j = np.asarray(core) % self.cores_per_spine
        return base + (np.asarray(pod) * self.spines_per_pod
                       + np.asarray(spine)) * self.cores_per_spine + j

    def core_down(self, core, pod):
        """Core c -> spine c // cpg of pod `pod`."""
        base = 2 * self.n_hosts + 2 * self.n_tors * self.spines_per_pod \
            + self.n_pods * self.spines_per_pod * self.cores_per_spine
        return base + np.asarray(core) * self.n_pods + np.asarray(pod)

    def candidate_paths(self, src, dst):
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        S, C = self.spines_per_pod, self.n_cores
        N, P, H = src.shape[0], max(S, C), self.max_hops
        null = self.n_links
        paths = np.full((N, P, H), null, np.int64)
        st, dt = self.tor_of(src), self.tor_of(dst)
        sp, dp = self.pod_of_tor(st), self.pod_of_tor(dt)
        paths[:, :, 0] = self.acc_up(src)[:, None]
        paths[:, :, H - 1] = self.acc_down(dst)[:, None]
        # intra-pod, inter-ToR: one candidate per pod spine
        ip = np.nonzero((sp == dp) & (st != dt))[0][:, None]
        s_idx = np.arange(S, dtype=np.int64)[None, :]
        paths[ip, s_idx, 1] = self.uplink(st[ip], s_idx)
        paths[ip, s_idx, 2] = self.downlink(sp[ip], s_idx, dt[ip])
        # inter-pod: one candidate per core; spine = core // cpg on both sides
        xp = sp != dp
        rows = np.nonzero(xp)[0][:, None]
        c_idx = np.arange(C, dtype=np.int64)[None, :]
        cs = c_idx // self.cores_per_spine
        paths[rows, c_idx, 1] = self.uplink(st[rows], cs)
        paths[rows, c_idx, 2] = self.spine_up(sp[rows], cs, c_idx)
        paths[rows, c_idx, 3] = self.core_down(c_idx, dp[rows])
        paths[rows, c_idx, 4] = self.downlink(dp[rows], cs, dt[rows])
        n_paths = np.where(xp, C,
                           np.where(st != dt, S, 1)).astype(np.int64)
        return paths, n_paths


def make_leaf_spine(
    n_hosts: int = 32,
    n_tors: int = 4,
    n_spines: int = 4,
    link_bps: float = DEFAULT_LINK_BPS,
    oversubscription: float = 1.0,
) -> LeafSpine:
    """Build the paper's default 4 ToR x 4 spine, 32-host fabric (Table 1).

    ``oversubscription`` > 1 shrinks fabric (ToR<->spine) capacity: a value of
    4 models a 1:4 oversubscribed tier.
    """
    if n_hosts % n_tors:
        raise ValueError(f"hosts ({n_hosts}) must divide evenly over ToRs ({n_tors})")
    n_fabric = 2 * n_tors * n_spines
    L = 2 * n_hosts + n_fabric
    cap = np.full(L, link_bps, np.float64)
    cap[2 * n_hosts:] = link_bps * (n_hosts / n_tors) / n_spines / oversubscription \
        if oversubscription != 1.0 else link_bps
    # Symphony runs on ToR egress ports: uplinks (ToR->spine) and access-down
    # (ToR->host) — §5 "Practical deployment": ToR-only is sufficient.
    mask = np.zeros(L, bool)
    mask[n_hosts:2 * n_hosts] = True            # ToR -> host
    mask[2 * n_hosts: 2 * n_hosts + n_tors * n_spines] = True  # ToR -> spine
    # egress-switch ownership: switches are ToRs [0, T) then spines [T, T+S)
    hpt = n_hosts // n_tors
    sw = np.full(L, -1, np.int32)
    sw[n_hosts:2 * n_hosts] = np.arange(n_hosts) // hpt          # ToR -> host
    sw[2 * n_hosts:2 * n_hosts + n_tors * n_spines] = \
        np.repeat(np.arange(n_tors), n_spines)                   # ToR -> spine
    sw[2 * n_hosts + n_tors * n_spines:] = \
        n_tors + np.repeat(np.arange(n_spines), n_tors)          # spine -> ToR
    level = np.concatenate([np.full(n_tors, LEVEL_TOR, np.int32),
                            np.full(n_spines, LEVEL_SPINE, np.int32)])
    return LeafSpine(n_hosts=n_hosts, n_tors=n_tors, n_spines=n_spines,
                     link_cap=cap, symphony_mask=mask, link_switch=sw,
                     switch_level=level)


def make_fat_tree(
    n_pods: int = 2,
    tors_per_pod: int = 2,
    spines_per_pod: int = 2,
    hosts_per_tor: int = 4,
    n_cores: int | None = None,
    link_bps: float = DEFAULT_LINK_BPS,
    oversubscription: float = 1.0,
    core_oversubscription: float = 1.0,
) -> FatTree:
    """Build a 3-tier multi-pod fat-tree.

    ``oversubscription`` scales the edge tier (ToR<->spine) and
    ``core_oversubscription`` the core tier (spine<->core) relative to a
    non-blocking fabric, matching the paper's 1:2-1:8 multi-pod setups.
    """
    n_cores = spines_per_pod if n_cores is None else n_cores
    if n_cores % spines_per_pod:
        raise ValueError(f"cores ({n_cores}) must divide evenly over "
                         f"pod spines ({spines_per_pod})")
    T = n_pods * tors_per_pod
    S, C, P = spines_per_pod, n_cores, n_pods
    H = T * hosts_per_tor
    cpg = C // S
    n_edge = T * S                 # per direction
    n_core_up = P * S * cpg        # spine -> core
    n_core_down = C * P            # core -> pod
    L = 2 * H + 2 * n_edge + n_core_up + n_core_down
    cap = np.full(L, link_bps, np.float64)
    edge_cap = link_bps * hosts_per_tor / S / oversubscription
    cap[2 * H:2 * H + 2 * n_edge] = edge_cap
    core_cap = link_bps * (tors_per_pod * hosts_per_tor) / C \
        / core_oversubscription
    cap[2 * H + 2 * n_edge:] = core_cap
    # Symphony default mask: ToR egress (acc-down + uplinks), §5 deployment.
    mask = np.zeros(L, bool)
    mask[H:2 * H + n_edge] = True
    # switches: ToRs [0, T), spines [T, T+P*S), cores [T+P*S, T+P*S+C)
    sw = np.full(L, -1, np.int32)
    sw[H:2 * H] = np.arange(H) // hosts_per_tor                  # ToR -> host
    sw[2 * H:2 * H + n_edge] = np.repeat(np.arange(T), S)        # ToR -> spine
    sw[2 * H + n_edge:2 * H + 2 * n_edge] = \
        T + np.repeat(np.arange(P * S), tors_per_pod)            # spine -> ToR
    sw[2 * H + 2 * n_edge:2 * H + 2 * n_edge + n_core_up] = \
        T + np.repeat(np.arange(P * S), cpg)                     # spine -> core
    sw[2 * H + 2 * n_edge + n_core_up:] = \
        T + P * S + np.repeat(np.arange(C), P)                   # core -> pod
    level = np.concatenate([np.full(T, LEVEL_TOR, np.int32),
                            np.full(P * S, LEVEL_SPINE, np.int32),
                            np.full(C, LEVEL_CORE, np.int32)])
    return FatTree(n_hosts=H, link_cap=cap, symphony_mask=mask,
                   link_switch=sw, switch_level=level,
                   n_pods=P, tors_per_pod=tors_per_pod, spines_per_pod=S,
                   n_cores=C)


def scale_for_hosts(n_hosts: int, link_bps: float = DEFAULT_LINK_BPS,
                    oversubscription: float = 1.0) -> LeafSpine:
    """Paper-style scaling: 8 hosts per ToR; spines sized to keep the fabric
    non-blocking at oversubscription=1 (S = hosts_per_tor)."""
    n_tors = max(2, n_hosts // 8)
    n_spines = max(2, min(8, n_hosts // n_tors))
    return make_leaf_spine(n_hosts, n_tors, n_spines, link_bps, oversubscription)
