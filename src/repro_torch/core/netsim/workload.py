"""Ring-collective workloads for the Symphony simulator.

NumPy only: the port keeps its own copy of ``repro.core.netsim.workload``
so that it imports nothing of the JAX package.  The arrays it builds are
equal to the reference's.

Model (paper §2.1-2.2):

* A *job* runs a sequence of ring collectives ("passes"); between passes there
  is an optional compute gap (Table 2's end-to-end model) and a job-wide
  barrier (gradient sync semantics).
* Each job owns one or more parallel 1-D rings over its hosts. Ring r of
  size N performs ``steps_per_pass = 2*(N-1)`` pipelined steps per pass; in
  each step every member sends one chunk to its successor.
* A *flow slot* f is one (ring, member): the persistent sender node->successor
  relationship. Its 5-tuple/path is fixed (per-flow ECMP) or re-hashed per
  step (per-step ECMP).
* Crucially, steps pipeline: node i may start sending step s as soon as it has
  *received* step s-1 (its predecessor finished sending s-1) — it does NOT
  wait for its own send of s-1 to drain.  Under congestion this produces
  multiple concurrent step-sends of one flow slot on the same path, which
  split bandwidth and cascade (Fig. 1e).  The simulator therefore tracks a
  window of concurrent *flow instances* per slot.
* Steps are numbered globally-monotonically across passes (the wire `step`
  field of §3.2; resets would be handled by Alg. 1's lazy correction anyway).

2-D ring collectives (§4.6) are expressed with two *phases* per pass: each
node has a dim-0 flow slot (phase 0) and a dim-1 slot (phase 1); a job-wide
barrier separates the phases.

The phase machinery generalizes beyond rings: recursive halving-doubling
allreduce is 2*log2(N) single-step phases with geometrically shrinking
chunks (:meth:`WorkloadBuilder.add_halving_doubling_job`), and hierarchical
allreduce is 3 phases — intra-group ring reduce-scatter, inter-group leader
ring, intra-group ring allgather (:meth:`WorkloadBuilder.add_hierarchical_job`).

Arrivals: fixed vs dependency-triggered
---------------------------------------
Jobs arrive either at a fixed ``start_time`` or via a **trigger rule**
(:meth:`WorkloadBuilder.set_trigger`): job j starts when job i completes
its c-th collective (plus an optional delay) — the CCL-Simulator-style
dependency-triggered injection.  Triggers are lowered to three traced
``[J]`` arrays (``trig_job`` / ``trig_seg`` / ``trig_delay``) that the
engine evaluates inside the tick (`stages.stage_segments`), so triggered
multi-tenant workloads run unchanged under the one-compile grid/shard
executors and the windowed checkpoint/resume core.
:meth:`WorkloadBuilder.add_poisson_churn` layers continuous tenant churn
on top: Poisson job arrivals over a host pool, each tenant departing when
its finite pass budget completes.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .topology import Topology


@dataclass(frozen=True)
class Workload:
    """Flow-slot arrays (length F) + per-job arrays (length J)."""

    # --- flow slots ---
    src: np.ndarray          # [F] host id
    dst: np.ndarray          # [F] successor host id
    pred: np.ndarray         # [F] flow-slot index of ring predecessor
    job: np.ndarray          # [F] job id
    phase: np.ndarray        # [F] phase within a pass (0 for plain 1-D rings)
    steps_per_seg: np.ndarray  # [F] steps this slot runs per segment
    pass_steps: np.ndarray   # [F] steps per collective = 2(N-1) (boundaries)
    step_offset: np.ndarray  # [F] added to the wire step index (Fig. 9 style
                             #     scenarios where flows start mid-collective)
    flow_start: np.ndarray   # [F] per-flow start time (s), on top of job start
    # --- jobs ---
    n_phases: np.ndarray     # [J] phases per pass (1 or 2)
    n_passes: np.ndarray     # [J]
    chunk_sched: np.ndarray  # [J, max_segments] bytes per chunk in that segment
    compute_gap: np.ndarray  # [J] seconds inserted before each pass
    start_time: np.ndarray   # [J] job arrival time (s)
    # --- dependency-triggered arrivals (set_trigger; -1 = fixed start) ---
    trig_job: np.ndarray = None    # [J] job whose progress releases this one
    trig_seg: np.ndarray = None    # [J] segment count of trig_job to wait for
    trig_delay: np.ndarray = None  # [J] seconds between trigger and release

    def __post_init__(self):
        # Workloads built before the trigger fields existed (or constructed
        # directly in tests) default to all-fixed starts.
        J = int(self.n_phases.shape[0])
        if self.trig_job is None:
            object.__setattr__(self, "trig_job", np.full(J, -1, np.int32))
        if self.trig_seg is None:
            object.__setattr__(self, "trig_seg", np.zeros(J, np.int32))
        if self.trig_delay is None:
            object.__setattr__(self, "trig_delay", np.zeros(J, np.float64))

    @property
    def n_flows(self) -> int:
        return int(self.src.shape[0])

    @property
    def n_jobs(self) -> int:
        return int(self.n_phases.shape[0])

    @property
    def max_segments(self) -> int:
        return int(self.chunk_sched.shape[1])

    def total_steps(self) -> np.ndarray:
        """[F] total steps each slot executes over the whole job."""
        return self.steps_per_seg * self.n_passes[self.job]


def _ring_slots(hosts: np.ndarray, ring_size: int, job_id: int, phase: int,
                flow_base: int):
    """Split `hosts` into interleaved rings of `ring_size` (stride layout:
    ring g = hosts[g::n_groups], matching Fig. 1a's 0-4-8-12 example)."""
    n = len(hosts)
    assert n % ring_size == 0, (n, ring_size)
    n_groups = n // ring_size
    src, dst, pred, phs = [], [], [], []
    idx = {}
    for g in range(n_groups):
        members = hosts[g::n_groups]
        for j in range(ring_size):
            idx[(g, j)] = flow_base + len(src)
            src.append(members[j])
            dst.append(members[(j + 1) % ring_size])
            phs.append(phase)
    for g in range(n_groups):
        for j in range(ring_size):
            pred.append(idx[(g, (j - 1) % ring_size)])
    return src, dst, pred, phs


class WorkloadBuilder:
    def __init__(self, max_segments: int | None = None):
        """``max_segments`` fixes the width of the chunk schedule: jobs with
        fewer segments are padded (repeating the last chunk); jobs with more
        raise at :meth:`build`.  Useful to keep array shapes — and therefore
        jit caches — stable across workloads."""
        self.max_segments = max_segments
        self._flows: dict[str, list] = {
            k: [] for k in ("src", "dst", "pred", "job", "phase", "sps", "ps",
                            "off", "fstart")}
        self._jobs: dict[str, list] = {k: [] for k in
                                       ("n_phases", "n_passes", "gap", "start", "chunks")}
        # job_id -> (after_job, collectives | None, delay_s)
        self._trigs: dict[int, tuple[int, int | None, float]] = {}

    def _pad_flow_defaults(self):
        n = len(self._flows["src"])
        for k in ("off", "fstart"):
            self._flows[k] += [0.0 if k == "fstart" else 0] * \
                (n - len(self._flows[k]))

    def add_ring_job(
        self,
        hosts: np.ndarray | list[int],
        ring_size: int,
        chunk_bytes: float | list[float] = 8e6,
        passes: int = 1,
        compute_gap: float = 0.0,
        start_time: float = 0.0,
        dims: tuple[int, ...] | None = None,
        barrier: bool = True,
    ) -> int:
        """Add one job. `dims=(d0, d1)` builds a 2-D ring collective instead of
        interleaved 1-D rings of `ring_size`.  `chunk_bytes` may be a list of
        per-pass chunk sizes (Table 2 layer-bucket schedules).

        ``barrier=False`` chains the passes back-to-back with only the ring
        data dependency between them (a pure communication benchmark, the
        paper's §2.2/§4.2 motivating workload): step misalignment can then
        accumulate *across* collective boundaries, which is how overlap
        degrees beyond 2(N-1) arise.  Requires scalar chunk_bytes and 1-D
        rings; compute_gap must be 0.
        """
        hosts = np.asarray(hosts, np.int32)
        job_id = len(self._jobs["n_passes"])
        base = len(self._flows["src"])
        if not barrier:
            assert dims is None and np.isscalar(chunk_bytes) and compute_gap == 0.0
            s, d, p, ph = _ring_slots(hosts, ring_size, job_id, 0, base)
            sps = [passes * 2 * (ring_size - 1)] * len(s)
            self._flows["src"] += list(s)
            self._flows["dst"] += list(d)
            self._flows["pred"] += list(p)
            self._flows["job"] += [job_id] * len(s)
            self._flows["phase"] += list(ph)
            self._flows["sps"] += sps
            self._flows["ps"] += [2 * (ring_size - 1)] * len(s)
            self._jobs["n_phases"].append(1)
            self._jobs["n_passes"].append(1)
            self._jobs["gap"].append(0.0)
            self._jobs["start"].append(float(start_time))
            self._jobs["chunks"].append([float(chunk_bytes)])
            return job_id
        if dims is None:
            s, d, p, ph = _ring_slots(hosts, ring_size, job_id, 0, base)
            sps = [2 * (ring_size - 1)] * len(s)
            n_phases = 1
        else:
            d0, d1 = dims
            assert d0 * d1 == len(hosts)
            grid = hosts.reshape(d0, d1)
            s, d, p, ph, sps = [], [], [], [], []
            # phase 0: rings along dim0 (columns), phase 1: rings along dim1 (rows)
            for c in range(d1):
                col = grid[:, c]
                s0, d0_, p0, _ = _ring_slots(col, d0, job_id, 0, base + len(s))
                s += s0; d += d0_; p += p0; ph += [0] * len(s0)
                sps += [2 * (d0 - 1)] * len(s0)
            for r in range(d0):
                row = grid[r, :]
                s1, d1_, p1, _ = _ring_slots(row, d1, job_id, 1, base + len(s))
                s += s1; d += d1_; p += p1; ph += [1] * len(s1)
                sps += [2 * (d1 - 1)] * len(s1)
            n_phases = 2
        self._flows["src"] += list(s)
        self._flows["dst"] += list(d)
        self._flows["pred"] += list(p)
        self._flows["job"] += [job_id] * len(s)
        self._flows["phase"] += list(ph)
        self._flows["sps"] += list(sps)
        self._flows["ps"] += list(sps)   # one collective per segment
        chunks = ([float(chunk_bytes)] * passes if np.isscalar(chunk_bytes)
                  else [float(c) for c in chunk_bytes])
        assert len(chunks) == passes, "per-pass chunk schedule must match passes"
        # segment k belongs to pass k // n_phases
        seg_chunks = [chunks[k // n_phases] for k in range(passes * n_phases)]
        self._jobs["n_phases"].append(n_phases)
        self._jobs["n_passes"].append(passes)
        self._jobs["gap"].append(float(compute_gap))
        self._jobs["start"].append(float(start_time))
        self._jobs["chunks"].append(seg_chunks)
        return job_id

    def add_chain_job(self, pairs, steps: int, chunk_bytes: float,
                      step_offsets=None, flow_starts=None,
                      start_time: float = 0.0) -> int:
        """Independent sender chains within ONE job (the Fig. 9 hardware
        scenario): each (src, dst) pair sends `steps` sequential chunks with
        no cross-flow gating; per-flow step_offsets place flows at different
        collective steps so Symphony sees outpacing vs lagging flows."""
        self._pad_flow_defaults()
        job_id = len(self._jobs["n_passes"])
        base = len(self._flows["src"])
        n = len(pairs)
        step_offsets = step_offsets or [0] * n
        flow_starts = flow_starts or [0.0] * n
        for i, (s, d) in enumerate(pairs):
            self._flows["src"].append(int(s))
            self._flows["dst"].append(int(d))
            self._flows["pred"].append(base + i)   # self-gated chain
            self._flows["job"].append(job_id)
            self._flows["phase"].append(0)
            self._flows["sps"].append(steps)
            self._flows["ps"].append(steps)
            self._flows["off"].append(int(step_offsets[i]))
            self._flows["fstart"].append(float(flow_starts[i]))
        self._jobs["n_phases"].append(1)
        self._jobs["n_passes"].append(1)
        self._jobs["gap"].append(0.0)
        self._jobs["start"].append(float(start_time))
        self._jobs["chunks"].append([float(chunk_bytes)])
        return job_id

    def _add_phase_slots(self, s, d, p, ph, sps, job_id):
        self._flows["src"] += list(s)
        self._flows["dst"] += list(d)
        self._flows["pred"] += list(p)
        self._flows["job"] += [job_id] * len(s)
        self._flows["phase"] += list(ph)
        self._flows["sps"] += list(sps)
        self._flows["ps"] += list(sps)   # one collective per segment

    def add_halving_doubling_job(
        self,
        hosts: np.ndarray | list[int],
        chunk_bytes: float = 8e6,
        passes: int = 1,
        compute_gap: float = 0.0,
        start_time: float = 0.0,
    ) -> int:
        """Recursive halving-doubling allreduce (Swing/Rabenseifner style).

        ``chunk_bytes`` is the *total* reduced volume V.  The collective runs
        2*log2(N) barrier-separated phases: reduce-scatter exchanges of
        V/2, V/4, .., V/N with partners at distance 1, 2, .., N/2, then the
        mirrored allgather doubling back up.  Each phase is one step per
        node, so each (node, phase) is its own self-gated flow slot.
        """
        hosts = np.asarray(hosts, np.int32)
        n = len(hosts)
        m = int(np.log2(n))
        assert 2 ** m == n, f"halving-doubling needs power-of-2 hosts, got {n}"
        self._pad_flow_defaults()
        job_id = len(self._jobs["n_passes"])
        n_phases = 2 * m
        for q in range(n_phases):
            dist = 1 << (q if q < m else 2 * m - 1 - q)
            base = len(self._flows["src"])
            s = list(hosts)
            d = [int(hosts[i ^ dist]) for i in range(n)]
            p = [base + i for i in range(n)]       # self-gated, 1 step
            self._add_phase_slots(s, d, p, [q] * n, [1] * n, job_id)
        seg_chunks = [float(chunk_bytes) / 2 ** (min(q, n_phases - 1 - q) + 1)
                      for _ in range(passes) for q in range(n_phases)]
        self._jobs["n_phases"].append(n_phases)
        self._jobs["n_passes"].append(passes)
        self._jobs["gap"].append(float(compute_gap))
        self._jobs["start"].append(float(start_time))
        self._jobs["chunks"].append(seg_chunks)
        return job_id

    def add_hierarchical_job(
        self,
        hosts: np.ndarray | list[int],
        group_size: int,
        chunk_bytes: float = 8e6,
        passes: int = 1,
        compute_gap: float = 0.0,
        start_time: float = 0.0,
    ) -> int:
        """Hierarchical allreduce: intra-group ring reduce-scatter (phase 0),
        inter-group ring allreduce over group leaders (phase 1), intra-group
        ring allgather (phase 2).  Groups are contiguous runs of
        ``group_size`` hosts, which maps onto ToR locality when hosts are
        numbered contiguously per ToR (topology convention)."""
        hosts = np.asarray(hosts, np.int32)
        n, g = len(hosts), int(group_size)
        assert n % g == 0 and n // g >= 2, (n, g)
        n_groups = n // g
        self._pad_flow_defaults()
        job_id = len(self._jobs["n_passes"])
        groups = [hosts[i * g:(i + 1) * g] for i in range(n_groups)]
        for phase, sps in ((0, g - 1), (2, g - 1)):
            if g == 1:
                continue
            for mem in groups:
                base = len(self._flows["src"])
                s, d, p, _ = _ring_slots(mem, g, job_id, phase, base)
                self._add_phase_slots(s, d, p, [phase] * len(s),
                                      [sps] * len(s), job_id)
        base = len(self._flows["src"])
        leader_phase = 1 if g > 1 else 0
        leaders = np.asarray([mem[0] for mem in groups], np.int32)
        s, d, p, _ = _ring_slots(leaders, n_groups, job_id, leader_phase, base)
        self._add_phase_slots(s, d, p, [leader_phase] * len(s),
                              [2 * (n_groups - 1)] * len(s), job_id)
        n_phases = 3 if g > 1 else 1
        # per-phase exchanged volume: ring RS/AG move V/g per step inside a
        # group; the leader ring reduces each group's shard of V.
        per_phase = ([float(chunk_bytes) / g,
                      float(chunk_bytes) / (g * n_groups),
                      float(chunk_bytes) / g] if g > 1
                     else [float(chunk_bytes) / n_groups])
        seg_chunks = [c for _ in range(passes) for c in per_phase]
        self._jobs["n_phases"].append(n_phases)
        self._jobs["n_passes"].append(passes)
        self._jobs["gap"].append(float(compute_gap))
        self._jobs["start"].append(float(start_time))
        self._jobs["chunks"].append(seg_chunks)
        return job_id

    def set_trigger(self, job: int, after_job: int, collectives: int | None = None,
                    delay: float = 0.0) -> None:
        """Make ``job`` a dependency-triggered arrival: it is released when
        ``after_job`` completes its ``collectives``-th collective (pass),
        plus ``delay`` seconds.  ``collectives=None`` waits for the whole
        job (every pass) — chained tenant hand-off.

        The trigger replaces the fixed ``start_time``: the engine holds the
        job's segment barrier closed (``seg_ready = INT32_MAX``) until the
        dependency fires *inside the simulation*, so trigger evaluation is
        traced and works unchanged under vmap/grids and windowed resume.
        """
        J = len(self._jobs["n_passes"])
        if not 0 <= job < J or not 0 <= after_job < J:
            raise ValueError(f"trigger references unknown job ({job}, "
                             f"{after_job}); have {J} jobs")
        if job == after_job:
            raise ValueError(f"job {job} cannot trigger on itself")
        if collectives is not None and collectives < 1:
            raise ValueError(f"collectives must be >= 1, got {collectives}")
        if delay < 0:
            raise ValueError(f"trigger delay must be >= 0, got {delay}")
        self._trigs[job] = (after_job, collectives, float(delay))

    def add_poisson_churn(self, host_groups, rate_hz: float, horizon_s: float,
                          ring_size: int | None = None,
                          chunk_bytes: float = 4e6, passes: int = 1,
                          seed: int = 0, max_jobs: int | None = None
                          ) -> list[int]:
        """Continuous tenant churn: Poisson job *arrivals* over a pool of
        host groups, each tenant *departing* when its finite ``passes``
        budget completes.  Arrival k lands on ``host_groups[k % G]`` (a
        tenant's host allocation) at the k-th Poisson event time; times are
        sampled host-side from ``seed`` so the workload is reproducible and
        lowers to plain traced start-tick arrays — the whole churn replay
        runs under one compile of the engine.

        Returns the job ids in arrival order.
        """
        if rate_hz <= 0 or horizon_s <= 0:
            raise ValueError(f"need rate_hz > 0 and horizon_s > 0, got "
                             f"({rate_hz}, {horizon_s})")
        groups = [np.asarray(g, np.int32) for g in host_groups]
        if not groups:
            raise ValueError("empty host_groups")
        rng = np.random.default_rng(seed)
        jobs, t, k = [], 0.0, 0
        while True:
            t += float(rng.exponential(1.0 / rate_hz))
            if t >= horizon_s or (max_jobs is not None and k >= max_jobs):
                break
            g = groups[k % len(groups)]
            rs = len(g) if ring_size is None else min(ring_size, len(g))
            jobs.append(self.add_ring_job(
                hosts=g, ring_size=rs, chunk_bytes=chunk_bytes,
                passes=passes, barrier=False, start_time=t))
            k += 1
        return jobs

    def build(self) -> Workload:
        self._pad_flow_defaults()
        max_seg = max(len(c) for c in self._jobs["chunks"])
        if self.max_segments is not None:
            if max_seg > self.max_segments:
                raise ValueError(
                    f"job needs {max_seg} segments > max_segments="
                    f"{self.max_segments}")
            max_seg = self.max_segments
        J = len(self._jobs["n_passes"])
        sched = np.zeros((J, max_seg), np.float64)
        for j, c in enumerate(self._jobs["chunks"]):
            sched[j, :len(c)] = c
            if len(c) < max_seg:           # pad with last value (unused segs)
                sched[j, len(c):] = c[-1]
        trig_job = np.full(J, -1, np.int32)
        trig_seg = np.zeros(J, np.int32)
        trig_delay = np.zeros(J, np.float64)
        for j, (after, colls, delay) in self._trigs.items():
            n_segs = len(self._jobs["chunks"][after])
            nph = self._jobs["n_phases"][after]
            want = n_segs if colls is None else colls * nph
            if want > n_segs:
                raise ValueError(
                    f"job {j} triggers on collective {colls} of job {after}, "
                    f"which only runs {n_segs // nph} collectives")
            trig_job[j], trig_seg[j], trig_delay[j] = after, want, delay
        return Workload(
            src=np.asarray(self._flows["src"], np.int32),
            dst=np.asarray(self._flows["dst"], np.int32),
            pred=np.asarray(self._flows["pred"], np.int32),
            job=np.asarray(self._flows["job"], np.int32),
            phase=np.asarray(self._flows["phase"], np.int32),
            steps_per_seg=np.asarray(self._flows["sps"], np.int32),
            pass_steps=np.asarray(self._flows["ps"], np.int32),
            step_offset=np.asarray(self._flows["off"], np.int32),
            flow_start=np.asarray(self._flows["fstart"], np.float64),
            n_phases=np.asarray(self._jobs["n_phases"], np.int32),
            n_passes=np.asarray(self._jobs["n_passes"], np.int32),
            chunk_sched=sched,
            compute_gap=np.asarray(self._jobs["gap"], np.float64),
            start_time=np.asarray(self._jobs["start"], np.float64),
            trig_job=trig_job, trig_seg=trig_seg, trig_delay=trig_delay,
        )


def path_table_for(topo: Topology, wl: Workload
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Per-flow ECMP candidate paths: ``(paths [F, P, H], n_paths [F])``."""
    return topo.candidate_paths(wl.src, wl.dst)


def routes_for(topo: Topology, wl: Workload, choice: np.ndarray) -> np.ndarray:
    """[F, H] link ids (null-link = topo.n_links for unused hops) given a
    per-flow candidate-path choice (applied modulo each flow's fan-out)."""
    paths, n_paths = path_table_for(topo, wl)
    return paths[np.arange(wl.n_flows), np.asarray(choice) % n_paths]


def ecmp_choice(topo: Topology, wl: Workload, seed: int) -> np.ndarray:
    """Per-flow 5-tuple-hash path selection (persistent across steps)."""
    paths, _ = path_table_for(topo, wl)
    rng = np.random.default_rng(seed)
    return rng.integers(0, paths.shape[1], wl.n_flows).astype(np.int64)


def balanced_choice(topo: Topology, wl: Workload) -> np.ndarray:
    """Static balanced routing: round-robin over each source edge switch's
    candidate paths (the paper's controlled 'static balanced' scenarios,
    Fig. 2).  Flows with a single path (intra-ToR) are skipped."""
    _, n_paths = path_table_for(topo, wl)
    st = topo.tor_of(wl.src)
    choice = np.zeros(wl.n_flows, np.int64)
    counters: dict[int, int] = {}
    for f in range(wl.n_flows):
        if n_paths[f] <= 1:
            continue  # single-path flows never touch the fabric
        t = int(st[f])
        c = counters.get(t, 0)
        choice[f] = c % n_paths[f]
        counters[t] = c + 1
    return choice

