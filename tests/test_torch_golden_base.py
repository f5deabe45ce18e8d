"""Table-1 golden, ecmp_base, on the CPU: the eager tick, Symphony off.

Table-1 fabric (32 hosts, leaf-spine 4x4), 4 rings of 8, 1 MB chunks, 2
passes, seed 3, 20,000 ticks, window 64.  The constants are the
reference's goldens (``tests/test_netsim_engine.py``), copied.  One run per
file, so that the test workers share the 20,000-tick runs out.
"""
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core.netsim as T  # noqa: E402

GOLDEN_JOB = 10757
GOLDEN_FLOWS = [
    9296, 7344, 7659, 8375, 8795, 9180, 9359, 9439, 10450, 10648, 10728,
    10601, 10268, 10348, 9887, 10228, 10658, 10757, 10754, 10205, 10011,
    10053, 10007, 10383, 9050, 9050, 9009, 8801, 8734, 9119, 9081, 9107]


def _table1():
    topo = T.make_leaf_spine(32, 4, 4)
    b = T.WorkloadBuilder()
    b.add_ring_job(hosts=list(range(32)), ring_size=8, chunk_bytes=1e6,
                   passes=2, barrier=False)
    return topo, b.build()


def test_golden_ecmp_base_eager():
    topo, wl = _table1()
    cfg = T.SimParams(n_ticks=20_000, window=64)
    res = T.simulate(topo, wl, cfg, routing="ecmp", seed=3,
                     device="cpu")
    assert int(res.job_finish_ticks[0]) == GOLDEN_JOB
    assert res.finish_ticks.tolist() == GOLDEN_FLOWS
