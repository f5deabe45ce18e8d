"""Table-1 golden, balanced_sym, on the CPU: balanced static routes,
Symphony on (slow, as in the reference).

Table-1 fabric (32 hosts, leaf-spine 4x4), 4 rings of 8, 1 MB chunks, 2
passes, seed 3, 20,000 ticks, window 64.  The constants are the
reference's goldens (``tests/test_netsim_engine.py``), copied.  One run per
file, so that the test workers share the 20,000-tick runs out.
"""
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core.netsim as T  # noqa: E402

GOLDEN_JOB = 2239


def _table1():
    topo = T.make_leaf_spine(32, 4, 4)
    b = T.WorkloadBuilder()
    b.add_ring_job(hosts=list(range(32)), ring_size=8, chunk_bytes=1e6,
                   passes=2, barrier=False)
    return topo, b.build()


@pytest.mark.slow
def test_golden_balanced_sym():
    topo, wl = _table1()
    cfg = T.SimParams(n_ticks=20_000, window=64, sym_on=True)
    res = T.simulate(topo, wl, cfg, routing="balanced", seed=3,
                     device="cpu")
    assert int(res.job_finish_ticks[0]) == GOLDEN_JOB
