"""Table-1 golden, ecmp_sym, on the CPU through the tiled tick:
``backend="cuda", segsum="onehot", blk=256`` (8 blocks of the 2,048
instances), which on CPU tensors runs the tiled kernel's plain torch
version.  Its float sums are block partials folded in block order, another
association than the staged tick's, and the integer goldens hold all the
same, as they do through the reference's tiled kernel.

Table-1 fabric (32 hosts, leaf-spine 4x4), 4 rings of 8, 1 MB chunks, 2
passes, seed 3, 20,000 ticks, window 64.  The constants are the
reference's goldens (``tests/test_netsim_engine.py``), copied.  One run per
file, so that the test workers share the 20,000-tick runs out.
"""
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core.netsim as T  # noqa: E402

GOLDEN_JOB = 7900
GOLDEN_FLOWS = [
    7853, 7891, 7769, 7877, 7837, 7864, 7698, 7900, 7845, 7894, 7802, 7889,
    7807, 7843, 7699, 7893, 7824, 7892, 7825, 7878, 7748, 7860, 7698, 7861,
    7853, 7877, 7764, 7877, 7747, 7835, 7692, 7891]


def _table1():
    topo = T.make_leaf_spine(32, 4, 4)
    b = T.WorkloadBuilder()
    b.add_ring_job(hosts=list(range(32)), ring_size=8, chunk_bytes=1e6,
                   passes=2, barrier=False)
    return topo, b.build()


def test_golden_ecmp_sym_tiled():
    topo, wl = _table1()
    cfg = T.SimParams(n_ticks=20_000, window=64, sym_on=True,
                      backend="cuda", segsum="onehot", blk=256)
    res = T.simulate(topo, wl, cfg, routing="ecmp", seed=3,
                     device="cpu")
    assert int(res.job_finish_ticks[0]) == GOLDEN_JOB
    assert res.finish_ticks.tolist() == GOLDEN_FLOWS
