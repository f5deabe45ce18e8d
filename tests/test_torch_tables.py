"""The port's packed route tables and tiling plan against the JAX package's.

``pack_route_tables`` must give the reference's ``[FW]``-leading slabs
exactly (integers and chunk sizes copied, nothing computed) on leaf-spine
fabrics with 1, 2 and 4 ECMP candidates and on a small multi-pod fat tree;
``plan_tiling`` must return what the reference returns, or raise the same
``ValueError``, case by case.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.core.netsim as R  # noqa: E402
from repro.core.netsim.params import pack_route_tables as r_pack  # noqa: E402
from repro.core.netsim.params import plan_tiling as r_plan  # noqa: E402
from repro.core.netsim.simulator import wl_arrays as r_wl_arrays  # noqa: E402

import repro_torch.core.netsim as T  # noqa: E402

WINDOW = 8


def _ring(mod, n_hosts, ring):
    b = mod.WorkloadBuilder()
    b.add_ring_job(hosts=list(range(n_hosts)), ring_size=ring,
                   chunk_bytes=2e5, passes=1, barrier=False)
    return b.build()


def _leaf_spine(mod, n_spines):
    return mod.make_leaf_spine(8, 2, n_spines), _ring(mod, 8, 4)


def _fat_tree(mod):
    topo = mod.make_fat_tree(n_pods=2, tors_per_pod=2, spines_per_pod=2,
                             hosts_per_tor=2)
    return topo, _ring(mod, topo.n_hosts, topo.n_hosts)


BUILDS = {"leaf_spine_p1": lambda m: _leaf_spine(m, 1),
          "leaf_spine_p2": lambda m: _leaf_spine(m, 2),
          "leaf_spine_p4": lambda m: _leaf_spine(m, 4),
          "fat_tree_multipod": _fat_tree}


def _tables(build):
    topo, wl = build(R)
    with jax.threefry_partitionable(False):
        st = R.build_static(topo, wl, "ecmp", seed=3, dt=10e-6)
        ref = r_pack(st, r_wl_arrays(wl, 10e-6), WINDOW)
    topo, wl = build(T)
    tst = T.build_static(topo, wl, "ecmp", 3, dt=10e-6, device="cpu")
    port = T.pack_route_tables(tst, T.wl_arrays(wl, 10e-6, device="cpu"),
                               WINDOW)
    return ref, port, int(tst.path_table.shape[1])


@pytest.mark.parametrize("name", list(BUILDS))
def test_packed_tables_match_reference(name):
    ref, port, _ = _tables(BUILDS[name])
    assert T.PackedTables._fields == type(ref)._fields
    for f in T.PackedTables._fields:
        x, y = getattr(port, f), np.asarray(getattr(ref, f))
        assert str(x.dtype).split(".")[-1] == str(y.dtype), f
        assert np.array_equal(x.numpy(), y), f
    # row f*W + w holds flow f's table
    assert torch.equal(port.routes[::WINDOW], port.routes[WINDOW - 1::WINDOW])


def test_fanouts_cover_one_two_and_four_paths():
    assert {_tables(b)[2] for b in BUILDS.values()} >= {1, 2, 4}


FW = 64
PLANS = {
    "untiled": (None, "scatter", 1),
    "onehot_tiled": (16, "onehot", 1),
    "window_normalizes": (16, "onehot", 5),
    "whole_axis": (FW, "onehot", 1),
    "beyond_axis_scatter": (FW + 8, "scatter", 1),
    "scatter_tiled": (16, "scatter", 1),
    "scatter_window": (16, "scatter", 5),
    "zero_block": (0, "onehot", 1),
}


@pytest.mark.parametrize("case", list(PLANS))
def test_plan_tiling_matches_reference(case):
    blk, segsum, tw = PLANS[case]
    try:
        with jax.threefry_partitionable(False):
            want = r_plan(FW, blk, segsum, tw)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            T.plan_tiling(FW, blk, segsum, tw)
        assert str(got.value) == str(e)
    else:
        assert T.plan_tiling(FW, blk, segsum, tw) == want
