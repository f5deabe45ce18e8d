"""The port's host builders against the reference, for every registered
scenario of ``benchmarks/common.py`` at its default arguments.

Each scenario is built twice: once as registered, and once with the
registry's builder names pointed at the port's copies (``make_leaf_spine``,
``make_fat_tree``, ``scale_for_hosts``, ``WorkloadBuilder``).  Every
topology and workload array, the candidate-path tables, the ECMP and
balanced path choices, the routes and the Symphony link domains must be
equal.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import benchmarks.common as common  # noqa: E402
from repro.core.netsim import simulator as r_sim  # noqa: E402
from repro.core.netsim import workload as r_wl  # noqa: E402

import repro_torch.core.netsim as T  # noqa: E402
from repro_torch.core.netsim import simulator as t_sim  # noqa: E402
from repro_torch.core.netsim import workload as t_wl  # noqa: E402

SCENARIOS = sorted(common.SCENARIOS)


def _assert_same_dataclass(a, b, what):
    assert type(a).__name__ == type(b).__name__, what
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == np.asarray(y).dtype, f"{what}.{f.name}"
            assert np.array_equal(x, y), f"{what}.{f.name}"
        else:
            assert x == y, f"{what}.{f.name}"


@pytest.mark.parametrize("name", SCENARIOS)
def test_scenario_builders_match_reference(name, monkeypatch):
    ref = common.build_scenario(name)
    for attr in ("make_leaf_spine", "make_fat_tree", "scale_for_hosts",
                 "WorkloadBuilder"):
        monkeypatch.setattr(common, attr, getattr(T, attr))
    port = common.build_scenario(name)
    assert type(port.topo).__module__.startswith("repro_torch")
    _assert_same_dataclass(ref.topo, port.topo, f"{name}.topo")
    _assert_same_dataclass(ref.wl, port.wl, f"{name}.wl")

    paths_r, n_r = r_wl.path_table_for(ref.topo, ref.wl)
    paths_t, n_t = t_wl.path_table_for(port.topo, port.wl)
    assert np.array_equal(paths_r, paths_t) and np.array_equal(n_r, n_t)
    for seed in (0, 3):
        c_r = r_wl.ecmp_choice(ref.topo, ref.wl, seed)
        c_t = t_wl.ecmp_choice(port.topo, port.wl, seed)
        assert np.array_equal(c_r, c_t)
        assert np.array_equal(r_wl.routes_for(ref.topo, ref.wl, c_r),
                              t_wl.routes_for(port.topo, port.wl, c_t))
    assert np.array_equal(r_wl.balanced_choice(ref.topo, ref.wl),
                          t_wl.balanced_choice(port.topo, port.wl))
    for deploy in ("tor", "all", "spine"):
        d_r, D_r = r_sim.link_domains(ref.topo, deploy)
        d_t, D_t = t_sim.link_domains(port.topo, deploy)
        assert D_r == D_t and np.array_equal(d_r, d_t)


@pytest.mark.parametrize("name", ["table1_ring", "fat_tree_ring",
                                  "tenant_churn"])
def test_static_and_workload_arrays_match_reference(name):
    """``build_static``/``wl_arrays`` give the reference's device arrays."""
    ref = common.build_scenario(name)
    st_r = r_sim.build_static(ref.topo, ref.wl, "ecmp", 3, dt=ref.cfg.dt)
    st_t = t_sim.build_static(ref.topo, ref.wl, "ecmp", 3, dt=ref.cfg.dt,
                              device="cpu")
    for f in st_r._fields:
        assert np.array_equal(np.asarray(getattr(st_r, f)),
                              getattr(st_t, f).numpy()), f
    wl_r = r_sim.wl_arrays(ref.wl, ref.cfg.dt)
    wl_t = t_sim.wl_arrays(ref.wl, ref.cfg.dt, device="cpu")
    for f in wl_r._fields:
        assert np.array_equal(np.asarray(getattr(wl_r, f)),
                              getattr(wl_t, f).numpy()), f
