"""The port's grid lanes split over several devices (``devices=``/``mesh=``),
on the CPU: the cases of ``tests/test_netsim_shard.py``.

A list naming the CPU two or three times stands for several devices: the
lanes split into contiguous shares, each run from its own thread, and are
gathered in lane order.  Held to:

- the one-device run of the port: every output bit for bit (lanes never
  interact, and each share runs the same per-lane arithmetic);
- the reference's one-device ``simulate_grid`` at a short horizon: the
  integer outputs exactly, ``ts_throughput`` and ``ts_qmax`` allclose at
  the float tolerances of ``tests/test_torch_simulator.py`` (the
  reference contracts a*b+c).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.core.netsim as R  # noqa: E402

import repro_torch.core.netsim as T  # noqa: E402
from repro_torch.core.netsim import prng  # noqa: E402
from repro_torch.core.netsim.simulator import make_lanes  # noqa: E402

INT_FIELDS = ("finish_ticks", "job_finish_ticks", "ts_min_wire",
              "ts_max_wire", "ts_done_min", "ts_alpha_max")
CPU2 = ["cpu", "cpu"]
CPU3 = ["cpu", "cpu", "cpu"]


def _small(mod):
    topo = mod.make_leaf_spine(8, 2, 2)
    b = mod.WorkloadBuilder()
    b.add_ring_job(hosts=list(range(8)), ring_size=4, chunk_bytes=2e5,
                   passes=1, barrier=False)
    return topo, b.build()


def _points(mod, ks, n_ticks=300):
    cfg = mod.SimParams(n_ticks=n_ticks, window=8, record_every=10)
    return [cfg._replace(sym_on=True, sym=cfg.sym._replace(k=k))
            for k in ks]


def _equal(a, b, what):
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f"{what}: {f}"


def _grid(ks, seeds, **kw):
    topo, wl = _small(T)
    struct, knobs = T.grid_from_params(_points(T, ks))
    return T.simulate_grid(topo, wl, struct, knobs, seeds, routing="ecmp",
                           **kw)


def _against_reference(port, ks, seeds):
    topo, wl = _small(R)
    struct, knobs = R.grid_from_params(_points(R, ks))
    with jax.threefry_partitionable(False):
        ref = R.simulate_grid(topo, wl, struct, knobs, seeds,
                              routing="ecmp")
    for f in INT_FIELDS:
        assert np.array_equal(np.asarray(getattr(ref, f)),
                              getattr(port, f).numpy()), f
    for f, atol in (("ts_throughput", 1e-6), ("ts_qmax", 1e-3)):
        np.testing.assert_allclose(getattr(port, f).numpy(),
                                   np.asarray(getattr(ref, f)),
                                   rtol=1e-5, atol=atol, err_msg=f)


# --------------------------------------------------------------- resolver
def test_resolve_none_and_single_device():
    assert T.resolve_grid_mesh() is None
    assert T.resolve_grid_mesh(devices=None) is None
    assert T.resolve_grid_mesh(devices=["cpu"]) is None
    assert T.resolve_grid_mesh(mesh=T.LaneMesh((torch.device("cpu"),))) \
        is None
    mesh = T.resolve_grid_mesh(devices=CPU3)
    assert mesh.devices == (torch.device("cpu"),) * 3
    assert mesh.axis_names == (T.GRID_AXIS,) == ("lanes",)
    assert T.resolve_grid_mesh(mesh=mesh) is mesh


def test_resolve_counts_cards(monkeypatch):
    """``"auto"`` and an int count CUDA cards (one, faked here): one card
    is the plain path, more than there are is refused."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert T.resolve_grid_mesh(devices="auto") is None
    assert T.resolve_grid_mesh(devices=1) is None
    for n in (0, 2):
        with pytest.raises(ValueError, match="out of range"):
            T.resolve_grid_mesh(devices=n)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    mesh = T.resolve_grid_mesh(devices=2)
    assert mesh.devices == (torch.device("cuda", 0), torch.device("cuda", 1))


@pytest.mark.parametrize("kw", [dict(devices="auto"), dict(devices=2)],
                         ids=["auto", "int"])
def test_auto_and_int_need_a_card(kw):
    if torch.cuda.is_available():
        assert T.resolve_grid_mesh(**kw) is None or kw["devices"] == 2
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.resolve_grid_mesh(**kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _grid((1e-3,), [0], **kw)


@pytest.mark.parametrize("kw, match", [
    (dict(mesh=T.LaneMesh((torch.device("cpu"),) * 2, ("a", "b"))), "1-D"),
    (dict(devices=CPU2, mesh=T.LaneMesh((torch.device("cpu"),) * 2)),
     "either"),
    (dict(devices=[]), "empty"),
    (dict(devices="cpu"), "auto"),
], ids=["2-D mesh", "mesh and devices", "empty", "bare name"])
def test_resolve_rejects(kw, match):
    with pytest.raises(ValueError, match=match):
        T.resolve_grid_mesh(**kw)


def test_device_and_devices_are_exclusive():
    with pytest.raises(ValueError, match="not both"):
        _grid((1e-3,), [0], devices=CPU2, device="cpu")


# ----------------------------------------------------------- equivalence
@pytest.mark.parametrize("devices", [CPU2, CPU3], ids=["2", "3"])
def test_split_grid_matches_single_device(devices):
    """K*S = 8 lanes over 2 devices (4 + 4) and over 3 (3 + 3 + 2, the
    second share starting mid-point): the one-device run bit for bit, and
    the reference's."""
    ks, seeds = (1e-3, 3e-3, 1e-2, 3e-2), [0, 1]
    one = _grid(ks, seeds, device="cpu")
    got = _grid(ks, seeds, devices=devices)
    assert got.finish_ticks.shape[:2] == (4, 2)
    _equal(got, one, f"{len(devices)} devices")
    _against_reference(got, ks, seeds)


def test_split_seeds_matches_single_device():
    """simulate_seeds: 3 seed lanes over 2 devices (2 + 1)."""
    topo, wl = _small(T)
    cfg = _points(T, (1e-2,))[0]
    one = T.simulate_seeds(topo, wl, cfg, "ecmp", [0, 1, 2], device="cpu")
    got = T.simulate_seeds(topo, wl, cfg, "ecmp", [0, 1, 2], devices=CPU2)
    _equal(got, one, "seeds over 2 devices")
    mesh = T.resolve_grid_mesh(devices=CPU2)
    _equal(T.simulate_seeds(topo, wl, cfg, "ecmp", [0, 1, 2], mesh=mesh),
           one, "seeds over a 2-device mesh")


def test_uneven_lanes_more_devices_than_lanes():
    """2 lanes over 3 devices: the third share is empty."""
    ks, seeds = (1e-3, 1e-2), [5]
    _equal(_grid(ks, seeds, devices=CPU3), _grid(ks, seeds, device="cpu"),
           "2 lanes over 3 devices")


def test_chunking_composes():
    """chunk_knobs bounds the knob points per device: 7 points, 2 per
    device over 2 devices, dispatched 4 + 3 (the last chunk not padded)."""
    ks = (1e-3, 2e-3, 3e-3, 5e-3, 1e-2, 3e-2, 1e-1)
    one = _grid(ks, [0], device="cpu")
    got = _grid(ks, [0], devices=CPU2, chunk_knobs=2)
    assert got.finish_ticks.shape[:2] == (7, 1)
    _equal(got, one, "chunk_knobs=2 over 2 devices")
    _against_reference(got, ks, [0])


def test_share_starting_mid_point_keeps_each_lanes_seed():
    """A share of lanes 5-8 of a 3 x 3 grid (lane 5 is point 1, seed 2)
    gets each lane's own seed statics, PRNG key and knob point: those of
    the same lanes set up whole."""
    topo, wl = _small(T)
    struct, knobs = T.grid_from_params(_points(T, (1e-3, 1e-2, 3e-2)))
    seeds = [4, 7, 9]
    ctx, cfg, sim = make_lanes(topo, wl, struct, knobs, seeds, device="cpu")
    lanes = [5, 6, 7, 8]
    sctx, scfg, ssim = make_lanes(topo, wl, struct, knobs, seeds,
                                  device="cpu", lanes=lanes)
    assert ssim.engine.key.shape[0] == len(lanes)
    for j, lane in enumerate(lanes):
        s = seeds[lane % 3]
        assert torch.equal(ssim.engine.key[j], prng.prng_key(s, "cpu")), lane
        assert torch.equal(ssim.engine.key[j], sim.engine.key[lane])
        assert int(sctx.st.seed[j]) == s
        for f in ("routes", "path_table", "cap"):
            assert torch.equal(getattr(sctx.st, f)[j],
                               getattr(ctx.st, f)[lane]), (lane, f)
        assert float(scfg.sym.k[j]) == float(cfg.sym.k[lane]) == \
            float(knobs.sym.k[lane // 3])


def test_launch_counts_survive_threads():
    """The shares' threads count kernel launches through one lock
    (``_build.count_launch``): 16 threads x 2,000 counts, the interpreter
    switching threads every microsecond, lose none."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels._build import count_launch

    def wrapper():
        pass

    wrapper.launches = 0

    def count(_):
        for _ in range(2000):
            count_launch(wrapper)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(16) as pool:
            for f in [pool.submit(count, i) for i in range(16)]:
                f.result(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert wrapper.launches == 16 * 2000
