"""The port's single-controller ``shard_map``, its collectives and meshes
against ``jax.lax``'s under the reference's ``shard_map``.

The reference side runs once for the file in a child python on 8 virtual
CPU devices (jax fixes the count at its first import), inside
``jax.threefry_partitionable(False)``, and hands its results back as
``.npz``; the port runs over the CPU named 8 times.  Inputs are drawn with
numpy from a seed.

- ``axis_index``, ``psum`` (one axis and two), ``all_to_all`` (split and
  concat axes equal and not, tiled and not), ``ppermute`` (a ring, a
  shift by two, a partial permutation whose unnamed receivers get zeros):
  float32 sums at 1e-6 (XLA's all-reduce adds in its own order), the rest
  bit for bit.
- Splits and assembly by ``P()``, ``P("data")``, ``P(("pod", "data"))``
  and a spec naming two dimensions.
- A rank that raises makes ``shard_map`` raise its error within seconds.
  A collective on a tensor that autograd tracks carries its gradient
  (one backward from rank 0's copy of a psum gives every rank's block its
  transpose), and a collective called inside a backward raises.
- Meshes: CPU names, repeats, the CUDA default raising without cards.
"""
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.parallel import spmd  # noqa: E402
from repro_torch.parallel.spmd import P, shard_map  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# (split_axis, concat_axis, tiled) of the all_to_all cases, on [4, 4, 8]
# local blocks over 'model' of 4
A2A = [(0, 0, False), (0, 1, False), (1, 0, False), (2, 1, True),
       (0, 0, True)]
PERMS = {"ring": [(i, (i + 1) % 4) for i in range(4)],
         "shift2": [(i, (i + 2) % 4) for i in range(4)],
         "partial": [(0, 2), (1, 3)]}

SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.compat import make_mesh, shard_map

inp = dict(np.load(sys.argv[1]))
A2A = %r
PERMS = %r
out = {}
mesh = make_mesh((2, 4), ("data", "model"))
mesh3 = make_mesh((2, 2, 2), ("pod", "data", "model"))
x = jnp.asarray(inp["x"])          # [8, 4, 6]: one [1, 4, 6] block a rank

def run(f, arg, in_spec=P(("data", "model")), out_spec=P(("data", "model")),
        m=mesh):
    return np.asarray(jax.jit(shard_map(f, mesh=m, in_specs=in_spec,
                                        out_specs=out_spec))(arg))

with jax.threefry_partitionable(False):
    out["index"] = run(lambda a: jnp.zeros((1, 3), jnp.int32)
                       + jnp.array([jax.lax.axis_index("data"),
                                    jax.lax.axis_index("model"),
                                    jax.lax.axis_index(("data", "model"))],
                                   jnp.int32), x)
    out["psum_model"] = run(lambda a: jax.lax.psum(a, "model"), x)
    out["psum_both"] = run(lambda a: jax.lax.psum(a, ("data", "model")), x)
    out["pmean_data"] = run(lambda a: jax.lax.pmean(a, "data"), x)
    y = jnp.asarray(inp["y"])      # [2, 16, 4, 8]: one [4, 4, 8] block
    for s, c, t in A2A:
        out[f"a2a/{s}/{c}/{t}"] = run(
            lambda a, s=s, c=c, t=t: jax.lax.all_to_all(
                a[0], "model", s, c, tiled=t)[None], y,
            P("data", "model"), P("data", "model"))
    for name, perm in PERMS.items():
        out[f"perm/{name}"] = run(
            lambda a, perm=perm: jax.lax.ppermute(a, "model", perm), x)
    z = jnp.asarray(inp["z"])      # [4, 8, 6]
    out["assemble"] = run(lambda a: a * (1 + jax.lax.axis_index("pod")), z,
                          P("data", ("pod", "model")), P("data",
                                                         ("pod", "model")),
                          mesh3)
np.savez(sys.argv[2], **out)
print("REFERENCE_DONE")
""" % (A2A, PERMS)

MESH = M.make_mesh((2, 4), ("data", "model"), ["cpu"] * 8)
MESH3 = M.make_mesh((2, 2, 2), ("pod", "data", "model"), ["cpu"] * 8)
ALL = P(("data", "model"))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("spmd")
    rng = np.random.default_rng(1)
    inp = {"x": rng.standard_normal((8, 4, 6)).astype(np.float32),
           "y": rng.standard_normal((2, 16, 4, 8)).astype(np.float32),
           "z": rng.standard_normal((4, 8, 6)).astype(np.float32)}
    np.savez(d / "in.npz", **inp)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", SCRIPT, str(d / "in.npz"),
                        str(d / "out.npz")], env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0 and "REFERENCE_DONE" in r.stdout, \
        r.stdout[-2000:] + r.stderr[-4000:]
    return inp, dict(np.load(d / "out.npz"))


def _run(f, x, in_spec=ALL, out_spec=ALL, mesh=MESH):
    return shard_map(f, mesh=mesh, in_specs=in_spec,
                     out_specs=out_spec)(torch.from_numpy(x)).numpy()


def test_axis_index(data):
    inp, ref = data
    got = _run(lambda a: torch.tensor([[spmd.axis_index("data"),
                                        spmd.axis_index("model"),
                                        spmd.axis_index(("data", "model"))]],
                                      dtype=torch.int32), inp["x"])
    np.testing.assert_array_equal(got, ref["index"])


@pytest.mark.parametrize("what", ["psum_model", "psum_both", "pmean_data"])
def test_psum_and_pmean(data, what):
    inp, ref = data
    fn = {"psum_model": lambda a: spmd.psum(a, "model"),
          "psum_both": lambda a: spmd.psum(a, ("data", "model")),
          "pmean_data": lambda a: spmd.pmean(a, "data")}[what]
    np.testing.assert_allclose(_run(fn, inp["x"]), ref[what], rtol=1e-6,
                               atol=1e-6)


def test_psum_is_the_same_bits_on_every_rank():
    x = np.random.default_rng(2).standard_normal((8, 1000)).astype(
        np.float32) * 1e3
    got = _run(lambda a: spmd.psum(a, ("data", "model")), x)
    for r in range(1, 8):
        np.testing.assert_array_equal(got[r], got[0])


@pytest.mark.parametrize("split,concat,tiled", A2A)
def test_all_to_all(data, split, concat, tiled):
    inp, ref = data
    got = _run(lambda a: spmd.all_to_all(a[0], "model", split, concat,
                                         tiled)[None], inp["y"],
               P("data", "model"), P("data", "model"))
    np.testing.assert_array_equal(got, ref[f"a2a/{split}/{concat}/{tiled}"])


@pytest.mark.parametrize("name", list(PERMS))
def test_ppermute(data, name):
    inp, ref = data
    spmd.ppermute.counts.clear()
    got = _run(lambda a: spmd.ppermute(a, "model", PERMS[name]), inp["x"])
    np.testing.assert_array_equal(got, ref[f"perm/{name}"])
    assert spmd.ppermute.counts == {"model": 1}


def test_assembly_over_three_axes(data):
    inp, ref = data
    got = _run(lambda a: a * (1 + spmd.axis_index("pod")), inp["z"],
               P("data", ("pod", "model")), P("data", ("pod", "model")),
               MESH3)
    np.testing.assert_array_equal(got, ref["assemble"])


def test_splits_and_replicated_outputs():
    """P() hands every rank the whole input; P("data") and P(("pod",
    "data")) hand out blocks row-major; a P() output is the first rank's,
    a split output is assembled in rank order."""
    mesh = M.make_mesh((2, 4), ("pod", "data"), ["cpu"] * 8)
    x = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    seen = {}

    def f(a, b, c):
        r = spmd.axis_index(("pod", "data"))
        seen[r] = (a.shape, b.clone(), c.clone())
        return a + r, c * 0 + r

    whole, blocks = shard_map(
        f, mesh=mesh, in_specs=(P(), P("data"), P(("pod", "data"))),
        out_specs=(P(), P(("pod", "data"))))(x, x, x)
    assert torch.equal(whole, x)                 # rank 0's
    assert torch.equal(blocks[:, 0], torch.arange(8.))
    for r, (shape, b, c) in seen.items():
        assert shape == (8, 3)
        assert torch.equal(b, x[2 * (r % 4):2 * (r % 4) + 2])
        assert torch.equal(c, x[r:r + 1])


def test_partial_manual_axes_keep_the_rest_whole():
    """axis_names={"data"} on (data 2, model 4): 2 ranks, each holding the
    model axis whole."""
    seen = []
    out = shard_map(lambda a: seen.append(a.shape) or a * 2, mesh=MESH,
                    in_specs=P("data"), out_specs=P("data"),
                    axis_names={"data"})(torch.ones(4, 5))
    assert sorted(seen) == [(2, 5), (2, 5)] and torch.equal(
        out, torch.full((4, 5), 2.0))
    assert spmd.rank_devices(MESH, {"data"}) == [torch.device("cpu")] * 2


def test_a_rank_that_raises_stops_every_rank():
    """Rank 5 raises before the ring's second step; the others wait at
    the barrier, which the failure aborts: shard_map re-raises rank 5's
    error within seconds (the call runs in a thread joined with a 60 s
    timeout), and no rank thread is left behind: the only threads added
    are the rank indices' own, which persist (``spmd._WORKERS``), and a
    call after it runs on them at once."""
    from repro_torch.collectives.ring import ring_all_reduce
    mesh = M.make_mesh((8,), ("data",), ["cpu"] * 8)

    def f(a):
        a = spmd.ppermute(a, "data", [(i, (i + 1) % 8) for i in range(8)])
        if spmd.axis_index("data") == 5:
            raise ValueError("rank 5 lost")
        return ring_all_reduce(a, "data")

    before, workers = threading.active_count(), len(spmd._WORKERS)
    caught = []

    def call():
        try:
            shard_map(f, mesh=mesh, in_specs=P("data"),
                      out_specs=P())(torch.ones(8, 4))
        except ValueError as e:
            caught.append(e)

    t0 = time.time()
    th = threading.Thread(target=call, daemon=True)
    th.start()
    th.join(timeout=60)
    assert not th.is_alive(), "shard_map hung after a rank raised"
    assert time.time() - t0 < 10
    assert len(caught) == 1 and "rank 5 lost" in str(caught[0])
    assert threading.active_count() <= before + len(spmd._WORKERS) - workers
    t0 = time.time()
    out = shard_map(lambda a: spmd.psum(a, "data"), mesh=mesh,
                    in_specs=P("data"), out_specs=P())(torch.ones(8, 4))
    assert torch.equal(out, torch.full((1, 4), 8.0))
    assert time.time() - t0 < 10


def test_a_sender_takes_a_gradient_of_its_own():
    """Through a psum each rank's tensor takes its gradient as a tensor of
    its own (``spmd._Copy``).  Autograd hands one gradient unchanged
    through a sum and a plain copy: every sender took rank 0's, and once
    no other reference held it, adding a second gradient into it was done
    in place, on the card on the adding rank's stream, where it could
    overtake another rank's queued read of the shared tensor.  Then with
    two ranks' outputs taking gradients, as the MoE aux loss's two data
    ranks do, every sender's sum is right."""
    mesh = M.make_mesh((4,), ("model",), ["cpu"] * 4)
    for weights in ((1.0,), (1.0, 2.0)):
        xs = [torch.full((3,), float(i + 1), requires_grad=True)
              for i in range(4)]
        got, outs = {}, [None] * 4

        def f(_, xs=xs, got=got, outs=outs):
            r = spmd.rank_index()
            x = xs[r] * 1.0
            x.register_hook(lambda g, r=r: got.setdefault(r, []).append(g))
            outs[r] = spmd.psum(x, "model")
            return outs[r].detach()

        shard_map(f, mesh=mesh, in_specs=P(), out_specs=P())(torch.zeros(1))
        sum(w * o.sum() for w, o in zip(weights, outs)).backward()
        assert sorted(got) == [0, 1, 2, 3]
        ptrs = [g.data_ptr() for r in sorted(got) for g in got[r]]
        assert len(set(ptrs)) == len(ptrs) == 4, ptrs
        for x in xs:
            assert torch.equal(x.grad, torch.full((3,), sum(weights)))


def test_a_rank_index_keeps_its_host_thread_across_meshes():
    """Rank i of any mesh runs on the same host thread (PyTorch keeps a
    cuBLAS workspace a thread's handle and stream: a new thread or
    stream a call multiplied them), and two callers' shard_maps at once
    take turns instead of sharing the ranks' threads."""
    seen = {}

    def who(a):
        seen.setdefault(spmd.rank_index(), set()).add(threading.get_ident())
        return spmd.psum(a, tuple(spmd.manual_axes()))

    for shape, names in (((8,), ("data",)), ((2, 4), ("data", "model")),
                         ((4,), ("model",))):
        mesh = M.make_mesh(shape, names, ["cpu"] * int(np.prod(shape)))
        for _ in range(2):
            shard_map(who, mesh=mesh, in_specs=P(names[0]),
                      out_specs=P())(torch.ones(8, 2))
    assert sorted(seen) == list(range(8))
    assert all(len(t) == 1 for t in seen.values()), seen
    assert len(set.union(*seen.values())) == 8
    mesh = M.make_mesh((8,), ("data",), ["cpu"] * 8)
    outs = []

    def call():
        outs.append(shard_map(who, mesh=mesh, in_specs=P("data"),
                              out_specs=P())(torch.ones(8, 2)))

    callers = [threading.Thread(target=call, daemon=True) for _ in range(3)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for th in callers:
            th.start()
        for th in callers:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in callers)
    assert len(outs) == 3 and all(torch.equal(o, torch.full((1, 2), 8.0))
                                  for o in outs)


def test_collectives_refuse_autograd_and_calls_outside_a_rank():
    """Autograd through a collective is the forward's copies (one graph,
    one backward); inside a backward, or outside a rank, a collective
    raises."""
    mesh = M.make_mesh((8,), ("data",), ["cpu"] * 8)
    w = torch.arange(16, dtype=torch.float32).reshape(8, 2).requires_grad_()
    total = shard_map(lambda a: spmd.psum(a * 2, "data") ** 2, mesh=mesh,
                      in_specs=P("data"), out_specs=P())(w)
    total.sum().backward()
    want = 2 * 2 * (2 * w.detach().sum(0, keepdim=True))
    assert torch.equal(w.grad, want.expand(8, 2))

    class Bad(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.clone()

        @staticmethod
        def backward(ctx, g):
            return spmd.psum(g, "data")

    with pytest.raises(RuntimeError, match="inside an autograd backward"):
        with spmd.lone_rank(mesh):
            Bad.apply(torch.ones(2, requires_grad=True)).sum().backward()
    with pytest.raises(RuntimeError, match="outside a shard_map rank"):
        spmd.psum(torch.ones(2), "data")
    assert not spmd.in_rank() and spmd.manual_axes() == set()


def test_meshes():
    m = M.make_mesh((2, 2), ("pod", "data"), ["cpu"] * 4)
    assert m.shape == {"pod": 2, "data": 2} and m.size == 4
    assert m.devices[1, 1] == torch.device("cpu")
    h = M.make_host_mesh(["cpu"] * 3)
    assert h.axis_names == ("data",) and h.size == 3
    with pytest.raises(ValueError, match="needs 4 devices"):
        M.make_mesh((2, 2), ("pod", "data"), ["cpu"] * 3)
    if not torch.cuda.is_available():
        for build in (lambda: M.make_mesh((2,), ("data",)),
                      M.make_host_mesh,
                      lambda: M.make_production_mesh(multi_pod=True)):
            with pytest.raises(RuntimeError, match="CUDA devices"):
                build()
    big = M.make_production_mesh(devices=["cpu"] * 256)
    assert big.shape == {"data": 16, "model": 16}
    pods = M.make_production_mesh(multi_pod=True, devices=["cpu"] * 512)
    assert pods.shape == {"pod": 2, "data": 16, "model": 16}
