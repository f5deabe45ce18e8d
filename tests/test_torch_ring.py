"""The port's explicit ring collectives, gradient sync and int8 compression
against the reference's, on 8 ranks.

The reference runs under ``shard_map`` on 8 virtual CPU devices, which jax
fixes at its first import: so its side runs once for the file, in a child
python with ``XLA_FLAGS=--xla_force_host_platform_device_count=8`` (as
``tests/test_collectives.py`` runs it) and ``jax.threefry_partitionable
(False)``, and hands its results back as ``.npz``.  Inputs are drawn with
numpy from a seed; bf16 inputs are float32 arrays holding bf16 values.
The port runs over the CPU named 8 times.

- ``ring_all_reduce`` (plain, ``channels=2``, ``bidirectional``) over the
  reference test's sweep (``tests/test_collectives.py:29-86``): float32
  bit for bit (the same adds in the same order), bf16 inputs at the
  reference's 2e-2 against the reference's result and the plain sum;
  ``ring_reduce_scatter`` + ``ring_all_gather``, ``ring_all_reduce_nd``
  and ``hierarchical_all_reduce`` on (pod 2, data 4), with and without
  int8 ``compress``, bit for bit.
- ``sync_grads_local`` in its three modes (``bucket_bytes=64``): ring and
  hierarchical bit for bit, psum (XLA's all-reduce adds in its own order)
  at 1e-6.
- ``encode_int8`` / ``decode_int8`` / ``ef_compress_update`` at 1e-6.
- ``ppermute`` counts: 2(N-1) per ring per channel.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch.collectives import (hierarchical_all_reduce,  # noqa: E402
                                     ring_all_gather, ring_all_reduce,
                                     ring_all_reduce_nd, ring_reduce_scatter,
                                     sync_grads_local)
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.optim.compress import (decode_int8,  # noqa: E402
                                        ef_compress_update, encode_int8)
from repro_torch.parallel.spmd import P, ppermute, shard_map  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SHAPES = [(8, 16), (16, 7, 3), (64,)]
VARIANTS = {"plain": {}, "channels2": {"channels": 2},
            "bidirectional": {"bidirectional": True}}
GRAD_SHAPES = {"a": (8, 6, 5), "c": (8, 33)}

SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.collectives.ring import (ring_all_gather, ring_all_reduce,
                                    ring_all_reduce_nd, ring_reduce_scatter,
                                    hierarchical_all_reduce)
from repro.collectives.scheduler import sync_grads_local
from repro.compat import make_mesh, shard_map
from repro.optim.compress import (decode_int8, ef_compress_update,
                                  encode_int8)

inp = dict(np.load(sys.argv[1]))
out = {}
mesh = make_mesh((8,), ("data",))
mesh2 = make_mesh((2, 4), ("pod", "data"))
VARIANTS = {"plain": {}, "channels2": {"channels": 2},
            "bidirectional": {"bidirectional": True}}
with jax.threefry_partitionable(False):
    for name in [k for k in inp if k.startswith("sweep/")]:
        dtype = jnp.bfloat16 if name.endswith("bfloat16") else jnp.float32
        x = jnp.asarray(inp[name]).astype(dtype)
        for v, kw in VARIANTS.items():
            f = jax.jit(shard_map(
                lambda a, kw=kw: ring_all_reduce(a.astype(jnp.float32),
                                                 "data", **kw),
                mesh=mesh, in_specs=P("data"), out_specs=P()))
            out[f"{name}/{v}"] = np.asarray(f(x))
        f = jax.jit(shard_map(lambda a: ring_all_reduce_nd(
            a.astype(jnp.float32), "data"), mesh=mesh, in_specs=P("data"),
            out_specs=P()))
        out[f"{name}/nd"] = np.asarray(f(x))
    f = jax.jit(shard_map(
        lambda a: ring_all_gather(ring_reduce_scatter(a, "data"), "data"),
        mesh=mesh, in_specs=P(), out_specs=P()))
    out["rsag"] = np.asarray(f(jnp.asarray(inp["rsag"])))
    for key, comp in (("hier", None), ("hier_int8", (encode_int8,
                                                     decode_int8))):
        f = jax.jit(shard_map(
            lambda a, comp=comp: hierarchical_all_reduce(
                a, "data", "pod", compress=comp),
            mesh=mesh2, in_specs=P(("pod", "data")), out_specs=P()))
        out[key] = np.asarray(f(jnp.asarray(inp[key])))
    grads = {"a": jnp.asarray(inp["grads/a"]),
             "b": {"c": jnp.asarray(inp["grads/c"])}}
    spec = {"a": P(("pod", "data")), "b": {"c": P(("pod", "data"))}}
    for mode in ["ring", "hierarchical", "psum"]:
        f = jax.jit(shard_map(
            lambda g, mode=mode: sync_grads_local(g, ("pod", "data"),
                                                  mode=mode,
                                                  bucket_bytes=64),
            mesh=mesh2, in_specs=(spec,), out_specs=spec))
        got = f(grads)
        out[f"sync/{mode}/a"] = np.asarray(got["a"])
        out[f"sync/{mode}/c"] = np.asarray(got["b"]["c"])
    q, meta = encode_int8(jnp.asarray(inp["int8"]))
    out["int8/q"], out["int8/scale"] = np.asarray(q), np.asarray(meta.scale)
    out["int8/deq"] = np.asarray(decode_int8(q, meta))
    q, res, meta = ef_compress_update(jnp.asarray(inp["ef"]),
                                      jnp.asarray(inp["ef_res"]))
    out["ef/q"], out["ef/res"] = np.asarray(q), np.asarray(res)
    out["ef/scale"] = np.asarray(meta.scale)
np.savez(sys.argv[2], **out)
print("REFERENCE_DONE")
"""


def _bf16(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    inp = {}
    for shape in SHAPES:
        x = rng.standard_normal(shape).astype(np.float32)
        inp[f"sweep/{shape}/float32"] = x
        inp[f"sweep/{shape}/bfloat16"] = _bf16(x)
    inp["rsag"] = rng.standard_normal((8, 32)).astype(np.float32)
    inp["hier"] = rng.standard_normal((8, 40)).astype(np.float32)
    # compress needs shards of whole BLOCKs: the reference's decode returns
    # the padded length
    inp["hier_int8"] = rng.standard_normal((8, 4096)).astype(np.float32)
    for k, shape in GRAD_SHAPES.items():
        inp[f"grads/{k}"] = rng.standard_normal(shape).astype(np.float32)
    inp["int8"] = (rng.standard_normal(2500) * 3).astype(np.float32)
    # error feedback subtracts the decoded (padded) values: whole BLOCKs
    inp["ef"] = (rng.standard_normal(3072) * 3).astype(np.float32)
    inp["ef_res"] = (rng.standard_normal(3072) * 1e-2).astype(np.float32)
    return inp


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("ring")
    inp = _inputs()
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


MESH8 = make_mesh((8,), ("data",), ["cpu"] * 8)
MESH24 = make_mesh((2, 4), ("pod", "data"), ["cpu"] * 8)


def _run(fn, x, spec, mesh=MESH8, out=P()):
    return shard_map(fn, mesh=mesh, in_specs=spec, out_specs=out)(x).numpy()


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_ring_all_reduce_sweep(data, shape, dtype, variant):
    inp, ref = data
    name = f"sweep/{shape}/{dtype}"
    x = torch.from_numpy(inp[name]).to(getattr(torch, dtype))
    kw = VARIANTS[variant]
    got = _run(lambda a: ring_all_reduce(a.float(), "data", **kw), x,
               P("data"))
    want = ref[f"{name}/{variant}"]
    plain = inp[name].reshape((8, shape[0] // 8) + shape[1:]).sum(0)
    if dtype == "float32":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=1e-2)
    np.testing.assert_allclose(got, plain, rtol=2e-2, atol=1e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_ring_all_reduce_nd(data, shape, dtype):
    """Chunked along dim 0, padded to a multiple of 8 ranks."""
    inp, ref = data
    name = f"sweep/{shape}/{dtype}"
    x = torch.from_numpy(inp[name]).to(getattr(torch, dtype))
    got = _run(lambda a: ring_all_reduce_nd(a.float(), "data"), x,
               P("data"))
    np.testing.assert_array_equal(got, ref[f"{name}/nd"])


def test_reduce_scatter_then_all_gather(data):
    inp, ref = data
    x = torch.from_numpy(inp["rsag"])
    got = _run(lambda a: ring_all_gather(ring_reduce_scatter(a, "data"),
                                         "data"), x, P())
    np.testing.assert_array_equal(got, ref["rsag"])
    np.testing.assert_allclose(got[:8], 8 * inp["rsag"], rtol=1e-5)


@pytest.mark.parametrize("compress", [False, True], ids=["plain", "int8"])
def test_hierarchical_all_reduce(data, compress):
    inp, ref = data
    key = "hier_int8" if compress else "hier"
    comp = (encode_int8, decode_int8) if compress else None
    got = _run(lambda a: hierarchical_all_reduce(a, "data", "pod",
                                                 compress=comp),
               torch.from_numpy(inp[key]), P(("pod", "data")), MESH24)
    np.testing.assert_array_equal(got, ref[key])
    if not compress:
        np.testing.assert_allclose(got[0], inp[key].sum(0), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("mode", ["ring", "hierarchical", "psum"])
def test_sync_grads_local(data, mode):
    inp, ref = data
    grads = {"a": torch.from_numpy(inp["grads/a"]),
             "b": {"c": torch.from_numpy(inp["grads/c"])}}
    spec = {"a": P(("pod", "data")), "b": {"c": P(("pod", "data"))}}
    got = shard_map(lambda g: sync_grads_local(g, ("pod", "data"), mode=mode,
                                               bucket_bytes=64),
                    mesh=MESH24, in_specs=(spec,), out_specs=spec)(grads)
    for k, leaf in (("a", got["a"]), ("c", got["b"]["c"])):
        want = ref[f"sync/{mode}/{k}"]
        if mode == "psum":
            np.testing.assert_allclose(leaf.numpy(), want, rtol=1e-6,
                                       atol=1e-6)
        else:
            np.testing.assert_array_equal(leaf.numpy(), want)
        np.testing.assert_allclose(
            leaf.numpy()[0], inp[f"grads/{k}"].mean(0), rtol=1e-4, atol=1e-4)


def test_int8_codec_and_error_feedback(data):
    inp, ref = data
    x = torch.from_numpy(inp["int8"])
    q, meta = encode_int8(x)
    np.testing.assert_allclose(q.numpy(), ref["int8/q"], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(meta.scale.numpy(), ref["int8/scale"],
                               rtol=1e-6)
    np.testing.assert_allclose(decode_int8(q, meta).numpy(),
                               ref["int8/deq"], rtol=1e-6, atol=1e-6)
    q, res, meta = ef_compress_update(torch.from_numpy(inp["ef"]),
                                      torch.from_numpy(inp["ef_res"]))
    for name, got in (("q", q), ("res", res), ("scale", meta.scale)):
        np.testing.assert_allclose(got.numpy(), ref[f"ef/{name}"],
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_ppermute_count_is_2n_minus_2_per_ring(n, variant):
    """ring_all_reduce over n ranks: 2(n-1) ppermutes per channel (a
    bidirectional ring is two rings, one each way)."""
    kw = VARIANTS[variant]
    rings = kw.get("channels", 1) * (2 if kw.get("bidirectional") else 1)
    mesh = make_mesh((n,), ("data",), ["cpu"] * n)
    ppermute.counts.clear()
    _run(lambda a: ring_all_reduce(a, "data", **kw),
         torch.ones(n * 4, 3), P("data"), mesh)
    assert ppermute.counts == {"data": 2 * (n - 1) * rings}


def test_hierarchical_ppermute_counts():
    """(pod 2, data 4): 3 reduce-scatter and 3 all-gather steps within a
    pod, 2(2-1) per inter-pod channel."""
    ppermute.counts.clear()
    _run(lambda a: hierarchical_all_reduce(a, "data", "pod", channels=4),
         torch.ones(8, 64), P(("pod", "data")), MESH24)
    assert ppermute.counts == {"data": 6, "pod": 2 * 4}
