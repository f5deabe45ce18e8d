"""The port's GPipe schedule (``parallel/pipeline.py``) against the
reference's and against the stages applied in turn (the case of
``tests/test_pipeline.py:16-35``: 4 stages of 2 ``tanh(h @ w)`` layers,
a batch of 8 rows of 16).

The reference's ``run_pipelined`` runs once for the file in a child python
on 4 virtual CPU devices (jax fixes the count at its first import), inside
``jax.threefry_partitionable(False)``; its outputs come back as ``.npz``.
Weights and inputs are drawn with numpy from a seed.  The port runs over
the CPU named 4 times.  Held at 1e-5; the port's own sequential
application on the same CPU gives the same bits.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.parallel.pipeline import run_pipelined  # noqa: E402
from repro_torch.parallel.spmd import ppermute  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MICROBATCHES = [1, 2, 4, 8]

SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.launch.mesh import make_mesh
from repro.parallel.pipeline import run_pipelined

inp = dict(np.load(sys.argv[1]))
mesh = make_mesh((4,), ("pod",))
W, x = jnp.asarray(inp["W"]), jnp.asarray(inp["x"])

def stage_fn(wstack, h):
    for i in range(wstack.shape[1]):
        h = jnp.tanh(h @ wstack[0, i])
    return h

out = {}
with jax.threefry_partitionable(False):
    for m in %r:
        out[f"m{m}"] = np.asarray(run_pipelined(mesh, stage_fn, W, x,
                                                microbatches=m))
np.savez(sys.argv[2], **out)
print("REFERENCE_DONE")
""" % (MICROBATCHES,)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("gpipe")
    rng = np.random.default_rng(0)
    inp = {"W": (rng.standard_normal((4, 2, 16, 16)) * 0.3).astype(
        np.float32), "x": rng.standard_normal((8, 16)).astype(np.float32)}
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


MESH = make_mesh((4,), ("pod",), ["cpu"] * 4)


def _stage_fn(wstack, h):
    for i in range(wstack.shape[1]):
        h = torch.tanh(h @ wstack[0, i])
    return h


@pytest.mark.parametrize("m", MICROBATCHES)
def test_gpipe_matches_reference_and_sequential(data, m):
    inp, ref = data
    W, x = torch.from_numpy(inp["W"]), torch.from_numpy(inp["x"])
    ppermute.counts.clear()
    got = run_pipelined(MESH, _stage_fn, W, x, microbatches=m)
    assert ppermute.counts == {"pod": m + 4 - 1}    # one a tick
    seq = x
    for s in range(4):
        seq = _stage_fn(W[s:s + 1], seq)
    np.testing.assert_allclose(got.numpy(), ref[f"m{m}"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), seq.numpy(), rtol=1e-5,
                               atol=1e-5)
    # each microbatch went through the same four stages as rows alone
    assert torch.equal(got, torch.cat([
        _stage_fn(W[3:4], _stage_fn(W[2:3], _stage_fn(W[1:2], _stage_fn(
            W[0:1], xs))))
        for xs in x.chunk(m)]))


def test_gpipe_takes_parameter_trees():
    """stage_params as a dict tree: every leaf split over the stages."""
    rng = np.random.default_rng(3)
    tree = {"w": torch.from_numpy(rng.standard_normal((4, 16, 16)).astype(
        np.float32) * 0.3), "b": {"c": torch.from_numpy(
            rng.standard_normal((4, 16)).astype(np.float32))}}
    x = torch.from_numpy(rng.standard_normal((4, 16)).astype(np.float32))

    def fn(p, h):
        return torch.tanh(h @ p["w"][0] + p["b"]["c"][0])

    got = run_pipelined(MESH, fn, tree, x, microbatches=2)
    want = x
    for s in range(4):
        want = torch.tanh(want @ tree["w"][s] + tree["b"]["c"][s])
    assert torch.equal(got, want)


def test_gpipe_refuses_a_ragged_batch():
    with pytest.raises(ValueError, match="microbatches"):
        run_pipelined(MESH, _stage_fn, torch.zeros(4, 2, 16, 16),
                      torch.zeros(6, 16), microbatches=4)
