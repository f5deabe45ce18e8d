"""The port's Symphony state machine (paper Alg. 1) against the reference.

Seeded numpy inputs go through ``repro.core.symphony`` and
``repro_torch.core.symphony``; marking probabilities, marks and the state
block must agree exactly (the arithmetic is the same float32 sequence).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.experimental  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import symphony as R  # noqa: E402

from repro_torch.core import symphony as S  # noqa: E402

PARAMS = [dict(), dict(k=0.05, tau=0.4, n_warmup=4, n_sample=8,
                       alpha_max=16.0)]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("pi", range(len(PARAMS)))
def test_marking_probability(seed, pi):
    rng = np.random.default_rng(seed)
    n = 4096
    step = rng.integers(0, 20, n).astype(np.int32)
    step_min = rng.integers(0, 20, n).astype(np.int32)
    psn = rng.uniform(0, 500, n).astype(np.float32)
    psn_rec = (rng.uniform(0, 300, n) * rng.integers(0, 2, n)
               ).astype(np.float32)
    alpha = rng.uniform(1, 64, n).astype(np.float32)
    want = np.asarray(R.marking_probability(
        jnp.asarray(step), jnp.asarray(psn), jnp.asarray(step_min),
        jnp.asarray(psn_rec), jnp.asarray(alpha),
        R.SymphonyParams(**PARAMS[pi])))
    got = S.marking_probability(
        torch.from_numpy(step), torch.from_numpy(psn),
        torch.from_numpy(step_min), torch.from_numpy(psn_rec),
        torch.from_numpy(alpha), S.SymphonyParams(**PARAMS[pi]))
    assert np.array_equal(want, got.numpy())
    assert 0.0 < float(want.max()) <= 1.0


def _stream(rng, n):
    steps = np.sort(rng.integers(0, 12, n)).astype(np.int32)
    steps = np.where(rng.random(n) < 0.2, steps - rng.integers(0, 3, n),
                     steps).astype(np.int32)
    psns = rng.uniform(0, 200, n).astype(np.float32)
    lasts = rng.random(n) < 0.1
    us = rng.random(n).astype(np.float32)
    return steps, psns, lasts, us


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_process_packet_batch_and_window_update(seed):
    rng = np.random.default_rng(seed)
    steps, psns, lasts, us = _stream(rng, 300)
    p_r = R.SymphonyParams(k=0.2, n_warmup=4, n_sample=16)
    p_s = S.SymphonyParams(k=0.2, n_warmup=4, n_sample=16)
    r_state, r_marks = R.process_packet_batch(
        R.init_state()._replace(alpha=jnp.float32(3.0)), jnp.asarray(steps),
        jnp.asarray(psns), jnp.asarray(lasts), jnp.asarray(us), p_r)
    s_state, s_marks = S.process_packet_batch(
        S.init_state(device="cpu")._replace(alpha=torch.tensor(3.0)),
        torch.from_numpy(steps), torch.from_numpy(psns),
        torch.from_numpy(lasts), torch.from_numpy(us), p_s)
    assert np.array_equal(np.asarray(r_marks), s_marks.numpy())
    assert int(np.asarray(r_marks).sum()) > 0
    for a, b in zip(r_state, s_state):
        assert np.array_equal(np.asarray(a), b.numpy())
    r_w = R.window_update(r_state, p_r)
    s_w = S.window_update(s_state, p_s)
    for a, b in zip(r_w, s_w):
        assert np.array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_init_state_dtype(dtype):
    """``init_state(dtype=...)`` types the four float fields as the
    reference's ``init_state(dtype)`` does; ``step_min`` stays int32."""
    got = S.init_state(device="cpu", dtype=getattr(torch, dtype))
    # jax >= 0.5 spells the x64 switch jax.enable_x64; older releases
    # jax.experimental.enable_x64.  Without either the reference gives the
    # float32 block, whose values the float64 one must equal.
    x64 = getattr(jax, "enable_x64", None)
    if x64 is None:
        x64 = getattr(jax.experimental, "enable_x64", None)
    if x64 is None:
        want = [np.asarray(x).astype(getattr(np, dtype) if i else np.int32)
                for i, x in enumerate(R.init_state())]
    else:
        with x64(True):
            want = [np.asarray(x) for x in R.init_state(getattr(jnp, dtype))]
    assert got.step_min.dtype == torch.int32
    for name, a, b in zip(S.SymphonyState._fields, got, want):
        assert str(a.dtype) == f"torch.{b.dtype}", name
        assert a.shape == b.shape and np.array_equal(a.numpy(), b), name
    if dtype == "float64":
        assert {str(x.dtype) for x in got[1:]} == {"torch.float64"}
    # shape and device keep their places
    block = S.init_state((2, 3), "cpu", dtype=getattr(torch, dtype))
    assert all(x.shape == (2, 3) for x in block)
    assert float(block.alpha.sum()) == 6.0
