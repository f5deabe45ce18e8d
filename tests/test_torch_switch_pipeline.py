"""The port's Alg. 1 switch pipeline against the JAX package.

``kernel.switch_pipeline`` on CPU tensors runs the CUDA kernel's plain
version (``ref.pipeline_plain``).  It is held against the reference's
``switch_pipeline`` (the Pallas kernel in interpret mode) and against the
oracles over ``core/symphony.py`` (the reference's ``pipeline_ref`` and the
port's), on the packet traces of ``tests/test_kernels.py`` (3,000 and
8,000 packets) and on a 1,000-packet trace (not a multiple of the
reference's 256-packet blocks), on both marking paths.

Contract: ``exact=True`` equals the reference kernel bit for bit, and its
marks and state equal the oracles'.  ``exact=False`` (the log2 LUT path)
has the same exact state trajectory; its marks equal the reference
kernel's except where the platform's ``log2`` rounds differently just
below a power of two and flips a LUT index — on these traces that happens
for no packet (asserted: 0 differing marks) — and its mark rate stays
within the reference's own bound of the exact rate
(``test_switch_pipeline_lut_close``).  The CUDA kernel itself is held
against this plain version on the card by ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.core.symphony import SymphonyParams as RSymphonyParams  # noqa: E402,E501
from repro.kernels.switch_pipeline.kernel import switch_pipeline as r_sp  # noqa: E402,E501
from repro.kernels.switch_pipeline.ref import pipeline_ref as r_oracle  # noqa: E402,E501

from repro_torch.kernels.switch_pipeline import kernel as SK  # noqa: E402
from repro_torch.kernels.switch_pipeline import ref as SR  # noqa: E402

# (packets, seed, steps advance every `div` packets, step jitter `hi`)
TRACES = {"3000": (3000, 42, 300, 6), "8000": (8000, 7, 200, 4),
          "1000": (1000, 3, 100, 5)}


def _trace(name):
    n, seed, div, hi = TRACES[name]
    rng = np.random.default_rng(seed)
    steps = np.maximum(0, rng.integers(0, hi, n) + np.arange(n) // div)
    psns = rng.integers(1, 5000, n)
    lasts = rng.random(n) < 0.02
    wins = np.arange(n) % 100 == 99
    us = rng.random(n)
    return (steps.astype(np.int32), psns.astype(np.float32),
            lasts.astype(np.int32), wins.astype(np.int32),
            us.astype(np.float32))


def _port(arrays, **kw):
    out = SK.switch_pipeline(*(torch.from_numpy(a) for a in arrays), **kw)
    return [x.numpy() for x in out]


def _reference(arrays, **kw):
    out = r_sp(*(jnp.asarray(a) for a in arrays), **kw)
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("trace", list(TRACES))
def test_exact_path_bitwise_vs_reference_kernel_and_oracles(trace):
    arrays = _trace(trace)
    port = _port(arrays, exact=True)
    ref = _reference(arrays, exact=True)
    for name, a, b in zip(("marks", "step_min", "psn_rec", "alpha"), port,
                          ref):
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    oracle = [np.asarray(x) for x in
              r_oracle(*(jnp.asarray(a) for a in arrays), RSymphonyParams())]
    mine = [x.numpy() for x in SR.pipeline_ref(
        *(torch.from_numpy(a) for a in arrays))]
    for o in (oracle, mine):
        assert np.array_equal(port[0], o[0])            # marks
        assert np.array_equal(port[1], o[1])            # step_min
        np.testing.assert_array_equal(port[2], o[2])    # psn_rec
        np.testing.assert_array_equal(port[3], o[3])    # alpha
    assert 0 < port[0].sum() < len(port[0])


@pytest.mark.parametrize("trace", list(TRACES))
def test_lut_path_vs_reference_kernel(trace):
    arrays = _trace(trace)
    lut = _port(arrays, exact=False)
    exact = _port(arrays, exact=True)
    ref = _reference(arrays, exact=False)
    # the state trajectory is exact whatever the marking path
    for a, b, c in zip(lut[1:], exact[1:], ref[1:]):
        assert np.array_equal(a, b) and np.array_equal(a, c)
    n_diff = int((lut[0] != ref[0]).sum())
    assert n_diff == 0, f"{n_diff} LUT marks differ from the reference"
    re, rl = float(exact[0].mean()), float(lut[0].mean())
    assert abs(re - rl) < 0.02 + 0.25 * re


def test_lut_log2_matches_reference_on_integers_and_powers_of_two():
    """The LUT value of every psn the traces can carry (1..4999), of the
    alpha values (1..64) and of k equals the reference's."""
    from repro.kernels.switch_pipeline.kernel import _LOG2_LUT, _lut_log2
    x = np.concatenate([np.arange(1, 5000), [0.01]]).astype(np.float32)
    mine = SR.lut_log2(torch.from_numpy(x),
                       torch.from_numpy(SR.LOG2_LUT)).numpy()
    ref = np.asarray(_lut_log2(jnp.asarray(x), jnp.asarray(_LOG2_LUT)))
    assert np.array_equal(SR.LOG2_LUT, _LOG2_LUT)
    assert np.array_equal(mine, ref)


def test_kernel_lut_constants_equal_the_plain_lut():
    """The CUDA source's LUT literals are LOG2_LUT bit for bit."""
    import re
    from pathlib import Path
    src = (Path(SK.__file__).parent / "csrc" / "switch_pipeline.cu"
           ).read_text()
    body = src[src.index("LOG2_LUT[16] = {"):].split("}", 1)[0]
    lits = re.findall(r"(0x[0-9a-f.]+p[+-]?\d+)f", body)
    consts = np.array([float.fromhex(x) for x in lits], np.float32)
    assert len(consts) == 16
    assert np.array_equal(consts, SR.LOG2_LUT)


def test_state_starts_fresh_on_every_call():
    arrays = _trace("1000")
    first = _port(arrays)
    again = _port(arrays)
    for a, b in zip(first, again):
        assert np.array_equal(a, b)
    assert first[3][0] == 1.0                       # alpha(0) = 1


def test_cpu_wrapper_runs_plain_version_without_launching():
    arrays = [torch.from_numpy(a) for a in _trace("1000")]
    before = SK.switch_pipeline.launches
    out = SK.switch_pipeline(*arrays, exact=False)
    plain = SR.pipeline_plain(*arrays, exact=False)
    assert SK.switch_pipeline.launches == before
    for a, b in zip(out, plain):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["dtype", "shape", "rank", "contiguity",
                                  "device_mix"])
def test_wrapper_rejects_bad_operands(case):
    arrays = [torch.from_numpy(a) for a in _trace("1000")]
    err = ValueError
    if case == "dtype":
        arrays[1] = arrays[1].to(torch.float64)
        err = TypeError
    elif case == "shape":
        arrays[4] = arrays[4][:-1]
    elif case == "rank":
        arrays = [a[None] for a in arrays]
    elif case == "contiguity":
        arrays[2] = torch.stack([arrays[2], arrays[2]], 1)[:, 0]
    else:
        arrays[3] = arrays[3].to("meta")
    with pytest.raises(err):
        SK.switch_pipeline(*arrays)
