"""The port's ServeEngine against the reference's, on danube's SMOKE config
in float32 (``ServeConfig(batch=4, max_seq=64)``), and on the SMOKE configs
of granite, kimi (MoE), jamba (hybrid, one period), minicpm3 (MLA: the
absorbed decode over latent caches) and qwen2-vl (M-RoPE: text tokens,
whose decode positions stand for t = h = w).

The same 6 requests (prompts of 3-12 tokens from a seeded generator, 6 new
tokens each) go through both engines with the same weights
(``params_from_reference``; float32 on both sides).  Every decode call's
logits are recorded on both sides and compared in order.  The KV caches
are bf16 on both sides, and an entry that rounds to another bf16 value
moves the float32 logits (by up to 3.7e-3 in this run, measured), so the
logits are held to atol 1e-2, rtol 1e-4, below the bf16 tolerance.
Each call's argmax (the next token of its slot) must be equal wherever the
reference's top-two margin exceeds that tolerance; past a token chosen
differently at a smaller margin the runs part, and the comparison stops,
but not before the first wave of 4 requests has been compared whole.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.config import ServeConfig as RServeConfig  # noqa: E402
from repro.configs import registry as r_registry  # noqa: E402
from repro.models import build_model as r_build_model  # noqa: E402
from repro.models.params import cast_tree as r_cast_tree  # noqa: E402
from repro.runtime.serve import Request as RRequest  # noqa: E402
from repro.runtime.serve import ServeEngine as RServeEngine  # noqa: E402

from repro_torch.config import ServeConfig  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import build_model, params_from_reference  # noqa: E402,E501
from repro_torch.models.params import cast_tree  # noqa: E402
from repro_torch.runtime import Request, ServeEngine  # noqa: E402

ARCH = "h2o_danube_3_4b"
FAMILIES = ["granite_moe_1b_a400m", "kimi_k2_1t_a32b", "jamba_v0_1_52b",
            "minicpm3_4b", "qwen2_vl_2b"]
ATOL, RTOL = 1e-2, 1e-4
N_REQ, NEW, SLOTS = 6, 6, 4


def _requests():
    rng = np.random.default_rng(0)
    return [(i, rng.integers(0, 512, int(rng.integers(3, 13))).astype(
        np.int32)) for i in range(N_REQ)]


@functools.lru_cache(maxsize=None)
def _drain(arch):
    """Both engines drained on ``arch``'s SMOKE config; each with its
    requests and every decode call's (tokens fed, logits)."""
    rcfg = dataclasses.replace(r_registry.get_config(arch, smoke=True),
                               dtype="float32")
    pcfg = dataclasses.replace(registry.get_config(arch, smoke=True),
                               dtype="float32")
    rmodel = r_build_model(rcfg)
    params = rmodel.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), params)

    reng = RServeEngine(rmodel, rcfg, RServeConfig(batch=SLOTS, max_seq=64),
                        r_cast_tree(params, jnp.float32))
    rlog = []
    rdecode = reng._decode

    def rrec(p, cache, tokens, pos):
        logits, cache = rdecode(p, cache, tokens, pos)
        rlog.append((np.asarray(tokens), np.asarray(logits, np.float32)))
        return logits, cache

    reng._decode = rrec
    rreqs = [RRequest(i, p, max_new_tokens=NEW) for i, p in _requests()]
    for r in rreqs:
        reng.submit(r)
    rdone = reng.run_until_drained()

    model = cast_tree(params_from_reference(pcfg, tree, "cpu"), torch.float32)
    peng = ServeEngine(model, ServeConfig(batch=SLOTS, max_seq=64),
                       device="cpu")
    plog = []
    pdecode = peng._decode

    def prec(tokens):
        logits = pdecode(tokens)
        plog.append((tokens.copy(), logits.float().numpy()))
        return logits

    peng._decode = prec
    preqs = [Request(i, p, max_new_tokens=NEW) for i, p in _requests()]
    for r in preqs:
        peng.submit(r)
    pdone = peng.run_until_drained()
    return (rreqs, rdone, rlog), (preqs, pdone, plog)


@pytest.fixture(scope="module")
def runs():
    return _drain(ARCH)


def _finished(runs):
    for reqs, done, _ in runs:
        assert len(done) == N_REQ
        assert [len(r.out) for r in reqs] == [NEW] * N_REQ
        assert all(r.done for r in reqs)


def _matched(runs):
    (rreqs, _, rlog), (preqs, _, plog) = runs
    assert len(plog) == len(rlog)
    compared = 0
    for (rt, rl), (pt, pl) in zip(rlog, plog):
        if not np.array_equal(rt, pt):
            break               # the runs parted at a near tie (below)
        np.testing.assert_allclose(pl, rl, atol=ATOL, rtol=RTOL,
                                   err_msg=f"decode call {compared}")
        # each slot's next token is this call's argmax: equal unless the
        # reference's top two are within the tolerance
        top2 = np.sort(rl[:, -1], axis=-1)[:, -2:]
        tie = top2[:, 1] - top2[:, 0] <= ATOL + RTOL * np.abs(top2[:, 1])
        same = rl[:, -1].argmax(-1) == pl[:, -1].argmax(-1)
        assert (same | tie).all(), f"decode call {compared}"
        compared += 1
    # at least the first wave of slots, prompts and generation, before any
    # parting: all of its prompt-prefill calls and its NEW decode steps
    first = sum(len(p) for _, p in _requests()[:SLOTS]) + NEW
    assert compared >= first, (f"only {compared} of {len(rlog)} decode "
                               f"calls compared; need {first}")
    if compared == len(rlog):
        for r, p in zip(rreqs, preqs):
            assert (r.rid, r.out) == (p.rid, p.out)


def test_every_request_finishes(runs):
    _finished(runs)


def test_decode_logits_and_tokens_match_reference(runs):
    _matched(runs)


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_engines_match(arch):
    """granite, kimi, jamba, minicpm3 and qwen2-vl at smoke width: every
    request finishes on both engines, every decode call's logits and
    tokens as for danube.
    MoE layers route each call's 4 slots together (idle and prefilling
    slots on token 0), so a slot's logits depend on the other slots'
    tokens: both engines feed the same batches and must agree on them."""
    runs = _drain(arch)
    _finished(runs)
    _matched(runs)


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None runs on it")
    model = build_model(registry.get_config(ARCH, smoke=True), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(model, ServeConfig(batch=2, max_seq=16))


def test_model_on_another_device_raises():
    model = build_model(registry.get_config(ARCH, smoke=True), device="cpu")
    with pytest.raises(ValueError, match="the model is on cpu"):
        ServeEngine(model, ServeConfig(batch=2, max_seq=16), device="meta")


@pytest.mark.parametrize("window", [0, 64])
def test_prompt_past_the_kv_cache_raises(window):
    """A 9-token prompt into an 8-position KV cache (max_seq 8; with
    danube's window of 64 the cache still holds min(8, 64) positions)
    raises on the host before the ninth write, where the reference drops
    the write silently."""
    cfg = dataclasses.replace(registry.get_config(ARCH, smoke=True),
                              sliding_window=window)
    model = build_model(cfg, device="cpu")
    eng = ServeEngine(model, ServeConfig(batch=2, max_seq=8), device="cpu")
    calls = []
    decode = model.decode_step

    def counted(*args):
        calls.append(int(args[2].max()))
        return decode(*args)

    model.decode_step = counted
    eng.submit(Request(0, np.arange(9, dtype=np.int32)))
    with pytest.raises(ValueError, match="outside the KV cache of 8"):
        eng.step()
    assert calls == list(range(8))      # positions 0-7 written, 8 refused

