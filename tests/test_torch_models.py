"""The port's model path against the JAX package, on danube's SMOKE config.

The reference's parameters (``model.init(PRNGKey(0))``) are carried into
the port by ``params_from_reference``.  Layers, the attention block (flash
and plain), ``LM.apply`` (flash and plain, B = 2, S = 256, where the window
of 64 bites) and ``decode_step`` (16 tokens) are compared with the
reference's:

- in float32 (weights cast to float32 on both sides) at rtol 1e-4, atol
  1e-3: the logits reach about 146 here, and the reference's own flash and
  plain paths differ by 3.8e-5 at most;
- in bf16 at the reference's own tolerance for this model, atol 0.15,
  rtol 0.1 (``tests/test_models.py:108-110``).

The KV caches are bf16 on both sides.  In float32 one cache entry (layer
1, written at token 12) rounds to another bf16 value than the reference's,
and the next token's logits then differ by up to 2.2e-3 (measured on this
config); ``decode_step`` in float32 is therefore held to atol 1e-2, rtol
1e-4 (below the bf16 tolerance), and its caches to at most one differing
entry in 1,000 (in bf16 the projections round differently on the two sides,
and a fifth of the written entries differ by an ulp).  The JAX side runs the Pallas kernel in interpret mode.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.config import param_count as r_param_count  # noqa: E402
from repro.configs import registry as r_registry  # noqa: E402
from repro.models import build_model as r_build_model  # noqa: E402
from repro.models import attention as r_attention  # noqa: E402
from repro.models import layers as r_layers  # noqa: E402
from repro.models.params import cast_tree as r_cast_tree  # noqa: E402

from repro_torch.config import param_count  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import (LM, EncDec, build_model,  # noqa: E402
                                params_from_reference, params_to_reference)
from repro_torch.models import attention as P_attention  # noqa: E402
from repro_torch.models import layers as P_layers  # noqa: E402
from repro_torch.models.model import NOT_PORTED, make_model  # noqa: E402
from repro_torch.models.params import cast_tree, count_params  # noqa: E402

ARCH = "h2o_danube_3_4b"
TOL = {"float32": dict(rtol=1e-4, atol=1e-3),
       "bfloat16": dict(rtol=0.1, atol=0.15)}
# decode reads a bf16 KV cache: one entry rounded differently moves the
# float32 logits by up to 2.2e-3 here
DECODE_TOL = {"float32": dict(rtol=1e-4, atol=1e-2),
              "bfloat16": TOL["bfloat16"]}
B, S = 2, 256
# the MoE and hybrid families at smoke width (jamba's smoke is one period)
FAMILIES = ["granite_moe_1b_a400m", "kimi_k2_1t_a32b", "jamba_v0_1_52b"]


def _np(x):
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def reference():
    """The reference's danube SMOKE parameters and their float32 numpy
    tree."""
    cfg = r_registry.get_config(ARCH, smoke=True)
    params = r_build_model(cfg).init(jax.random.PRNGKey(0))
    return params, jax.tree.map(_np, params)


@pytest.fixture(scope="module")
def tokens():
    cfg = registry.get_config(ARCH, smoke=True)
    return np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _configs(dtype):
    rc = dataclasses.replace(r_registry.get_config(ARCH, smoke=True),
                             dtype=dtype)
    pc = dataclasses.replace(registry.get_config(ARCH, smoke=True),
                             dtype=dtype)
    return rc, pc


def _models(reference, dtype, use_flash=False):
    """(reference model, its params, port model) in ``dtype``."""
    params, tree = reference
    rc, pc = _configs(dtype)
    port = params_from_reference(pc, tree, "cpu", use_flash=use_flash)
    if dtype == "float32":
        params = r_cast_tree(params, jnp.float32)
        cast_tree(port, torch.float32)
    return r_build_model(rc, use_flash=use_flash), params, port


# ------------------------------------------------------------- layers


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_norm(norm, dtype):
    rng = np.random.default_rng(1)
    cfg = dataclasses.replace(r_registry.get_config(ARCH, smoke=True),
                              norm=norm)
    pcfg = dataclasses.replace(registry.get_config(ARCH, smoke=True),
                               norm=norm)
    x, scale, bias = _rand(rng, 2, 16, 128), _rand(rng, 128), _rand(rng, 128)
    p = {"scale": scale, "bias": bias}
    want = r_layers.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                               jnp.asarray(x, getattr(jnp, dtype)), cfg)
    got = P_layers.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                              torch.from_numpy(x).to(getattr(torch, dtype)),
                              pcfg)
    assert got.dtype == getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(_np(got.float()), _np(want), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("arch", [ARCH, "nemotron_4_15b"])   # swiglu, relu2
def test_apply_mlp(arch):
    rng = np.random.default_rng(2)
    cfg = r_registry.get_config(arch, smoke=True)
    pcfg = registry.get_config(arch, smoke=True)
    wi = (_rand(rng, 128, 2, cfg.d_ff) if cfg.activation == "swiglu"
          else _rand(rng, 128, cfg.d_ff)) / 128 ** 0.5
    p = {"wi": wi, "wo": _rand(rng, cfg.d_ff, 128) / cfg.d_ff ** 0.5}
    x = _rand(rng, 2, 16, 128)
    want = r_layers.apply_mlp({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x), cfg)
    got = P_layers.apply_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                             torch.from_numpy(x), pcfg)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-4)


def test_apply_rope_head_dim_120():
    rng = np.random.default_rng(3)
    x = _rand(rng, 2, 64, 4, 120)
    pos = np.broadcast_to(np.arange(64, dtype=np.int32) * 37, (2, 64))
    want = r_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)
    got = P_layers.apply_rope(torch.from_numpy(x), torch.from_numpy(
        pos.copy()), 1e4)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("use_flash", [False, True])
def test_attention_block(reference, use_flash):
    params, tree = reference
    cfg = dataclasses.replace(r_registry.get_config(ARCH, smoke=True),
                              dtype="float32")
    pcfg = dataclasses.replace(registry.get_config(ARCH, smoke=True),
                               dtype="float32")
    attn = {k: v[0] for k, v in tree["block_0"]["attn"].items()}
    x = _rand(np.random.default_rng(4), B, S, cfg.d_model)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    want = r_attention.attention_block(
        {k: jnp.asarray(v) for k, v in attn.items()}, jnp.asarray(x), cfg,
        jnp.asarray(pos), use_flash=use_flash)
    got = P_attention.attention_block(
        {k: torch.from_numpy(v) for k, v in attn.items()},
        torch.from_numpy(x), pcfg, torch.from_numpy(pos.copy()),
        use_flash=use_flash)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-4)


# ------------------------------------------------------------- the model


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_apply(reference, tokens, dtype, use_flash):
    rmodel, params, port = _models(reference, dtype, use_flash)
    want, _ = rmodel.apply(params, jnp.asarray(tokens))
    with torch.inference_mode():
        got, aux = port.apply(torch.from_numpy(tokens))
    assert got.shape == want.shape and got.dtype == getattr(torch, dtype)
    assert float(aux) == 0.0
    np.testing.assert_allclose(_np(got.float()), _np(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step(reference, tokens, dtype):
    rmodel, params, port = _models(reference, dtype)
    rcache = rmodel.init_cache(B, 32)
    pcache = port.init_cache(B, 32)
    step = jax.jit(rmodel.decode_step)
    for t in range(16):
        want, rcache = step(
            params, rcache, jnp.asarray(tokens[:, t:t + 1]),
            jnp.full((B,), t, jnp.int32))
        with torch.inference_mode():
            got, pcache = port.decode_step(
                pcache, torch.from_numpy(tokens[:, t:t + 1]),
                torch.full((B,), t, dtype=torch.int32))
        np.testing.assert_allclose(_np(got.float()), _np(want),
                                   err_msg=f"token {t}", **DECODE_TOL[dtype])
    if dtype == "bfloat16":
        return          # bf16 products round differently on the two sides
    differ = total = 0
    for layer, c in enumerate(pcache):
        for mine, theirs in ((c.k, rcache["block_0"].k[layer]),
                             (c.v, rcache["block_0"].v[layer])):
            differ += int((_np(mine.float()) != _np(theirs)).sum())
            total += mine.numel()
    assert differ <= 1e-3 * total, (differ, total)


def test_decode_matches_prefill_gqa():
    """Cached decode == teacher-forced forward, token by token (the port of
    the reference's test of the same name)."""
    cfg = registry.get_config(ARCH, smoke=True)
    model = build_model(cfg, device="cpu")
    T = 16
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, T)))
    with torch.inference_mode():
        full, _ = model.apply(toks)
        cache = model.init_cache(B, 32)
        outs = []
        for t in range(T):
            lg, cache = model.decode_step(cache, toks[:, t:t + 1],
                                          torch.full((B,), t))
            outs.append(lg[:, 0])
    dec = torch.stack(outs, dim=1)
    np.testing.assert_allclose(_np(dec.float()), _np(full.float()),
                               atol=0.15, rtol=0.1)


# ------------------------------------------------- sizes, init, factory


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", [ARCH, "nemotron_4_15b"] + FAMILIES)
def test_param_count(arch, smoke):
    """Closed form against the spec tree (no allocation: meta device), less
    the rows that pad the vocabulary to a multiple of 128 (granite: 49,155
    -> 49,280), once per embedding table."""
    cfg = registry.get_config(arch, smoke=smoke)
    assert param_count(cfg) == r_param_count(
        r_registry.get_config(arch, smoke=smoke))
    model = LM(cfg, device="meta")
    pad = (model.vocab_padded - cfg.vocab_size) * cfg.d_model * (
        1 if cfg.tie_embeddings else 2)
    assert count_params(model.param_spec()) - pad == param_count(cfg)
    if arch == "granite_moe_1b_a400m" and not smoke:
        assert param_count(cfg) == 1_334_628_352


def _check_init(model, tree, sigmas=None):
    """Each leaf's mean, spread and truncation against the reference's
    init (the bits differ: different generators); layer ``l`` against
    ``block_<l % period>[l // period]``.  With ``sigmas``, the mean and
    spread tolerances (0.1) widen to that many standard errors of a leaf
    of n values (1/sqrt(n) of sd for the mean, 1/sqrt(2n) for the spread):
    the smoke families' leaves go down to 128 values."""
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "blocks":
            g, i = divmod(int(parts[1]), model.period)
            ref = tree[f"block_{i}"]
            for k in parts[2:]:
                ref = ref[k]
            ref = ref[g]
        else:
            ref = tree
            for k in parts:
                ref = ref[k]
        got = _np(p.detach().float())
        assert got.shape == ref.shape, name
        sd = ref.std()
        if sd == 0:
            np.testing.assert_array_equal(got, ref, err_msg=name)
            continue
        n = got.size
        m_tol = max(0.1, sigmas / np.sqrt(n)) if sigmas else 0.1
        s_tol = max(0.1, sigmas / np.sqrt(2 * n)) if sigmas else 0.1
        assert abs(got.std() / sd - 1) < s_tol, name
        assert abs(got.mean()) < m_tol * sd, name
        assert np.abs(got).max() <= 3.0 * sd / 0.88 * 1.01, name


def test_init_matches_reference_distributions(reference):
    """Each leaf's mean, spread and truncation match the reference's init
    (the bits differ: different generators)."""
    _, tree = reference
    model = build_model(registry.get_config(ARCH, smoke=True), device="cpu",
                        seed=0)
    _check_init(model, tree)


# the MLA, M-RoPE and encoder-decoder families, and the reference's
# param_count of each at full width
LEFT3 = {"minicpm3_4b": 4_073_875_968, "qwen2_vl_2b": 1_543_656_960,
         "whisper_large_v3": 1_537_303_040}


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", list(LEFT3))
def test_build_model_builds_mla_mrope_encdec(arch, smoke):
    """param_count equals the reference's (and the published sizes at full
    width); the parameter tree less the rows that pad the vocabulary to a
    multiple of 128 equals it (the meta device: no allocation), and so do
    the parameters build_model draws at smoke width."""
    cfg = registry.get_config(arch, smoke=smoke)
    assert param_count(cfg) == r_param_count(
        r_registry.get_config(arch, smoke=smoke))
    if not smoke:
        assert param_count(cfg) == LEFT3[arch]
    assert NOT_PORTED == {}
    model = make_model(cfg, device=torch.device("meta"))
    assert isinstance(model, EncDec) == (cfg.family == "encdec")
    pad = (model.vocab_padded - cfg.vocab_size) * cfg.d_model
    assert count_params(model.param_spec()) - pad == param_count(cfg)
    if smoke:
        built = build_model(cfg, device="cpu")
        assert sum(p.numel() for p in built.parameters()) - pad == \
            param_count(cfg)


@pytest.mark.parametrize("change", [dict(attention="mla"),
                                    dict(pos_emb="rope"),
                                    dict(sliding_window=64)])
def test_check_ported_rejects_what_no_shipped_config_has(change):
    """An encoder-decoder with MLA, a VLM with plain RoPE, an MLA model with
    a sliding window: no shipped config has them, and the port raises."""
    arch = {"attention": "whisper_large_v3", "pos_emb": "qwen2_vl_2b",
            "sliding_window": "minicpm3_4b"}[next(iter(change))]
    cfg = dataclasses.replace(registry.get_config(arch, smoke=True),
                              **change)
    with pytest.raises(NotImplementedError, match="not ported"):
        build_model(cfg, device="cpu")


@pytest.mark.parametrize("smoke", [False, True])
def test_build_model_builds_mamba(smoke):
    """mamba2-130m builds on the CPU with the closed-form count (the
    reference's), plus the rows that pad its vocabulary to a multiple of
    128 (50,280 -> 50,304 at full width)."""
    cfg = registry.get_config("mamba2_130m", smoke=smoke)
    assert param_count(cfg) == r_param_count(
        r_registry.get_config("mamba2_130m", smoke=smoke))
    if not smoke:
        assert param_count(cfg) == 128_940_480
    model = build_model(cfg, use_ssd_kernel=True, device="cpu")
    built = sum(p.numel() for p in model.parameters())
    pad = (model.vocab_padded - cfg.vocab_size) * cfg.d_model
    assert built - pad == param_count(cfg)
    assert model.use_ssd_kernel and len(model.blocks) == cfg.num_layers
    assert all(set(b._modules) == {"ln1", "ssm"} for b in model.blocks)


def test_default_device_needs_a_card(reference):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None runs on it")
    cfg = registry.get_config(ARCH, smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_reference(cfg, reference[1])


# ------------------------------------------ the MoE and hybrid families
# (granite and kimi, MoE on every layer; jamba one period: 7 SSM layers
# and one attention layer, MoE on the odd ones)
FAMILY_S = 128          # a multiple of flash's 128 rows and of the chunk
HYBRID_BF16_ROW_L2 = 5e-2     # jamba's bf16 logits (2.6e-2 at most, seen)


@functools.lru_cache(maxsize=None)
def _family(arch):
    """The reference's SMOKE parameters of ``arch`` and their float32 numpy
    tree."""
    cfg = r_registry.get_config(arch, smoke=True)
    params = r_build_model(cfg).init(jax.random.PRNGKey(0))
    return params, jax.tree.map(_np, params)


def _family_models(arch, dtype, kernels):
    """(reference model, its params, port model) of ``arch`` in ``dtype``;
    ``kernels``: flash (and the SSD kernel) on both sides."""
    params, tree = _family(arch)
    rc = dataclasses.replace(r_registry.get_config(arch, smoke=True),
                             dtype=dtype)
    pc = dataclasses.replace(registry.get_config(arch, smoke=True),
                             dtype=dtype)
    port = params_from_reference(pc, tree, "cpu", use_flash=kernels,
                                 use_ssd_kernel=kernels)
    if dtype == "float32":
        params = r_cast_tree(params, jnp.float32)
        cast_tree(port, torch.float32)
    return r_build_model(rc, use_flash=kernels, use_ssd_kernel=kernels), \
        params, port


def _family_tokens(arch, n=FAMILY_S):
    cfg = registry.get_config(arch, smoke=True)
    return np.random.default_rng(7).integers(
        0, cfg.vocab_size, (B, n)).astype(np.int32)


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_builds_with_the_reference_layout(arch):
    """Blocks by period position: jamba's layer 7 attends, the rest scan;
    odd layers route through experts, even ones through the dense MLP;
    the parameters round-trip through the reference's tree exactly."""
    cfg = registry.get_config(arch, smoke=True)
    model = build_model(cfg, device="cpu")
    rm = r_build_model(r_registry.get_config(arch, smoke=True))
    assert model.period == rm.period and model.n_groups == rm.n_groups
    for i, b in enumerate(model.blocks):
        want = set(rm.param_spec()[f"block_{i % rm.period}"])
        assert set(b._modules) == want, (i, set(b._modules), want)
    _, tree = _family(arch)
    back = params_to_reference(params_from_reference(cfg, tree, "cpu"))
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    assert len(leaves) == len(jax.tree.leaves(back))
    for path, want in leaves:
        have = back
        for k in path:
            have = have[k.key]
        np.testing.assert_array_equal(have, want,
                                      err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_init_matches_reference_distributions(arch):
    _check_init(build_model(registry.get_config(arch, smoke=True),
                            device="cpu", seed=0), _family(arch)[1],
                sigmas=4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_apply(arch, dtype):
    """Logits and the aux loss against the reference's: float32 with the
    kernels on (their plain versions here; the reference's in interpret
    mode), bf16 plain, at the module's tolerances.  jamba in bf16 is held
    instead to a relative L2 distance per row of HYBRID_BF16_ROW_L2 and
    equal argmaxes: through its 7 SSM layers the two frameworks' bf16
    roundings part the logits by 1.1 % (rel L2; up to 1.09 on logits of
    ~25, 1 % of them outside atol 0.15 rtol 0.1), less than either side's
    bf16 run is from its float32 run (1.9 %, measured on this config)."""
    rmodel, params, port = _family_models(arch, dtype, dtype == "float32")
    toks = _family_tokens(arch)
    want, raux = rmodel.apply(params, jnp.asarray(toks))
    with torch.inference_mode():
        got, aux = port.apply(torch.from_numpy(toks))
    assert got.shape == want.shape and got.dtype == getattr(torch, dtype)
    got, want = _np(got.float()), _np(want)
    if dtype == "bfloat16" and arch == "jamba_v0_1_52b":
        rows = np.linalg.norm(got - want, axis=-1) / np.linalg.norm(
            want, axis=-1)
        assert rows.max() <= HYBRID_BF16_ROW_L2, rows.max()
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    else:
        np.testing.assert_allclose(got, want, **TOL[dtype])
    assert float(raux) > 0
    np.testing.assert_allclose(float(aux), float(raux),
                               rtol=1e-5 if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_decode_step(arch):
    """12 decode steps in float32 against the reference's (bf16 KV caches
    on both sides, hence DECODE_TOL)."""
    rmodel, params, port = _family_models(arch, "float32", False)
    toks = _family_tokens(arch, 12)
    rcache = rmodel.init_cache(B, 16)
    pcache = port.init_cache(B, 16)
    step = jax.jit(rmodel.decode_step)
    for t in range(toks.shape[1]):
        want, rcache = step(params, rcache, jnp.asarray(toks[:, t:t + 1]),
                            jnp.full((B,), t, jnp.int32))
        with torch.inference_mode():
            got, pcache = port.decode_step(
                pcache, torch.from_numpy(toks[:, t:t + 1]),
                torch.full((B,), t, dtype=torch.int32))
        np.testing.assert_allclose(_np(got.float()), _np(want),
                                   err_msg=f"token {t}",
                                   **DECODE_TOL["float32"])


def _first_k_dense_cfgs():
    """A hybrid test config with period 2 (attention every 2nd layer, MoE
    on every layer) and ``first_k_dense=1``: by position in the period
    (the reference's reading) position 0 is dense, so layers 0 and 2 are;
    by layer index only layer 0 would be."""
    from repro.config import MoEConfig as RMoE
    from repro.config import SSMConfig as RSSM
    from repro_torch.config import MoEConfig, SSMConfig
    base = registry.get_config("jamba_v0_1_52b", smoke=True)
    rbase = r_registry.get_config("jamba_v0_1_52b", smoke=True)
    kw = dict(num_layers=4, attn_every=2, moe_every=1, dtype="float32")
    moe = dict(num_experts=4, experts_per_token=2, d_ff_expert=64,
               capacity_factor=1.5, first_k_dense=1)
    ssm = dict(d_state=16, d_conv=4, expand=2, head_dim=32, chunk_size=32)
    return (dataclasses.replace(rbase, moe=RMoE(**moe), ssm=RSSM(**ssm),
                                **kw),
            dataclasses.replace(base, moe=MoEConfig(**moe),
                                ssm=SSMConfig(**ssm), **kw))


def test_first_k_dense_counts_position_in_period():
    """The reference asks ``is_moe_layer`` of the position in the period;
    so does the port: layers 0 and 2 dense, 1 and 3 MoE, where
    ``param_count`` (layer index) counts layer 2 as MoE."""
    rc, pc = _first_k_dense_cfgs()
    rmodel = r_build_model(rc)
    assert rmodel.period == 2 and "mlp" in rmodel.param_spec()["block_0"]
    port = LM(pc, device="cpu")
    kinds = [("moe" if "moe" in b._modules else "mlp") for b in port.blocks]
    assert kinds == ["mlp", "moe", "mlp", "moe"]
    assert [pc.is_moe_layer(i) for i in range(4)] == [False, True, True,
                                                      True]
    built = count_params(port.param_spec()) - (
        port.vocab_padded - pc.vocab_size) * pc.d_model
    assert param_count(pc) == r_param_count(rc) != built
    params = rmodel.init(jax.random.PRNGKey(1))
    model = cast_tree(params_from_reference(pc, jax.tree.map(_np, params),
                                            "cpu"), torch.float32)
    params = r_cast_tree(params, jnp.float32)
    toks = _family_tokens("jamba_v0_1_52b", 64)
    want, raux = rmodel.apply(params, jnp.asarray(toks))
    with torch.inference_mode():
        got, aux = model.apply(torch.from_numpy(toks))
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-5)
