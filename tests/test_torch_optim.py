"""The port's AdamW against the JAX package.

The same parameters (bf16 and float32 leaves) and four steps of gradients,
made with numpy, go through the reference's ``adamw_update`` and the
port's (which updates the parameters and the state in place), with
``m``/``v`` in float32 and in bf16, the fp32 master copy on and off, and
global-norm clipping on (the gradients' norm is ~20, so every step clips)
and off.  Both compute in float32 from the same values; they may differ in
the last bits of ``b ** step`` and ``cos`` and in the order of the global
norm's sum, so float32 values are held at rtol 1e-5 (atol 1e-7) and bf16
values to one bf16 step (rtol 2 ** -7).  ``cosine_lr`` is held at rtol
1e-6, and exactly 0 at step 0.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.config import TrainConfig as RTrainConfig  # noqa: E402
from repro.optim import adamw as R  # noqa: E402

from repro_torch.config import TrainConfig  # noqa: E402
from repro_torch.optim import adamw as P  # noqa: E402

SHAPES = {"w": ((16, 8), "bfloat16"), "b": ((8,), "float32"),
          "e": ((32, 4), "bfloat16")}
TOL = {"float32": dict(rtol=1e-5, atol=1e-7),
       "bfloat16": dict(rtol=2 ** -7, atol=1e-7)}


def _np(x):
    return np.asarray(x, np.float32)


def _tree(rng, scale=1.0):
    return {k: (rng.standard_normal(shape) * scale).astype(np.float32)
            for k, (shape, _) in SHAPES.items()}


def _check(got: dict, want: dict, dtypes: dict, what: str):
    for k, w in want.items():
        g = got[k]
        np.testing.assert_allclose(_np(g.float()), _np(w), err_msg=f"{what}"
                                   f"[{k}]", **TOL[dtypes[k]])


@pytest.mark.parametrize("clip", [1.0, 0.0], ids=["clip", "noclip"])
@pytest.mark.parametrize("master", [True, False], ids=["master", "nomaster"])
@pytest.mark.parametrize("state", ["float32", "bfloat16"])
def test_adamw_matches_reference(state, master, clip):
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=6, weight_decay=0.1,
              grad_clip=clip, opt_state_dtype=state, master_weights=master)
    rng = np.random.default_rng(0)
    p0 = _tree(rng, 0.5)
    grads = [_tree(rng, 2.0) for _ in range(4)]
    pdt = {k: dt for k, (_, dt) in SHAPES.items()}
    sdt = {k: state for k in SHAPES}

    rcfg = RTrainConfig(**kw)
    rparams = {k: jnp.asarray(v, getattr(jnp, pdt[k])) for k, v in
               p0.items()}
    ropt = R.init_opt_state(rparams, rcfg)
    cfg = TrainConfig(**kw)
    params = {k: torch.tensor(v).to(getattr(torch, pdt[k])) for k, v in
              p0.items()}
    opt = P.init_opt_state(params, cfg)
    for i, g in enumerate(grads):
        rparams, ropt, rmet = R.adamw_update(
            rparams, {k: jnp.asarray(v, getattr(jnp, pdt[k]))
                      for k, v in g.items()}, ropt, rcfg)
        opt, met = P.adamw_update(
            params, {k: torch.from_numpy(v).to(getattr(torch, pdt[k]))
                     for k, v in g.items()}, opt, cfg)
        assert int(opt.step) == int(ropt.step) == i + 1
        for name in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(met[name]), float(rmet[name]),
                                       rtol=1e-5, err_msg=name)
        if i == 0:      # lr is 0 at step 0: nothing moves
            for k, v in p0.items():
                assert torch.equal(params[k], torch.from_numpy(v).to(
                    params[k].dtype)), k
        _check(params, rparams, pdt, f"step {i} params")
        _check(opt.m, ropt.m, sdt, f"step {i} m")
        _check(opt.v, ropt.v, sdt, f"step {i} v")
        if master:
            _check(opt.master, ropt.master, {k: "float32" for k in SHAPES},
                   f"step {i} master")
        else:
            assert opt.master is None
    for k in SHAPES:
        assert params[k].dtype == getattr(torch, pdt[k])
        assert opt.m[k].dtype == opt.v[k].dtype == getattr(torch, state)
    # the update moved the parameters (lr > 0 from step 1)
    assert not torch.equal(params["b"], torch.from_numpy(p0["b"]))


def test_cosine_lr_matches_reference():
    kw = dict(lr=3e-4, warmup_steps=3, total_steps=10)
    want = R.cosine_lr(RTrainConfig(**kw))
    got = P.cosine_lr(TrainConfig(**kw))
    for step in range(13):
        g = got(torch.tensor(step, dtype=torch.int32))
        assert g.dtype == torch.float32 and g.dim() == 0
        np.testing.assert_allclose(float(g),
                                   float(want(jnp.asarray(step, jnp.int32))),
                                   rtol=1e-6, atol=0, err_msg=f"step {step}")
    assert float(got(torch.tensor(0, dtype=torch.int32))) == 0.0
    assert float(got(torch.tensor(3, dtype=torch.int32))) == \
        pytest.approx(3e-4, rel=1e-6)
    assert float(got(torch.tensor(12, dtype=torch.int32))) == 0.0


def test_global_norm_matches_reference():
    rng = np.random.default_rng(3)
    tree = _tree(rng)
    want = R.global_norm({k: jnp.asarray(v) for k, v in tree.items()})
    got = P.global_norm({k: torch.from_numpy(v) for k, v in tree.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
