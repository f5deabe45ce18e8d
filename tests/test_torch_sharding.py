"""The port's logical-axis sharding rules against the reference's.

``make_rules``, ``spec_for`` and ``mesh_axis_size`` are plain Python over a
mesh's axis sizes, so the reference's run here in-process on a stand-in
object with the mesh's ``shape`` (a jax mesh of 8 devices would need 8
devices at jax's first import).  Held over ``fsdp``, ``seq_shard_decode``
and overrides, on one-, two- and three-axis meshes, for every leaf axis of
the shipped configs' parameter trees (smoke widths) and the activation
axes the models constrain.  ``constrain`` returns its input itself.  A
model built under a mesh with a ``model`` axis pads heads and vocabulary
as the reference's does (its side in a child python on 3 virtual devices),
and ``params_from_reference`` carries the padded tree across.
"""
import types

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.parallel import sharding as R  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models.model import make_model  # noqa: E402
from repro_torch.models.params import tree_leaves_with_path  # noqa: E402
from repro_torch.parallel import sharding as S  # noqa: E402
from repro_torch.parallel.spmd import P, shard_map  # noqa: E402

MESHES = {"data8": ((8,), ("data",)),
          "data2_model4": ((2, 4), ("data", "model")),
          "pod2_data2_model2": ((2, 2, 2), ("pod", "data", "model"))}
RULES = {"base": {}, "fsdp": dict(fsdp=True),
         "seq_shard_decode": dict(seq_shard_decode=True),
         "fsdp_overrides": dict(fsdp=True, overrides={
             "heads": None, "batch": ("data", "pod"), "seq": ("model",)})}
ARCHS = ["h2o_danube_3_4b", "granite_moe_1b_a400m", "mamba2_130m",
         "minicpm3_4b", "whisper_large_v3", "jamba_v0_1_52b"]
ACTIVATIONS = [("batch", "seq", "act_embed"), ("batch", "seq_sp", "act_embed"),
               ("batch", "seq", "act_heads"), ("batch", None, "act_embed"),
               ("batch", "kv_seq", "kv_heads", "head_dim"),
               ("layers", "experts", "embed", None, "expert_mlp"),
               ("unknown", "batch"), (None, None)]


def _axes_sets() -> list[tuple]:
    seen = dict.fromkeys(ACTIVATIONS)
    for arch in ARCHS:
        model = make_model(registry.get_config(arch, smoke=True),
                           device="meta")
        for _, spec in tree_leaves_with_path(model.param_spec()):
            seen.setdefault(spec.axes)
    return list(seen)


AXES = _axes_sets()


@pytest.mark.parametrize("rules", list(RULES))
def test_make_rules(rules):
    assert S.make_rules(**RULES[rules]) == R.make_rules(**RULES[rules])
    assert S.BASE_RULES == R.BASE_RULES


@pytest.mark.parametrize("rules", list(RULES))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_spec_for_every_leaf_and_activation(mesh, rules):
    shape, names = MESHES[mesh]
    port_mesh = make_mesh(shape, names, ["cpu"] * int(torch.tensor(
        shape).prod()))
    ref_mesh = types.SimpleNamespace(shape=dict(zip(names, shape)))
    table = S.make_rules(**RULES[rules])
    for axes in AXES:
        got = S.spec_for(axes, table, port_mesh)
        want = R.spec_for(axes, R.make_rules(**RULES[rules]), ref_mesh)
        assert isinstance(got, P)
        assert tuple(got) == tuple(want), (axes, got, want)
        assert S.sharding_for(axes, table, port_mesh).spec == got
    for a, m in table.items():
        assert S.mesh_axis_size(port_mesh, m) == \
            R.mesh_axis_size(ref_mesh, m), a


def test_constrain_returns_its_input():
    mesh = make_mesh((2, 4), ("data", "model"), ["cpu"] * 8)
    rules = S.make_rules()
    x = torch.ones(2, 8, 4)
    assert S.constrain(x, ("batch", "seq", "act_embed"), rules, mesh) is x
    assert S.constrain(x, ("batch",), None, mesh) is x
    with pytest.raises(ValueError, match="3 dimensions"):
        S.constrain(x, ("batch", "seq", "act_embed", "act_heads"), rules,
                    mesh)
    # inside a rank manual over 'data', its axis drops out of the rules
    out = shard_map(lambda a: S.constrain(a, ("batch", "seq", "act_embed"),
                                          rules, mesh) * 1,
                    mesh=mesh, in_specs=P("data"), out_specs=P("data"),
                    axis_names={"data"})(x)
    assert torch.equal(out, x)


@pytest.mark.parametrize("n,tp,want", [(32, 1, 32), (32, 3, 33), (50, 16, 64),
                                       (32000, 512, 32256)])
def test_padded(n, tp, want):
    assert S.padded(n, tp) == R.padded(n, tp) == want


PAD_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=3"
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from repro.configs import registry
from repro.launch.mesh import make_mesh
from repro.models import build_model
from repro.models.params import cast_tree

cfg = dataclasses.replace(registry.get_config("h2o_danube_3_4b", smoke=True),
                          num_heads=4, num_kv_heads=4, vocab_size=300,
                          dtype="float32")
mesh = make_mesh((1, 3), ("data", "model"))
out = {}
with jax.threefry_partitionable(False):
    model = build_model(cfg, mesh=mesh)
    params = cast_tree(model.init(jax.random.PRNGKey(0)), jnp.float32)
    toks = jnp.asarray(np.load(sys.argv[1]))
    logits, _ = jax.jit(model.apply)(params, toks)
    out["logits"] = np.asarray(logits)
    for p, v in jax.tree_util.tree_leaves_with_path(params):
        out["p" + jax.tree_util.keystr(p)] = np.asarray(v, np.float32)
np.savez(sys.argv[2], **out)
print("REFERENCE_DONE")
"""


def test_padded_trees_carry_across_under_a_tensor_parallel_mesh(tmp_path):
    """A model built under a (data 1, model 3) mesh pads heads (4 -> 6,
    MHA: KV heads too) and vocabulary (300 -> 384) as the reference does;
    params_from_reference carries the reference's padded tree into the
    port's model on that mesh, whose logits equal the reference's
    (float32, 1e-5)."""
    import dataclasses
    import os
    import subprocess
    import sys
    from pathlib import Path

    import numpy as np

    from repro_torch.models import params_from_reference
    from repro_torch.models.params import cast_tree
    root = Path(__file__).resolve().parents[1]
    toks = np.random.default_rng(0).integers(0, 300, (2, 16)).astype(
        np.int32)
    np.save(tmp_path / "toks.npy", toks)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(root / "src")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", PAD_SCRIPT,
                        str(tmp_path / "toks.npy"), str(tmp_path / "o.npz")],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0 and "REFERENCE_DONE" in r.stdout, \
        r.stdout[-2000:] + r.stderr[-4000:]
    ref = dict(np.load(tmp_path / "o.npz"))
    tree: dict = {}
    for key, v in ref.items():
        if not key.startswith("p["):
            continue
        path = [p.strip("'") for p in key[2:-1].split("][")]
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    cfg = dataclasses.replace(registry.get_config("h2o_danube_3_4b",
                                                  smoke=True),
                              num_heads=4, num_kv_heads=4, vocab_size=300,
                              dtype="float32")
    mesh = make_mesh((1, 3), ("data", "model"), ["cpu"] * 3)
    model = cast_tree(params_from_reference(cfg, tree, "cpu", mesh=mesh),
                      torch.float32)
    assert model.tp == 3 and model.vocab_padded == 384
    assert model.blocks[0].attn["wq"].shape[1] == 6
    assert model.blocks[0].attn["wk"].shape[1] == 6
    with torch.no_grad():
        logits, _ = model.apply(torch.from_numpy(toks))
    np.testing.assert_allclose(logits.numpy(), ref["logits"], rtol=1e-5,
                               atol=1e-5)
