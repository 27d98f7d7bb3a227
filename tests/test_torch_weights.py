"""The weight bridge from the JAX package's parameter tree and back, and
the port's import hygiene: it imports torch, numpy and the standard
library, never JAX, flax or the JAX package."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import vaesne_tpu.models as jmodels
import vaesne_tpu_torch.models as tmodels
from vaesne_tpu_torch.utils import init_params, load_jax_params, to_jax_params
from vaesne_tpu_torch.utils.weights import torch_key

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "vaesne_tpu_torch"
FLAGSHIP = dict(latent_len=4, latent_dim=4, model_dim=32, ff_dim=32, num_layers=4, num_heads=4)
FORBIDDEN = ("jax", "flax", "vaesne_tpu")


def _flagship_tree():
    """The flagship model's flax parameter tree (shapes from an abstract
    init, values from numpy)."""
    jm = jmodels.PhotoSpecMMVAE(vaes=[jmodels.PhotometricVAE(num_bands=6, **FLAGSHIP),
                                      jmodels.SpectraVAE(**FLAGSHIP)], beta=1.0)
    rng = np.random.default_rng(0)
    photo = (np.zeros((2, 60), np.float32), np.zeros((2, 60), np.float32),
             np.zeros((2, 60), np.int32), np.zeros((2, 60), bool))
    spec = (np.zeros((2, 982), np.float32), np.zeros((2, 982), np.float32),
            np.zeros((2,), np.float32), np.zeros((2, 982), bool))
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda x: jm.init({"params": key, "sample": key}, x, 1),
                            (photo, spec))
    return jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)


def _torch_flagship():
    return tmodels.PhotoSpecMMVAE([tmodels.PhotometricVAE(num_bands=6, **FLAGSHIP),
                                   tmodels.SpectraVAE(**FLAGSHIP)], beta=1.0)


def test_flagship_tree_maps_one_to_one():
    tree = _flagship_tree()
    model = _torch_flagship()
    load_jax_params(model, tree)
    state = model.state_dict()
    flat = jax.tree_util.tree_flatten_with_path(tree["params"])[0]
    keys = set()
    for path, value in flat:
        names = tuple(p.key for p in path)
        k = torch_key(names)
        want = value.T if names[-1] == "kernel" else value
        np.testing.assert_array_equal(state[k].numpy(), want)
        keys.add(k)
    # every flax leaf filled a distinct port parameter, and every port
    # parameter came from a flax leaf
    assert len(keys) == len(flat) == len(state) and keys == set(state)


def test_to_jax_params_inverts_the_bridge():
    """flax tree → port → flax tree is the identity, leaf for leaf, and a
    mapping of other values (gradients, say) lands on the same paths."""
    tree = _flagship_tree()
    model = _torch_flagship()
    load_jax_params(model, tree)
    back = to_jax_params(model)
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(flat)
    for path, value in flat:
        np.testing.assert_array_equal(got[path], value)
    twice = to_jax_params(model, {n: 2 * p for n, p in model.named_parameters()})
    for path, value in jax.tree_util.tree_flatten_with_path(twice)[0]:
        np.testing.assert_allclose(value, 2 * got[path], rtol=1e-6)


def test_bridge_raises_on_mismatch():
    tree = _flagship_tree()
    model = _torch_flagship()
    missing = jax.tree_util.tree_map(lambda a: a, tree)
    del missing["params"]["vaes_1"]["dec"]["get_flux"]["fc2"]["bias"]
    with pytest.raises(ValueError, match="get_flux.fc2.bias"):
        load_jax_params(model, missing)
    extra = jax.tree_util.tree_map(lambda a: a, tree)
    extra["params"]["vaes_0"]["enc"]["brightnessfc"] = {"out": {"bias": np.zeros(1)}}
    with pytest.raises(ValueError, match="brightnessfc"):
        load_jax_params(model, extra)
    bad = jax.tree_util.tree_map(lambda a: a, tree)
    bad["params"]["vaes_0"]["enc"]["initbottleneck"] = np.zeros((3, 32), np.float32)
    with pytest.raises(ValueError, match="does not fit"):
        load_jax_params(model, bad)


def test_init_params_is_seeded():
    a, b = _torch_flagship(), _torch_flagship()
    init_params(a, torch.Generator().manual_seed(3))
    init_params(b, torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb
        torch.testing.assert_close(va, vb, rtol=0, atol=0)


def _port_modules():
    mods = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


def test_import_hygiene_in_a_fresh_process():
    mods = _port_modules() + ["chip_smoke"]
    code = ("import sys\n"
            f"for m in {mods!r}:\n"
            "    __import__(m)\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_no_forbidden_import_in_source():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


# Names of the JAX package with no port counterpart, and why: the jax.Array
# alias; the Pallas switches and tiles and the TPU's packed [B, E, L] head
# layout; the JAX sharding specs, placements and custom_partitioning helpers
# (a rank holds its own slice, ops/partition.py); flax's init (the port's
# is utils.init_params).
JAX_ONLY = {
    "Array", "use_pallas", "pallas_interpret", "pack_heads", "unpack_heads", "ROW_TILE",
    "axes_on_dim", "batch_axes", "batch_only", "n_shards", "replicated", "shard_index",
    "shard_kernels", "spec_entry", "batch_sharding", "init_model",
}


def _public_names(path: Path):
    """Functions, classes and assigned names at a module's top level (not
    its imports), without the private ones."""
    names = set()
    for node in ast.parse(path.read_text(), str(path)).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for target in node.targets if isinstance(node, ast.Assign) else [node.target]:
                if isinstance(target, ast.Name):
                    names.add(target.id)
    return {n for n in names if not n.startswith("_")}


def test_every_jax_module_and_name_has_a_port_counterpart():
    """Every module of vaesne_tpu has a module at the same path in the
    port, which defines or imports each of its public names but the
    JAX-only ones."""
    jax_root = REPO / "vaesne_tpu"
    for path in sorted(jax_root.rglob("*.py")):
        rel = path.relative_to(jax_root)
        port = PORT / rel
        assert port.exists(), f"no port module for vaesne_tpu/{rel}"
        module = __import__(".".join(("vaesne_tpu_torch",) + rel.with_suffix("").parts)
                            .removesuffix(".__init__"), fromlist=["_"])
        missing = sorted(n for n in _public_names(path) - JAX_ONLY if not hasattr(module, n))
        assert not missing, f"vaesne_tpu_torch/{rel} lacks {missing}"


def test_safelog10_and_goldstein_keys_match_jax():
    from vaesne_tpu import training as jtraining
    from vaesne_tpu.data import goldstein as jgoldstein
    from vaesne_tpu_torch import training as ttraining
    from vaesne_tpu_torch.data import goldstein as tgoldstein

    assert tgoldstein.GOLDSTEIN_KEYS == jgoldstein.GOLDSTEIN_KEYS
    for x in (0.0, -3.0, 1e-12, 0.5, 12345.678):
        assert ttraining.safelog10(x) == jtraining.safelog10(x)
