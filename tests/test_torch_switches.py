"""The JAX package's environment switches and class members in the port,
on the CPU: ``VAESNE_BF16`` and ``VAESNE_REMAT`` parsed as the JAX package
parses them, every ``VAESNE_*`` name the JAX package reads either read by
the port or listed here as JAX-only with its reason, ``VAESNE_DROPOUT_BITS``
giving the JAX kernel's interpret-mode mask bit for bit at each width, and
every public member of a JAX class present on the port's class of the same
name."""

import ast
import importlib
import os
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vaesne_tpu.nn.layers as jlayers
import vaesne_tpu.ops.attention as jattention
import vaesne_tpu_torch.nn.layers as tlayers
import vaesne_tpu_torch.ops.attention as tattention
from vaesne_tpu_torch.nn import TransformerStack
from vaesne_tpu_torch.utils import init_params

REPO = Path(__file__).resolve().parent.parent
JAX_PKG, PORT = REPO / "vaesne_tpu", REPO / "vaesne_tpu_torch"

# the values of a switch the parses are held to (None: unset)
SETTINGS = [None, "", "0", "1", "false", "False", "no", "true"]


def _set(monkeypatch, name, value):
    if value is None:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, value)


def _jax_remat_default():
    """The JAX package's ``TransformerStack.remat`` default expression (a
    dataclass default, read once at import), evaluated now."""
    tree = ast.parse((JAX_PKG / "nn" / "layers.py").read_text())
    (cls,) = [n for n in tree.body if isinstance(n, ast.ClassDef) and n.name == "TransformerStack"]
    (field,) = [n for n in cls.body if isinstance(n, ast.AnnAssign) and n.target.id == "remat"]
    return eval(compile(ast.Expression(field.value), "remat", "eval"), {"os": os})


@pytest.mark.parametrize("value", SETTINGS)
def test_bf16_and_remat_parses_equal_jax(monkeypatch, value):
    """``compute_dtype`` is bf16 exactly where the JAX package's is, and
    ``TransformerStack``'s remat default is the JAX expression's value:
    ``VAESNE_REMAT=false`` keeps remat on, as there."""
    _set(monkeypatch, "VAESNE_BF16", value)
    _set(monkeypatch, "VAESNE_REMAT", value)
    assert (tlayers.compute_dtype() is torch.bfloat16) == (jlayers.compute_dtype() is jnp.bfloat16)
    assert tlayers.compute_dtype() in (None, torch.bfloat16)
    assert tlayers.resolve_precision(None) == ("bf16" if tlayers.compute_dtype() else "fp32")
    assert tlayers.remat_default() == _jax_remat_default()
    assert TransformerStack(8, 2, 8, 1).remat == _jax_remat_default()
    assert TransformerStack(8, 2, 8, 1, remat=True).remat


# VAESNE_* names the JAX package reads that the port does not, and why
JAX_ONLY_SWITCHES = {
    "VAESNE_PALLAS": "a CUDA tensor launches the kernel or raises: no switch to the plain path",
    "VAESNE_PALLAS_INTERPRET": "Pallas interpret mode; the plain versions are the CPU path",
    "VAESNE_SHARD_KERNELS": "XLA custom partitioning; a rank always runs its own slice",
    "VAESNE_ATTN_QT_FWD": "the TPU kernels' query tile; the mask follows the default tile",
    "VAESNE_ATTN_QT_BWD": "the TPU kernels' query tile, backward",
    "VAESNE_DROPOUT_DRAW": "the TPU's hardware PRNG draw; the port hashes as JAX's default",
    "VAESNE_DELTA": "an A/B knob of the TPU backward; K2 always uses the delta row term",
    "VAESNE_EXP2": "an A/B knob of the TPU kernels; K1 and K2 always use exp2",
    "VAESNE_AB_UNFOLD": "an A/B knob of the TPU kernels' dropout rescale",
    "VAESNE_AB_DIVIDE": "an A/B knob of the TPU kernels' softmax divide",
    "VAESNE_COMPILE_CACHE": "the XLA compile cache; the port's build cache is build/kernels/",
}


def _switches(root, literal):
    """VAESNE_* names in a package's sources: every match of the pattern
    (the JAX package), or only whole string constants, which is how the
    port reads one (``literal``)."""
    names = set()
    for path in root.rglob("*.py"):
        text = path.read_text()
        if literal:
            names |= {n.value for n in ast.walk(ast.parse(text)) if isinstance(n, ast.Constant)
                      and isinstance(n.value, str) and re.fullmatch(r"VAESNE_[A-Z0-9_]+", n.value)}
        else:
            names |= set(re.findall(r"VAESNE_[A-Z0-9_]+", text))
    return names


def test_every_jax_switch_is_read_by_the_port_or_listed_jax_only():
    """The switch counterpart of the name test: each VAESNE_* name of the
    JAX package (the query-tile prefix VAESNE_ATTN_QT_ aside) is read by the
    port or is JAX-only with a reason, never both; the README's table names
    every one."""
    jax_names = _switches(JAX_PKG, literal=False) - {"VAESNE_ATTN_QT_"}
    port_names = _switches(PORT, literal=True)
    assert len(jax_names) == 17, sorted(jax_names)
    assert not set(JAX_ONLY_SWITCHES) & port_names, set(JAX_ONLY_SWITCHES) & port_names
    assert set(JAX_ONLY_SWITCHES) <= jax_names, set(JAX_ONLY_SWITCHES) - jax_names
    missing = jax_names - port_names - set(JAX_ONLY_SWITCHES)
    assert not missing, f"read by the JAX package, not by the port: {sorted(missing)}"
    assert {"VAESNE_BF16", "VAESNE_REMAT", "VAESNE_DROPOUT_BITS"} <= port_names
    readme = (REPO / "README.md").read_text()
    assert all(f"`{n}" in readme for n in jax_names), sorted(
        n for n in jax_names if f"`{n}" not in readme)


def _jax_kernel_mask(seed, rows, heads, lq, lk, rate):
    """The JAX kernel's keep mask [rows, H, Lq, Lk], read off its
    interpret-mode forward: with q = 0 every weight is 1/Lk, and with v the
    identity over Lk = Dh keys the output is keep/Lk/(1 − rate)."""
    dh = lk
    q = jnp.zeros((rows, heads * dh, lq), jnp.float32)
    k = jnp.zeros((rows, heads * dh, lk), jnp.float32)
    v = jnp.tile(jnp.eye(dh, dtype=jnp.float32)[None], (rows, heads, 1))  # [R, H·Dh, Lk]
    out = jattention.fused_attention(q, k, v, jnp.zeros((rows, lk), jnp.float32), heads, rate,
                                     True, jnp.int32(seed))
    return np.asarray(out).reshape(rows, heads, dh, lq).transpose(0, 1, 3, 2) > 0


@pytest.mark.parametrize("bits", ["8", "16", "32"])
def test_dropout_width_gives_the_jax_kernel_mask(monkeypatch, bits):
    """At each VAESNE_DROPOUT_BITS width the port's plain mask equals the
    JAX kernel's interpret-mode mask bit for bit (rate 0.1, Lq = 200 in
    one query tile of 256), the plain forward drops exactly those weights,
    and the
    threshold is round(2ʷ·rate) (a keep rate of 1 − 26/256 at 8 bits)."""
    monkeypatch.setenv("VAESNE_DROPOUT_BITS", bits)
    monkeypatch.setenv("VAESNE_SHARD_KERNELS", "0")
    w = int(bits)
    seed, rows, heads, lq, lk = 2**31 - 77, 2, 2, 200, 32
    want = _jax_kernel_mask(seed, rows, heads, lq, lk, 0.1)
    got = tattention.dropout_keep(seed, rows, heads, lq, lk, 0.1).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, tattention.dropout_keep(seed, rows, heads, lq, lk, 0.1,
                                                               bits=w).numpy())
    assert tattention.drop_threshold(0.1) == round(0.1 * 2**w)
    q = torch.zeros(rows, lq, heads * lk)
    v = torch.eye(lk).repeat(1, heads)[None].expand(rows, lk, heads * lk).contiguous()
    out = tattention.fused_attention(q, torch.zeros(rows, lk, heads * lk), v, None, heads, 0.1,
                                     seed)
    kept = out.reshape(rows, lq, heads, lk).permute(0, 2, 1, 3) > 0
    np.testing.assert_array_equal(kept.numpy(), want)
    if w == 8:
        assert tattention.drop_threshold(0.1) == 26


def test_dropout_width_outside_8_16_32_raises_as_in_jax(monkeypatch):
    monkeypatch.setenv("VAESNE_DROPOUT_BITS", "12")
    with pytest.raises(ValueError, match="VAESNE_DROPOUT_BITS=12 must be 8, 16 or 32"):
        jattention._dropout_bits()
    with pytest.raises(ValueError, match="VAESNE_DROPOUT_BITS=12 must be 8, 16 or 32"):
        tattention.dropout_bits()
    x = torch.zeros(1, 300, 8)
    with pytest.raises(ValueError, match="VAESNE_DROPOUT_BITS=12"):
        tattention.fused_attention(x, x, x, None, 2, 0.1, 0)


def test_remat_rerun_keeps_the_forward_width(monkeypatch):
    """A rematerialised stack's backward re-runs the forward's attention
    with the width the forward had, though the environment changed in
    between: its gradients equal a run at that width throughout (bitwise on
    the CPU), and differ from a run at the new width."""
    torch.manual_seed(0)
    stack = init_params(TransformerStack(8, 2, 8, 2, dropout=0.1, remat=True),
                        torch.Generator().manual_seed(0)).train()
    x = torch.randn(2, 300, 8)  # 300 x 300 routes to the fused attention

    def grads(fwd_bits, bwd_bits):
        monkeypatch.setenv("VAESNE_DROPOUT_BITS", fwd_bits)
        xi = x.clone().requires_grad_()
        out = stack(xi, seed=5)
        monkeypatch.setenv("VAESNE_DROPOUT_BITS", bwd_bits)
        g = torch.autograd.grad(out.square().sum(), [xi, *stack.parameters()],
                                allow_unused=True)  # no context: the cross-attention idles
        return [t.clone() for t in g if t is not None]

    same = grads("32", "32")
    for a, b in zip(grads("32", "8"), same):
        assert torch.equal(a, b)
    assert not torch.equal(grads("8", "8")[0], same[0])


# members of JAX classes with no port counterpart, and why
JAX_ONLY_MEMBERS = {
    "setup": "flax builds submodules in setup; a torch module builds them in __init__",
    "tree_flatten": "a JAX pytree hook; torch needs none to carry a distribution",
    "tree_unflatten": "a JAX pytree hook",
    "replace": "flax.struct's copy-with-changes of the immutable TrainState; the port's "
               "TrainState is a mutable dataclass (dataclasses.replace)",
}


def _class_members(path, cls):
    """A JAX class's public methods, properties and class-level names: those
    its body defines and the callables its class dict holds (flax.struct
    adds ``replace``). Fields are constructor arguments in the port (the
    config test and the weight bridge hold them)."""
    names = {n for n, v in vars(cls).items()
             if callable(v) or isinstance(v, (property, classmethod, staticmethod))}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ClassDef) and node.name == cls.__name__:
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    names.add(item.name)
                elif isinstance(item, ast.Assign):
                    names |= {t.id for t in item.targets if isinstance(t, ast.Name)}
    return {n for n in names if not n.startswith("_")}


def test_every_jax_class_member_has_a_port_counterpart():
    """Every public member of every public JAX class is on the port's class
    of the same name, but the JAX-only ones; each JAX-only entry is still a
    member of some JAX class."""
    missing, used = [], set()
    for path in sorted(JAX_PKG.rglob("*.py")):
        rel = path.relative_to(JAX_PKG).with_suffix("")
        name = ".".join(rel.parts).removesuffix(".__init__")
        jmod = importlib.import_module(f"vaesne_tpu.{name}".rstrip("."))
        tmod = importlib.import_module(f"vaesne_tpu_torch.{name}".rstrip("."))
        for node in ast.parse(path.read_text()).body:
            if not isinstance(node, ast.ClassDef) or node.name.startswith("_"):
                continue
            members = _class_members(path, getattr(jmod, node.name))
            used |= members & set(JAX_ONLY_MEMBERS)
            port_cls = getattr(tmod, node.name)
            missing += [f"{name}.{node.name}.{m}" for m in sorted(members - set(JAX_ONLY_MEMBERS))
                        if not hasattr(port_cls, m)]
    assert not missing, missing
    assert used == set(JAX_ONLY_MEMBERS), set(JAX_ONLY_MEMBERS) - used
