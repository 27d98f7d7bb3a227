"""The JAX package's attention backward in bf16 against its fp32 run on a
near-uniform, key-padded 983 x 983 input, the contrastive spectra context's
(ROADMAP Queue 3). The input comes from ``chip_smoke.near_uniform_attention_inputs``
(numpy, from a seed), so the port's K2 on the card (chip_smoke phase 16(e))
sees the same values. The JAX kernels run in interpret mode on the CPU, as
the JAX package's own tests run them; the committed number is recomputed.

    PYTHONPATH=. python tests/test_torch_queue3.py   # rewrites the JSON
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

import chip_smoke
from vaesne_tpu.ops.attention import fused_attention

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RATES = {"0": None, "0.1": 1302}  # dropout rate → the kernels' seed (phase 13(c)'s)
# the port's query tile, hash_tile(983): with it the JAX mask is the port's
# in both dtypes (the tests' "highest" matmul precision caps JAX's fp32 tile
# at 512 otherwise); the kernels run unsharded
ENV = {"VAESNE_ATTN_QT_FWD": "1024", "VAESNE_ATTN_QT_BWD": "1024",
       "VAESNE_SHARD_KERNELS": "0", "VAESNE_DROPOUT_BITS": "8"}


def jax_errors():
    """{rate: [dq, dk, dv]}: max |bf16 − fp32| / max |fp32| of the JAX
    kernels' gradients, each dtype's forward output feeding its backward
    (the delta row term Σ dout·o reads it), on the same bf16-grid inputs."""
    q, k, v, dout, mask = chip_smoke.near_uniform_attention_inputs()
    bias = jnp.asarray(np.where(mask, -1e9, 0.0).astype(np.float32))
    out = {}
    for rate, seed in RATES.items():
        grads = {}
        for dtype in (jnp.float32, jnp.bfloat16):
            def packed(a):
                return jnp.asarray(a).astype(dtype).transpose(0, 2, 1)

            def attention(q_, k_, v_):
                return fused_attention(q_, k_, v_, bias, chip_smoke.HEADS, float(rate), True,
                                       None if seed is None else jnp.int32(seed))

            _, vjp = jax.vjp(attention, packed(q), packed(k), packed(v))
            grads[dtype] = [np.asarray(g.astype(jnp.float32)) for g in vjp(packed(dout))]
        out[rate] = [float(np.abs(a - b).max() / np.abs(b).max())
                     for a, b in zip(grads[jnp.bfloat16], grads[jnp.float32])]
    return out


def test_jax_bf16_backward_error_is_the_committed_number(monkeypatch):
    """Recomputed within 1e-6 relative of the committed number (a CPU's
    summation order moves the last bits of the gradients), and the input has
    the stated statistics: max |logit| 0.093 over the observed keys, 52.1%
    of keys masked."""
    for name, value in ENV.items():
        monkeypatch.setenv(name, value)
    with open(os.path.join(REPO, chip_smoke.QUEUE3)) as f:
        committed = json.load(f)
    assert committed["seed"] == chip_smoke.QUEUE3_SEED
    assert committed["rows"] == chip_smoke.QUEUE3_ROWS
    q, k, _, _, mask = chip_smoke.near_uniform_attention_inputs()
    assert abs(mask.mean() - 0.521) < 1e-3
    dh = chip_smoke.MODEL_DIM // chip_smoke.HEADS
    logits = np.einsum("rqhd,rkhd->rhqk", *(a.reshape(*a.shape[:2], chip_smoke.HEADS, dh)
                                            for a in (q, k))) / np.sqrt(dh)
    assert abs(np.abs(logits[..., ~mask[0]]).max() - 0.093) < 1e-3
    got = jax_errors()
    assert got.keys() == committed["jax_dq_dk_dv"].keys()
    for rate, errs in got.items():
        np.testing.assert_allclose(errs, committed["jax_dq_dk_dv"][rate], rtol=1e-6)


if __name__ == "__main__":
    os.environ.update(ENV)
    jax.config.update("jax_default_matmul_precision", "highest")  # as tests/conftest.py
    errors = jax_errors()
    path = os.path.join(REPO, chip_smoke.QUEUE3)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"about": "max |bf16 - fp32| / max |fp32| of the JAX package's attention "
                            "backward (_bwd_pallas, interpret mode, CPU) for dq, dk, dv on "
                            "chip_smoke.near_uniform_attention_inputs(seed, rows); the 2e-2 "
                            "bf16 gate of chip_smoke phase 3 is the yardstick",
                   "seed": chip_smoke.QUEUE3_SEED, "rows": chip_smoke.QUEUE3_ROWS,
                   "jax_dq_dk_dv": errors}, f, indent=1)
        f.write("\n")
    print(json.dumps(errors), file=sys.stderr)
