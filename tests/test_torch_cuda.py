"""The port's CUDA kernel and its card-only behaviour. These tests need an
NVIDIA card with nvcc (the kernel has no CPU mode) and skip elsewhere; on
the card run them with

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

(``--noconftest``: the suite's conftest imports JAX, which the card's machine
need not have.)
"""

import numpy as np
import pytest
import torch

import vaesne_tpu_torch.ops.attention as attention
from vaesne_tpu_torch import InferenceServer, PhotometricVAE, PhotoSpecMMVAE, SpectraVAE, init_params
from vaesne_tpu_torch.nn import MultiHeadAttention

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the attention kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(device, R, H, Dh, Lq, Lk, masked, seed=0):
    g = torch.Generator(device).manual_seed(seed)
    q = torch.randn(R, Lq, H * Dh, device=device, generator=g)
    k = torch.randn(R, Lk, H * Dh, device=device, generator=g)
    v = torch.randn(R, Lk, H * Dh, device=device, generator=g)
    mask = None
    if masked:
        mask = torch.rand(R, Lk, device=device, generator=g) < 0.3
        mask[0] = True
    return q, k, v, mask


@pytest.mark.parametrize("R,H,Dh,Lq,Lk,masked", [
    (3, 4, 8, 1, 1, False), (2, 4, 8, 31, 127, True), (2, 2, 4, 129, 257, True),
    (2, 1, 16, 200, 33, True), (2, 1, 32, 130, 129, False), (4, 4, 8, 982, 982, True),
])
def test_kernel_matches_plain_version(cuda, R, H, Dh, Lq, Lk, masked):
    """fp32 max-abs 1e-5 (sums in another order); bf16 2e-2 of max |plain|."""
    q, k, v, mask = _inputs(cuda, R, H, Dh, Lq, Lk, masked)
    ref = attention.attention_reference(q, k, v, mask, H)
    before = attention.launches
    out = attention.fused_attention(q, k, v, mask, H)
    torch.cuda.synchronize()
    assert attention.launches == before + 1
    assert (out - ref).abs().max().item() <= 1e-5
    out16 = attention.fused_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), mask, H)
    torch.cuda.synchronize()
    assert out16.dtype == torch.bfloat16
    assert ((out16.float() - ref).abs().max() / ref.abs().max()).item() <= 2e-2


def test_wrapper_raises_instead_of_falling_back(cuda):
    q, k, v, mask = _inputs(cuda, 2, 2, 8, 5, 7, True)
    with pytest.raises(TypeError):
        attention.fused_attention(q.half(), k.half(), v.half(), mask, 2)
    with pytest.raises(ValueError, match="one device"):
        attention.fused_attention(q, k, v, mask.cpu(), 2)


def test_routed_dropout_raises_on_the_card(cuda):
    mha = MultiHeadAttention(32, 4, dropout=0.1).to(cuda).train()
    x = torch.randn(1, 256, 32, device=cuda)
    with pytest.raises(NotImplementedError, match="training slice"):
        mha(x, x, x)
    mha.eval()
    before = attention.launches
    assert torch.isfinite(mha(x, x, x)).all()
    assert attention.launches == before + 1


def test_server_runs_on_the_card_by_default(cuda):
    kw = dict(latent_len=2, latent_dim=2, model_dim=16, ff_dim=16, num_layers=1, num_heads=2)
    model = init_params(PhotoSpecMMVAE([PhotometricVAE(num_bands=6, **kw), SpectraVAE(**kw)]),
                        torch.Generator().manual_seed(0))
    server = InferenceServer(model, buckets=(4,))
    assert server.device.type == "cuda"
    rng = np.random.default_rng(0)
    photo = (rng.normal(size=(3, 12)).astype(np.float32),
             np.sort(rng.uniform(-1, 1, (3, 12)), axis=1).astype(np.float32),
             rng.integers(0, 6, (3, 12)), rng.uniform(size=(3, 12)) < 0.2)
    spec = (rng.normal(size=(3, 300)).astype(np.float32),
            np.linspace(-1, 1, 300, dtype=np.float32)[None].repeat(3, 0),
            rng.normal(size=(3,)).astype(np.float32), rng.uniform(size=(3, 300)) < 0.2)
    before = attention.launches
    out = server.crossmodal(photo, spec, K=2)
    assert out.is_cuda and out.shape == (2, 3, 300) and torch.isfinite(out).all()
    assert attention.launches == before + 1  # one layer's 300x300 self-attention
