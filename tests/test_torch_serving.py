"""InferenceServer of the PyTorch port on the CPU: bucket reuse, pad-row
isolation, task shapes, and embed parity with the JAX server on the same
weights."""

import threading

import numpy as np
import pytest
import torch

from vaesne_tpu.models import PhotometricVAE as JPhotometricVAE
from vaesne_tpu.models import PhotoSpecMMVAE as JPhotoSpecMMVAE
from vaesne_tpu.models import SpectraVAE as JSpectraVAE
from vaesne_tpu.serving import InferenceServer as JInferenceServer
from vaesne_tpu_torch import InferenceServer, PhotometricVAE, PhotoSpecMMVAE, SpectraVAE
from vaesne_tpu_torch.serving import _pad_to, _quantile
from vaesne_tpu_torch.utils import init_params

from torch_parity import jax_params_from

LP, NS = 12, 40
TINY = dict(latent_len=2, latent_dim=2, model_dim=16, ff_dim=16, num_layers=1, num_heads=2)


def _batch(n, seed=0):
    rng = np.random.default_rng(seed)
    photo = (rng.normal(size=(n, LP)).astype(np.float32),
             np.sort(rng.uniform(-1, 1, (n, LP)), axis=1).astype(np.float32),
             rng.integers(0, 6, (n, LP)).astype(np.int32),
             rng.uniform(size=(n, LP)) < 0.2)
    spec = (rng.normal(size=(n, NS)).astype(np.float32),
            np.linspace(-1, 1, NS, dtype=np.float32)[None].repeat(n, 0),
            rng.normal(size=(n,)).astype(np.float32),
            rng.uniform(size=(n, NS)) < 0.2)
    return photo, spec


def _models():
    jm = JPhotoSpecMMVAE(vaes=[JPhotometricVAE(num_bands=6, **TINY), JSpectraVAE(**TINY)],
                         beta=1.0)
    tm = PhotoSpecMMVAE([PhotometricVAE(num_bands=6, **TINY), SpectraVAE(**TINY)], beta=1.0)
    init_params(tm, torch.Generator().manual_seed(0))
    return jm, jax_params_from(tm, jm, _batch(2)), tm


@pytest.fixture(scope="module")
def models():
    return _models()


@pytest.fixture(scope="module")
def server(models):
    return InferenceServer(models[2], buckets=(4, 8, 16), seed=0, device="cpu")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_bucket_reuse(models):
    srv = InferenceServer(models[2], buckets=(4, 8, 16), device="cpu")
    photo, spec = _batch(3)
    assert srv.crossmodal(photo, spec, K=2).shape == (2, 3, NS)
    assert srv.stats()["compiles"] == 1
    # a different size in the SAME bucket reuses the program
    photo2, spec2 = _batch(4, seed=1)
    assert srv.crossmodal(photo2, spec2, K=2).shape == (2, 4, NS)
    stats = srv.stats()
    assert stats["compiles"] == 1 and stats["hits"] == 1
    # crossing a bucket boundary compiles exactly once more
    photo3, spec3 = _batch(7, seed=2)
    assert srv.crossmodal(photo3, spec3, K=2).shape == (2, 7, NS)
    assert srv.stats() == {"programs": 2, "compiles": 2, "hits": 1}


def test_oversized_request_raises(server):
    photo, spec = _batch(17)
    with pytest.raises(ValueError, match="largest serving bucket"):
        server.crossmodal(photo, spec)


def test_pad_rows_do_not_leak(server):
    """Real-event outputs are identical whatever fills the pad rows."""
    photo, spec = _batch(3, seed=3)
    a = server.crossmodal(photo, spec, K=2, generator=_gen(7))
    filled = tuple(tuple(np.concatenate([np.asarray(r), np.zeros_like(np.asarray(r))[:1]])
                         for r in m) for m in (photo, spec))
    b = server.crossmodal(filled[0], filled[1], K=2, generator=_gen(7))[:, :3]
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_crossmodal_ci_shapes_and_order(server):
    photo, spec = _batch(5, seed=5)
    mean, lo, hi = server.crossmodal_ci(photo, spec, K=16, generator=_gen(3))
    assert mean.shape == lo.shape == hi.shape == (5, NS)
    assert bool((lo <= hi).all()) and bool((lo <= mean).all() and (mean <= hi).all())


def test_embed_matches_jax_server(models, server):
    jm, variables, _ = models
    jserver = JInferenceServer(jm, variables, buckets=(4, 8, 16), seed=0)
    photo, spec = _batch(6, seed=6)
    for m, x in enumerate((photo, spec)):
        z = server.embed(x, modality=m)
        assert z.shape == (6, 2, 2)
        np.testing.assert_allclose(z.numpy(), np.asarray(jserver.embed(x, modality=m)),
                                   rtol=1e-4, atol=1e-5)


def test_reconstruct_matrix(server):
    out = server.reconstruct(_batch(3, seed=7), K=2, generator=_gen(5))
    assert len(out) == 2 and len(out[0]) == 2
    assert out[0][0].shape == (2, 3, LP)   # LC→LC
    assert out[0][1].shape == (2, 3, NS)   # LC→spec
    assert out[1][0].shape == (2, 3, LP)   # spec→LC
    assert out[1][1].shape == (2, 3, NS)   # spec→spec
    assert all(np.isfinite(c).all() for row in out for c in row)


def test_server_without_device_needs_cuda(models, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceServer(models[2])
    with pytest.raises(ValueError, match="precision"):
        InferenceServer(models[2], precision="fp16", device="cpu")
    with pytest.raises(ValueError, match="ascending"):
        InferenceServer(models[2], buckets=(8, 4), device="cpu")


def test_prewarm_runs_every_program(models):
    srv = InferenceServer(models[2], buckets=(4, 8), device="cpu")
    timings = srv.prewarm(_batch(2), tasks=("crossmodal", "embed"), buckets=(4,),
                          Ks=(2,), directions=((0, 1),))
    # 1 crossmodal (1 direction x 1 K x 1 predictive) + 2 embeds
    assert len(timings) == 3 and all(t >= 0 for t in timings.values())
    assert srv.stats()["compiles"] == 3
    photo, spec = _batch(3, seed=1)
    assert srv.crossmodal(photo, spec, K=2).shape == (2, 3, NS)
    assert srv.stats()["compiles"] == 3 and srv.stats()["hits"] == 1
    with pytest.raises(ValueError, match="not server buckets"):
        srv.prewarm(_batch(2), buckets=(5,))
    with pytest.raises(ValueError, match="unknown prewarm task"):
        srv.prewarm(_batch(2), tasks=("bogus",), buckets=(4,))


def test_bf16_precision_tracks_fp32(models):
    srv32 = InferenceServer(models[2], buckets=(4,), device="cpu", precision="fp32")
    srv16 = InferenceServer(models[2], buckets=(4,), device="cpu", precision="bf16")
    photo, spec = _batch(4, seed=2)
    a = srv32.crossmodal(photo, spec, K=2, generator=_gen(1))
    b = srv16.crossmodal(photo, spec, K=2, generator=_gen(1))
    assert a.dtype == torch.float32 and b.dtype == torch.bfloat16
    b = b.float()
    assert torch.isfinite(b).all()
    assert abs(a.mean() - b.mean()) < 0.2 and abs(a.std() - b.std()) < 0.2


def test_generator_chain_is_thread_safe(server):
    """Concurrent calls never share a sampling seed."""
    firsts = []
    lock = threading.Lock()

    def draw():
        for _ in range(50):
            x = torch.rand(1, generator=server._next_generator(None)).item()
            with lock:
                firsts.append(x)

    threads = [threading.Thread(target=draw) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert len(firsts) == 200 and len(set(firsts)) == 200


def test_quantile_and_pad_helpers():
    x = np.random.default_rng(0).normal(size=(37, 3, 5)).astype(np.float32)
    lo, hi = _quantile(torch.from_numpy(x), (0.05, 0.95))
    np.testing.assert_allclose(lo.numpy(), np.quantile(x, 0.05, axis=0), rtol=1e-6)
    np.testing.assert_allclose(hi.numpy(), np.quantile(x, 0.95, axis=0), rtol=1e-6)
    a = np.arange(6, dtype=np.float32).reshape(3, 2)
    (padded,) = _pad_to((a,), 5)
    assert padded.shape == (5, 2)
    np.testing.assert_array_equal(padded[3], a[0])
    np.testing.assert_array_equal(padded[:3], a)
