"""The port's image VAE against the benchmark's plain reference
(``benchmark/reference/image_model.py``) on the CPU at a small size, and
``train_image.main``'s ×``aug_factor`` copies of the training images.

12×12 images at patch 2 (36 patch tokens, 144 pixel queries), model_dim 8,
2 heads, 2 layers, seeded random weights with LayerNorms and biases moved
off their initial values; dropout 0.1 in train mode, so the step's seeds
reach every dropout site on both sides. One case at 32×32 puts the hybrid
decoder's 256×256 self-attention on the kernels' route, whose dropout is
the counter hash.

Tolerances, fp32 on both sides: the ELBO within 1e-6 relative (a sum over
every pixel of terms of order 1, added in another order by the im2col
convolutions and the plain attention); each parameter's gradient within
1e-4 of the largest gradient norm of the model, in norm (a gradient is a sum
over the batch, the pixels and the tokens of products that cancel, so a
parameter whose gradient nearly vanishes carries the round-off of the large
ones).
"""

import numpy as np
import pytest
import torch

from benchmark.reference.image_model import ImageNet, elbo, parameter_shapes
from vaesne_tpu_torch import objectives
from vaesne_tpu_torch.data import image_tuple, make_images
from vaesne_tpu_torch.experiments import train_image
from vaesne_tpu_torch.utils import init_params
from vaesne_tpu_torch.utils.config import ImageVAEConfig, parse_overrides

SMALL = ["img_size=12", "model.latent_len=2", "model.latent_dim=2", "model.model_dim=8",
         "model.ff_dim=8", "model.num_layers=2", "model.num_heads=2"]
ELBO_RTOL = 1e-6
GRAD_TOL = 1e-4


def reference_config(cfg):
    """The reference's view of an ``ImageVAEConfig``."""
    m = cfg.model
    return {"model": {"latent_len": m.latent_len, "latent_dim": m.latent_dim,
                      "model_dim": m.model_dim, "num_heads": m.num_heads, "ff_dim": m.ff_dim,
                      "num_layers": m.num_layers, "dropout": m.dropout, "selfattn": m.selfattn},
            "img_size": cfg.img_size, "patch_size": cfg.patch_size,
            "in_channels": cfg.in_channels, "hybrid": cfg.hybrid, "focal_loc": cfg.focal_loc}


def _model(cfg, seed):
    model = init_params(train_image.build_model(cfg), torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias") or "layernorm" in name:
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    return model.train()


@pytest.mark.parametrize("extra, K", [((), 1), (("hybrid=false",), 1), ((), 2),
                                      (("img_size=32",), 1)],
                         ids=["hybrid", "per-pixel", "hybrid-K2", "hybrid-kernel-route"])
def test_the_elbo_and_every_gradient_match_the_reference(extra, K):
    cfg = parse_overrides(ImageVAEConfig(), [*SMALL, *extra])
    model = _model(cfg, 7)
    config = reference_config(cfg)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == parameter_shapes(config)
    batch = image_tuple(make_images(n=3, img_size=cfg.img_size, seed=3), "cpu")
    seed = 2 ** 31 - 11

    mine = objectives.elbo(model, batch, K, seed=seed)
    (-mine).backward()
    params = {k: v.detach().clone().requires_grad_() for k, v in model.named_parameters()}
    net = ImageNet(params, config, training=True)
    theirs = elbo(net, batch[0], seed, K, cfg.train.beta)
    (-theirs).backward()

    assert abs(mine.item() - theirs.item()) <= ELBO_RTOL * abs(theirs.item())
    grads = {k: p.grad for k, p in model.named_parameters()}
    scale = max(torch.linalg.vector_norm(p.grad).item() for p in params.values())
    worst = max(grads, key=lambda k: torch.linalg.vector_norm(grads[k] - params[k].grad).item())
    gap = torch.linalg.vector_norm(grads[worst] - params[worst].grad).item()
    assert gap <= GRAD_TOL * scale, (worst, gap, scale)


def test_the_reference_sees_the_dropout_and_the_noise():
    """Another step seed moves the reference's ELBO, and so does eval mode:
    the comparison above is not blind to the draws."""
    cfg = parse_overrides(ImageVAEConfig(), SMALL)
    model = _model(cfg, 5)
    params = {k: v.detach() for k, v in model.named_parameters()}
    images = image_tuple(make_images(n=2, img_size=cfg.img_size, seed=1), "cpu")[0]
    config = reference_config(cfg)
    values = [elbo(ImageNet(params, config, training=train), images, seed, 1, 0.5).item()
              for train, seed in ((True, 1), (True, 2), (False, 1))]
    assert len(set(values)) == 3


def test_main_trains_on_aug_factor_copies_that_augmentation_tells_apart(tmp_path, monkeypatch):
    """``train_image.main`` at ``aug_factor`` 5 runs five times the steps of
    ``aug_factor`` 1 (512 images, batch 64); its training data are five
    copies of the images, which one epoch's flips and warps make differ."""
    seen = {}
    real = train_image.train_loop

    def spy(model, train_data, loss_fn, train_cfg, **kwargs):
        seen["data"], seen["augment"] = train_data, kwargs["augment_fn"]
        return real(model, train_data, loss_fn, train_cfg, **kwargs)

    monkeypatch.setattr(train_image, "train_loop", spy)
    steps = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # a tiny model's many small ops: one thread beats a busy pool
    try:
        for factor in (1, 5):
            argv = [*SMALL, "train.batch_size=64", "train.epochs=1", f"aug_factor={factor}",
                    f"train.ckpt_dir={tmp_path / str(factor)}",
                    f"train.log_dir={tmp_path / 'logs'}"]
            state, losses = train_image.main(argv, device="cpu")
            steps[factor] = state.step
            assert np.isfinite(losses).all()
    finally:
        torch.set_num_threads(threads)
    assert steps == {1: 512 // 64, 5: 5 * (512 // 64)}
    images = seen["data"][0].view(5, 512, 3, 12, 12)
    assert all(torch.equal(images[0], images[k]) for k in range(1, 5))
    augmented = seen["augment"](torch.Generator().manual_seed(4), seen["data"])[0]
    copies = augmented.view(5, 512, 3, 12, 12)
    for k in range(1, 5):
        same = (copies[0] == copies[k]).flatten(1).all(1)
        assert same.float().mean().item() < 0.05, (k, same.sum().item())
