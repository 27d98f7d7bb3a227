"""Shared helpers of the PyTorch port's parity tests: a flax parameter tree
filled with the torch model's weights, the numpy batches both packages
take, pinned posterior noise, and the bridge of a JAX (Orbax) checkpoint
into a port checkpoint.

The two frameworks draw different random numbers, so sampling is pinned:
``fixed_noise`` replaces the Laplace sampler of both packages with one that
adds the same numpy noise (a function of the draw's shape) to loc."""

import importlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vaesne_tpu.distributions as jdist
import vaesne_tpu.models as jmodels
import vaesne_tpu.objectives as jobj
import vaesne_tpu_torch.distributions as tdist
import vaesne_tpu_torch.models as tmodels
from vaesne_tpu_torch.utils import init_params, load_jax_params
from vaesne_tpu_torch.utils.weights import flax_kernel, torch_key

SMALL = dict(latent_len=2, latent_dim=2, model_dim=16, ff_dim=16, num_layers=1, num_heads=2)
FLAGSHIP = dict(latent_len=4, latent_dim=4, model_dim=32, ff_dim=32, num_layers=4, num_heads=4)


def jax_params_from(tm, jm, example):
    """The flax parameter tree of ``jm`` (structure from an abstract init,
    no compile) filled with the torch model's weights."""
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda x: jm.init({"params": key, "sample": key}, x, 1),
                            example)
    state = tm.state_dict()

    def leaf(path, _):
        names = tuple(p.key for p in path)
        value = state[torch_key(names[1:])].numpy()
        return jnp.asarray(flax_kernel(value) if names[-1] == "kernel" else value)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def make_batch(B=3, lp=12, ns=40, seed=0):
    rng = np.random.default_rng(seed)
    photo = (rng.normal(size=(B, lp)).astype(np.float32),
             np.sort(rng.uniform(-1, 1, (B, lp)), axis=1).astype(np.float32),
             rng.integers(0, 6, (B, lp)).astype(np.int32),
             rng.uniform(size=(B, lp)) < 0.2)
    spec = (rng.normal(size=(B, ns)).astype(np.float32),
            np.linspace(-1, 1, ns, dtype=np.float32)[None].repeat(B, 0),
            rng.normal(size=(B,)).astype(np.float32),
            rng.uniform(size=(B, ns)) < 0.2)
    return photo, spec


def jx(batch):
    return tuple(tuple(jnp.asarray(a) for a in m) for m in batch)


def tx(batch):
    return tuple(tuple(torch.from_numpy(a.astype(np.int64) if a.dtype == np.int32 else a)
                       for a in m) for m in batch)


def make_pair(kw, batch, bright=False):
    """(JAX PhotoSpecMMVAE, its flax params, the port's twin in eval mode)
    with the same weights, from a seeded port initialisation; ``bright``
    takes the Bright* sub-VAEs."""
    prefix = "Bright" if bright else ""
    jm = jmodels.PhotoSpecMMVAE(
        vaes=[getattr(jmodels, prefix + "PhotometricVAE")(num_bands=6, **kw),
              getattr(jmodels, prefix + "SpectraVAE")(**kw)], beta=1.0)
    tm = tmodels.PhotoSpecMMVAE([getattr(tmodels, prefix + "PhotometricVAE")(num_bands=6, **kw),
                                 getattr(tmodels, prefix + "SpectraVAE")(**kw)], beta=1.0)
    init_params(tm, torch.Generator().manual_seed(0))
    return jm, jax_params_from(tm, jm, jx(batch)), tm.eval()


def noise(shape):
    return np.random.default_rng(list(shape) or [0]).laplace(size=shape).astype(np.float32)


@pytest.fixture
def fixed_noise(monkeypatch):
    """Both packages' Laplace draws become loc + scale·(numpy noise)."""

    def jax_sample(self, key, sample_shape=()):
        shape = jdist._as_shape(sample_shape) + tuple(self.batch_shape)
        return self.loc + self.scale * jnp.asarray(noise(shape))

    def torch_sample(self, generator=None, sample_shape=()):
        shape = tdist._as_shape(sample_shape) + tuple(self.batch_shape)
        return self.loc + self.scale * torch.from_numpy(noise(shape))

    monkeypatch.setattr(jdist.Laplace, "sample", jax_sample)
    monkeypatch.setattr(tdist.Laplace, "sample", torch_sample)


# seconds a test's spawned ranks may run, and a collective may wait for its peers
RANKS_DEADLINE, COLLECTIVE_DEADLINE = 240.0, 60.0


@pytest.fixture(autouse=True)
def rank_deadlines(monkeypatch):
    """Deadlines for the ranks a test spawns (``parallel.launch``), so a
    hang fails the test rather than the suite; autouse in each module that
    imports it."""
    import vaesne_tpu_torch.parallel.mesh as tmesh

    monkeypatch.setattr(tmesh, "LAUNCH_TIMEOUT", RANKS_DEADLINE)
    monkeypatch.setattr(tmesh, "GROUP_TIMEOUT", COLLECTIVE_DEADLINE)


# a checkpoint's config class → (the driver module that builds its model in
# either package, its data kind, its tuple builder)
_EXPORTABLE = {
    "PhotoSpectraMMVAEConfig": ("train_photospectra", "goldstein", "multimodal_tuple"),
    "ZTFMMVAEConfig": ("train_ztf_photospect", "ztf", "multimodal_tuple"),
    "SpectraVAEConfig": ("train_spectra", "goldstein", "spectra_tuple"),
    "ZTFSpectraConfig": ("train_ztf_spectra", "ztf", "spectra_tuple"),
    "PhotometryVAEConfig": ("train_photometry", "goldstein", "photometry_tuple"),
    "ImageVAEConfig": ("train_image", "image", "image_tuple"),
    "ContrastiveConfig": ("train_contrastive", "goldstein", "multimodal_tuple"),
    "RegressionConfig": ("train_regression", "goldstein", None),
}
# beside a bridged image checkpoint: the JAX package's posterior-mean
# reconstruction of REFERENCE_IMAGES, decode(encode(x)).loc, dropout off
REFERENCE_FILE = "jax_reconstruction.npy"
REFERENCE_IMAGES = dict(n=8, seed=0)
# beside a bridged contrastive checkpoint: the JAX package's deterministic
# projections z1, z2 of the test split of resolve_dataset(None, "goldstein")
# and its symmetric InfoNCE (the CE, −neg_info_nce) over consecutive
# batches of INFO_NCE_BATCH test events, the remainder dropped
PROJECTIONS_FILE = "jax_projections.npz"
INFO_NCE_BATCH = 32
# beside a bridged regression head: the JAX package's eval_regression
# absdiff [N_test, 4] on that test split, with the normalizing JSON that
# sits beside the JAX checkpoint (copied beside the bridged one)
ABSDIFF_FILE = "jax_absdiff.npy"
NORMALIZING_FILE = "goldstein_normalizing.json"
# beside a bridged light-curve or spectrum VAE or MMVAE (written on request,
# ``reference=True``): the JAX package's outputs for REFERENCE_EVENTS events
# of the data kind's synthetic set, per modality m: ``embed_m``, the
# posterior mean encode(x_m) [B, latent_len, latent_dim], and ``decode_m``,
# the posterior-mean decode decode(embed_m[None], x_m).loc[0], dropout off
VAE_REFERENCE_FILE = "jax_reference.npz"
REFERENCE_EVENTS = dict(n=4, seed=1)


def reference_events(kind, builder, lib="jax"):
    """The events of a VAE checkpoint's reference file, as the JAX
    package's (numpy) or the port's (CPU tensors) data tuple."""
    import vaesne_tpu.data as jdata
    import vaesne_tpu_torch.data as tdata

    data = (jdata if lib == "jax" else tdata)
    maker = data.make_goldstein_like if kind == "goldstein" else data.make_ztf_like
    events = maker(**REFERENCE_EVENTS)
    idx = np.arange(REFERENCE_EVENTS["n"])
    if lib == "jax":
        return getattr(data, builder)(events, idx=idx)
    return getattr(data, builder)(events, idx=idx, device="cpu")


def write_vae_reference(jmodel, params, kind, builder, out_dir):
    """``VAE_REFERENCE_FILE`` for the JAX VAE or MMVAE ``jmodel``."""
    x = reference_events(kind, builder)
    variables = {"params": params}
    multimodal = builder == "multimodal_tuple"
    out = {}
    for m, xm in enumerate(x if multimodal else (x,)):
        def vae(module, m=m):
            return module.vaes[m] if multimodal else module

        z = jmodel.apply(variables, xm, method=lambda mod, a: vae(mod).encode(a))
        loc = jmodel.apply(variables, z[None], xm,
                           method=lambda mod, zs, a: vae(mod).decode(zs, a).loc)[0]
        out[f"embed_{m}"], out[f"decode_{m}"] = np.asarray(z), np.asarray(loc)
    np.savez(os.path.join(out_dir, VAE_REFERENCE_FILE), **out)


def regression_case(path):
    """(modality, backbone) of a regression checkpoint directory named
    ``goldstein_{modality}2param_{backbone}``."""
    modality, backbone = os.path.basename(os.path.normpath(path))[len("goldstein_"):].split(
        "2param_")
    return modality, backbone


def jax_regression_params(jax_dir, jc):
    """The JAX package's regression head for ``jax_dir`` and its restored
    parameters, through the template its eval_regression builds (the head's
    parameters merged with the whole backbone, the masked optimizer)."""
    import optax

    import vaesne_tpu.data as jdata
    import vaesne_tpu.utils.checkpoint as jck
    import vaesne_tpu.utils.config as jcfg
    from vaesne_tpu import training as jtr
    from vaesne_tpu.experiments import train_regression as jreg

    modality, backbone = regression_case(jax_dir)
    data = jdata.make_goldstein_like(n=8, seed=0)
    builder = (lambda: jcfg.PhotoSpectraMMVAEConfig()) if backbone == "mmvae" else (
        lambda: jcfg.ContrastiveConfig())
    example = jdata.multimodal_tuple(data, idx=np.arange(2))
    key = jax.random.PRNGKey(0)
    head, frozen = jreg.build_head(modality, backbone, builder, None,
                                   example if backbone != "end2end" else None, key, jc)
    x = (jdata.photometry_tuple if modality == "photometry" else jdata.spectra_tuple)(
        data, idx=np.arange(2))
    params = {**jtr.init_model(head, x, key, has_sample_rng=False), **(frozen or {})}
    opt = jtr.adamw(jc.train.lr)
    if frozen:
        opt = optax.masked(opt, jreg.frozen_param_mask(params, frozen))
    return head, jck.restore_checkpoint(jax_dir, jtr.TrainState.create(params, opt, key)).params


def write_contrastive_reference(jmodel, params, out_dir, temperature):
    """``PROJECTIONS_FILE`` for the JAX contrastive model ``jmodel``."""
    import vaesne_tpu.data as jdata
    from vaesne_tpu.experiments.common import resolve_dataset

    data = resolve_dataset(None, "goldstein")
    x = jdata.multimodal_tuple(data, idx=np.asarray(data["testing_idx"]))
    variables = {"params": params}
    z1, z2 = jmodel.apply(variables, x, True)
    ce = []
    for start in range(0, int(z1.shape[0]) - INFO_NCE_BATCH + 1, INFO_NCE_BATCH):
        batch = jax.tree_util.tree_map(lambda a: a[start:start + INFO_NCE_BATCH], x)
        ce.append(-float(jobj.neg_info_nce(jmodel, variables, batch, temperature=temperature,
                                           deterministic=True)))
    np.savez(os.path.join(out_dir, PROJECTIONS_FILE), z1=np.asarray(z1), z2=np.asarray(z2),
             info_nce=np.asarray(ce, np.float32))


def jax_image_model(cfg):
    """The JAX package's HostImgVAE for an ImageVAEConfig, built as its
    train_image.main builds it."""
    m = cfg.model
    return jmodels.HostImgVAE(
        img_size=cfg.img_size, patch_size=cfg.patch_size, in_channels=cfg.in_channels,
        hybrid=cfg.hybrid, focal_loc=cfg.focal_loc, latent_len=m.latent_len,
        latent_dim=m.latent_dim, model_dim=m.model_dim, num_heads=m.num_heads,
        ff_dim=m.ff_dim, num_layers=m.num_layers, dropout=m.dropout, selfattn=m.selfattn,
        beta=cfg.train.beta)


def reference_images(cfg, n=REFERENCE_IMAGES["n"], seed=REFERENCE_IMAGES["seed"]):
    import vaesne_tpu.data as jdata

    return jdata.make_images(n=n, img_size=cfg.img_size, channels=cfg.in_channels, seed=seed)


def export_port_checkpoint(jax_dir, out_dir, config_class="PhotoSpectraMMVAEConfig",
                           reference=False):
    """Bridge the JAX package's checkpoint at ``jax_dir`` (its Orbax
    ``state/`` and ``config.json``) into a port checkpoint at ``out_dir``:
    ``config.json`` tagged with its config class and a ``state.pt`` of the
    parameters alone (``save_params``), which ``restore_params`` and
    ``InferenceServer.from_checkpoint`` read and ``restore_checkpoint``
    refuses (the AdamW moments are not bridged). The config class is the
    checkpoint's ``_config_class`` tag, else ``config_class``. The JAX
    state is restored into an abstract template, so nothing is compiled.
    For an image VAE it also writes ``REFERENCE_FILE``: the JAX package's
    posterior-mean reconstruction of ``reference_images``, [N, C, H, W];
    for a contrastive model ``PROJECTIONS_FILE``; for a light-curve or
    spectrum VAE or MMVAE, with ``reference``, ``VAE_REFERENCE_FILE``; for a
    regression head
    (a directory named ``goldstein_{modality}2param_{backbone}``) the JAX
    eval_regression's ``ABSDIFF_FILE``, and a copy of the normalizing JSON
    beside ``jax_dir`` into the parent of ``out_dir``."""
    import vaesne_tpu.data as jdata
    import vaesne_tpu.utils.checkpoint as jck
    import vaesne_tpu.utils.config as jcfg
    from vaesne_tpu import training as jtr
    from vaesne_tpu.experiments.common import optimizer_from_config
    from vaesne_tpu_torch.utils import checkpoint as tck
    from vaesne_tpu_torch.utils import config as tcfg

    name = (jck.load_config(jax_dir) or {}).get("_config_class", config_class)
    driver, kind, builder = _EXPORTABLE[name]
    jc = jck.restore_config(jax_dir, jcfg.CONFIG_CLASSES[name])
    tc = tck.restore_config(jax_dir, tcfg.CONFIG_CLASSES[name])
    config = tcfg.asdict(tc)
    config["_config_class"] = name
    if name == "RegressionConfig":
        return _export_regression(jax_dir, out_dir, jc, tc, config)
    if kind == "image":
        jmodel = jax_image_model(jc)
        example = jdata.image_tuple(reference_images(jc, n=2))
    else:
        jmodel = importlib.import_module(f"vaesne_tpu.experiments.{driver}").build_model(jc)
        maker = jdata.make_goldstein_like if kind == "goldstein" else jdata.make_ztf_like
        example = getattr(jdata, builder)(maker(n=8, seed=0), idx=np.arange(2))
    key = jax.random.PRNGKey(0)
    one_device = jax.sharding.SingleDeviceSharding(jax.devices()[0])
    template = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype, sharding=one_device),
        jax.eval_shape(lambda: jtr.TrainState.create(
            jtr.init_model(jmodel, example, key, K=1,
                           has_sample_rng=name != "ContrastiveConfig"),
            optimizer_from_config(jc.train), key)))
    params = jck.restore_checkpoint(jax_dir, template).params

    model = importlib.import_module(f"vaesne_tpu_torch.experiments.{driver}").build_model(tc)
    load_jax_params(model, {"params": jax.tree_util.tree_map(np.asarray, params)})
    tck.save_params(out_dir, model, config)
    if name == "ContrastiveConfig":
        write_contrastive_reference(jmodel, params, out_dir, jc.temperature)
    elif reference and kind != "image":
        write_vae_reference(jmodel, params, kind, builder, out_dir)
    if kind == "image":
        x = jdata.image_tuple(reference_images(jc))
        variables = {"params": params}
        z = jmodel.apply(variables, x, method="encode")
        loc = jmodel.apply(variables, z[None], x, method="decode").loc[0]
        np.save(os.path.join(out_dir, REFERENCE_FILE), np.asarray(loc, np.float32))
    return model


def _export_regression(jax_dir, out_dir, jc, tc, config):
    """export_port_checkpoint of a regression head."""
    import shutil
    import tempfile

    from vaesne_tpu.experiments import eval_regression as jeval
    from vaesne_tpu_torch.experiments import train_regression as treg
    from vaesne_tpu_torch.utils import checkpoint as tck

    modality, backbone = regression_case(jax_dir)
    _, params = jax_regression_params(jax_dir, jc)
    model, _ = treg.build_head(modality, backbone, None, 0, tc)
    load_jax_params(model, {"params": jax.tree_util.tree_map(np.asarray, params)})
    tck.save_params(out_dir, model, config)
    norm_dir = os.path.dirname(os.path.normpath(jax_dir))
    with tempfile.TemporaryDirectory() as tmp:
        absdiff = jeval.main([f"modality={modality}", f"backbone={backbone}",
                              f"head_ckpt={jax_dir}", f"train.ckpt_dir={norm_dir}",
                              f"out={tmp}", "mesh=none"])
    np.save(os.path.join(out_dir, ABSDIFF_FILE), np.asarray(absdiff))
    shutil.copyfile(os.path.join(norm_dir, NORMALIZING_FILE),
                    os.path.join(os.path.dirname(os.path.normpath(out_dir)), NORMALIZING_FILE))
    return model


if __name__ == "__main__":
    # PYTHONPATH=. python tests/torch_parity.py <JAX checkpoint> <port checkpoint> [class]
    export_port_checkpoint(*sys.argv[1:], reference=True)
    print(f"wrote {os.path.join(sys.argv[2], 'state.pt')}")
