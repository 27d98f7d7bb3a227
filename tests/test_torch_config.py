"""The port's experiment configs against the JAX package's: the same dicts
key for key, the same override parsing, and a config.json written by either
package read by the other."""

import json

import pytest

import vaesne_tpu.utils.config as jcfg
import vaesne_tpu_torch.utils.config as tcfg
from vaesne_tpu.utils.checkpoint import restore_config as jrestore_config
from vaesne_tpu_torch.utils.checkpoint import restore_config as trestore_config


def test_the_same_config_classes():
    assert tcfg.CONFIG_CLASSES.keys() == jcfg.CONFIG_CLASSES.keys()


@pytest.mark.parametrize("name", sorted(jcfg.CONFIG_CLASSES))
def test_asdict_equals_the_jax_packages(name):
    got = tcfg.asdict(tcfg.CONFIG_CLASSES[name]())
    assert got == jcfg.asdict(jcfg.CONFIG_CLASSES[name]())
    assert json.dumps(got) == json.dumps(jcfg.asdict(jcfg.CONFIG_CLASSES[name]()))
    cls = tcfg.CONFIG_CLASSES[name]
    assert tcfg.from_dict(cls, json.loads(json.dumps(got))) == cls()


OVERRIDES = [
    ("PhotoSpectraMMVAEConfig", ["model.latent_len=2", "model.num_layers=1", "train.lr=0.001",
                                 "train.grad_clip=-1"]),
    ("PhotoSpectraMMVAEConfig", ["train.resume=true", "train.parity=1", "model.bright=yes",
                                 "model.concat=False", "train.mesh=none"]),
    ("PhotoSpectraMMVAEConfig", ["train.beta=2", "train.K=8", "train.seed=3",
                                 "model.dropout=0", "train.accum_reduction=mean"]),
    ("ZTFSpectraConfig", ["extra_mask_prob=0.1", "repeat_factor=1", "train.epochs=3"]),
    ("ZTFMMVAEConfig", ["num_bands=6", "train.ckpt_dir=/tmp/x", "train.b2=0.99"]),
    ("RegressionConfig", ["outdim=2", "train.batch_size=8"]),
    ("ImageVAEConfig", ["hybrid=0", "img_size=28", "model.selfattn=TRUE"]),
]


@pytest.mark.parametrize("name,argv", OVERRIDES)
def test_parse_overrides_equals_the_jax_packages(name, argv):
    got = tcfg.parse_overrides(tcfg.CONFIG_CLASSES[name](), argv)
    want = jcfg.parse_overrides(jcfg.CONFIG_CLASSES[name](), argv)
    assert tcfg.asdict(got) == jcfg.asdict(want)
    assert ({type(v) for v in tcfg.asdict(got)["train"].values()}
            == {type(v) for v in jcfg.asdict(want)["train"].values()})


def test_parse_overrides_rejects_a_bare_word():
    with pytest.raises(ValueError, match="key=value"):
        tcfg.parse_overrides(tcfg.PhotoSpectraMMVAEConfig(), ["lr"])


def _write(path, d, name):
    path.mkdir()
    (path / "config.json").write_text(json.dumps(dict(d, _config_class=name), indent=2))
    return str(path)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_config_json_reads_across_packages(tmp_path, writer):
    argv = ["model.latent_len=2", "train.epochs=7", "model.bright=true"]
    mods = {"jax": jcfg, "port": tcfg}
    src = mods[writer]
    cfg = src.parse_overrides(src.PhotoSpectraMMVAEConfig(), argv)
    path = _write(tmp_path / "ck", src.asdict(cfg), "PhotoSpectraMMVAEConfig")
    got = trestore_config(path, tcfg.PhotoSpectraMMVAEConfig)
    want = jrestore_config(path, jcfg.PhotoSpectraMMVAEConfig)
    assert tcfg.asdict(got) == jcfg.asdict(want) == src.asdict(cfg)
    assert trestore_config(path).model.latent_len == 2  # the tag picks the class
    with pytest.raises(ValueError, match="trained as"):
        trestore_config(path, tcfg.SpectraVAEConfig)


def test_restore_config_without_a_file_or_a_tag(tmp_path):
    assert trestore_config(str(tmp_path)) is None
    path = _write(tmp_path / "ck", tcfg.asdict(tcfg.SpectraVAEConfig()), "Unknown")
    with pytest.raises(ValueError, match="unknown _config_class"):
        trestore_config(path)
    assert trestore_config(path, tcfg.SpectraVAEConfig) == tcfg.SpectraVAEConfig()
