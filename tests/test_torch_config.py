"""The port's config against the JAX config: same presets, same fields, and
byte-equal ``hash``/``model_hash``, so both packages agree on what a
checkpoint means."""

import _torch_threads  # noqa: F401  (first: sizes torch's thread pool)
import dataclasses

import pytest
import torch

from longterm360fov_tpu import config as jax_config
from longterm360fov_tpu.models import seq2seq as jax_seq2seq
from longterm360fov_tpu_torch import config as torch_config
from longterm360fov_tpu_torch.models import seq2seq as torch_seq2seq

PRESETS = sorted(jax_config.PRESETS)


def test_same_presets():
    assert len(PRESETS) == 7
    assert sorted(torch_config.PRESETS) == PRESETS


@pytest.mark.parametrize("name", PRESETS)
def test_model_hash_matches_jax(name):
    ours, ref = torch_config.PRESETS[name], jax_config.PRESETS[name]
    assert ours.model_hash() == ref.model_hash()
    assert ours.model_hash(_legacy_peers=4) == ref.model_hash(_legacy_peers=4)


@pytest.mark.parametrize("name", PRESETS)
def test_hash_matches_jax(name):
    assert torch_config.PRESETS[name].hash() == jax_config.PRESETS[name].hash()


def _fields(cls):
    # the nested model default compares by value across the two classes
    return [
        (f.name, dataclasses.asdict(f.default)
         if dataclasses.is_dataclass(f.default) else f.default)
        for f in dataclasses.fields(cls)
    ]


@pytest.mark.parametrize("which", ["Seq2SeqConfig", "ExperimentConfig"])
def test_same_fields_and_defaults(which):
    mods = {"Seq2SeqConfig": (torch_seq2seq, jax_seq2seq),
            "ExperimentConfig": (torch_config, jax_config)}[which]
    ours, ref = (getattr(m, which) for m in mods)
    assert _fields(ours) == _fields(ref)


def test_overrides_hash_like_jax():
    kw = dict(model_layers=2, model_h_out=12, lr=3e-4, model_family="seq2seq")
    ours = torch_config.get_preset("seq2seq-tf-30", **kw)
    ref = jax_config.get_preset("seq2seq-tf-30", **kw)
    assert ours.model.layers == 2 and ours.lr == 3e-4
    assert (ours.hash(), ours.model_hash()) == (ref.hash(), ref.model_hash())
    with pytest.raises(KeyError):
        torch_config.get_preset("no-such-preset")


def test_dtype_is_torch():
    assert torch_seq2seq.Seq2SeqConfig().dtype is torch.float32
    assert torch_seq2seq.Seq2SeqConfig(param_dtype="bfloat16").dtype is torch.bfloat16
