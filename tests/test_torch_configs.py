"""The port's config registry against the reference's: every arch's
published and smoke configs, and the concrete smoke inputs."""
import dataclasses

import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.configs import base as ref_base
from repro_torch import configs
from repro_torch.configs import base

torch.set_num_threads(1)


def test_registry_lists_the_same_archs():
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref_configs.SHAPES.items()}
    with pytest.raises(ValueError, match="unknown arch"):
        configs.get_config("no-such-arch")


@pytest.mark.parametrize("arch", sorted(ref_configs.ARCH_IDS))
def test_config_and_smoke_equal_the_reference(arch):
    for get, ref_get in ((configs.get_config, ref_configs.get_config),
                         (configs.get_smoke, ref_configs.get_smoke)):
        cfg, ref = get(arch), ref_get(arch)
        assert type(cfg).__module__ == "repro_torch.configs.base"
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
        assert (cfg.head_dim, cfg.padded_vocab, cfg.pattern_repeats,
                cfg.is_subquadratic) == (ref.head_dim, ref.padded_vocab,
                                         ref.pattern_repeats,
                                         ref.is_subquadratic)


def test_scale_down_overrides_like_the_reference():
    cfg = base.scale_down(configs.get_config("granite-3-2b"), d_model=96,
                          n_layers=3)
    ref = ref_base.scale_down(ref_configs.get_config("granite-3-2b"),
                              d_model=96, n_layers=3)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)


@pytest.mark.parametrize("arch,kind", [("granite-3-2b", "train"),
                                       ("granite-3-2b", "prefill"),
                                       ("pixtral-12b", "train"),
                                       ("seamless-m4t-medium", "prefill")])
def test_concrete_inputs_give_the_same_draws(arch, kind):
    cfg = configs.get_smoke(arch)
    got = configs.concrete_inputs(cfg, batch=2, seq=12, kind=kind, seed=3,
                                  device="cpu")
    want = ref_configs.concrete_inputs(ref_configs.get_smoke(arch), batch=2,
                                       seq=12, kind=kind, seed=3)
    assert sorted(got) == sorted(want)
    for name, arr in want.items():
        arr = np.asarray(arr)
        assert got[name].dtype == getattr(torch, str(arr.dtype)), name
        np.testing.assert_array_equal(got[name].numpy(), arr, err_msg=name)
