"""The port's config registry equals the reference's, field for field."""

import dataclasses

import pytest
import torch

from repro import configs as ref_configs
from repro_torch import configs as port_configs


def test_registry_matches():
    assert port_configs.ARCH_IDS == ref_configs.ARCH_IDS
    assert port_configs.INPUT_SHAPES == ref_configs.INPUT_SHAPES


@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_config_and_reduced_match(arch):
    ref_cfg = ref_configs.get_config(arch)
    cfg = port_configs.get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(ref_cfg.reduced())
    assert cfg.padded_vocab == ref_cfg.padded_vocab
    if cfg.num_heads:  # head_dim_ divides by the head count
        assert cfg.head_dim_ == ref_cfg.head_dim_
    assert cfg.torch_dtype == getattr(torch, str(ref_cfg.jnp_dtype))
