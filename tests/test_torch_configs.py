"""The port's ten architecture configs and the planner's view of them,
against the reference package: every config field-equal, `layer_costs`
equal for every family, and sim mode's `profile_model` equal on a cluster
of the TPU classes both packages define."""

import dataclasses

import jax.numpy as jnp
import pytest
import torch

from repro.api.config import ModelSpec as RefModelSpec
from repro.api.session import profile_model as ref_profile_model
from repro.configs import ARCH_IDS as REF_ARCH_IDS, get_config as ref_config
from repro.core.types import ClusterSpec as RefClusterSpec
from repro.models.model_zoo import layer_costs as ref_layer_costs
from repro_torch.api.config import ModelSpec
from repro_torch.api.session import profile_model
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.types import ClusterSpec
from repro_torch.models.model_zoo import PORTED_FAMILIES, build_model, layer_costs

DTYPES = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}
# the TPU classes of both packages' tables: the planner's fastest is tpu-hi
COUNTS = {"tpu-hi": 2, "tpu-mid": 2, "tpu-lo": 4}


def _fields(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    d["dtype"] = DTYPES.get(d["dtype"], d["dtype"])
    return d


def test_registry_lists_the_references_ten_in_order():
    assert ARCH_IDS == REF_ARCH_IDS and len(ARCH_IDS) == 10


@pytest.mark.parametrize("arch", REF_ARCH_IDS)
def test_config_equals_reference(arch):
    """Every field, the full config and `reduced()` (its dtype mapped from
    jnp to torch)."""
    assert _fields(get_config(arch)) == _fields(ref_config(arch))
    assert _fields(get_config(arch).reduced()) == _fields(ref_config(arch).reduced())


@pytest.mark.parametrize("seq", [1, 128, 2048])
@pytest.mark.parametrize("arch", REF_ARCH_IDS)
def test_layer_costs_equal_reference(arch, seq):
    """The planner's per-layer profile of every family: dense and vlm, MoE,
    MoE with MLA (deepseek's dense layers at 18432), the Mamba2 hybrid and
    xLSTM ('m', 'M', 's', 'a'), and the audio encoder-decoder."""
    got, want = layer_costs(get_config(arch), seq), ref_layer_costs(ref_config(arch), seq)
    assert [dataclasses.asdict(c) for c in got] == [dataclasses.asdict(c) for c in want]


@pytest.mark.parametrize("arch", REF_ARCH_IDS)
def test_sim_profile_equals_reference(arch):
    """`profile_model` (sim mode's profiling step: layer costs, blocks, the
    SLO) gives the reference's profile for every architecture, full size and
    reduced."""
    for reduced in (None, {"n_layers": 2}):
        spec = dict(arch=arch, seq_len=128, n_blocks=6, reduced=reduced)
        got = profile_model(ModelSpec(**spec), ClusterSpec(counts=COUNTS))
        want = ref_profile_model(RefModelSpec(**spec), RefClusterSpec(counts=COUNTS))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_build_model_runs_the_ported_families_only():
    """Every family of the registry is ported and builds, full size and
    reduced; the MoE family picks deepseek's MLA module or llama4's GQA one
    by `mla`, as the reference does.  A family outside the registry raises."""
    from repro_torch.models import deepseek, moe

    assert {get_config(a).family for a in ARCH_IDS} <= set(PORTED_FAMILIES)
    for arch in ARCH_IDS:
        for cfg in (get_config(arch), get_config(arch).reduced()):
            assert build_model(cfg).cfg.family == cfg.family
    assert build_model(get_config("deepseek-v3-671b")).mod is deepseek
    assert build_model(get_config("llama4-maverick-400b-a17b")).mod is moe
    with pytest.raises(NotImplementedError, match="not ported"):
        build_model(dataclasses.replace(get_config("stablelm-3b"), family="retrieval"))
