"""The port's ``ArchConfig`` against the reference's on every one of the
reference's ten configs: the port's dataclass is built from each, field by
field over the fields both have, and every derived count and every field of
``reduced()`` must equal the reference's.  The reference is only read here
(its dataclasses); no mesh is built and nothing is traced."""
import dataclasses

import pytest

from repro import configs as jconfigs
from repro_torch import configs as tconfigs
from repro_torch.configs.base import ArchConfig

NAMES = sorted(jconfigs.ARCHS)
TFIELDS = {f.name for f in dataclasses.fields(ArchConfig)}


def _shared(jcfg) -> dict:
    return {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
            if f.name in TFIELDS}


def _port(jcfg) -> ArchConfig:
    return ArchConfig(**_shared(jcfg))


def _derived(cfg) -> dict:
    return dict(param_count=cfg.param_count(),
                active_param_count=cfg.active_param_count(),
                n_experts_padded=cfg.n_experts_padded,
                vocab_padded=cfg.vocab_padded, head_dim_=cfg.head_dim_,
                is_moe=cfg.is_moe)


def test_the_pool_is_the_ten_configs():
    assert len(NAMES) == 10
    # every family the reference's branches read is in the pool
    assert {jconfigs.get(n).family for n in NAMES} >= \
        {"lm", "moe", "encdec", "vlm", "rglru", "rwkv6"}


@pytest.mark.parametrize("name", NAMES)
def test_derived_counts_match_reference(name):
    jcfg = jconfigs.get(name)
    assert _derived(_port(jcfg)) == _derived(jcfg)


@pytest.mark.parametrize("name", NAMES)
def test_reduced_matches_reference(name):
    jcfg = jconfigs.get(name)
    jr, tr = jcfg.reduced(), _port(jcfg).reduced()
    assert dataclasses.asdict(tr) == _shared(jr)
    assert _derived(tr) == _derived(jr)


@pytest.mark.parametrize("name", sorted(tconfigs.ARCHS))
def test_registered_configs_equal_reference(name):
    """The configs the port registers are the reference's, so their
    counts (and what the port runs) are unchanged."""
    jcfg, tcfg = jconfigs.get(name), tconfigs.get(name)
    assert dataclasses.asdict(tcfg) == _shared(jcfg)
    assert _derived(tcfg) == _derived(jcfg)
    assert dataclasses.asdict(tcfg.reduced()) == _shared(jcfg.reduced())
