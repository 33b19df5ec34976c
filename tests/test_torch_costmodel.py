"""The port's cost model against the JAX package's, on the CPU.

`repro_torch.core.costmodel` is a copy of `repro.core.costmodel`: plain
Python on both sides, so every function must give the same number, exactly,
on the same configuration and shape. The prefix pool's eviction prices a
chain with `model_flops`, `attention_flops` and `weight_bytes`
(`launch.scheduler._re_prefill_cost`), so a copied formula that drifted
would change which block is evicted; the rest of the module is held here
too, so no copied function goes unchecked.

Configurations: every architecture of the reference, full and smoke, each
rebuilt field for field as the port's `ModelConfig` (the port registers
only tinyllama-1.1b and whisper-small, but the formulas branch on MLA, MoE,
SSM, RG-LRU, windows and encoders, and this reaches every branch), plus the
port's own registered configs.
"""

import _torch_threads  # noqa: F401

import dataclasses

import pytest

from repro import configs as jconfigs
from repro.configs import base as jbase
from repro.core import costmodel as jcost
from repro_torch import configs
from repro_torch.configs import base
from repro_torch.core import costmodel

SHAPES = (("prefill", 1, 1), ("prefill", 17, 1), ("prefill", 256, 8), ("prefill", 4096, 2),
          ("decode", 1, 1), ("decode", 300, 8), ("decode", 32768, 4), ("train", 2048, 16))


def _port_config(jcfg: jbase.ModelConfig) -> base.ModelConfig:
    return base.ModelConfig(**{f.name: getattr(jcfg, f.name)
                               for f in dataclasses.fields(jbase.ModelConfig)})


def _configs():
    for name in jconfigs.ARCH_NAMES:
        for smoke in (False, True):
            jcfg = jconfigs.get_smoke(name) if smoke else jconfigs.get_config(name)
            yield pytest.param(jcfg, _port_config(jcfg), id=jcfg.name)
    for name in configs.ARCH_NAMES:
        for smoke in (False, True):
            tcfg = configs.get_smoke(name) if smoke else configs.get_config(name)
            jcfg = jconfigs.get_smoke(name) if smoke else jconfigs.get_config(name)
            yield pytest.param(jcfg, tcfg, id=f"port-{tcfg.name}")


CONFIGS = list(_configs())


def test_field_sets_match():
    assert [f.name for f in dataclasses.fields(base.ModelConfig)] == \
        [f.name for f in dataclasses.fields(jbase.ModelConfig)]
    assert [f.name for f in dataclasses.fields(base.ShapeConfig)] == \
        [f.name for f in dataclasses.fields(jbase.ShapeConfig)]


def test_module_surface_matches():
    """Every public name of the reference's module is in the port's, and
    the port adds none."""
    def public(mod):
        return {n for n in vars(mod) if not n.startswith("_") and callable(getattr(mod, n))
                and getattr(getattr(mod, n), "__module__", "") == mod.__name__}
    assert public(costmodel) == public(jcost)


@pytest.mark.parametrize("jcfg,tcfg", CONFIGS)
def test_param_counts_match(jcfg, tcfg):
    assert costmodel.param_count(tcfg) == jcost.param_count(jcfg)
    assert costmodel.active_param_count(tcfg) == jcost.active_param_count(jcfg)
    for i in range(tcfg.n_layers):
        assert costmodel.layer_params(tcfg, i) == jcost.layer_params(jcfg, i), i
        assert costmodel.layer_active_params(tcfg, i) == jcost.layer_active_params(jcfg, i), i
    for bpp in (2.0, 1.0, 0.5):
        assert costmodel.weight_bytes(tcfg, bpp) == jcost.weight_bytes(jcfg, bpp)
    assert costmodel.weight_bytes(tcfg) == jcost.weight_bytes(jcfg)
    assert costmodel.param_count(tcfg) > 0


@pytest.mark.parametrize("jcfg,tcfg", CONFIGS)
@pytest.mark.parametrize("kind,seq,batch", SHAPES)
def test_shape_costs_match(jcfg, tcfg, kind, seq, batch):
    jshape = jbase.ShapeConfig("s", seq, batch, kind)
    tshape = base.ShapeConfig("s", seq, batch, kind)
    assert costmodel.model_flops(tcfg, tshape) == jcost.model_flops(jcfg, jshape)
    assert costmodel.attention_flops(tcfg, tshape) == jcost.attention_flops(jcfg, jshape)
    for nbytes in (2, 1):
        assert costmodel.kv_cache_bytes(tcfg, tshape, nbytes) == \
            jcost.kv_cache_bytes(jcfg, jshape, nbytes)
    ops = [dataclasses.astuple(o) for o in costmodel.op_graph(tcfg, tshape)]
    assert ops == [dataclasses.astuple(o) for o in jcost.op_graph(jcfg, jshape)]
    assert costmodel.model_flops(tcfg, tshape) > 0
