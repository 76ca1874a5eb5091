"""Port parity, the analytic cost model: every public function of the
port's `launch.costmodel` (all but the reference's `xla_cost_analysis`,
which reads XLA's compiled object) equals the JAX package's, float for
float, for every arch × shape cell × mesh model.  The port takes a mesh
as a mapping from axis to size; the reference a fake mesh with
`axis_names` and `devices`, as its own tests build one."""
import dataclasses

import numpy as np
import pytest

from repro.configs import registry as jconfigs
from repro.configs.base import SHAPE_CELLS as J_CELLS
from repro.launch import costmodel as jcm

from repro_torch.configs import registry as tconfigs
from repro_torch.configs.base import SHAPE_CELLS as T_CELLS
from repro_torch.launch import costmodel as tcm

MESHES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
          {"data": 2, "model": 4}, {"data": 4, "model": 2}]
ARCHS = jconfigs.list_archs() + ["gpt-100m"]


def _fake(shape: dict):
    class Devices:
        size = int(np.prod(list(shape.values())))
    Devices.shape = tuple(shape.values())

    class Mesh:
        axis_names = tuple(shape)
        devices = Devices
    return Mesh()


def _knobs(mod):
    return [mod.CostKnobs(),
            mod.CostKnobs(kv_cache_bytes=1, prefill_last_logits_only=True,
                          decode_kv_gather=False, moe_capacity_factor=1.0,
                          train_remat=False)]


@pytest.mark.parametrize("arch", ARCHS)
def test_every_function_equals_the_reference(arch):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert tcm.params_bytes(tcfg) == jcm.params_bytes(jcfg)
    for name in J_CELLS:
        jcell, tcell = J_CELLS[name], T_CELLS[name]
        for jk, tk in zip(_knobs(jcm), _knobs(tcm)):
            assert dataclasses.asdict(tk) == dataclasses.asdict(jk)
            assert tcm.forward_flops_total(tcfg, tcell, tk) == \
                jcm.forward_flops_total(jcfg, jcell, jk), (name, tk)
            assert tcm.kv_cache_bytes_total(tcfg, tcell, tk) == \
                jcm.kv_cache_bytes_total(jcfg, jcell, jk), (name, tk)
        for shape in MESHES:
            want = jcm.mesh_model(_fake(shape))
            assert dataclasses.asdict(tcm.mesh_model(shape)) == \
                dataclasses.asdict(want)
            for jk, tk in [(None, None), *zip(_knobs(jcm), _knobs(tcm))]:
                got = tcm.cell_costs(tcfg, tcell, shape, tk)
                ref = jcm.cell_costs(jcfg, jcell, _fake(shape), jk)
                assert got == ref, (name, shape, tk)


def test_costs_accumulate_as_the_reference():
    j, t = jcm.Costs(), tcm.Costs()
    for args in ((1.5, 2.0, 0.0), (0.25, 0.0, 3.0)):
        j.add(*args)
        t.add(*args)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (tcm.BF16, tcm.F32, tcm.ACT_TENSORS_PER_LAYER) == \
        (jcm.BF16, jcm.F32, jcm.ACT_TENSORS_PER_LAYER)
