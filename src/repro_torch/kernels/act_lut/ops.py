"""Named activations through the engine's 33-knot tables.

After `src/repro/kernels/act_lut/ops.py`: `table_operands(name, device)` is
the table a kernel reads (its `lut_table_operands`, :32, as one fp32 tensor
of 99 values, cached per device), `lut_activation(name)` evaluates it
through the `act_lut` kernel in ANE mode (:58) and `lut_apply_ref` through
the plain version (:43). The kernel is forward-only in the port (the
reference's custom JVP, :64-80, serves no training path: a fused epilogue's
gradient comes from the conv's plain version, `kernels/conv/ops.py`), and
`models.dispatched` refuses a gradient through an unfused `act_lut`.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core.numerics import build_lut
from repro_torch.kernels.act_lut.act_lut import act_lut
from repro_torch.kernels.act_lut.ref import act_lut_ref


@functools.cache
def _table(name: str, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(build_lut(name).kernel_operands()).to(device)


def table_operands(name: str, device) -> torch.Tensor:
    """The (99,) fp32 table of activation `name` on `device` (made once;
    callers only read it)."""
    return _table(name, torch.device(device))


def lut_activation(name: str, *, ane_mode: bool = True):
    """x -> the `act_lut` kernel's evaluation of `name` at x."""
    def f(x: torch.Tensor) -> torch.Tensor:
        return act_lut(x, table_operands(name, x.device), ane_mode=ane_mode)
    return f


def lut_apply_ref(x: torch.Tensor, name: str, *, ane_mode: bool = True) -> torch.Tensor:
    """The plain version of `lut_activation(name)(x)`."""
    return act_lut_ref(x, table_operands(name, x.device), ane_mode=ane_mode)
