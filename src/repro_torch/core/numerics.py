"""The 33-knot piecewise-linear activation tables of the port (paper §3.5).

A copy of the LUT half of `src/repro/core/numerics.py`: `round_fp16` (:44),
`LutTable` (:305), `_optimal_knots` (:341), `f_at` (:371), `_LUT_SPECS`
(:379), `_erf_np` (:395), `_ORIGIN_BIAS` (:399), `build_lut` (:401) and
`lut_worst_error` (:417), with the same arithmetic in numpy float64, so
`build_lut(name)` gives the reference's table bit for bit. The port keeps
its own copy: it imports nothing of the JAX package. The `act_lut` kernel
and the fused epilogues of `anemm` and `conv2d` evaluate these tables.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Literal

import numpy as np

from repro_torch.core import hal

TieMode = Literal["even", "away"]


def round_fp16(x: np.ndarray | float, tie: TieMode = "even") -> np.ndarray:
    """Round float64 values onto the fp16 grid with the given tie mode.

    numpy's float16 cast is IEEE round-half-to-even; the half-away mode is
    synthesized by nudging exact ties away from zero before the cast.
    """
    x = np.asarray(x, dtype=np.float64)
    with np.errstate(over="ignore", invalid="ignore"):
        f16 = np.float16(x).astype(np.float64)        # IEEE RTNE result
    if tie == "even":
        return f16
    up = np.nextafter(np.float16(f16), np.float16(np.inf)).astype(np.float64)
    dn = np.nextafter(np.float16(f16), np.float16(-np.inf)).astype(np.float64)
    lo = np.where(f16 <= x, f16, dn)
    hi = np.where(f16 <= x, up, f16)
    is_tie = np.isfinite(x) & (lo != hi) & ((x - lo) == (hi - x))
    away = np.where(x > 0, hi, lo)
    return np.where(is_tie, away, f16)


@dataclasses.dataclass(frozen=True)
class LutTable:
    """One decoded activation table: 33 knots, 32 linear segments, end clamps."""

    name: str
    xs: np.ndarray          # (33,) knot abscissae, ascending
    ys: np.ndarray          # (33,) knot ordinates (fp16-rounded, as stored)
    lo_clamp: float         # asymptote value left of the domain
    hi_clamp: float         # asymptote value right of the domain

    @property
    def slopes(self) -> np.ndarray:
        return (self.ys[1:] - self.ys[:-1]) / (self.xs[1:] - self.xs[:-1])

    @property
    def intercepts(self) -> np.ndarray:
        return self.ys[:-1] - self.slopes * self.xs[:-1]

    def __call__(self, x: np.ndarray) -> np.ndarray:
        """Evaluate: NaN coerces to the hi clamp (the +inf coercion), values
        past the table domain clamp to the end-knot asymptote, in-domain
        values evaluate as slope*x + intercept in fp16."""
        x = np.asarray(x, dtype=np.float64)
        x = np.where(np.isnan(x), np.inf, x)
        idx = np.clip(np.searchsorted(self.xs, x, side="right") - 1, 0, 31)
        s, c = self.slopes[idx], self.intercepts[idx]
        val = round_fp16(s * x + c)
        val = np.where(x < self.xs[0], self.lo_clamp, val)
        val = np.where(x > self.xs[-1], self.hi_clamp, val)
        return val

    def kernel_operands(self) -> np.ndarray:
        """The 99 float32 values a kernel reads: xs (33), slopes (32),
        intercepts (32), then the lo and hi clamps. Raises unless the
        float32 knots are non-decreasing: the kernels find the segment by a
        search that equals the reference's compare count only then
        (`csrc/lut_eval.cuh`)."""
        ops = np.concatenate([self.xs, self.slopes, self.intercepts,
                              [self.lo_clamp, self.hi_clamp]]).astype(np.float32)
        if not np.all(ops[1:33] >= ops[:32]):
            raise ValueError(f"LUT {self.name!r}: knots not non-decreasing: {ops[:33]}")
        return ops


def _optimal_knots(fn: Callable, lo: float, hi: float, n: int) -> np.ndarray:
    """Knot placement with density ~ |f''|^(1/2), the optimal rate for PWL
    interpolation, then Lloyd-style refinement that equalizes the
    per-segment error."""
    grid = np.linspace(lo, hi, 4097)
    h = grid[1] - grid[0]
    f = fn(grid)
    f2 = np.abs(np.gradient(np.gradient(f, h), h))
    density = np.sqrt(f2) + 1e-4 * np.max(np.sqrt(f2) + 1e-30)
    cdf = np.cumsum(density)
    cdf = (cdf - cdf[0]) / (cdf[-1] - cdf[0])
    qs = np.linspace(0.0, 1.0, n)
    xs = np.interp(qs, cdf, grid)
    xs[0], xs[-1] = lo, hi
    for _ in range(6):
        seg_err = np.empty(xs.size - 1)
        for i in range(xs.size - 1):
            g = np.linspace(xs[i], xs[i + 1], 65)
            lin = f_at(fn, xs[i], xs[i + 1], g)
            seg_err[i] = np.max(np.abs(fn(g) - lin))
        w = np.repeat(np.power(seg_err + 1e-12, 0.5), 1)
        cdf = np.concatenate([[0.0], np.cumsum(w)])
        cdf = cdf / cdf[-1]
        xs = np.interp(np.linspace(0, 1, n), cdf, xs)
        xs[0], xs[-1] = lo, hi
    return xs


def f_at(fn, x0, x1, g):
    """Chord of fn between x0 and x1, evaluated at grid g."""
    y0 = fn(np.asarray(x0, dtype=np.float64))
    y1 = fn(np.asarray(x1, dtype=np.float64))
    t = (g - x0) / (x1 - x0)
    return y0 + t * (y1 - y0)


def _erf_np(x):
    # vectorized erf without scipy
    return np.vectorize(math.erf)(np.asarray(x, dtype=np.float64))


_LUT_SPECS: dict[str, tuple[Callable, float, float, float, float]] = {
    # name: (fn, lo, hi, lo_clamp, hi_clamp)
    "sigmoid": (lambda x: 1 / (1 + np.exp(-x)), *hal.SIGMOID_DOMAIN, 0.0, 1.0),
    "tanh": (np.tanh, -3.6, 3.6, -1.0, 1.0),
    "gelu": (lambda x: x * 0.5 * (1 + _erf_np(x / math.sqrt(2))), -6.0, 6.0, 0.0, np.inf),
    "swish": (lambda x: x / (1 + np.exp(-x)), -9.0, 9.0, 0.0, np.inf),
    "erf": (lambda x: _erf_np(x), -3.9, 3.9, -1.0, 1.0),
    "exp": (np.exp, -11.1, 11.05, 0.0, np.inf),
    # exp's hi clamp stays +inf: past ln(65504) ~ 11.094 a bare exp overflows
    "softplus": (lambda x: np.logaddexp(0.0, x), -10.0, 10.0, 0.0, 0.0),
    # softplus(+inf) -> +0 is a measured table collapse (§3.6), hence hi_clamp=0
    "softsign": (lambda x: x / (1 + np.abs(x)), -16.0, 16.0, -1.0, 0.0),
    "sin": (np.sin, -math.pi, math.pi, 0.0, 0.0),
    "cos": (np.cos, -math.pi, math.pi, 0.0, 0.0),
}

_ORIGIN_BIAS = {"gelu": -0.000543, "swish": -0.001259}   # paper:T3.3


def build_lut(name: str, knots: int = hal.LUT_KNOTS) -> LutTable:
    """Fit the 33-knot table for one activation; gelu/swish carry the decoded
    constant origin bias the paper reports."""
    fn, lo, hi, lo_clamp, hi_clamp = _LUT_SPECS[name]
    xs = _optimal_knots(fn, lo, hi, knots)
    ys = fn(xs)
    if name in _ORIGIN_BIAS:
        # shift the whole table by the decoded origin bias so eval(0) matches
        i = np.argmin(np.abs(xs))
        xs[i] = 0.0
        ys = fn(xs) + _ORIGIN_BIAS[name]
    ys = round_fp16(ys)
    if hi_clamp == np.inf and name != "exp":
        hi_clamp = float(ys[-1])
    return LutTable(name=name, xs=xs, ys=ys, lo_clamp=float(lo_clamp),
                    hi_clamp=float(hi_clamp))


def lut_worst_error(table: LutTable, n: int = 20001) -> float:
    """Worst absolute error of the table against the exact function over its
    domain."""
    fn = _LUT_SPECS[table.name][0]
    xs = np.linspace(table.xs[0], table.xs[-1], n)
    exact = fn(xs)
    if table.name in _ORIGIN_BIAS:
        exact = exact + _ORIGIN_BIAS[table.name]
    err = np.abs(table(xs) - exact)
    return float(np.max(err[np.isfinite(err)]))
