"""The reference's parameters for the port's test files, drawn once a process.

Many port test files hold the port against the same reference config
(tinyllama smoke in a dozen of them), and each drew the reference's
parameters with a `Model.init` of its own: a jit compile (or some hundred
eagerly dispatched ops) of a few seconds each, repeated in every file a
worker runs. `init_params(cfg)` is that draw, `jax.jit(Model.init)` at
`PRNGKey(seed)`, memoised by (config, seed) for the process;
`packed_params(cfg, form)` the same params packed by the reference's
`compress_model_params`, memoised likewise. The trees are JAX arrays,
which nothing mutates.
"""

import functools

import jax

from repro.models.model import build_model as jbuild
from repro.optim.compression import compress_model_params as jcompress


@functools.lru_cache(maxsize=None)
def init_params(cfg, seed: int = 0):
    return jax.jit(jbuild(cfg).init)(jax.random.PRNGKey(seed))


@functools.lru_cache(maxsize=None)
def packed_params(cfg, form: str, seed: int = 0):
    return init_params(cfg, seed) if form == "fp16" else jcompress(init_params(cfg, seed), form)
