"""The port's one-device MoE (dbrx-132b) against the JAX package's, on the CPU.

dbrx-132b smoke (3 layers, 4 experts, top-2, layernorm, untied head), from
the reference's own parameters bridged into the port; the JAX model runs
under `KernelDispatcher(TPU_V5E)` (Pallas kernels in interpret mode), the
port on the CPU (plain versions). `moe_dense` alone: gates, expert indices,
the load-balance loss and the output against the reference's on a smoke
block, and on ties (equal router columns), where both take the lower expert
first. The whole model: prefill and decode logits within 4x the `anemm`
tolerance, dense and under `int4_palette` (the reference's packed
parameters, expert banks packed with the expert dim as a stack dim, within
4x the `palette` tolerance); greedy streams token-exact against the
reference's continuous schedule, continuous and sequential. JAX runs are
memoised.
"""

import _torch_threads  # noqa: F401

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import hal as jhal
from repro.core.dispatch import (ExecutionStream as JStream, KernelDispatcher as JDispatcher,
                                 ProgramCache as JCache)
from repro.kernels import registry as jreg
from repro.launch.scheduler import (ContinuousSchedule as JContinuous, Request as JRequest,
                                    merge_prefill_caches as jmerge)
from repro.models import dispatched as jdsp
from repro.models import moe as jmoe
from repro.models.model import Model as JModel, build_model as jbuild
from _reference_params import packed_params
from repro_torch import configs
from repro_torch.bridge import params_from_numpy
from repro_torch.core.dispatch import ExecutionStream, KernelDispatcher, ProgramCache
from repro_torch.launch.scheduler import (ContinuousSchedule, Request, SequentialSchedule,
                                          merge_prefill_caches)
from repro_torch.models import dispatched as dsp
from repro_torch.models import moe
from repro_torch.models.model import build_model
from repro_torch.optim.compression import weight_form_census
from repro_torch.tree import leaves_with_path, map_with_path

ARCH = "dbrx-132b"
B, S, DECODE_STEPS = 2, 12, 3
LENS, GEN, LANES = (5, 8, 13), 4, 2


def _configs():
    return jconfigs.get_smoke(ARCH), configs.get_smoke(ARCH)


def _tol(kernel: str) -> tuple[float, float]:
    rtol, atol = jreg.get(kernel).tol(jnp.float32)
    return 4 * rtol, 4 * atol


@functools.lru_cache(maxsize=None)
def reference(form: str = "fp16"):
    """(jmodel, jparams, the port's bridged params), dense or packed by the
    reference's `compress_model_params`."""
    jcfg, tcfg = _configs()
    jmodel = jbuild(jcfg, dispatcher=JDispatcher(jhal.TPU_V5E))
    jparams = packed_params(jcfg, form)
    return jmodel, jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")


@functools.lru_cache(maxsize=None)
def logits_run(form: str) -> dict:
    jcfg, tcfg = _configs()
    jmodel, jparams, tparams = reference(form)
    tdisp = KernelDispatcher()
    tmodel = build_model(tcfg, tdisp, device="cpu")
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab, size=(B, S)).astype(np.int32)
    jcaches, jlg = jax.jit(jmodel.prefill)(jparams, {"tokens": jnp.asarray(tokens)})
    tcaches, tlg = tmodel.prefill(tparams, {"tokens": torch.from_numpy(tokens)})
    steps = [(np.asarray(jlg), tlg.numpy())]
    max_len = S + DECODE_STEPS + 1
    jcaches = jmerge(jmodel.init_cache(B, max_len), jcaches)
    tcaches = merge_prefill_caches(tmodel.init_cache(B, max_len), tcaches)
    jdecode = jax.jit(jmodel.decode_step)
    tok = np.argmax(np.asarray(jlg)[:, -1, :jcfg.vocab], -1).astype(np.int32)[:, None]
    for i in range(DECODE_STEPS):
        pos = np.full((B,), S + i, np.int32)
        jcaches, jdl = jdecode(jparams, jcaches, jnp.asarray(tok), jnp.asarray(pos))
        tcaches, tdl = tmodel.decode_step(tparams, tcaches, torch.from_numpy(tok),
                                          torch.from_numpy(pos))
        steps.append((np.asarray(jdl), tdl.numpy()))
        tok = np.argmax(np.asarray(jdl)[:, -1, :jcfg.vocab], -1).astype(np.int32)[:, None]
    return {"steps": steps, "routes": tdisp.census(), "params": tparams}


@functools.lru_cache(maxsize=None)
def streams() -> dict:
    jcfg, tcfg = _configs()
    jmodel, jparams, tparams = reference()
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, jcfg.vocab, size=(L,)).astype(np.int32) for L in LENS]
    max_len = max(LENS) + GEN
    jsched = JContinuous(jmodel, jparams, jcfg, n_slots=LANES, max_len=max_len,
                         sampling="greedy", seed=0, stream=JStream(JCache(), target=jhal.TPU_V5E))
    out = {"reference": jsched.run([JRequest(i, p, GEN) for i, p in enumerate(prompts)])}
    tmodel = build_model(tcfg, KernelDispatcher(), device="cpu")
    for name, cls, kw in (("continuous", ContinuousSchedule, {"n_slots": LANES}),
                          ("sequential", SequentialSchedule, {})):
        sched = cls(tmodel, tparams, tcfg, max_len=max_len, sampling="greedy",
                    stream=ExecutionStream(ProgramCache(), device="cpu"), **kw)
        out[name] = sched.run([Request(i, p, GEN) for i, p in enumerate(prompts)])
    return out


# ---------------------------------------------------------------------------
# moe_dense alone
# ---------------------------------------------------------------------------


def _block(router=None):
    """A dbrx smoke MoE block (the reference's init) and its port twin, and
    seeded tokens (2, 5, d)."""
    jcfg, tcfg = _configs()
    jp = jmoe.init_moe(jax.random.PRNGKey(3), jcfg, jnp.float32)
    if router is not None:
        jp = dict(jp, router=jnp.asarray(router(np.asarray(jp["router"]))))
    tp = map_with_path(lambda _, a: torch.from_numpy(np.array(a)), jax.tree.map(np.asarray, jp))
    x = np.random.default_rng(4).normal(size=(2, 5, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, tp, x


def _moe_both(jcfg, tcfg, jp, tp, x):
    with jdsp.use_dispatcher(JDispatcher(jhal.TPU_V5E)):
        jgates, jidx, jaux = jmoe._route(jcfg, jp["router"],
                                         jnp.asarray(x.reshape(-1, x.shape[-1])))
        jout, jaux2 = jmoe.moe_dense(jcfg, jp, jnp.asarray(x))
    with dsp.use_dispatcher(KernelDispatcher()):
        gates, idx, aux = moe.route(tcfg, tp["router"],
                                    torch.from_numpy(x.reshape(-1, x.shape[-1])))
        out, aux2 = moe.moe_forward(tcfg, tp, torch.from_numpy(x))
    return (np.asarray(jgates), np.asarray(jidx), float(jaux), np.asarray(jout), float(jaux2)), \
        (gates.numpy(), idx.numpy(), float(aux), out.numpy(), float(aux2))


def test_moe_dense_matches_reference():
    want, got = _moe_both(*_block())
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6)
    np.testing.assert_allclose(got[3], want[3], *_tol("anemm"))
    assert got[4] == pytest.approx(want[4], rel=1e-6)


@pytest.mark.parametrize("tie", ["all_equal", "straddle"])
def test_moe_dense_ties_take_the_lower_expert(tie):
    """All router columns equal (every token: experts 0 and 1, gates 1/2),
    or experts 1 and 3 equal: 3 is picked only after 1, the lower index
    first, as `jax.lax.top_k` orders equal values."""
    def router(w):
        w = w.copy()
        if tie == "all_equal":
            w[:] = w[:, :1]
        else:
            w[:, 3] = w[:, 1]
        return w

    want, got = _moe_both(*_block(router))
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[3], want[3], *_tol("anemm"))
    if tie == "all_equal":
        assert (got[1] == [0, 1]).all() and np.allclose(got[0], 0.5)
    else:
        # 3 ties 1: it is picked only after 1, never in 1's place
        for row in got[1]:
            assert 3 not in row or list(row).index(1) < list(row).index(3), row
        assert any(list(row) == [1, 3] for row in got[1])


def test_router_rows_do_not_change_with_the_row_count():
    """The router's pairwise fp32 sum is per row: 8 rows give the bits of the
    first 8 of 16 (a tree verify window runs 16 rows where decode runs 8)."""
    _, tcfg, _, tp, _ = _block()
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(16, tcfg.d_model))
                         .astype(np.float32))
    a = moe.route(tcfg, tp["router"], x[:8])
    b = moe.route(tcfg, tp["router"], x)
    assert torch.equal(a[0], b[0][:8]) and torch.equal(a[1], b[1][:8])
    want = (x.double() @ tp["router"].double()).float()
    torch.testing.assert_close(moe.router_logits(x, tp["router"]), want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("form,kernel", [("fp16", "anemm"), ("int4_palette", "palette")])
def test_prefill_and_decode_logits_match_reference(form, kernel):
    run = logits_run(form)
    for step, (want, got) in enumerate(run["steps"]):
        assert got.shape == want.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, *_tol(kernel), err_msg=f"{form} step {step}")
    assert {k for k, _ in run["routes"]} == {kernel, "flash", "decode_attention"}
    if form != "fp16":
        # 4 attention projections, 3 expert banks and the head, per stack
        census = weight_form_census(run["params"])
        assert sorted(p.rsplit("/", 2)[-2] + "/" + p.rsplit("/", 1)[-1] for p in census) == \
            sorted(["mix/wq", "mix/wk", "mix/wv", "mix/wo", "moe/wg", "moe/wu", "moe/wd",
                    "embed/unembed"])
        bank = dict(leaves_with_path(run["params"], is_leaf=lambda x: isinstance(
            x, dsp.DispatchedWeight)))["layers/0/sub0/moe/wg"]
        assert bank.n_stack == 2 and bank.index(0).index(1).n_stack == 0


@pytest.mark.parametrize("schedule", ["continuous", "sequential"])
def test_greedy_streams_token_exact_against_reference(schedule):
    run = streams()
    assert [r.rid for r in run[schedule]] == [r.rid for r in run["reference"]]
    for j, t in zip(run["reference"], run[schedule]):
        np.testing.assert_array_equal(t.tokens, j.tokens, err_msg=f"rid {j.rid}")


def test_init_matches_reference_tree_and_groups():
    """The reference's tree (router fp32, stacked banks), and the layer
    groups follow the runs of equal signature: one leading dense layer is a
    group of its own."""
    jcfg, tcfg = _configs()
    jshape = jax.eval_shape(jbuild(jcfg).init, jax.random.PRNGKey(0))
    want = [(p, tuple(x.shape), jnp.dtype(x.dtype).name) for p, x in JModel.named_leaves(jshape)]
    got = [(p, tuple(x.shape), str(x.dtype).removeprefix("torch."))
           for p, x in leaves_with_path(build_model(tcfg, device="cpu").init(
               torch.Generator().manual_seed(0)))]
    assert got == want
    from repro.models.transformer import layer_groups as jgroups
    from repro_torch.models.transformer import layer_groups

    lead = dataclasses.replace(tcfg, n_dense_layers=1)
    jlead = dataclasses.replace(jcfg, n_dense_layers=1)
    assert layer_groups(lead) == jgroups(jlead) == [(( ("attn", False),), 1),
                                                     ((("attn", True),), 2)]
    model = build_model(lead, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    assert "mlp" in params["layers"][0]["sub0"] and "moe" in params["layers"][1]["sub0"]
    tokens = torch.randint(0, lead.vocab, (2, 8), dtype=torch.int32)
    _, lg = model.prefill(params, {"tokens": tokens})
    assert torch.isfinite(lg).all()


def test_bridge_carries_every_leaf_bit_for_bit():
    """The reference's numpy tree, the int4_palette-packed one included:
    the fp32 router, the stacked expert banks' payloads (layer and expert
    dims leading) and every other leaf arrive bit for bit."""
    from repro.models.model import Model as JM

    for form in ("fp16", "int4_palette"):
        _, jparams, tparams = reference(form)
        want = {p: np.asarray(x) for p, x in JM.named_leaves(jparams)}
        got = {}
        for path, leaf in leaves_with_path(tparams):
            t = leaf.float() if leaf.dtype == torch.bfloat16 else leaf
            got[path] = t.numpy()
        assert got.keys() == want.keys()
        for path in want:
            w = want[path]
            w = w.astype(np.float32) if w.dtype.name == "bfloat16" else w
            np.testing.assert_array_equal(got[path], w, err_msg=f"{form} {path}")
        assert got["layers/0/sub0/moe/router"].dtype == np.float32
