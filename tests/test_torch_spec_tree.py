"""The port's tree windows (`--draft-branches 2`) against the JAX package, on the CPU.

The parity setting of `test_torch_spec.py` with two sibling draft chains per
lane: the port's greedy streams, with the self drafter and with the shrink
drafter (the reference's weights, bridged), must equal the reference
`SpeculativeSchedule`'s tokens, windows, proposals, acceptances, draft /
verify records and ProgramCache hits and misses. A tree run verifies its
K > 0 windows through the `specdec_tree` row and its K = 0 windows through
the chain row. Then the reference's tree cases on the port alone: two
floors per tree window, the CLI round trip, and the root candidates' order on
planted ties. Last, chain and tree runs with an early-exit drafter (the
target's first L-1 layers) on 8 lanes against the reference: it accepts
some proposals and not others, so the rollback keeps part of a window and
branch 1 wins some lanes.
"""

import _torch_threads  # noqa: F401

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dispatch import AsyncExecutionStream as JAsync, ProgramCache as JCache
from repro.launch.scheduler import Request as JRequest
from repro.launch.speculative import Drafter as JDrafter, SpeculativeSchedule as JSpec
from repro.models.model import build_model as jbuild
from repro_torch import configs
from repro_torch.core.dispatch import AsyncExecutionStream, KernelDispatcher, ProgramCache
from repro_torch.launch import serve
from repro_torch.launch.scheduler import Request
from repro_torch.launch.speculative import Drafter, SpeculativeSchedule, top_candidates
from repro_torch.models.model import build_model
from repro_torch.tree import tree_map
from test_torch_spec import (ARCH, V5E, _prompts, _serve, check_against_reference,
                             port_params, reference_model, spec_counts)

# enough lane-windows for an early-exit drafter to keep part of a window and
# to lose branch 0 somewhere
EXIT_LENS, EXIT_GEN, EXIT_LANES = (24, 6, 17, 16, 9, 30, 12, 20), 24, 8


def _check_tree(draft: str):
    tokens, sched = check_against_reference(draft, 2)
    assert sched.draft_branches == 2 and sched.window_kinds["tree"] > 0
    census = sched.model.dispatcher.census()
    assert census[("specdec_tree", "torch")] == sched.window_kinds["tree"]
    assert census.get(("specdec", "torch"), 0) == sched.window_kinds["chain"] \
        == sched.bonus_windows
    return sched


def test_spec_tree_self_matches_reference():
    sched = _check_tree("self")
    assert sched.acceptance_rate == 1.0     # branch 0 is the chain proposal


def test_spec_tree_shrink_matches_reference():
    sched = _check_tree("shrink")
    assert sched.accepted < sched.proposed  # the winning-branch rollback ran


@pytest.mark.parametrize("draft", ["self", "shrink"])
def test_spec_tree_categorical_schedule_invariance(draft):
    """After the reference's `test_spec_tree_categorical_schedule_invariance`
    (:1084): the root branches rank the drafter's gumbel-perturbed first
    row, every branch shares the per-(rid, pos) noise, so the emitted
    streams are the reference's sequential ones whichever branch wins, with
    the reference spec run's windows and acceptances."""
    _, sched = check_against_reference(draft, 2, "categorical")
    assert sched.window_kinds["tree"] > 0
    if draft == "self":
        assert sched.acceptance_rate == 1.0


def test_spec_tree_two_floors_per_window():
    _, sched = _serve("spec", [16, 16], 10, n_slots=2, draft="self", draft_depth=4,
                      draft_branches=2)
    recs = sched.stream.records
    draft_recs = [r for r in recs if r.key in sched._draft_keys]
    verify_recs = [r for r in recs if r.key in sched._verify_keys]
    assert len(verify_recs) == sched.n_windows == 2
    assert len(draft_recs) == 2
    assert all(r.floor_s == sched.stream.floor_s > 0.0 for r in draft_recs + verify_recs)
    st = sched.stats(2)
    assert st["draft_branches"] == 2 and st["drafter_trained"] is True
    assert st["emitted_tokens"] == 18
    assert st["windows_by_kind"] == {"tree": 2}


def test_serve_cli_spec_tree_round_trip():
    argv = ["--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "8", "--gen", "6"]
    cont = serve.run(argv + ["--schedule", "continuous"])
    out = serve.run(argv + ["--schedule", "spec", "--draft", "self", "--draft-depth", "2",
                            "--draft-branches", "2"])
    np.testing.assert_array_equal(out["tokens"], cont["tokens"])
    assert out["acceptance_rate"] == 1.0
    assert out["windows_by_kind"].get("tree", 0) > 0


def test_root_candidates_order_ties_like_top_k():
    """Planted equal maxima: the lower index comes first, as jax.lax.top_k
    orders them."""
    rng = np.random.default_rng(5)
    row = rng.normal(size=(6, 300)).astype(np.float32)
    for i, cols in enumerate([(3, 200), (250, 7, 100), (0, 299), (5, 6, 7), (150,), ()]):
        for c in cols:
            row[i, c] = 9.0
    row[5, :] = 1.0                                  # every column ties
    for n in (1, 2, 3):
        want = np.asarray(jax.lax.top_k(jnp.asarray(row), n)[1])
        got = top_candidates(torch.from_numpy(row), n)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def _exit_run(make, branches: int):
    """One spec run on the early-exit setting; `make(n_layers)` gives one
    side's model, params, config, drafter, stream, request and schedule types."""
    model, params, cfg, drafter, stream, request, cls = make(
        configs.get_smoke(ARCH).n_layers - 1)
    sched = cls(model, params, cfg, n_slots=EXIT_LANES, max_len=max(EXIT_LENS) + EXIT_GEN,
                stream=stream, drafter=drafter, draft_depth=3, draft_branches=branches)
    res = sched.run([request(i, p, EXIT_GEN)
                     for i, p in enumerate(_prompts(cfg.vocab, EXIT_LENS))])
    return {r.rid: r.tokens for r in res}, spec_counts(sched.stats(len(EXIT_LENS)),
                                                       stream.cache), sched


def _reference_exit(n: int):
    jcfg, jmodel, jparams = reference_model()
    dcfg = dataclasses.replace(jcfg, n_layers=n)
    dparams = {**jparams, "layers": jax.tree.map(lambda a: a[:n], jparams["layers"])}
    drafter = JDrafter(jbuild(dcfg, dispatcher=jmodel.dispatcher), dparams, dcfg,
                       kind="shrink", trained=True)
    return (jmodel, jparams, jcfg, drafter, JAsync(JCache(), target=V5E), JRequest, JSpec)


def _port_exit(n: int):
    cfg = configs.get_smoke(ARCH)
    model = build_model(cfg, KernelDispatcher(), device="cpu")
    params = port_params()
    dcfg = dataclasses.replace(cfg, n_layers=n)
    dparams = {**params, "layers": tree_map(lambda t: t[:n], params["layers"])}
    drafter = Drafter(build_model(dcfg, model.dispatcher, device="cpu"), dparams, dcfg,
                      kind="early_exit", trained=True)
    return (model, params, cfg, drafter, AsyncExecutionStream(ProgramCache(), device="cpu"),
            Request, SpeculativeSchedule)


@pytest.mark.parametrize("branches", [1, 2])
def test_spec_early_exit_drafter_matches_reference(branches):
    """A drafter that agrees with the target only sometimes (its first L-1
    layers, final norm and head): windows keep part of their cache writes
    and restore the rest, and in a tree branch 1 wins some lanes. Tokens and
    counts equal the reference's."""
    tokens, counts, sched = _exit_run(_port_exit, branches)
    ref_tokens, ref_counts, _ = _exit_run(_reference_exit, branches)
    for rid, want in ref_tokens.items():
        np.testing.assert_array_equal(tokens[rid], want, err_msg=f"rid {rid}")
    assert counts == ref_counts
    assert 0 < sched.accepted < sched.proposed
    assert sched.partial_accepts > 0
    if branches > 1:
        assert sched.window_kinds["tree"] > 0
        assert any(b > 0 for b in sched.branch_wins)
