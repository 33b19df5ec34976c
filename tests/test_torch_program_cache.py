"""The port's program cache against the JAX package's, and its CUDA graphs.

On the CPU: the port's `ProgramCache` and the reference's
`repro.core.dispatch.ProgramCache` go through one call sequence on small
functions written once for both array types (new shapes, repeats, an option,
a dtype, `is_new_compile_required`, `force_recompilation`, `purge`): equal
hits, misses, answers and compile-required verdicts. On the CPU a program is
the function itself, run eagerly, and nothing is captured. Also the
bookkeeping that makes replays count: launches and routes recorded inside a
capture are not counted until a replay adds them, and a capture's seconds
stay out of its dispatch record; and the serve CLI with every program a
`GraphProgram` over stand-in graphs that replay by rerunning (binding,
per-call copies, outputs that are arguments, captures = misses).

`cuda`-marked cases (skipped without a card; no JAX import, so they run on a
card's machine alone: `PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_program_cache.py`), at smoke size in bf16: prefill and
decode replays bit-identical to eager calls of the same function over three
calls with different per-call inputs; launches and the route census after N
replays equal N eager calls; a resident tensor in new storage gets its own
capture and right answers; a capture that fails raises; `purge` drops the
graphs; the async stream captures on a miss; a capture survives a garbage
collection of other programs' graphs.
"""

import _torch_threads  # noqa: F401

import dataclasses
import gc
import time
from collections import Counter

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core import dispatch
from repro_torch.core.dispatch import (AsyncExecutionStream, ExecutionStream, GraphProgram,
                                       KernelDispatcher, ProgramCache)
from repro_torch.kernels import native
from repro_torch.models.model import build_model


def scale_add(x, y):
    return x * y + 1.0


def total(x):
    return (x * 2.0).sum()


def _call_sequence():
    """(label, fn, shapes, dtype, options, force): the one sequence both
    caches go through."""
    return [
        ("first", scale_add, [(2, 3), (2, 3)], "float32", "", False),
        ("repeat", scale_add, [(2, 3), (2, 3)], "float32", "", False),
        ("new shape", scale_add, [(4, 3), (4, 3)], "float32", "", False),
        ("back", scale_add, [(2, 3), (2, 3)], "float32", "", False),
        ("option", scale_add, [(2, 3), (2, 3)], "float32", "o1", False),
        ("option repeat", scale_add, [(2, 3), (2, 3)], "float32", "o1", False),
        ("dtype", scale_add, [(2, 3), (2, 3)], "float16", "", False),
        ("other fn", total, [(5,)], "float32", "", False),
        ("force", scale_add, [(2, 3), (2, 3)], "float32", "", True),
        ("after force", scale_add, [(2, 3), (2, 3)], "float32", "", False),
    ]


def test_program_cache_matches_reference_call_sequence():
    import jax.numpy as jnp

    from repro.core.dispatch import ProgramCache as JCache

    rng = np.random.default_rng(0)
    tcache, jcache = ProgramCache(), JCache()

    def step(fn, shapes, dtype, options, force):
        # small integers: every product and sum is exact, so the answers
        # compare bit for bit whatever order or fusion either side uses
        arrays = [rng.integers(-8, 8, size=s).astype(dtype) for s in shapes]
        targs = [torch.from_numpy(a) for a in arrays]
        jargs = [jnp.asarray(a) for a in arrays]
        required = (tcache.is_new_compile_required(fn, *targs, options=options),
                    jcache.is_new_compile_required(fn, *jargs, options=options))
        tprog, _ = tcache.compile(fn, *targs, options=options, force_recompilation=force)
        jprog, _ = jcache.compile(fn, *jargs, options=options, force_recompilation=force)
        np.testing.assert_array_equal(np.asarray(tprog(*targs)), np.asarray(jprog(*jargs)))
        assert tprog is fn                      # the CPU runs the function eagerly
        return required

    for label, fn, shapes, dtype, options, force in _call_sequence():
        t_req, j_req = step(fn, shapes, dtype, options, force)
        assert t_req == j_req, label
        assert (tcache.stats.hits, tcache.stats.misses) == \
            (jcache.stats.hits, jcache.stats.misses), label
    assert (tcache.stats.hits, tcache.stats.misses) == (4, 6)

    tcache.purge()
    jcache.purge()
    t_req, j_req = step(scale_add, [(2, 3), (2, 3)], "float32", "", False)
    assert t_req and j_req
    assert (tcache.stats.hits, tcache.stats.misses) == \
        (jcache.stats.hits, jcache.stats.misses) == (4, 7)
    # compile seconds: the reference's XLA compiles; nothing captures on the CPU
    assert jcache.stats.compile_seconds > 0.0
    assert tcache.stats.compile_seconds == 0.0
    assert (tcache.stats.captures, tcache.stats.replays) == (0, 0)


def test_bound_methods_key_on_their_receiver():
    """A bound method is re-created per access: the key follows the function
    and the receiver, so two models' prefills are two programs and one
    model's prefill, fetched twice, is one."""
    cfg = configs.get_smoke("tinyllama-1.1b")
    a, b = build_model(cfg, device="cpu"), build_model(cfg, device="cpu")
    x = torch.zeros(2, 3)
    cache = ProgramCache()
    ka = cache.compile(a.prefill, x)[1]
    assert cache.compile(a.prefill, x)[1] == ka
    assert cache.compile(b.prefill, x)[1] != ka
    assert (cache.stats.hits, cache.stats.misses) == (1, 2)


def test_launches_and_routes_inside_a_capture_are_recorded_not_counted():
    native.reset_launch_counts()
    disp = KernelDispatcher()
    route = disp.resolve("anemm", torch.zeros(2, 2))
    with native.recording_launches() as launches, dispatch._recording_routes() as routes:
        native.count_launch("anemm")
        native.count_launch("anemm")
        native.count_launch("flash")
        disp.count(route)
    assert native.launch_counts()["anemm"] == 0 and not disp.routes
    assert launches == Counter({"anemm": 2, "flash": 1})
    assert routes == Counter({(disp, route): 1})
    for _ in range(3):                          # three replays
        native.add_launches(launches)
        dispatch._count_routes(routes)
    counts = native.launch_counts()
    assert (counts["anemm"], counts["flash"]) == (6, 3)
    assert disp.routes == Counter({route: 3})
    disp.count(route)                           # outside a capture: counted
    assert disp.routes[route] == 4
    native.reset_launch_counts()


class _CapturingProgram:
    """Stands in for a `GraphProgram` whose call captures: it spends
    `capture` seconds and books them as capture time."""

    def __init__(self, capture: float) -> None:
        self.capture = capture
        self.capture_seconds = 0.0

    def __call__(self, x):
        time.sleep(self.capture)
        self.capture_seconds += self.capture
        return x + 1


@pytest.mark.parametrize("stream_cls", [ExecutionStream, AsyncExecutionStream])
def test_stream_records_leave_capture_time_out(stream_cls):
    stream = stream_cls(ProgramCache(), device="cpu")
    program = _CapturingProgram(0.2)
    stream.encode_operation(program, (torch.zeros(4),), "captured")
    stream.execute_sync()
    rec = stream.records[-1]
    assert rec.wall_s < 0.2 and rec.complete_ts - rec.submit_ts == pytest.approx(rec.wall_s)
    if isinstance(stream, AsyncExecutionStream):
        stream.encode_operation(program, (torch.zeros(4),), "captured-async")
        stream.submit()
        stream.sync()
        assert stream.records[-1].wall_s < 0.2
        stream.close()


def test_argument_leaves_round_trip_in_tree_order():
    """The walk that binds a program's arguments and rebuilds its outputs
    visits dict keys sorted and lists in order, as `repro_torch.tree` does."""
    tree = ({"b": torch.ones(1), "a": [torch.zeros(2), 3]}, None, torch.full((3,), 2.0))
    leaves = dispatch._leaves(tree)
    assert [x if not isinstance(x, torch.Tensor) else tuple(x.shape) for x in leaves] == \
        [(2,), 3, (1,), None, (3,)]
    rebuilt = dispatch._rebuild(tree, [10, 11, 12, 13, 14])
    assert rebuilt == ({"a": [10, 11], "b": 12}, 13, 14)


class _RerunGraph:
    """A stand-in for a CUDA graph on the CPU: its capture ran the function
    (the programs served here write the same values when run twice on the
    same inputs), and a replay reruns it on the captured arguments and
    copies the results into the captured outputs, as a graph's replay
    overwrites its static outputs. Its own launches and routes are not
    counted: a replay counts the capture's."""

    def __init__(self, fn, args, out) -> None:
        self.fn, self.args, self.out = fn, args, out

    def replay(self) -> None:
        with native.recording_launches(), dispatch._recording_routes():
            new = self.fn(*self.args)
        for dst, src in zip(dispatch._leaves(self.out), dispatch._leaves(new)):
            if isinstance(dst, torch.Tensor) and dst is not src:
                dst.copy_(src)

    def reset(self) -> None:
        pass


def _rerun_capture(fn, args, device):
    out = fn(*args)
    return _RerunGraph(fn, args, out), out


SERVES = {"continuous": ["--prompt-lens", "5,8,13,16,21"],
          "spec tree": ["--prompt-lens", "5,9,17", "--schedule", "spec", "--draft",
                        "shrink", "--draft-branches", "2"]}


@pytest.mark.parametrize("serve_name", sorted(SERVES))
def test_graph_programs_bookkeeping_on_stand_in_graphs(serve_name, monkeypatch):
    """The serve CLI with every program a `GraphProgram` over stand-in
    graphs: the same tokens, routes and cache hits and misses as the eager
    run; captures = misses, no recapture (the tree verify writes its
    winners into the resident caches), replays = program dispatches less
    captures."""
    from repro_torch.launch import serve

    argv = ["--smoke", "--device", "cpu", "--batch", "2", "--gen", "5",
            "--requests", "2"] + SERVES[serve_name]
    eager = serve.run(argv)
    monkeypatch.setattr(dispatch, "_capture", _rerun_capture)
    monkeypatch.setattr(dispatch, "_on_cuda", lambda args: True)
    out = serve.run(argv)
    assert np.array_equal(out["tokens"], eager["tokens"])
    assert out["routes"] == eager["routes"]
    assert (out["cache_hits"], out["cache_misses"]) == \
        (eager["cache_hits"], eager["cache_misses"])
    named = ("admit_slot", "reset_slot", "spec_admit_slot", "spec_reset_slot")
    programs = sum(r.key not in named for r in out["records"])
    assert out["captures"] == out["cache_misses"] and out["recaptures"] == 0
    assert out["replays"] == programs - out["captures"] > 0


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs of the hand-written kernels")
    return torch.device("cuda")


def _smoke(device, seed=0):
    cfg = dataclasses.replace(configs.get_smoke("tinyllama-1.1b"), dtype="bfloat16")
    model = build_model(cfg, KernelDispatcher(), device=device)
    params = model.init(torch.Generator(device=device).manual_seed(seed))
    return cfg, model, params


def _tokens(gen, vocab, shape, device):
    return torch.randint(0, vocab, shape, generator=gen, dtype=torch.int32).to(device)


def _clone(tree):
    return dispatch._rebuild((tree,), [t.clone() if isinstance(t, torch.Tensor) else t
                                       for t in dispatch._leaves(tree)])[0]


def _same(a, b) -> bool:
    la, lb = dispatch._leaves(a), dispatch._leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y for x, y in zip(la, lb))


def _filled_cache(model, lanes, max_len, gen):
    """A decode cache with every slot before 24 valid and random K/V."""
    caches = model.init_cache(lanes, max_len)
    for leaf in dispatch._leaves(caches):
        if leaf.dtype == torch.int32:
            leaf[..., :24] = torch.arange(24, dtype=torch.int32, device=leaf.device)
        else:
            leaf.copy_(torch.randn(leaf.shape, generator=gen).to(leaf))
    return caches


@pytest.mark.cuda
def test_cuda_prefill_and_decode_replays_equal_eager_calls(cuda_device):
    cfg, model, params = _smoke(cuda_device)
    gen = torch.Generator().manual_seed(1)
    cache = ProgramCache()
    for bucket in (8, 16):
        batch = {"tokens": _tokens(gen, cfg.vocab, (1, bucket), cuda_device)}
        prog, _ = cache.compile(model.prefill, params, batch, per_call=(1,))
        assert isinstance(prog, GraphProgram)
        for call in range(3):
            batch = {"tokens": _tokens(gen, cfg.vocab, (1, bucket), cuda_device)}
            want = model.prefill(params, {"tokens": batch["tokens"].clone()})
            got = prog(params, batch)
            torch.cuda.synchronize()
            assert _same(got, want), (bucket, call)
    caches = _filled_cache(model, 4, 32, gen)
    tok = _tokens(gen, cfg.vocab, (4, 1), cuda_device)
    pos = torch.full((4,), 24, dtype=torch.int32, device=cuda_device)
    prog, _ = cache.compile(model.decode_step, params, caches, tok, pos, per_call=(2, 3))
    for call in range(3):
        tok = _tokens(gen, cfg.vocab, (4, 1), cuda_device)
        pos = torch.full((4,), 24 + call, dtype=torch.int32, device=cuda_device)
        eager_caches = _clone(caches)
        want_caches, want = model.decode_step(params, eager_caches, tok.clone(), pos.clone())
        got_caches, got = prog(params, caches, tok, pos)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and _same(got_caches, want_caches), call
        assert all(a is b for a, b in zip(dispatch._leaves(got_caches),
                                           dispatch._leaves(caches)))
    assert (cache.stats.captures, cache.stats.replays, cache.stats.recaptures) == (3, 6, 0)
    assert cache.stats.compile_seconds > 0.0


@pytest.mark.cuda
def test_cuda_replays_count_launches_and_routes_as_eager_calls(cuda_device):
    cfg, model, params = _smoke(cuda_device)
    gen = torch.Generator().manual_seed(2)
    caches = _filled_cache(model, 4, 32, gen)
    tok = _tokens(gen, cfg.vocab, (4, 1), cuda_device)
    pos = torch.full((4,), 24, dtype=torch.int32, device=cuda_device)
    n = 5

    native.reset_launch_counts()
    model.dispatcher.routes.clear()
    eager = _clone(caches)
    for _ in range(n):
        model.decode_step(params, eager, tok, pos)
    torch.cuda.synchronize()
    want_launches, want_routes = native.launch_counts(), dict(model.dispatcher.census())

    prog, _ = ProgramCache().compile(model.decode_step, params, caches, tok, pos,
                                     per_call=(2, 3))
    prog(params, caches, tok, pos)              # eager run, then the capture
    native.reset_launch_counts()
    model.dispatcher.routes.clear()
    for _ in range(n):
        prog(params, caches, tok, pos)
    torch.cuda.synchronize()
    assert native.launch_counts() == want_launches
    assert model.dispatcher.census() == want_routes
    assert want_launches["anemm"] == n * (7 * cfg.n_layers + 1)


@pytest.mark.cuda
def test_cuda_new_resident_storage_gets_its_own_capture(cuda_device):
    cfg, model, params = _smoke(cuda_device)
    gen = torch.Generator().manual_seed(3)
    first = _filled_cache(model, 4, 32, gen)
    tok = _tokens(gen, cfg.vocab, (4, 1), cuda_device)
    pos = torch.full((4,), 24, dtype=torch.int32, device=cuda_device)
    cache = ProgramCache()
    prog, _ = cache.compile(model.decode_step, params, first, tok, pos, per_call=(2, 3))
    prog(params, first, tok, pos)
    second = _filled_cache(model, 4, 32, gen)    # alive beside the first: new storage
    for caches in (second, first, second):
        want_caches, want = model.decode_step(params, _clone(caches), tok, pos)
        got_caches, got = prog(params, caches, tok, pos)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and _same(got_caches, want_caches)
    assert (cache.stats.captures, cache.stats.recaptures, cache.stats.replays) == (2, 1, 2)
    assert cache.stats.misses == 1


@pytest.mark.cuda
def test_cuda_failed_capture_raises(cuda_device):
    """A host sync cannot be captured: the eager first run succeeds, the
    capture raises, and the card stays usable."""
    def host_sync(x):
        return x * float(x.sum().item())

    x = torch.ones(8, device=cuda_device)
    cache = ProgramCache()
    prog, _ = cache.compile(host_sync, x, per_call=(0,))
    with pytest.raises(RuntimeError):
        prog(x)
    assert cache.stats.captures == 0
    assert torch.equal((x + 1).cpu(), torch.full((8,), 2.0))


@pytest.mark.cuda
def test_cuda_purge_releases_graphs_and_async_stream_captures(cuda_device):
    cfg, model, params = _smoke(cuda_device)
    gen = torch.Generator().manual_seed(4)
    caches = _filled_cache(model, 4, 32, gen)
    tok = _tokens(gen, cfg.vocab, (4, 1), cuda_device)
    pos = torch.full((4,), 24, dtype=torch.int32, device=cuda_device)
    cache = ProgramCache()
    stream = AsyncExecutionStream(cache, device=cuda_device, max_in_flight=2)
    prog, key = cache.compile(model.decode_step, params, caches, tok, pos, per_call=(2, 3))
    logits = []
    for _ in range(4):                          # capture on the first submit
        stream.encode_operation(prog, (params, caches, tok, pos), key)
        logits.append(stream.submit()[0][1].clone())
    stream.sync()
    stream.close()
    assert (cache.stats.captures, cache.stats.replays) == (1, 3)
    cache.purge()
    assert cache.is_new_compile_required(model.decode_step, params, caches, tok, pos)
    prog(params, caches, tok, pos)              # a purged program captures again
    assert cache.stats.captures == 2
    assert all(torch.isfinite(lg).all() for lg in logits)


@pytest.mark.cuda
def test_cuda_capture_survives_a_collection_of_other_graphs(cuda_device):
    """Graphs of a dropped cache that only the cyclic collector frees: with
    the collector run on (nearly) every allocation, a collection inside the
    next capture would destroy them there and invalidate it."""
    def affine(x):
        return (x * 2.0 + 1.0).sum(0)

    x = torch.ones(64, 64, device=cuda_device)
    threshold = gc.get_threshold()
    gc.set_threshold(1)
    try:
        for _ in range(4):
            cache = ProgramCache()
            prog, _ = cache.compile(affine, x, per_call=(0,))
            prog(x)
            out = prog(x)
            assert cache.stats.replays == 1 and torch.equal(out, affine(x))
            cycle = [cache]
            cycle.append(cycle)
            del cache, prog, cycle
    finally:
        gc.set_threshold(*threshold)

