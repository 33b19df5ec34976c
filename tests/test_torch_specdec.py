"""The port's verify/accept kernels against the JAX package's Pallas kernels, on the CPU.

For `specdec` and `specdec_tree`, every registry shape class: the reference's
own input bundle goes through the Pallas kernel (interpret mode on the CPU,
as the reference's tests run it) and, bridged into torch, through the port's
wrapper, which on a CPU tensor runs the plain version. The outputs are
integers (picks, accept lengths, winning branches), so they must be equal.
The rows must mirror the reference's and draw the reference's inputs. Planted
within-row ties, rows of all -inf and a vocab narrower than the row are held
against Pallas too, and a single-branch tree against the chain, bit for bit.

The CUDA kernels themselves run only on a card: the `cuda`-marked tests at
the end hold each against its plain version there and skip here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import registry as jreg
from repro.kernels.specdec.specdec import (verify_accept_kernel as jchain,
                                           verify_accept_tree_kernel as jtree)
from repro_torch.core.dispatch import KernelDispatcher
from repro_torch.kernels import native
from repro_torch.kernels import registry as treg
from repro_torch.kernels.specdec import ops
from repro_torch.kernels.specdec.ref import verify_accept_ref, verify_accept_tree_ref
from repro_torch.kernels.specdec.specdec import verify_accept_kernel, verify_accept_tree_kernel

KERNELS = ("specdec", "specdec_tree")


def _cases():
    for name in KERNELS:
        for case in jreg.get(name).cases:
            yield pytest.param(name, case.name, id=f"{name}-{case.name}")


def _torch(bundle: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in bundle.items()}


@pytest.mark.parametrize("name,case_name", list(_cases()))
def test_port_matches_pallas_kernel(name, case_name):
    jspec, tspec = jreg.get(name), treg.get(name)
    case = next(c for c in jspec.cases if c.name == case_name)
    bundle = jspec.make_inputs(case, jnp.float32, np.random.default_rng(0))
    want = np.asarray(jspec.run_kernel(bundle))   # the Pallas kernel, interpret mode
    got = tspec.run_kernel(_torch(bundle))        # CPU tensor: the plain version
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert native.launch_counts()[name] == 0


@pytest.mark.parametrize("name", KERNELS)
def test_registry_rows_mirror_the_reference(name):
    jspec, tspec = jreg.get(name), treg.get(name)
    assert [(c.name, c.dims, c.edge) for c in tspec.cases] == \
        [(c.name, c.dims, c.edge) for c in jspec.cases]
    assert tspec.dtypes == (torch.float32,) and jspec.dtypes == (jnp.float32,)
    assert tspec.tol(torch.float32) == jspec.tol(jnp.float32) == (0.0, 0.0)
    assert tspec.source == "src/repro_torch/csrc/specdec.cu"
    assert tspec.replaces.startswith("src/repro/kernels/specdec/specdec.py:")
    for case in tspec.cases:           # the reference's cost: 2 ops a score
        inputs = tspec.make_inputs(case, torch.float32, np.random.default_rng(0), "cpu")
        ops_, nbytes = tspec.work(inputs)
        assert ops_ == jspec.cost(case, jnp.float32).flops
        assert nbytes >= 4.0 * np.prod(case.dims)


@pytest.mark.parametrize("name", KERNELS)
def test_make_inputs_draw_the_reference_values(name):
    jspec, tspec = jreg.get(name), treg.get(name)
    for case in jspec.cases:
        want = jspec.make_inputs(case, jnp.float32, np.random.default_rng(3))
        got = tspec.make_inputs(case, torch.float32, np.random.default_rng(3), "cpu")
        assert list(got) == list(want)
        for key in want:
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


def _stress(kind: str, shape, rng) -> np.ndarray:
    """Score rows with planted equal maxima, or all -inf."""
    s = rng.normal(size=shape).astype(np.float32)
    if kind == "ties":
        flat = s.reshape(-1, shape[-1])
        for r in range(flat.shape[0]):
            cols = rng.choice(shape[-1], size=3, replace=False)
            flat[r, cols] = flat[r].max() + 1.0
    elif kind == "neg_inf":
        s[..., :] = -np.inf
    return s


@pytest.mark.parametrize("kind", ["ties", "neg_inf"])
def test_planted_ties_and_neg_inf_rows_match_pallas(kind):
    rng = np.random.default_rng(11)
    scores = _stress(kind, (4, 5, 301), rng)
    picks = scores.argmax(-1)
    draft = picks[:, :-1].astype(np.int32)
    draft[1, 2] = (draft[1, 2] + 1) % 301                # one lane rejects at 2
    want = [np.asarray(x) for x in jchain(jnp.asarray(scores), jnp.asarray(draft))]
    got = verify_accept_kernel(torch.from_numpy(scores), torch.from_numpy(draft))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    tscores = np.stack([scores, _stress(kind, (4, 5, 301), rng)], axis=1)
    tdraft = np.stack([draft, tscores[:, 1].argmax(-1)[:, :-1].astype(np.int32)], axis=1)
    want = [np.asarray(x) for x in jtree(jnp.asarray(tscores), jnp.asarray(tdraft))]
    got = verify_accept_tree_kernel(torch.from_numpy(tscores), torch.from_numpy(tdraft))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    if kind == "neg_inf":
        assert (got[0].numpy() == 0).all()


def test_vocab_narrower_than_the_row_matches_pallas():
    """Columns at or past `vocab` never win, even when they hold the max."""
    rng = np.random.default_rng(12)
    scores = rng.normal(size=(3, 4, 300)).astype(np.float32)
    scores[..., 290:] = 50.0
    draft = scores[..., :290].argmax(-1)[:, :-1].astype(np.int32)
    want = [np.asarray(x) for x in jchain(jnp.asarray(scores), jnp.asarray(draft), vocab=290)]
    got = verify_accept_kernel(torch.from_numpy(scores), torch.from_numpy(draft), vocab=290)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert (got[0].numpy() < 290).all() and (got[1].numpy() == 3).all()


def test_single_branch_equals_chain_bitwise():
    """NBR = 1 is the chain: the same picks and accept lengths, branch 0
    (after `tests/test_serve_scheduler.py:1051`)."""
    rng = np.random.default_rng(3)
    b, t, v = 4, 5, 300
    scores = rng.normal(size=(b, t, v)).astype(np.float32)
    draft = rng.integers(0, v, size=(b, t - 1)).astype(np.int32)
    draft[0] = scores[0].argmax(-1)[:-1]               # one accept-all lane
    cs, ca = verify_accept_kernel(torch.from_numpy(scores), torch.from_numpy(draft))
    ts, ta, tb = verify_accept_tree_kernel(torch.from_numpy(scores[:, None]),
                                           torch.from_numpy(draft[:, None]))
    assert torch.equal(cs, ts) and torch.equal(ca, ta)
    assert torch.equal(tb, torch.zeros(b, dtype=torch.int32))
    assert int(ca[0]) == t - 1


def test_wrappers_refuse_bad_operands():
    s = torch.zeros(2, 3, 8)
    with pytest.raises(ValueError, match="does not pair"):
        verify_accept_kernel(s, torch.zeros(2, 3, dtype=torch.int32))
    with pytest.raises(ValueError, match="branch"):
        verify_accept_tree_kernel(torch.zeros(2, 0, 3, 8), torch.zeros(2, 0, 2))
    with pytest.raises(ValueError, match="does not pair"):
        verify_accept_tree_kernel(torch.zeros(2, 2, 3, 8), torch.zeros(2, 1, 2))
    with pytest.raises(ValueError, match="vocab"):
        verify_accept_kernel(s, torch.zeros(2, 2, dtype=torch.int32), vocab=9)
    with pytest.raises(ValueError):
        verify_accept_kernel(s.to("meta"), torch.zeros(2, 2, dtype=torch.int32).to("meta"))


def test_seeded_scores_and_routing():
    lg = torch.randn(2, 3, 8, dtype=torch.bfloat16)
    assert ops.seeded_scores(lg, "greedy").dtype == torch.float32
    with pytest.raises(NotImplementedError, match="A.16"):
        ops.seeded_scores(lg, "categorical")
    with pytest.raises(ValueError):
        ops.seeded_scores(lg, "beam")
    disp = KernelDispatcher()
    scores, draft = lg.float(), torch.zeros(2, 2, dtype=torch.int32)
    got = ops.verify_accept(scores, draft, dispatcher=disp)
    want = verify_accept_ref(scores, draft)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    got = ops.verify_accept_tree(scores[:, None], draft[:, None], dispatcher=disp)
    want = verify_accept_tree_ref(scores[:, None], draft[:, None])
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert disp.census() == {("specdec", "torch"): 1, ("specdec_tree", "torch"): 1}


# ---------------------------------------------------------------------------
# On the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", KERNELS)
def test_cuda_kernel_matches_plain_version(name, cuda_device):
    spec = treg.get(name)
    rng = np.random.default_rng(0)
    for case in spec.cases:
        inputs = spec.make_inputs(case, torch.float32, rng, cuda_device)
        before = native.launch_counts()[name]
        got = spec.run_kernel(inputs)
        torch.cuda.synchronize()
        assert native.launch_counts()[name] == before + 1
        assert torch.equal(got, spec.run_oracle(inputs))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ties", "neg_inf"])
def test_cuda_stress_rows_match_plain_version(kind, cuda_device):
    rng = np.random.default_rng(13)
    scores = torch.from_numpy(_stress(kind, (8, 2, 5, 32000), rng)).to(cuda_device)
    draft = scores.argmax(-1)[..., :-1].to(torch.int32).contiguous()
    for got, want in ((verify_accept_kernel(scores[:, 0].contiguous(), draft[:, 0].contiguous()),
                       verify_accept_ref(scores[:, 0], draft[:, 0])),
                      (verify_accept_tree_kernel(scores, draft),
                       verify_accept_tree_ref(scores, draft))):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
