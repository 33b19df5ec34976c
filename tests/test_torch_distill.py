"""The port's drafter distillation against the JAX package's, on the CPU.

tinyllama-1.1b smoke (fp32). Both packages take the same weights: drawn
by the port's `init` (the teacher from seed 0, the student `draft_of`'s
from seed 1), handed to the reference as numpy and to the port through
`repro_torch.bridge`, so no JAX init is compiled. Each JAX run is memoised
for the module.

- `make_distill_loss` on the same student params, batch and teacher
  logits: `loss`, `kl`, `ce` within 2e-5 relative, `agree` equal, and every
  gradient leaf within 1e-4 of the leaf's largest |value| (at least 1e-7 of
  the tree's largest gradient, the floor of `test_torch_train.py`) against
  `jax.value_and_grad` of the reference's loss; kl_weight 0, 0.75 and 1, T
  1 and 2, over the whole vocab and with the last 12 of 512 logit columns
  masked as padded slots (vocab 500). At a masked slot the KL's term is 0
  exactly in fp32 in both frameworks.
- `make_teacher_logits_fn` against the reference's: within 2e-5 (rtol and
  atol), fp32, detached.
- Three `distill_student` steps at T = 2 (the student's init handed to
  both): the logged losses within 2e-5, each printed metric equal at its
  printed precision, every param within 1e-5 + 1e-4·|p| (the bound of the
  train-step test).
- The port's whole pipeline at the reference tier's knobs
  (`tests/test_train.py` `_distill_bundle`: teacher 60 steps, 80 student
  steps, seq 48): the reference's bars, agreement >= 0.6 and, through the
  port's `SpeculativeSchedule`, acceptance >= 0.4 and above the
  random-init drafter's; `rollout_agreement` of the reference on the same
  trained pair (bridged) equals the port's.
- Checkpoints both ways: the reference's `load_teacher` and
  `Drafter.shrink(ckpt=)` read the port CLI's `teacher/` and `student/`
  (dense, and `int4_palette` with its form tags) bit for bit; the port's
  `load_teacher`, `Drafter.shrink(ckpt=)` and the serve CLI's `--ckpt` /
  `--draft-ckpt` read the ones the reference's `distill.run` wrote.
- The CLI's refusals: a teacher of another vocab, a missing directory,
  kl_weight outside [0, 1], and no CUDA device without `--device cpu`.
"""

import _torch_threads  # noqa: F401

import contextlib
import functools
import io
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint.checkpoint import CheckpointManager as JCheckpointManager
from repro.launch import distill as jdistill
from repro.launch.speculative import Drafter as JDrafter
from repro.launch.speculative import draft_of as jdraft_of
from repro.models.dispatched import DispatchedWeight as JDispatchedWeight
from repro.models.model import Model as JModel
from repro.models.model import build_model as jbuild
from repro_torch import configs
from repro_torch.bridge import params_from_numpy
from repro_torch.core.dispatch import AsyncExecutionStream, ProgramCache
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import distill, serve
from repro_torch.launch.scheduler import Request
from repro_torch.launch.speculative import Drafter, SpeculativeSchedule, draft_of
from repro_torch.models.dispatched import DispatchedWeight
from repro_torch.models.model import Model, build_model
from repro_torch.optim.compression import compress_model_params
from repro_torch.tree import leaves_with_path, tree_map

ARCH = "tinyllama-1.1b"
JCFG, TCFG = jconfigs.get_smoke(ARCH), configs.get_smoke(ARCH)
B, S = 2, 16
# kl_weight 0, 0.75 and 1; T 1 and 2; vocab 500 masks the last 12 columns
LOSS_CASES = [(0.0, 1.0, 512), (0.75, 1.0, 500), (0.75, 2.0, 512), (1.0, 2.0, 500)]
# the reference tier's knobs (tests/test_train.py `_distill_bundle`)
TIER = dict(teacher_steps=60, steps=80, batch=8, seq=48, lr=3e-3, kl_weight=0.75,
            temperature=1.0, seed=0, eval_steps=8, log_every=40)
ZERO_GRAD_FLOOR = 1e-7


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


@functools.lru_cache(maxsize=None)
def init_params(student: bool) -> dict:
    """The teacher's (seed 0) or the student's (seed 1) smoke params as
    numpy leaves in the reference's tree layout, drawn by the port."""
    cfg = draft_of(TCFG) if student else TCFG
    params = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(int(student)))
    return tree_map(lambda t: t.numpy(), params)


def _port_params(student: bool):
    return params_from_numpy(init_params(student), draft_of(TCFG) if student else TCFG, "cpu")


def _batch(vocab: int) -> dict[str, np.ndarray]:
    src = SyntheticLM(DataConfig(vocab=vocab, seq_len=S, global_batch=B))
    return src.batch(distill.STUDENT_STEP_OFFSET)


def _leaves(tree, named) -> dict[str, np.ndarray]:
    return {p: _np(x) for p, x in named(tree)}


# ---------------------------------------------------------------------------
# the loss and the teacher's logits
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def reference_teacher_logits(vocab: int) -> np.ndarray:
    fn = jdistill.make_teacher_logits_fn(jbuild(JCFG), JCFG)
    return np.asarray(fn(_jtree(init_params(False)), jnp.asarray(_batch(vocab)["tokens"])))


def test_teacher_logits_match_reference():
    want = reference_teacher_logits(512)
    tparams = _port_params(False)
    for _, t in leaves_with_path(tparams):
        t.requires_grad_(True)           # as inside a train step: still no graph
    got = distill.make_teacher_logits_fn(build_model(TCFG, device="cpu"))(
        tparams, torch.from_numpy(_batch(512)["tokens"]))
    assert got.dtype == torch.float32 and got.shape == (B, S, TCFG.padded_vocab)
    assert not got.requires_grad and got.grad_fn is None
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@functools.lru_cache(maxsize=None)
def reference_loss(kl_weight: float, temperature: float, vocab: int):
    student = jbuild(jdraft_of(JCFG))
    loss_fn = jdistill.make_distill_loss(student, vocab, kl_weight=kl_weight,
                                         temperature=temperature)
    batch = {k: jnp.asarray(v) for k, v in _batch(vocab).items()}
    batch["teacher_logits"] = jnp.asarray(reference_teacher_logits(vocab))
    (_, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        _jtree(init_params(True)), batch)
    return {k: float(v) for k, v in metrics.items()}, _leaves(grads, JModel.named_leaves)


@pytest.mark.parametrize("kl_weight,temperature,vocab", LOSS_CASES)
def test_distill_loss_and_gradients_match_reference(kl_weight, temperature, vocab):
    want_metrics, want = reference_loss(kl_weight, temperature, vocab)
    params = _port_params(True)
    named = leaves_with_path(params)
    for _, t in named:
        t.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in _batch(vocab).items()}
    batch["teacher_logits"] = torch.tensor(reference_teacher_logits(vocab))
    loss_fn = distill.make_distill_loss(build_model(draft_of(TCFG), device="cpu"), vocab,
                                        kl_weight=kl_weight, temperature=temperature)
    loss, metrics = loss_fn(params, batch)
    grads = torch.autograd.grad(loss, [t for _, t in named], allow_unused=True)
    assert metrics.keys() == want_metrics.keys() == {"loss", "kl", "ce", "agree"}
    for k in ("loss", "kl", "ce"):
        np.testing.assert_allclose(float(metrics[k].detach()), want_metrics[k], rtol=2e-5,
                                   err_msg=k)
    assert float(metrics["agree"]) == want_metrics["agree"]
    got = {p: (np.zeros(t.shape, np.float32) if g is None else g.numpy())
           for (p, t), g in zip(named, grads)}
    assert got.keys() == want.keys()
    top = max(np.abs(w).max() for w in want.values())
    for path, w in want.items():
        bound = max(1e-4 * np.abs(w).max(), ZERO_GRAD_FLOOR * top)
        assert np.abs(got[path] - w).max() <= bound, (path, np.abs(got[path] - w).max(), bound)


@pytest.mark.parametrize("temperature", [1.0, 2.0])
def test_masked_slots_carry_no_teacher_mass(temperature):
    """Padded slots at -1e30 in both logits: each slot's KL term
    `p_t * (logp_t - logp_s)` is 0 exactly in fp32, in both frameworks, and
    the port's per-token KL is the sum over the true vocab alone."""
    rng = np.random.default_rng(4)
    lg, tl = (rng.normal(size=(2, 3, 512)).astype(np.float32) * 4 for _ in range(2))
    vocab, T = 500, temperature

    def terms(xp, log_softmax, exp, s, t):
        vmask = xp.arange(512) < vocab
        s, t = xp.where(vmask, s, -1e30), xp.where(vmask, t, -1e30)
        logp_s, logp_t = log_softmax(s / T), log_softmax(t / T)
        return exp(logp_t) * (logp_t - logp_s)

    jterm = np.asarray(terms(jnp, lambda x: jax.nn.log_softmax(x, axis=-1), jnp.exp,
                             jnp.asarray(lg), jnp.asarray(tl)))
    tterm = terms(torch, lambda x: torch.log_softmax(x, dim=-1), torch.exp,
                  torch.from_numpy(lg), torch.from_numpy(tl)).numpy()
    for term in (jterm, tterm):
        assert np.isfinite(term).all()
        assert (term[..., vocab:] == 0.0).all()
    targets = torch.from_numpy(rng.integers(0, vocab, size=(2, 3)))
    kl = distill.distill_terms(torch.from_numpy(lg), torch.from_numpy(tl), targets, vocab,
                               T)["kl"]
    np.testing.assert_allclose(kl.numpy(), T * T * tterm[..., :vocab].sum(-1), rtol=1e-6)


# ---------------------------------------------------------------------------
# three distill_student steps
# ---------------------------------------------------------------------------

STEP_KW = dict(steps=3, batch=B, seq=S, lr=3e-3, kl_weight=0.75, temperature=2.0, seed=0,
               log_every=1)
_LINE = re.compile(r"\[distill\] step +(\d+) loss +(\S+)((?: \w+ \S+)*)")


def _printed(text: str) -> list[dict[str, float]]:
    out = []
    for m in _LINE.finditer(text):
        pairs = m.group(3).split()
        out.append({"loss": float(m.group(2)),
                    **{k: float(v) for k, v in zip(pairs[::2], pairs[1::2])}})
    return out


@contextlib.contextmanager
def _student_init(model_cls, make):
    """`model_cls.init` of a one-layer (student) config returns `make(model)`."""
    orig = model_cls.init
    model_cls.init = lambda self, key: make(self) if self.cfg.n_layers == 1 else orig(self, key)
    try:
        yield
    finally:
        model_cls.init = orig


@functools.lru_cache(maxsize=None)
def reference_student_steps():
    buf = io.StringIO()
    with _student_init(JModel, lambda m: _jtree(init_params(True))), \
            contextlib.redirect_stdout(buf):
        _, params, history = jdistill.distill_student(
            JCFG, jbuild(JCFG), _jtree(init_params(False)), **STEP_KW)
    return history, _printed(buf.getvalue()), _leaves(params, JModel.named_leaves)


def test_three_distill_student_steps_match_reference():
    want_hist, want_printed, want = reference_student_steps()
    buf = io.StringIO()
    with _student_init(Model, lambda m: params_from_numpy(init_params(True), m.cfg, m.device)), \
            contextlib.redirect_stdout(buf):
        student, params, hist, step_s = distill.distill_student(
            TCFG, build_model(TCFG, device="cpu"), _port_params(False), **STEP_KW)
    assert student.cfg == draft_of(TCFG) and len(hist) == len(step_s) == 3
    np.testing.assert_allclose(hist, want_hist, rtol=0, atol=2e-5)
    printed = _printed(buf.getvalue())
    assert len(printed) == len(want_printed) == 3
    for got_line, want_line in zip(printed, want_printed):
        assert got_line.keys() == want_line.keys()
        for k, v in want_line.items():
            assert abs(got_line[k] - v) <= 1.5e-3, (k, got_line[k], v)
    got = _leaves(params, leaves_with_path)
    assert got.keys() == want.keys()
    for path, w in want.items():
        assert not (np.abs(got[path] - w) > 1e-5 + 1e-4 * np.abs(w)).any(), \
            (path, np.abs(got[path] - w).max())


# ---------------------------------------------------------------------------
# the whole pipeline at the reference tier's knobs
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def port_pipeline() -> dict:
    return distill.distill_pipeline(TCFG, device="cpu", **TIER)


@functools.lru_cache(maxsize=None)
def reference_rollout() -> float:
    """The reference's `rollout_agreement` on the port's trained teacher
    and student (bridged as numpy), at the pipeline's eval settings."""
    out = port_pipeline()
    as_j = lambda p: _jtree(tree_map(lambda t: t.numpy(), p))  # noqa: E731
    return jdistill.rollout_agreement(
        JCFG, jbuild(JCFG), as_j(out["teacher_params"]), jbuild(jdraft_of(JCFG)),
        as_j(out["student_params"]), steps=TIER["eval_steps"], seed=TIER["seed"] + 7)


def _acceptance(out: dict, drafter: Drafter) -> float:
    """The reference tier's spec run: 6 held-out motif prompts of 24
    tokens, 8 new tokens each, two proposals a window, greedy."""
    n, plen, gen = 6, 24, 8
    toks = SyntheticLM(DataConfig(vocab=TCFG.vocab, seq_len=plen, global_batch=n,
                                  seed=21)).prompt_batch(0, n, plen)
    sched = SpeculativeSchedule(out["teacher"], out["teacher_params"], TCFG, n_slots=n,
                                max_len=plen + gen, draft_depth=2, drafter=drafter,
                                stream=AsyncExecutionStream(ProgramCache(), device="cpu"))
    sched.run([Request(rid=i, prompt=np.asarray(toks[i], np.int32), max_new_tokens=gen)
               for i in range(n)])
    sched.stream.close()
    assert sched.proposed > 0
    return sched.acceptance_rate


def test_port_pipeline_holds_the_reference_bars():
    out = port_pipeline()
    hist, thist = out["history"], out["teacher_history"]
    assert len(hist) == 2 and np.isfinite(hist).all() and hist[-1] < hist[0], hist
    assert len(thist) == 1 and thist[0] < np.log(TCFG.vocab), thist
    assert len(out["teacher_step_s"]) == TIER["teacher_steps"]
    assert len(out["step_s"]) == TIER["steps"]
    assert {b for _, b in out["routes"]} == {"torch"}
    assert {k for k, _ in out["routes"]} == {"anemm", "flash"}
    disp = out["teacher"].dispatcher
    trained = _acceptance(out, Drafter.shrink(TCFG, dispatcher=disp, device="cpu",
                                              params=out["student_params"]))
    random = _acceptance(out, Drafter.shrink(TCFG, dispatcher=disp, device="cpu"))
    ref_agree = reference_rollout()
    print(f"port: agreement {out['agreement']:.4f}, acceptance {trained:.4f} (random-init "
          f"drafter {random:.4f}); the reference's rollout_agreement on the same pair "
          f"{ref_agree:.4f}; bars (tests/test_train.py): agreement >= 0.6, acceptance >= 0.4 "
          "and above random")
    assert out["agreement"] >= 0.6, out["agreement"]
    assert trained >= 0.4, (trained, random)
    assert trained > random, (trained, random)


def test_rollout_agreement_matches_reference():
    out = port_pipeline()
    got = distill.rollout_agreement(TCFG, out["teacher"], out["teacher_params"],
                                    out["student"], out["student_params"],
                                    steps=TIER["eval_steps"], seed=TIER["seed"] + 7)
    assert got == out["agreement"] == reference_rollout()


# ---------------------------------------------------------------------------
# checkpoints both ways, and the CLI's refusals
# ---------------------------------------------------------------------------


def _forms(tree) -> list[str]:
    out = []

    def walk(node):
        if isinstance(node, (DispatchedWeight, JDispatchedWeight)):
            out.append(getattr(node.form, "value", node.form))
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
    walk(tree)
    return out


def _payloads(tree) -> dict[str, np.ndarray]:
    """path -> array of every leaf, a packed weight's payload arrays under
    its path (either package's tree)."""
    out = {}

    def walk(node, prefix):
        if isinstance(node, (DispatchedWeight, JDispatchedWeight)):
            for k, v in node.payload.items():
                out[f"{prefix}/{k}"] = _np(v)
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}/{k}" if prefix else str(k))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}/{i}" if prefix else str(i))
        else:
            out[prefix] = _np(node)
    walk(tree, "")
    return out


def _assert_same_bits(got, want) -> None:
    got, want = _payloads(got), _payloads(want)
    assert got.keys() == want.keys()
    for path, w in want.items():
        assert got[path].dtype == w.dtype, path
        np.testing.assert_array_equal(got[path], w, err_msg=path)


@pytest.fixture(scope="module")
def port_ckpts(tmp_path_factory):
    """The acceptance command's checkpoints (dense student), and an
    int4_palette student distilled from its teacher checkpoint."""
    root = tmp_path_factory.mktemp("port_distill")
    dense, packed = str(root / "dense"), str(root / "int4")
    out = distill.run(["--arch", ARCH, "--smoke", "--device", "cpu", "--teacher-steps", "40",
                       "--steps", "50", "--seq", "32", "--log-every", "25",
                       "--ckpt-dir", dense])
    out4 = distill.run(["--arch", ARCH, "--smoke", "--device", "cpu", "--teacher-ckpt",
                        os.path.join(dense, "teacher"), "--steps", "5", "--seq", "32",
                        "--eval-steps", "2", "--log-every", "5", "--student-weight-form",
                        "int4_palette", "--ckpt-dir", packed])
    return dense, out, packed, out4


def test_reference_reads_the_ports_checkpoints(port_ckpts):
    dense, out, packed, out4 = port_ckpts
    assert out["loss_history"][-1] < out["loss_history"][0]
    assert set(out["save_s"]) == {"teacher", "student"}
    meta = JCheckpointManager(os.path.join(dense, "student")).metadata()
    assert meta == jdistill._metadata(jdraft_of(JCFG), "draft-student", weight_form="fp16",
                                      target_arch=JCFG.name,
                                      agreement_top1=float(out["agreement"]))
    assert JCheckpointManager(os.path.join(dense, "teacher")).metadata() == \
        jdistill._metadata(JCFG, "teacher")
    _, tparams = jdistill.load_teacher(JCFG, os.path.join(dense, "teacher"))
    _assert_same_bits(tparams, out["teacher_params"])
    drafter = JDrafter.shrink(JCFG, ckpt=os.path.join(dense, "student"))
    assert drafter.trained and drafter.cfg.vocab == JCFG.vocab
    _assert_same_bits(drafter.params, out["student_params"])
    # packed: the form tags intact, the payloads the port's packing's
    jpacked = JDrafter.shrink(JCFG, ckpt=os.path.join(packed, "student"))
    assert _forms(jpacked.params) == ["int4_palette"] * 8
    _assert_same_bits(jpacked.params, compress_model_params(out4["student_params"],
                                                            "int4_palette"))
    assert JCheckpointManager(os.path.join(packed, "student")).metadata()["weight_form"] \
        == "int4_palette"
    with pytest.raises(ValueError, match="vocab"):
        JDrafter.shrink(jconfigs.get_config(ARCH), ckpt=os.path.join(dense, "student"))


@pytest.fixture(scope="module")
def reference_ckpts(port_ckpts, tmp_path_factory):
    """The reference's CLI from the port's teacher checkpoint (it writes
    the teacher again), one student step, an int4_palette student."""
    d = str(tmp_path_factory.mktemp("reference_distill"))
    with contextlib.redirect_stdout(io.StringIO()):
        jdistill.run(["--arch", ARCH, "--smoke", "--teacher-ckpt",
                      os.path.join(port_ckpts[0], "teacher"), "--teacher-steps", "0",
                      "--steps", "1", "--batch", str(B), "--seq", str(S), "--eval-steps", "0",
                      "--log-every", "1", "--student-weight-form", "int4_palette",
                      "--ckpt-dir", d])
    return d


def test_port_reads_the_references_checkpoints(reference_ckpts):
    teacher_dir = os.path.join(reference_ckpts, "teacher")
    student_dir = os.path.join(reference_ckpts, "student")
    _, want = jdistill.load_teacher(JCFG, teacher_dir)
    _, got = distill.load_teacher(TCFG, teacher_dir, device="cpu")
    _assert_same_bits(got, want)
    jdrafter = JDrafter.shrink(JCFG, ckpt=student_dir)
    drafter = Drafter.shrink(TCFG, device="cpu", ckpt=student_dir)
    assert drafter.trained and _forms(drafter.params) == ["int4_palette"] * 8
    _assert_same_bits(drafter.params, jdrafter.params)
    out = serve.run(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                     "--prompt-lens", "8,12", "--gen", "4", "--ckpt", teacher_dir,
                     "--schedule", "spec", "--draft", "shrink", "--draft-ckpt", student_dir])
    assert out["ckpt_step"] == 0 and out["engine"].drafter.trained
    assert out["tokens"].shape == (2, 4) and out["proposed"] > 0
    assert ("palette", "torch") in out["routes"] and ("anemm", "torch") in out["routes"]


def test_cli_refusals(port_ckpts, tmp_path):
    dense = port_ckpts[0]
    teacher_dir = os.path.join(dense, "teacher")
    # a teacher of another vocab: refused before any array loads
    with pytest.raises(ValueError, match="vocab"):
        distill.run(["--arch", ARCH, "--device", "cpu", "--teacher-ckpt", teacher_dir])
    with pytest.raises(ValueError, match="vocab"):
        Drafter.shrink(configs.get_config(ARCH), device="cpu",
                       ckpt=os.path.join(dense, "student"))
    with pytest.raises(FileNotFoundError):
        distill.run(["--arch", ARCH, "--smoke", "--device", "cpu", "--teacher-ckpt",
                     str(tmp_path / "nope")])
    assert not (tmp_path / "nope").exists()
    with pytest.raises(ValueError, match="kl_weight"):
        distill.run(["--arch", ARCH, "--smoke", "--device", "cpu", "--teacher-ckpt",
                     teacher_dir, "--steps", "1", "--kl-weight", "1.5"])
    for bad in (-0.25, 1.25):
        with pytest.raises(ValueError, match="kl_weight"):
            distill.make_distill_loss(build_model(draft_of(TCFG), device="cpu"), TCFG.vocab,
                                      kl_weight=bad)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            distill.run(["--arch", ARCH, "--smoke"])
