"""The port's checkpoint reader against checkpoints in the reference's layout.

The port's `CheckpointManager` writes, in-process, deepseek-v3-671b smoke's
parameters (MLA, the MTP module) as the reference draws them (bridged), dense
and packed by the reference's `compress_model_params` (int4_palette), and a
shrink drafter's parameters with the metadata `launch.distill` records (the
reference's own manager writing and reading is held against the port's in
`tests/test_torch_train_loop.py`). The port's `CheckpointReader` (numpy
only) restores them into templates drawn by the port's own `init` (packed
where the checkpoint is): every leaf bit for bit the reference's, the
prefill and decode logits equal (bit for bit) to those of the same
parameters bridged directly. Also: only COMMITted steps count, metadata
reads back, dense-versus-packed and form mismatches raise in the
reference's words, and the serve CLI's `--ckpt` and `--draft-ckpt` serve
the restored weights and refuse as the reference's do (a drafter of another
vocab before any array loads, `--draft self` with `--draft-ckpt`,
`params=` with `ckpt=`).
"""

import _torch_threads  # noqa: F401

import dataclasses
import functools
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch.speculative import draft_of as jdraft_of
from repro.models.model import Model as JModel, build_model as jbuild
from _reference_params import packed_params
from repro_torch import configs
from repro_torch.bridge import params_from_numpy
from repro_torch.checkpoint.checkpoint import CheckpointManager, CheckpointReader
from repro_torch.core.dispatch import ExecutionStream, KernelDispatcher, ProgramCache
from repro_torch.launch import serve
from repro_torch.launch.scheduler import SequentialSchedule, Request, merge_prefill_caches
from repro_torch.launch.speculative import Drafter, draft_of
from repro_torch.models.model import build_model
from repro_torch.optim.compression import compress_model_params, weight_form_census
from repro_torch.tree import leaves_with_path

ARCH = "deepseek-v3-671b"
B, S = 2, 10
LENS, GEN = (9, 13), 4


@functools.lru_cache(maxsize=None)
def reference(form: str = "fp16"):
    """(jparams, the port's bridged params) of deepseek smoke."""
    jcfg = jconfigs.get_smoke(ARCH)
    jparams = packed_params(jcfg, form)
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      configs.get_smoke(ARCH), "cpu")


@functools.lru_cache(maxsize=None)
def reference_drafter():
    """The reference's shrink drafter of deepseek smoke (seed 7), bridged."""
    jcfg = jconfigs.get_smoke(ARCH)
    dparams = jax.jit(jbuild(jdraft_of(jcfg)).init)(jax.random.PRNGKey(7))
    return dparams, params_from_numpy(jax.tree.map(np.asarray, dparams),
                                      draft_of(configs.get_smoke(ARCH)), "cpu")


@pytest.fixture(scope="module")
def ckpt_root(tmp_path_factory):
    """Checkpoints the port's manager writes of the reference's params:
    `dense` (step 3), `int4` (step 5), the drafter `draft` and a drafter of
    another vocab `draft_vocab`."""
    root = tmp_path_factory.mktemp("ckpt")
    CheckpointManager(str(root / "dense")).save(3, reference()[1],
                                                 metadata={"arch": ARCH, "step": 3})
    CheckpointManager(str(root / "int4")).save(5, reference("int4_palette")[1])
    jcfg = jconfigs.get_smoke(ARCH)
    meta = {"role": "student", "arch": jcfg.name, "vocab": jcfg.vocab,
            "d_model": jcfg.d_model, "n_layers": 1, "weight_form": "fp16"}
    dparams = reference_drafter()[1]
    CheckpointManager(str(root / "draft")).save(11, dparams, metadata=meta)
    CheckpointManager(str(root / "draft_vocab")).save(
        1, dparams, metadata=dict(meta, vocab=jcfg.vocab * 2))
    return root


def _template(form: str = "fp16"):
    cfg = configs.get_smoke(ARCH)
    model = build_model(cfg, KernelDispatcher(), device="cpu")
    params = model.init(torch.Generator().manual_seed(1))
    return model, (params if form == "fp16" else compress_model_params(params, form))


def _logits(model, params) -> list[torch.Tensor]:
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, model.cfg.vocab, size=(B, S)).astype(np.int32))
    caches, lg = model.prefill(params, {"tokens": tokens})
    caches = merge_prefill_caches(model.init_cache(B, S + 2), caches)
    _, dl = model.decode_step(params, caches, tokens[:, :1], torch.full((B,), S,
                                                                          dtype=torch.int32))
    return [lg, dl]


def _leaves(tree) -> dict:
    return dict(leaves_with_path(tree))


@pytest.mark.parametrize("form,name,step", [("fp16", "dense", 3),
                                            ("int4_palette", "int4", 5)])
def test_restores_what_the_reference_wrote(ckpt_root, form, name, step):
    model, template = _template(form)
    params, got_step = CheckpointReader(str(ckpt_root / name)).restore(template)
    assert got_step == step
    _, bridged = reference(form)
    want = _leaves(bridged)
    got = _leaves(params)
    assert got.keys() == want.keys() and "mtp/proj" in "".join(got)
    for path in want:
        assert got[path].dtype == want[path].dtype and torch.equal(got[path], want[path]), path
    if form != "fp16":
        assert weight_form_census(params) == weight_form_census(bridged)
        assert len(weight_form_census(params)) == 26
    for a, b in zip(_logits(model, params), _logits(model, bridged)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("members", ["stored", "compressed"])
def test_bf16_leaves_cross_bit_for_bit(tmp_path, members):
    """A bfloat16 tree (stored as raw 2-byte records, the manifest naming
    the dtype) restores bit for bit, with an int32 leaf, a 0-d leaf and a
    None leaf; from the members `np.savez` stores (memory-mapped) and from
    the same members compressed (read through `np.load`)."""
    rng = np.random.default_rng(0)
    tree = {"w": torch.from_numpy(rng.normal(size=(3, 5))).to(torch.bfloat16),
            "n": {"i": torch.arange(4, dtype=torch.int32), "s": torch.tensor(2.5),
                  "none": None}}
    CheckpointManager(str(tmp_path)).save(0, tree)
    npz = tmp_path / "step_000000000" / "arrays.npz"
    if members == "compressed":
        with np.load(npz) as z:
            stored = {k: z[k] for k in z.files}
        np.savez_compressed(npz, **stored)
    template = {"w": torch.zeros(3, 5, dtype=torch.bfloat16),
                "n": {"i": torch.zeros(4, dtype=torch.int32), "s": torch.zeros(()),
                      "none": None}}
    got, _ = CheckpointReader(str(tmp_path)).restore(template)
    assert got["w"] is template["w"] and got["n"]["none"] is None
    want = tree["w"].view(torch.int16).numpy()
    np.testing.assert_array_equal(got["w"].view(torch.int16).numpy(), want)
    np.testing.assert_array_equal(got["n"]["i"].numpy(), np.arange(4))
    assert float(got["n"]["s"]) == 2.5


def test_only_committed_steps_count(ckpt_root, tmp_path):
    """A step directory without COMMIT (a torn write) and a `.tmp` one are
    ignored: the latest committed step restores."""
    root = tmp_path / "torn"
    shutil.copytree(ckpt_root / "dense", root)
    torn = root / "step_000000009"
    shutil.copytree(root / "step_000000003", torn)
    os.remove(torn / "COMMIT")
    shutil.copytree(root / "step_000000003", root / "step_000000010.tmp")
    reader = CheckpointReader(str(root))
    assert reader.steps() == [3] and reader.latest_step() == 3
    assert reader.metadata() == {"arch": ARCH, "step": 3}
    assert CheckpointReader(str(ckpt_root / "int4")).metadata() is None
    _, template = _template()
    assert reader.restore(template)[1] == 3
    with pytest.raises(FileNotFoundError, match="no committed checkpoint"):
        CheckpointReader(str(tmp_path / "absent")).restore(template)


def test_form_mismatches_raise(ckpt_root):
    dense, int4 = str(ckpt_root / "dense"), str(ckpt_root / "int4")
    with pytest.raises(ValueError, match="holds a dense one"):
        CheckpointReader(dense).restore(_template("int4_palette")[1])
    with pytest.raises(ValueError, match="does not match template tag 'sparse'"):
        CheckpointReader(int4).restore(_template("sparse")[1])
    with pytest.raises(ValueError, match="template expects a dense weight"):
        CheckpointReader(int4).restore(_template()[1])
    cut = build_model(dataclasses.replace(configs.get_smoke(ARCH), d_model=32),
                      device="cpu").init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="has shape"):
        CheckpointReader(dense).restore(cut)


def _want_tokens() -> np.ndarray:
    """Sequential greedy streams of the bridged dense params."""
    cfg = configs.get_smoke(ARCH)
    sched = SequentialSchedule(build_model(cfg, KernelDispatcher(), device="cpu"),
                               reference()[1], cfg, max_len=max(LENS) + GEN,
                               stream=ExecutionStream(ProgramCache(), device="cpu"))
    return np.stack([r.tokens for r in sched.run(
        [Request(i, p, GEN) for i, p in enumerate(_cli_prompts())])])


def _cli_prompts() -> list[np.ndarray]:
    rng = np.random.default_rng(4)
    return [rng.integers(0, configs.get_smoke(ARCH).vocab, size=(n,)).astype(np.int32)
            for n in LENS]


def _cli(*extra: str) -> dict:
    return serve.run(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                      "--gen", str(GEN), "--seed", "5", *extra], prompts=[_cli_prompts()])


def test_cli_ckpt_serves_the_restored_target(ckpt_root, capsys):
    want = _want_tokens()
    out = _cli("--ckpt", str(ckpt_root / "dense"))
    assert f"loaded target params from {ckpt_root / 'dense'} (step 3)" in capsys.readouterr().out
    assert out["ckpt_step"] == 3
    np.testing.assert_array_equal(out["tokens"], want)
    assert not np.array_equal(_cli()["tokens"], want)      # seed 5's own weights differ
    packed = _cli("--ckpt", str(ckpt_root / "dense"), "--weight-form", "int4_palette")
    assert packed["weight_form_census"] == {"int4_palette": 26}


def test_cli_draft_ckpt_serves_the_distilled_drafter(ckpt_root):
    """The drafter's leaves are the reference's bit for bit; the spec
    streams are the target's whatever the drafter proposes."""
    base = _cli("--ckpt", str(ckpt_root / "dense"))
    out = _cli("--ckpt", str(ckpt_root / "dense"), "--schedule", "spec", "--draft", "shrink",
               "--draft-ckpt", str(ckpt_root / "draft"), "--draft-branches", "2")
    drafter = out["engine"].drafter
    assert drafter.trained and drafter.cfg.n_layers == 1
    np.testing.assert_array_equal(out["tokens"], base["tokens"])
    want = {p: np.asarray(x) for p, x in JModel.named_leaves(reference_drafter()[0])}
    got = _leaves(drafter.params)
    assert got.keys() == want.keys()
    for path, w in want.items():
        g = got[path]
        np.testing.assert_array_equal((g.float() if g.dtype == torch.bfloat16 else g).numpy(),
                                      w.astype(np.float32) if w.dtype.name == "bfloat16" else w)


def test_draft_ckpt_refusals(ckpt_root, tmp_path):
    # another vocab: refused from the metadata, before any array loads
    broken = tmp_path / "draft_vocab"
    shutil.copytree(ckpt_root / "draft_vocab", broken)
    with open(broken / "step_000000001" / "arrays.npz", "wb") as f:
        f.write(b"not an npz")
    with pytest.raises(ValueError, match="vocab=1024.*re-distill"):
        _cli("--schedule", "spec", "--draft", "shrink", "--draft-ckpt", str(broken))
    with pytest.raises(ValueError, match="self drafter IS the target"):
        _cli("--schedule", "spec", "--draft", "self", "--draft-ckpt", str(ckpt_root / "draft"))
    with pytest.raises(FileNotFoundError, match="no committed drafter checkpoint"):
        _cli("--schedule", "spec", "--draft-ckpt", str(tmp_path / "absent"))
    cfg = configs.get_smoke(ARCH)
    with pytest.raises(ValueError, match="not both"):
        Drafter.shrink(cfg, device="cpu", params={}, ckpt=str(ckpt_root / "draft"))
    # no metadata, another width: refused by the restore
    narrow = draft_of(dataclasses.replace(configs.get_smoke(ARCH), d_model=32))
    CheckpointManager(str(tmp_path / "narrow")).save(
        0, build_model(narrow, device="cpu").init(torch.Generator().manual_seed(0)))
    with pytest.raises(ValueError, match="does not restore into.*has shape"):
        Drafter.shrink(cfg, device="cpu", ckpt=str(tmp_path / "narrow"))
