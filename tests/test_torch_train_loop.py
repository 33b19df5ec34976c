"""The port's training loop on the CPU: the CLI, restarts and checkpoints.

After `tests/test_train.py:24-146`: the CLI's loss falls at smoke, with and
without int8 gradient compression; 2k steps straight equal k steps, a save,
a crash and k more from the restored state, bit for bit; the CLI resumes a
crashed run from its latest committed step to the straight run's params,
bit for bit; the supervisor restarts after an injected crash and its
default policy is fresh per call; the straggler detector flags the slow
host; a torn write is ignored. Checkpoints cross both ways: the port's
`CheckpointManager` writes a training state (bf16 params, fp32 moments, an
int32 step, a packed weight, a None leaf) that the reference's manager
restores bit for bit, and restores what the reference's manager wrote (its
packed int4_palette MLP and a None leaf among them).
"""

import _torch_threads  # noqa: F401

import dataclasses
import inspect
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import CheckpointManager as JManager, _flatten as jflatten
from repro.core.hal import WeightForm as JForm
from repro.models.dispatched import DispatchedWeight as JPacked
from repro.optim.compression import compress_model_params as jcompress
from repro_torch import configs
from repro_torch.checkpoint.checkpoint import CheckpointManager, _flatten as port_flatten
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import train
from repro_torch.models.dispatched import DispatchedWeight
from repro_torch.models.model import build_model
from repro_torch.optim import adamw
from repro_torch.optim.compression import compress_model_params
from repro_torch.runtime import fault_tolerance as ft
from repro_torch.tree import leaves_with_path

ARCH = "tinyllama-1.1b"


def _cli(*extra: str) -> dict:
    return train.run(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "8",
                      "--seq", "64", "--lr", "3e-3", "--log-every", "10", *extra])


def test_cli_loss_decreases_at_smoke():
    out = _cli("--steps", "60")
    hist = out["loss_history"]
    assert len(hist) == 6 and out["final_step"] == 60 and len(out["step_s"]) == 60
    assert hist[-1] < hist[0] - 0.5, hist
    assert out["restarts"] == []
    assert np.isfinite(hist[-1]) and out["final_loss"] == hist[-1]
    assert set(out["routes"]) == {("anemm", "torch"), ("flash", "torch")}


def test_cli_int8_compression_trains():
    out = _cli("--steps", "40", "--grad-compression", "int8")
    assert out["loss_history"][-1] < out["loss_history"][0] - 0.3


def _leaves(tree) -> dict[str, torch.Tensor]:
    return {p: t.clone() for p, t in leaves_with_path(tree)}


def test_checkpoint_restart_resumes_bit_for_bit(tmp_path):
    """12 steps straight against 6, a save, a fresh init (the crash), the
    restore and 6 more: every param and every moment equal."""
    cfg = configs.get_smoke(ARCH)
    model = build_model(cfg, device="cpu")
    opt = adamw.AdamWConfig(peak_lr=1e-3, warmup_steps=2, total_steps=12)
    src = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4))
    step_fn = train.make_train_step(model, opt)

    def fresh():
        params = model.init(torch.Generator().manual_seed(0))
        return params, adamw.init_state(opt, params)

    def run(lo, hi, params, state):
        for t in range(lo, hi):
            params, state, _ = step_fn(params, state, {k: torch.from_numpy(v)
                                                       for k, v in src.batch(t).items()})
        return params, state

    straight = _leaves(run(0, 12, *fresh()))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(6, run(0, 6, *fresh()))
    restored, step = mgr.restore(fresh())
    assert step == 6
    resumed = _leaves(run(6, 12, *restored))
    assert resumed.keys() == straight.keys()
    for path, t in straight.items():
        assert torch.equal(resumed[path], t), path


def test_cli_resumes_a_crashed_run_from_its_checkpoint(tmp_path, monkeypatch):
    """The CLI saves every 5 steps; an injected crash at step 8 restarts
    the run from step 5's checkpoint, and its final state equals an
    uncrashed run's bit for bit."""
    args = ("--steps", "10", "--ckpt-every", "5", "--log-every", "1")
    _cli(*args, "--ckpt-dir", str(tmp_path / "straight"))
    real = train.make_train_step
    crashed = {"n": 0}

    def crashing(*a, **kw):
        step = real(*a, **kw)

        def wrapped(params, state, batch):
            if int(state["step"]) == 8 and not crashed["n"]:
                crashed["n"] += 1
                raise RuntimeError("injected node failure")
            return step(params, state, batch)
        return wrapped

    monkeypatch.setattr(train, "make_train_step", crashing)
    out = _cli(*args, "--ckpt-dir", str(tmp_path / "crashed"))
    # logged: steps 1..8, then 6..10 from step 5's checkpoint
    assert crashed["n"] == 1 and out["final_step"] == 10 and len(out["loss_history"]) == 13
    assert out["restarts"] == [repr(RuntimeError("injected node failure"))]
    want = CheckpointManager(str(tmp_path / "straight"))
    got = CheckpointManager(str(tmp_path / "crashed"))
    assert got.steps() == want.steps() == [5, 10]
    with np.load(tmp_path / "straight" / "step_000000010" / "arrays.npz") as a, \
            np.load(tmp_path / "crashed" / "step_000000010" / "arrays.npz") as b:
        assert a.files == b.files and "|1|step" in a.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_supervisor_restarts_after_injected_crash():
    crashes = {"n": 0}

    def run_fn(start_step):
        step = 10 if start_step == -1 else 0   # "restored from checkpoint"
        while step < 30:
            step += 1
            if step == 12 and crashes["n"] == 0:
                crashes["n"] += 1
                raise RuntimeError("injected node failure")
        return step

    assert ft.run_with_restarts(run_fn, policy=ft.RestartPolicy(max_restarts=2)) == 30
    assert crashes["n"] == 1

    def always(start_step):
        raise RuntimeError("down")

    with pytest.raises(ft.TrainingAborted, match="exceeded 1 restarts"):
        ft.run_with_restarts(always, policy=ft.RestartPolicy(max_restarts=1))


def test_supervisor_default_policy_is_fresh_per_call():
    assert inspect.signature(ft.run_with_restarts).parameters["policy"].default is None
    calls = {"n": 0}

    def flaky(start_step):
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("boom")
        return 42

    assert ft.run_with_restarts(flaky) == 42      # the default budget covers 2
    assert calls["n"] == 3


def test_straggler_detector_flags_slow_host_and_watchdog_expires():
    det = ft.StragglerDetector(window=8, threshold=1.5, patience=2)
    for step in range(8):
        for host in range(4):
            det.record(ft.Heartbeat(host, step, 3.0 if host == 2 else 1.0, time.time()))
        flagged = det.evaluate()
    assert flagged == [2]
    dog = ft.Watchdog(deadline_s=0.0)
    time.sleep(0.01)
    assert dog.expired()
    dog.deadline_s = 60.0
    dog.poke()
    assert not dog.expired()


def test_checkpoint_atomicity_ignores_torn_write(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"w": torch.ones(4)}
    mgr.save(1, tree)
    torn = tmp_path / "step_000000002"
    os.makedirs(torn)
    (torn / "manifest.json").write_text("{}")
    assert mgr.latest_step() == 1
    assert mgr.restore({"w": torch.zeros(4)})[1] == 1
    for step in (3, 4, 5):                  # keep=2: the older committed steps go
        mgr.save_async(step, {"w": torch.full((4,), float(step))})
    mgr.wait()
    assert mgr.steps() == [4, 5]
    got, _ = mgr.restore({"w": torch.zeros(4)})
    assert torch.equal(got["w"], torch.full((4,), 5.0))


def _state_tree():
    """A training state as the CLI saves it, with a packed weight and a
    None leaf beside bf16 params, fp32 moments and an int32 step."""
    cfg = dataclasses.replace(configs.get_smoke(ARCH), dtype="bfloat16")
    params = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    state = adamw.init_state(adamw.AdamWConfig(), params)
    state["m"]["embed"]["table"].normal_()
    state["step"].fill_(7)
    extra = compress_model_params({"mlp": {"wg": torch.randn(64, 32)}}, "int4_palette")
    return (params, state, extra, None)


def _reference_template(node):
    """The port tree's structure as the reference's restore walks it: its
    packed node where the port has one, a placeholder for every array."""
    if isinstance(node, DispatchedWeight):
        return JPacked(JForm(node.form.value), node.contract_shape, node.out_shape,
                       node.dtype_name, {k: None for k in node.payload})
    if isinstance(node, dict):
        return {k: _reference_template(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_reference_template(v) for v in node)
    return None if node is None else 0


def test_the_reference_restores_what_the_port_writes(tmp_path):
    tree = _state_tree()
    CheckpointManager(str(tmp_path)).save(7, tree, metadata={"arch": ARCH})
    mgr = JManager(str(tmp_path))
    assert mgr.latest_step() == 7 and mgr.metadata() == {"arch": ARCH}
    got, step = mgr.restore(_reference_template(tree))
    assert step == 7 and got[3] is None
    assert got[2]["mlp"]["wg"].form.value == "int4_palette"
    want, have = port_flatten(tree, snapshot=True), jflatten(got)
    assert have.keys() == want.keys() and "/1/step" in want and "/3" in want
    for k, w in want.items():
        if w is None:
            assert have[k] is None, k
            continue
        h = np.asarray(have[k])
        assert h.dtype == w.dtype and h.shape == w.shape and h.tobytes() == w.tobytes(), k
    assert want["/0/embed/table"].dtype == np.dtype("V2")     # bf16 as raw records


def test_the_port_restores_what_the_reference_writes(tmp_path):
    """The reference saves a (params, opt_state)-shaped tree, bf16 and fp32
    leaves, an int32 step, an MLP packed by its own `compress_model_params`
    (int4_palette) and a None leaf; the port's manager restores it in place
    into a template packed by the port, bit for bit."""
    rng = np.random.default_rng(4)
    wg = rng.normal(size=(64, 32)).astype(np.float32)
    jtree = ({"embed": {"table": jnp.asarray(rng.normal(size=(6, 4)), jnp.bfloat16)},
              "layers": [{"w": jnp.asarray(rng.normal(size=(4, 4)), jnp.float32)}],
              "packed": jcompress({"mlp": {"wg": jnp.asarray(wg)}}, "int4_palette"),
              "none": None},
             {"m": {"x": jnp.asarray(rng.normal(size=(3,)), jnp.float32)},
              "step": jnp.int32(9)})
    JManager(str(tmp_path)).save(9, jtree, metadata={"role": "trainer"})
    packed = compress_model_params({"mlp": {"wg": torch.zeros(64, 32)}}, "int4_palette")
    template = ({"embed": {"table": torch.zeros(6, 4, dtype=torch.bfloat16)},
                 "layers": [{"w": torch.zeros(4, 4)}], "packed": packed, "none": None},
                {"m": {"x": torch.zeros(3)}, "step": torch.zeros((), dtype=torch.int32)})
    mgr = CheckpointManager(str(tmp_path))
    got, step = mgr.restore(template)
    assert step == 9 and mgr.metadata() == {"role": "trainer"}
    assert got[0]["none"] is None
    jw, w = jtree[0]["packed"]["mlp"]["wg"], got[0]["packed"]["mlp"]["wg"]
    assert isinstance(w, DispatchedWeight) and w.form.value == jw.form.value == "int4_palette"
    assert w.payload.keys() == jw.payload.keys()
    for name, arr in jw.payload.items():
        want = np.asarray(arr)
        have = w.payload[name].numpy()
        assert have.dtype == want.dtype and have.tobytes() == want.tobytes(), name
    assert got[0]["embed"]["table"] is template[0]["embed"]["table"]
    np.testing.assert_array_equal(got[0]["embed"]["table"].view(torch.int16).numpy(),
                                  np.asarray(jtree[0]["embed"]["table"]).view(np.int16))
    np.testing.assert_array_equal(got[0]["layers"][0]["w"].numpy(),
                                  np.asarray(jtree[0]["layers"][0]["w"]))
    np.testing.assert_array_equal(got[1]["m"]["x"].numpy(), np.asarray(jtree[1]["m"]["x"]))
    assert int(got[1]["step"]) == 9
