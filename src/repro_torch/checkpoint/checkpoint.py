"""Checkpoints in the reference's layout: read and written with numpy.

After `src/repro/checkpoint/checkpoint.py`. One directory per step:

    <dir>/step_000000123/
        manifest.json        # flat key "a/b/c" -> {shape, dtype}, or null
        arrays.npz           # the leaves, stored under "a|b|c"
        metadata.json        # optional provenance (vocab, d_model, form, ...)
        COMMIT               # written last: a step without it is torn

`CheckpointReader` counts only COMMITted `step_%09d` directories (`steps`,
`latest_step`, reference :104-115), reads a step's metadata (`metadata`,
:171-183) and restores a step into a template tree (`restore`, :190-215).
`CheckpointManager` adds the write half (:93-169): `save` writes a tree
leaf by leaf, `save_async` snapshots it to host numpy now and writes on a
background thread (`wait` joins it), and every write goes to
`step_%09d.tmp`, is renamed into place, gets its COMMIT last and then
keeps the newest `keep` committed steps (`_gc`). The reference's manager
restores what this one writes, and this one what the reference's writes.

A packed weight (`models.dispatched.DispatchedWeight`) is stored as its
payload arrays under its path plus a `__weightform__` marker, and restores
into a template node of the same form, with the template's tag (the walk of
`_unflatten_into`, :66-91); a dense-versus-packed or form mismatch raises in
the reference's words.

Numpy only: no JAX and no pickle. A bfloat16 leaf is stored as raw 2-byte
records (numpy's `V2`, as the reference's `np.savez` stores its bfloat16;
the manifest names the dtype) and is reinterpreted bit for bit. A member
stored uncompressed (as `np.savez` writes them) is memory-mapped where it
lies in `arrays.npz` and copied once, straight into the template's tensor,
so its CRC is not recomputed (COMMIT guards against a torn write); a
compressed member is read through `np.load`. The restore writes each array
into the template's tensor in place, on that tensor's device and in its
dtype (a tree drawn by `Model.init`, packed first where the checkpoint is),
so no second copy of the weights is ever held.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import struct
import threading
import zipfile
from typing import Any

import numpy as np
import torch

from repro_torch.models.dispatched import DispatchedWeight

_SEP = "/"
_FORM_KEY = "__weightform__"
_STEP = re.compile(r"step_(\d+)")


def _tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A stored array as a CPU tensor (no copy of a C-ordered one);
    `dtype_name` is the manifest's."""
    arr = arr if arr.flags.c_contiguous else arr.copy(order="C")
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _place(path: str, dst: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"checkpoint leaf {path!r} has shape {tuple(src.shape)}, the "
                         f"template wants {tuple(dst.shape)}")
    dst.copy_(src)
    return dst


def _unflatten_into(template: Any, flat: dict[str, Any]) -> Any:
    """The template's structure with every leaf filled from `flat` (path ->
    (array, manifest dtype) or None), in place."""
    def walk(node, prefix):
        if isinstance(node, DispatchedWeight):
            stored = flat.get(f"{prefix}{_SEP}{_FORM_KEY}")
            if stored is None:
                raise ValueError(
                    f"checkpoint weight form mismatch at {prefix!r}: template "
                    f"expects a packed {node.form.value!r} weight but the "
                    f"checkpoint holds a dense one (no {_FORM_KEY} marker)")
            if str(stored[0]) != node.form.value:
                raise ValueError(
                    f"checkpoint weight form {str(stored[0])!r} at {prefix!r} "
                    f"does not match template tag {node.form.value!r}")
            for k, dst in node.payload.items():
                _place(f"{prefix}{_SEP}{k}", dst, _tensor(*flat[f"{prefix}{_SEP}{k}"]))
            return node
        if isinstance(node, dict):
            return {k: walk(node[k], f"{prefix}{_SEP}{k}" if prefix else str(k))
                    for k in node}
        if isinstance(node, (list, tuple)):
            out = [walk(v, f"{prefix}{_SEP}{i}") for i, v in enumerate(node)]
            return type(node)(out) if isinstance(node, tuple) else out
        if node is None:
            return None
        if f"{prefix}{_SEP}{_FORM_KEY}" in flat:
            raise ValueError(
                f"checkpoint weight form mismatch at {prefix!r}: template expects a "
                f"dense weight but the checkpoint holds a packed "
                f"{str(flat[f'{prefix}{_SEP}{_FORM_KEY}'][0])!r} one")
        got = flat[prefix]
        if got is None:
            raise ValueError(f"checkpoint leaf {prefix!r} is None, the template wants a "
                             f"{tuple(node.shape)} tensor")
        return _place(prefix, node, _tensor(*got))
    return walk(template, "")


class CheckpointReader:
    """The committed steps of a checkpoint directory, read with numpy."""

    def __init__(self, directory: str) -> None:
        self.dir = directory

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:09d}")

    def steps(self) -> list[int]:
        """The COMMITted steps, ascending; a torn step is ignored."""
        if not os.path.isdir(self.dir):
            return []
        out = []
        for name in os.listdir(self.dir):
            m = _STEP.fullmatch(name)
            if m and os.path.exists(os.path.join(self.dir, name, "COMMIT")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def _resolve(self, step: int | None) -> int:
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        return step

    def metadata(self, step: int | None = None) -> dict | None:
        """The metadata dict saved with `step` (default: the latest
        committed), or None when the checkpoint carries none."""
        path = os.path.join(self._step_dir(self._resolve(step)), "metadata.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def restore(self, template: Any, step: int | None = None) -> tuple[Any, int]:
        """(the template filled with step `step`'s leaves, the step); default
        the latest committed step. Every template leaf is overwritten in
        place (same shape, its own device and dtype); a `None` leaf stays
        `None`; checkpoint keys the template does not name are not read."""
        step = self._resolve(step)
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        with _NpzLeaves(manifest, os.path.join(d, "arrays.npz")) as flat:
            return _unflatten_into(template, flat), step


_NPY_HEADERS = {(1, 0): np.lib.format.read_array_header_1_0,
                (2, 0): np.lib.format.read_array_header_2_0}


class _NpzLeaves:
    """path -> (array, manifest dtype), each read from the npz on first
    access, so only the leaves the template names are loaded, one at a
    time: a stored member memory-mapped in place (copy on write), any other
    through `np.load`."""

    def __init__(self, manifest: dict, path: str) -> None:
        self.manifest, self.path = manifest, path
        self.zip = zipfile.ZipFile(path)
        self.npz = np.load(path, allow_pickle=False)

    def __enter__(self) -> "_NpzLeaves":
        return self

    def __exit__(self, *exc) -> None:
        self.npz.close()
        self.zip.close()

    def __contains__(self, key: str) -> bool:
        return key in self.manifest

    def get(self, key: str):
        return self[key] if key in self.manifest else None

    def __getitem__(self, key: str):
        meta = self.manifest[key]
        if meta is None:
            return None
        return self._member(key.replace(_SEP, "|")), meta["dtype"]

    def _member(self, name: str) -> np.ndarray:
        info = self.zip.getinfo(name + ".npy")
        if info.compress_type != zipfile.ZIP_STORED:
            return self.npz[name]
        with open(self.path, "rb") as f:
            f.seek(info.header_offset)
            local = f.read(30)                   # the member's local file header
            if local[:4] != b"PK\x03\x04":
                raise ValueError(f"{self.path}: member {name!r} has no local header")
            n_name, n_extra = struct.unpack("<HH", local[26:30])
            f.seek(info.header_offset + 30 + n_name + n_extra)
            read_header = _NPY_HEADERS.get(np.lib.format.read_magic(f))
            if read_header is None:
                return self.npz[name]
            shape, fortran, dtype = read_header(f)
            offset = f.tell()
        if dtype.hasobject or 0 in shape:
            return self.npz[name]
        return np.memmap(self.path, dtype=dtype, mode="c", offset=offset, shape=shape,
                         order="F" if fortran else "C")


# ---------------------------------------------------------------------------
# The write half (reference :29-64, :93-169)
# ---------------------------------------------------------------------------


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor as the numpy array the reference's snapshot would hold:
    bfloat16 as raw 2-byte `V2` records."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view("V2")
    return t.numpy()


def _flatten(tree: Any, *, snapshot: bool) -> dict[str, Any]:
    """path -> leaf (or None), packed nodes as their payload plus the form
    marker (reference `_flatten`, :29); `snapshot`: every tensor copied to a
    host numpy array now, else left where it is."""
    flat: dict[str, Any] = {}

    def walk(node, prefix):
        if isinstance(node, DispatchedWeight):
            flat[f"{prefix}{_SEP}{_FORM_KEY}"] = np.asarray(node.form.value)
            walk(node.payload, prefix)
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{prefix}{_SEP}{k}" if prefix else str(k))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}{_SEP}{i}")
        elif node is None:
            flat[prefix] = None
        elif isinstance(node, torch.Tensor):
            flat[prefix] = _host(node) if snapshot else node
        else:
            flat[prefix] = np.asarray(node)

    walk(tree, "")
    return flat


def _manifest_entry(leaf: Any) -> dict | None:
    if leaf is None:
        return None
    if isinstance(leaf, torch.Tensor):
        return {"shape": list(leaf.shape), "dtype": str(leaf.dtype).removeprefix("torch.")}
    return {"shape": list(leaf.shape),
            "dtype": "bfloat16" if leaf.dtype == np.dtype("V2") else str(leaf.dtype)}


class CheckpointManager(CheckpointReader):
    """The reader plus atomic, optionally asynchronous writes; keeps the
    newest `keep` committed steps. `arrays.npz` is written as `np.savez`
    writes it (stored members, `a|b|c.npy`), one leaf at a time: `save`
    copies each tensor to the host only as its turn comes, so a large tree
    never has a second whole copy on the host."""

    def __init__(self, directory: str, keep: int = 3) -> None:
        super().__init__(directory)
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    def save(self, step: int, tree: Any, metadata: dict | None = None) -> None:
        """Write `tree` as step `step`, atomically. `metadata` (a small
        JSON-serializable dict) commits with it."""
        self.wait()
        self._write(step, _flatten(tree, snapshot=False), metadata)

    def save_async(self, step: int, tree: Any, metadata: dict | None = None) -> None:
        """Snapshot `tree` to host now; write it on a background thread."""
        self.wait()
        snapshot = _flatten(tree, snapshot=True)
        self._thread = threading.Thread(target=self._write, args=(step, snapshot, metadata),
                                        daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, flat: dict[str, Any], metadata: dict | None) -> None:
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        with zipfile.ZipFile(os.path.join(tmp, "arrays.npz"), "w", zipfile.ZIP_STORED,
                             allowZip64=True) as zf:
            for k, leaf in flat.items():
                if leaf is None:
                    continue
                arr = _host(leaf) if isinstance(leaf, torch.Tensor) else leaf
                with zf.open(k.replace(_SEP, "|") + ".npy", "w", force_zip64=True) as f:
                    np.lib.format.write_array(f, arr, allow_pickle=False)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({k: _manifest_entry(v) for k, v in flat.items()}, f)
        if metadata is not None:
            with open(os.path.join(tmp, "metadata.json"), "w") as f:
                json.dump(metadata, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        with open(os.path.join(final, "COMMIT"), "w") as f:
            f.write("ok")
        self._gc()

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[:max(0, len(steps) - self.keep)]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
