"""Checkpointing with async save, retention, and restore onto a device.

Port of :mod:`repro.checkpoint.checkpointer`, writing and reading the
same on-disk format: one directory per step containing a
``manifest.json`` (tree structure, leaf names, step metadata) and one
``.npy`` per leaf.  A ``COMMITTED`` marker is written last — partially
written checkpoints (a crash mid-save) are ignored at restore, giving
crash consistency.  A step written by either package loads in the other.

Two layouts share the step directory and the COMMITTED protocol:

* the **legacy single-tree** layout (:meth:`Checkpointer.save` /
  :meth:`Checkpointer.restore`): leaf ``.npy`` files at the step root;
* the **domain** layout (:meth:`Checkpointer.save_domains` /
  :meth:`Checkpointer.restore_domain`): named, versioned sub-trees, one
  subdirectory per domain, plus a free-form JSON ``meta`` blob in the
  manifest.  This is the service-durability format: a
  ``ServiceSnapshot`` (:mod:`repro_torch.serve.durable`) stores its array
  payload as domains and its python structure as meta.

Trees are dicts (children in sorted key order, as JAX flattens them),
lists, tuples and ``None`` (no leaves) over leaves (tensors, numpy
arrays, numbers).  Leaf names are the reference's: the flatten index and
the key path, ``0000.params.w``, with unsafe characters replaced.

Every restore path validates the manifest: leaf names and counts must
match what the template gives (a renamed field raises instead of
silently zip-truncating), and domain versions are checked against the
caller's expectation.

Restore loads host arrays and moves them to ``device`` (default
``"cuda"``): the format is topology-free, so a checkpoint restores onto
whatever device the caller names.

Concurrency: saves may run on a background thread (``blocking=False``)
whose retention pass deletes old steps.  A concurrent :meth:`restore`
pins the step it is reading — retention skips any step newer than or
equal to the pin, so a restore never has its files deleted out from
under it mid-read.
"""
from __future__ import annotations

import contextlib
import json
import re
import shutil
import threading
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.tree import tree_flatten, tree_unflatten

_SAFE = re.compile(r"[^A-Za-z0-9_.-]")


def _flatten_with_path(tree, path=()) -> list:
    """[(key path, leaf)] in the order JAX's
    ``tree_flatten_with_path`` gives: dict keys sorted, sequences in
    order, ``None`` contributing no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten_with_path(tree[k], path + (k,))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, child in enumerate(tree):
            out += _flatten_with_path(child, path + (i,))
        return out
    return [(path, tree)]


def _treedef_str(tree) -> str:
    """The structure as JAX prints a PyTreeDef (``PyTreeDef({'a': *})``),
    the manifest's informational ``treedef`` field."""
    def render(t) -> str:
        if t is None:
            return "None"
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {render(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, list):
            return "[" + ", ".join(render(c) for c in t) + "]"
        if isinstance(t, tuple):
            inner = ", ".join(render(c) for c in t)
            return f"({inner},)" if len(t) == 1 else f"({inner})"
        return "*"
    return f"PyTreeDef({render(tree)})"


def _leaf_name(path) -> str:
    return _SAFE.sub("_", ".".join(str(k) for k in path))


def _to_numpy(x) -> np.ndarray:
    """A host copy of ``x``: a background save writes it while the caller
    goes on, and may update its tensors in place (a CPU tensor's
    ``.numpy()`` would share their memory)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x)


def _named_leaves(tree) -> list:
    """[(name, leaf)] in flatten order — the one naming scheme save and
    restore must agree on."""
    return [(f"{i:04d}.{_leaf_name(p)}", x)
            for i, (p, x) in enumerate(_flatten_with_path(tree))]


def _as_tensor(arr: np.ndarray, tmpl, device) -> torch.Tensor:
    """``arr`` in the template leaf's dtype, on ``device``."""
    if isinstance(tmpl, torch.Tensor):
        return torch.from_numpy(arr).to(device=device, dtype=tmpl.dtype)
    arr = np.ascontiguousarray(arr.astype(np.dtype(tmpl.dtype)))
    return torch.from_numpy(arr).to(device)


class Checkpointer:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None
        # step a concurrent restore is reading (retention must not
        # delete it, or anything newer, mid-read)
        self._restore_pin: int | None = None
        self._pin_lock = threading.Lock()

    # ------------------------------------------------------------- save
    def save(self, step: int, tree: Any, *, blocking: bool = True,
             extra: dict | None = None):
        """Serialize ``tree`` (a tree of arrays) at ``step`` (legacy
        single-tree layout)."""
        self.wait()
        leaves = [(name, _to_numpy(x)) for name, x in _named_leaves(tree)]
        structure = _treedef_str(tree)

        def _write():
            tmp = self._tmp_dir(step)
            names = self._write_leaves(tmp, leaves)
            manifest = {"step": step, "leaves": names,
                        "treedef": structure,
                        "time": time.time(), "extra": extra or {}}
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            self._commit_dir(step, tmp)
            self._retain()

        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def save_domains(self, step: int, domains: dict, *,
                     versions: dict | None = None,
                     meta: dict | None = None, blocking: bool = True,
                     _pre_commit=None):
        """Serialize named sub-trees at ``step`` (domain layout).

        domains:   {name: tree of arrays} — each domain gets its own
                   subdirectory and manifest entry.
        versions:  {name: int} schema version per domain (default 1);
                   validated by :meth:`restore_domain`.
        meta:      free-form JSON blob stored in the manifest — the
                   python-side structure that describes the arrays.
        _pre_commit: test hook, called after every leaf is written but
                   BEFORE the COMMITTED marker — raising here simulates a
                   crash mid-save (the partial checkpoint is ignored at
                   restore).
        """
        self.wait()
        versions = versions or {}
        flat_domains = {}
        for name, tree in domains.items():
            if _SAFE.search(name):
                raise ValueError(f"domain name {name!r} has unsafe chars")
            flat_domains[name] = [(n, _to_numpy(x))
                                  for n, x in _named_leaves(tree)]

        def _write():
            tmp = self._tmp_dir(step)
            entry = {}
            for name, leaves in flat_domains.items():
                sub = tmp / name
                sub.mkdir()
                names = self._write_leaves(sub, leaves)
                entry[name] = {"version": int(versions.get(name, 1)),
                               "leaves": names}
            manifest = {"step": step, "domains": entry,
                        "time": time.time(), "extra": meta or {}}
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            if _pre_commit is not None:
                _pre_commit()
            self._commit_dir(step, tmp)
            self._retain()

        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    @staticmethod
    def _write_leaves(d: Path, leaves) -> list:
        names = []
        for name, arr in leaves:
            np.save(d / f"{name}.npy", arr)
            names.append(name)
        return names

    def _tmp_dir(self, step: int) -> Path:
        tmp = self.dir / f".tmp_step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        return tmp

    def _commit_dir(self, step: int, tmp: Path) -> None:
        (tmp / "COMMITTED").write_text("ok")
        d = self.dir / f"step_{step:08d}"
        if d.exists():
            shutil.rmtree(d)
        tmp.rename(d)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _retain(self):
        """Delete steps beyond ``keep`` — EXCEPT any step a concurrent
        restore has pinned (or anything newer): the async save thread
        must never delete files a restore is reading mid-way."""
        with self._pin_lock:
            pin = self._restore_pin
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            if pin is not None and s >= pin:
                continue
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    @contextlib.contextmanager
    def _pinned(self, step: int):
        with self._pin_lock:
            self._restore_pin = step
        try:
            yield
        finally:
            with self._pin_lock:
                self._restore_pin = None

    # ---------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for p in sorted(self.dir.glob("step_*")):
            if (p / "COMMITTED").exists():
                out.append(int(p.name.split("_")[1]))
        return out

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _resolve_step(self, step: int | None) -> tuple[int, Path, dict]:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        return step, d, manifest

    @staticmethod
    def _validate_names(written: list, expected: list, what: str) -> None:
        """Leaf names computed from the template must equal what the
        manifest says was written — a silent zip-truncate here restores
        the WRONG leaves into the right-shaped arrays."""
        if list(written) == list(expected):
            return
        missing = [n for n in expected if n not in written]
        surplus = [n for n in written if n not in expected]
        raise ValueError(
            f"{what}: template does not match the manifest "
            f"({len(expected)} template leaves vs {len(written)} written; "
            f"template-only={missing[:4]}, checkpoint-only={surplus[:4]}) "
            f"— restore into the structure that was saved")

    def _load_tree(self, d: Path, written_names: list, template: Any,
                   device) -> Any:
        named = _named_leaves(template)
        self._validate_names(written_names, [n for n, _ in named],
                             f"restore from {d.name}")
        out = []
        for name, tmpl in named:
            arr = np.load(d / f"{name}.npy")
            if tuple(arr.shape) != tuple(tmpl.shape):
                raise ValueError(f"leaf {name}: checkpoint shape "
                                 f"{arr.shape} != template "
                                 f"{tuple(tmpl.shape)}")
            out.append(_as_tensor(arr, tmpl, device))
        _, treedef = tree_flatten(template)
        return tree_unflatten(treedef, out)

    def restore(self, template: Any, step: int | None = None, *,
                device="cuda") -> tuple[Any, int]:
        """Load into the structure of ``template`` (leaves: anything with
        ``shape`` and ``dtype``), each leaf a tensor on ``device`` in the
        template leaf's dtype."""
        device = resolve_device(device)
        step, d, manifest = self._resolve_step(step)
        if "leaves" not in manifest:
            raise ValueError(
                f"step {step} is a domain checkpoint "
                f"({sorted(manifest.get('domains', {}))}); use "
                f"restore_domain")
        with self._pinned(step):
            tree = self._load_tree(d, manifest["leaves"], template, device)
        return tree, step

    # -- domain layout ----------------------------------------------------

    def domains(self, step: int | None = None) -> dict:
        """{name: version} of a domain checkpoint."""
        _, _, manifest = self._resolve_step(step)
        return {n: e["version"]
                for n, e in manifest.get("domains", {}).items()}

    def meta(self, step: int | None = None) -> dict:
        """The free-form JSON blob stored by :meth:`save_domains`."""
        _, _, manifest = self._resolve_step(step)
        return manifest.get("extra", {})

    def _domain_entry(self, name: str, step: int | None):
        step, d, manifest = self._resolve_step(step)
        entry = manifest.get("domains", {}).get(name)
        if entry is None:
            raise KeyError(
                f"step {step} has no domain {name!r} "
                f"(has {sorted(manifest.get('domains', {}))})")
        return step, d / name, entry

    def restore_domain(self, name: str, template: Any,
                       step: int | None = None, *, device="cuda",
                       expect_version: int | None = None) -> tuple[Any, int]:
        """Load one named domain into ``template`` on ``device``
        (manifest-validated: leaf names, counts, and — when
        ``expect_version`` is given — the domain's schema version)."""
        device = resolve_device(device)
        step, sub, entry = self._domain_entry(name, step)
        if expect_version is not None and entry["version"] != expect_version:
            raise ValueError(f"domain {name!r} at step {step} has version "
                             f"{entry['version']}, expected {expect_version}")
        with self._pinned(step):
            tree = self._load_tree(sub, entry["leaves"], template, device)
        return tree, step

    def load_domain_arrays(self, name: str,
                           step: int | None = None) -> tuple[list, int, int]:
        """Template-free load of one domain: the raw numpy leaves in
        manifest order.  Returns (arrays, version, step) — for callers
        whose tree structure lives in :meth:`meta` (the service
        snapshot)."""
        step, sub, entry = self._domain_entry(name, step)
        with self._pinned(step):
            arrays = []
            for leaf in entry["leaves"]:
                p = sub / f"{leaf}.npy"
                if not p.exists():
                    raise ValueError(f"domain {name!r} at step {step}: "
                                     f"manifest names leaf {leaf!r} but "
                                     f"the file is missing")
                arrays.append(np.load(p))
        return arrays, entry["version"], step
