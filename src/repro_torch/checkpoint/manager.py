"""Atomic, async, integrity-checked checkpointing (restart and preemption
safety), in the reference's on-disk format.

Layout per step:
  <dir>/step_<n>.npz       — the tree's leaves (numpy archive)
  <dir>/step_<n>.json      — manifest: step, leaf count, dtypes, the
                             tree's structure, sha256, optional config and
                             codec compatibility fingerprints

Trees are nested dicts (and lists or tuples) of arrays.  Leaves are
flattened with dict keys sorted, which is jax's leaf order, and the
manifest's `treedef` is the structure written as jax prints it (e.g.
``PyTreeDef({'jkey': *, 'weights': {'B1': *, 'C': *}})``).  So a manifest
written here equals the reference's in every key but `sha256` (`np.savez`
stamps each zip entry with the time), and either package restores the
other's checkpoints.

Write protocol: tmp file + fsync + atomic rename + directory fsync,
manifest LAST — a crash mid-write can never leave a manifest pointing at
a torn archive, and the rename itself is durable before the manifest
appears.  Restore takes the newest manifest whose JSON parses (torn
manifests are skipped), whose schema is complete, and whose archive hash
verifies.  `save_async` copies the tree to host numpy before it returns
(tensors on the card through `.to("cpu")`) and writes it on a worker
thread, so the step loop never blocks on I/O.

Compatibility refusal: a manifest may carry `config_hash` (semantic
run-config fingerprint) and `codec_version` (wire-format version).  A
load that passes the matching `expect_*` values REFUSES — raises
`CheckpointMismatch` with both values spelled out — rather than silently
resuming a run whose recovered streams would diverge.  Torn or corrupt
checkpoints are *skipped* (an older valid step is tried); mismatched
ones are *refused* (falling back would hide the operator's error).

Only dtypes that npz holds natively are written (bool, integers, floats,
complex, strings); anything else (bfloat16, float8, objects) is refused
with a `TypeError`, and so is a reference checkpoint whose manifest names
such a dtype, since restoring it would need `ml_dtypes`.
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
from typing import Any

import numpy as np


class CheckpointMismatch(RuntimeError):
    """A valid checkpoint exists but belongs to an incompatible run
    (config or codec-version hash differs) — resume refused."""


#: manifest keys a readable checkpoint must carry — a parsed-but-partial
#: manifest (e.g. truncated then padded by a broken filesystem) is torn.
_REQUIRED_MANIFEST_KEYS = ("step", "n_leaves", "dtypes", "treedef",
                           "sha256")

#: numpy dtype kinds an npz archive holds without pickling
_NPZ_KINDS = "b?iufcSU"


def _to_numpy(x) -> np.ndarray:
    """A leaf as a host numpy COPY (torch tensors through `.to("cpu")`),
    so later writes to the caller's tensor or array do not reach a save
    in flight; dtypes npz cannot hold are refused."""
    if hasattr(x, "detach") and hasattr(x, "cpu"):          # torch.Tensor
        try:
            arr = x.detach().to("cpu", copy=True).numpy()
        except TypeError as e:                  # bfloat16, float8, ...
            raise TypeError(f"checkpoint leaf of dtype {x.dtype} has no "
                            "numpy form an npz archive can hold") from e
    else:
        arr = np.array(x)
    if arr.dtype.kind not in _NPZ_KINDS or arr.dtype.names is not None:
        raise TypeError(f"checkpoint leaf of dtype {arr.dtype} cannot be "
                        "stored in an npz archive")
    return arr


def _leaves(tree: Any) -> list:
    """Leaves in jax's order: dict keys sorted, sequences in order; None
    is an empty node, as in jax."""
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [v for x in tree for v in _leaves(x)]
    if tree is None:
        return []
    return [tree]


def _structure(tree: Any) -> str:
    """The tree's structure as jax prints a treedef's body."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(_structure(x) for x in tree) + "]"
    if isinstance(tree, tuple):
        body = ", ".join(_structure(x) for x in tree)
        return f"({body},)" if len(tree) == 1 else f"({body})"
    return "None" if tree is None else "*"


def treedef_str(tree: Any) -> str:
    """`str(jax.tree_util.tree_structure(tree))` without jax."""
    return f"PyTreeDef({_structure(tree)})"


def _unflatten(template: Any, leaves: list) -> Any:
    """`leaves` (in `_leaves` order) placed into `template`'s structure;
    dicts come back with their keys sorted, as jax rebuilds them."""
    if len(leaves) != len(_leaves(template)):
        raise ValueError(f"checkpoint holds {len(leaves)} leaves, the "
                         f"template {len(_leaves(template))}")
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)([build(x) for x in t])
        return None if t is None else next(it)
    return build(template)


def _map(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(x, fn) for x in tree)
    return None if tree is None else fn(tree)


def _flatten(tree: Any) -> tuple[dict[str, np.ndarray], list[str], str]:
    flat, dtypes = {}, []
    for i, x in enumerate(_leaves(tree)):
        arr = _to_numpy(x)
        dtypes.append(str(arr.dtype))
        flat[f"leaf_{i}"] = arr
    return flat, dtypes, treedef_str(tree)


def _restore_leaf(arr: np.ndarray, dtype_name: str | None,
                  i: int) -> np.ndarray:
    if dtype_name is not None and dtype_name != str(arr.dtype):
        raise TypeError(f"checkpoint leaf {i} has dtype {dtype_name}, stored "
                        f"as {arr.dtype}: restoring it needs ml_dtypes, which "
                        "this package does not use")
    return arr


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _fsync_dir(directory: str) -> None:
    """Make a completed rename durable (POSIX: the rename lives in the
    directory entry, which has its own write-back)."""
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:          # platform without directory fds
        return
    try:
        os.fsync(fd)
    except OSError:          # fsync unsupported on this filesystem
        pass
    finally:
        os.close(fd)


def save_checkpoint(directory: str, step: int, tree: Any,
                    extra: dict | None = None,
                    config_hash: str | None = None,
                    codec_version: int | None = None) -> str:
    os.makedirs(directory, exist_ok=True)
    flat, dtypes, treedef = _flatten(tree)
    base = os.path.join(directory, f"step_{step}")
    tmp = f"{base}.npz.tmp.{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, base + ".npz")
    _fsync_dir(directory)
    manifest = {
        "step": step,
        "n_leaves": len(flat),
        "dtypes": dtypes,
        "treedef": treedef,
        "sha256": _sha256(base + ".npz"),
        "extra": extra or {},
    }
    if config_hash is not None:
        manifest["config_hash"] = config_hash
    if codec_version is not None:
        manifest["codec_version"] = int(codec_version)
    mtmp = f"{base}.json.tmp.{os.getpid()}.{threading.get_ident()}"
    with open(mtmp, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    os.rename(mtmp, base + ".json")
    _fsync_dir(directory)
    return base


def _read_manifest(path: str) -> dict | None:
    """Parse one manifest; None for torn/partial manifests (truncated
    JSON, missing required keys) — callers skip those."""
    try:
        with open(path) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    if not isinstance(manifest, dict) or \
            any(k not in manifest for k in _REQUIRED_MANIFEST_KEYS):
        return None
    return manifest


def check_compat(manifest: dict, expect_config_hash: str | None,
                 expect_codec_version: int | None) -> None:
    """Refuse (raise `CheckpointMismatch`) when the caller expects a
    config/codec fingerprint and the manifest's differs or is absent."""
    if expect_config_hash is not None:
        got = manifest.get("config_hash")
        if got != expect_config_hash:
            raise CheckpointMismatch(
                f"checkpoint step {manifest.get('step')}: config hash "
                f"{got!r} != this run's {expect_config_hash!r} — the "
                "checkpoint belongs to a different run configuration; "
                "resume refused (use a fresh checkpoint directory or the "
                "original config)")
    if expect_codec_version is not None:
        got = manifest.get("codec_version")
        if got != int(expect_codec_version):
            raise CheckpointMismatch(
                f"checkpoint step {manifest.get('step')}: codec version "
                f"{got!r} != this build's {expect_codec_version!r} — "
                "serialized stream state is not portable across codec "
                "versions; resume refused")


def _step_of(filename: str) -> int:
    return int(filename.split("_")[1].split(".")[0])


def _manifest_files(directory: str) -> list[str]:
    return sorted((f for f in os.listdir(directory)
                   if f.startswith("step_") and f.endswith(".json")),
                  key=_step_of, reverse=True)


def valid_steps(directory: str,
                expect_config_hash: str | None = None,
                expect_codec_version: int | None = None) -> list[int]:
    """Steps whose manifest parses, matches the expected fingerprints,
    and whose archive hash verifies — the set a resume may offer.
    Ascending.  Torn entries are skipped; fingerprint mismatches raise
    `CheckpointMismatch` (refusal, not fallback)."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for mf in _manifest_files(directory):
        base = os.path.join(directory, mf[:-5])
        manifest = _read_manifest(base + ".json")
        if manifest is None:
            continue
        check_compat(manifest, expect_config_hash, expect_codec_version)
        try:
            if _sha256(base + ".npz") != manifest["sha256"]:
                continue
        except OSError:
            continue
        steps.append(int(manifest["step"]))
    return sorted(steps)


def load_checkpoint(directory: str, template: Any,
                    step: int | None = None,
                    expect_config_hash: str | None = None,
                    expect_codec_version: int | None = None
                    ) -> tuple[int, Any, dict] | None:
    """Restore the newest (or given) valid checkpoint into the structure
    of `template`.  Returns (step, tree, extra) or None.  Torn archives
    and torn manifests are skipped (older steps tried next);
    config/codec fingerprint mismatches raise `CheckpointMismatch`."""
    if not os.path.isdir(directory):
        return None
    for mf in _manifest_files(directory):
        if step is not None and _step_of(mf) != step:
            continue
        base = os.path.join(directory, mf[:-5])
        manifest = _read_manifest(base + ".json")
        if manifest is None:
            continue                       # torn manifest — skip
        check_compat(manifest, expect_config_hash, expect_codec_version)
        try:
            if _sha256(base + ".npz") != manifest["sha256"]:
                continue                   # torn archive — skip
            with np.load(base + ".npz") as data:
                dtypes = manifest.get("dtypes") or \
                    [None] * manifest["n_leaves"]
                leaves = [_restore_leaf(data[f"leaf_{i}"], dtypes[i], i)
                          for i in range(manifest["n_leaves"])]
            tree = _unflatten(template, leaves)
            return manifest["step"], tree, manifest.get("extra", {})
        except (OSError, KeyError, ValueError):
            continue
    return None


class CheckpointManager:
    """keep-N rotation + async save + compatibility fingerprints.

    Args:
      directory: checkpoint root (one party/run per directory).
      keep: number of newest steps retained by rotation.
      config_hash / codec_version: when given, stamped into every saved
        manifest and *required* to match on `restore`/`steps` — a
        mismatched directory refuses with `CheckpointMismatch` instead
        of silently resuming an incompatible run.
    """

    def __init__(self, directory: str, keep: int = 3,
                 config_hash: str | None = None,
                 codec_version: int | None = None):
        self.directory = directory
        self.keep = keep
        self.config_hash = config_hash
        self.codec_version = codec_version
        self._thread: threading.Thread | None = None

    def save(self, step: int, tree: Any, extra: dict | None = None) -> None:
        self.wait()                             # never race a pending async
        save_checkpoint(self.directory, step, _map(tree, _to_numpy), extra,
                        config_hash=self.config_hash,
                        codec_version=self.codec_version)
        self._gc()

    def save_async(self, step: int, tree: Any,
                   extra: dict | None = None) -> None:
        self.wait()
        tree = _map(tree, _to_numpy)            # host copy BEFORE returning
        self._thread = threading.Thread(
            target=save_checkpoint,
            args=(self.directory, step, tree, extra),
            kwargs={"config_hash": self.config_hash,
                    "codec_version": self.codec_version},
            daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
            self._gc()

    def restore(self, template: Any, step: int | None = None):
        self.wait()
        return load_checkpoint(self.directory, template, step=step,
                               expect_config_hash=self.config_hash,
                               expect_codec_version=self.codec_version)

    def steps(self) -> list[int]:
        """Valid, compatible steps currently on disk (ascending)."""
        self.wait()
        return valid_steps(self.directory,
                           expect_config_hash=self.config_hash,
                           expect_codec_version=self.codec_version)

    def _gc(self) -> None:
        if not os.path.isdir(self.directory):
            return
        steps = sorted({_step_of(f) for f in os.listdir(self.directory)
                        if f.startswith("step_") and f.endswith(".json")},
                       reverse=True)
        for s in steps[self.keep:]:
            for ext in (".npz", ".json"):
                try:
                    os.remove(os.path.join(self.directory, f"step_{s}{ext}"))
                except OSError:
                    pass
