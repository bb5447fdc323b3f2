"""Atomic, checksummed checkpoints (counterpart of
``repro.checkpointing.ckpt``), in the JAX package's on-disk format.

A checkpoint is a directory ``step_XXXXXXXX/`` holding one ``.npz`` shard
and a ``manifest.json`` (step, leaf shapes and dtypes, a structure
fingerprint, the shard's sha256, an optional config identity and the
caller's ``extra``).  Leaves are keyed by their path in the state tree,
joined with "/": dict keys as they are, dataclass fields as ``.name``
(JAX's spelling of an attribute key), list items by index.  A state saved
in the JAX layout (``models.bridge``) is therefore the same file set
whichever package wrote it, and restores into the other.

  * Writes go to ``step_XXXXXXXX.tmp/`` and are published by one rename,
    so a crash mid-write never damages the latest checkpoint.
  * ``restore`` re-verifies the shard checksums (a flipped bit raises
    :class:`CheckpointMismatchError`), the config identity and the
    structure fingerprint against the target tree.
  * ``latest_intact_step`` / ``restore_latest`` fall back past a damaged
    newest checkpoint, with a warning, to the newest one that verifies.
  * ``keep_last`` bounds the number kept on disk.
  * A checkpoint holds the GLOBAL arrays, whatever mesh wrote it, as the
    reference's does (``repro/checkpointing/ckpt.py:9-12``): on a model
    axis every rank gathers its blocks to rank 0 one leaf at a time
    (``models/bridge.py`` ``export_params`` / ``export_opt_state`` with
    ``mesh=``), and rank 0 alone calls :meth:`CheckpointManager.save`, so
    the manifest, the leaves and the fingerprint are a meshless save's.
    :meth:`CheckpointManager.restore` checks them against the global
    shapes (``bridge.abstract_params``, no memory) and returns the global
    arrays, which each rank of any mesh cuts to its block
    (``bridge.load_jax_params`` / ``load_opt_state`` with ``mesh=``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import time
import warnings
from typing import Any, Optional

import numpy as np


class CheckpointMismatchError(ValueError):
    """The checkpoint on disk disagrees with what the caller expects --
    restoring one model's checkpoint into another's tree, a corrupt
    shard, or re-saving a different state over an existing step."""


def _items(node):
    """(key string, child) pairs of one tree node, in JAX's order: sorted
    dict keys, dataclass fields in declaration order, sequence items."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f".{f.name}", getattr(node, f.name))
                for f in dataclasses.fields(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), x) for i, x in enumerate(node)]
    return None


def _flatten_with_paths(tree, prefix=()) -> dict:
    items = _items(tree)
    if items is None:
        return {"/".join(prefix): tree}
    out = {}
    for key, child in items:
        out.update(_flatten_with_paths(child, prefix + (key,)))
    return out


def _unflatten_like(like, leaves: dict, prefix=()):
    items = _items(like)
    if items is None:
        return leaves["/".join(prefix)]
    built = {k: _unflatten_like(c, leaves, prefix + (k,)) for k, c in items}
    if isinstance(like, dict):
        return {k: built[str(k)] for k in like}
    if dataclasses.is_dataclass(like):
        return dataclasses.replace(like, **{k[1:]: v
                                            for k, v in built.items()})
    return type(like)(built[str(i)] for i in range(len(like)))


def tree_paths(tree) -> list[str]:
    return sorted(_flatten_with_paths(tree))


def _leaf_sig(tree) -> dict[str, dict]:
    """Manifest-style {path: {shape, dtype}} of a tree."""
    out = {}
    for key, leaf in _flatten_with_paths(tree).items():
        arr = np.asarray(leaf)
        out[key] = {"shape": [int(s) for s in arr.shape],
                    "dtype": str(arr.dtype)}
    return out


def _sig_fingerprint(sig: dict[str, dict]) -> str:
    items = [[k, sig[k]["shape"], sig[k]["dtype"]] for k in sorted(sig)]
    return hashlib.sha256(json.dumps(items).encode()).hexdigest()


def tree_fingerprint(tree) -> str:
    """sha256 over the sorted (leaf path, shape, dtype) triples: identifies
    the architecture a checkpoint belongs to, not its values."""
    return _sig_fingerprint(_leaf_sig(tree))


def _file_sha256(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def _sig_diff(a: dict[str, dict], b: dict[str, dict], n: int = 5) -> str:
    """Human-readable first differences between two leaf signatures."""
    lines = []
    for k in sorted(set(a) | set(b)):
        if a.get(k) != b.get(k):
            lines.append(f"  {k}: checkpoint={a.get(k)} target={b.get(k)}")
        if len(lines) >= n:
            lines.append("  ...")
            break
    return "\n".join(lines) or "  (tree structures identical?)"


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    keep_last: int = 3

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)

    # ------------------------------------------------------------- paths --
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def all_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    steps.append(int(name.split("_")[1]))
                except ValueError:
                    continue
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------ verify --
    def verify(self, step: int) -> bool:
        """True iff the manifest parses and every shard listed in it exists
        with a matching sha256."""
        d = self._step_dir(step)
        try:
            with open(os.path.join(d, "manifest.json")) as f:
                manifest = json.load(f)
        except (OSError, json.JSONDecodeError):
            return False
        checksums = manifest.get("checksums")
        if checksums is None:
            return True                   # pre-checksum checkpoint: trust
        for name, want in checksums.items():
            path = os.path.join(d, name)
            if not os.path.exists(path) or _file_sha256(path) != want:
                return False
        return True

    def latest_intact_step(self) -> Optional[int]:
        """Newest step that passes :meth:`verify`, warning past damaged
        ones: a corrupt final checkpoint costs one save interval."""
        for step in reversed(self.all_steps()):
            if self.verify(step):
                return step
            warnings.warn(f"checkpoint step {step} at "
                          f"{self._step_dir(step)} failed verification "
                          f"(corrupt or torn write) — falling back")
        return None

    # -------------------------------------------------------------- save --
    def save(self, step: int, state: Any, *, extra: dict | None = None,
             config: Optional[str] = None):
        """Atomic save of a tree of numpy arrays.

        ``config`` is an architecture identity string stored in the
        manifest and checked on restore.  Re-saving an existing step is a
        no-op only if the manifest matches; a conflicting re-save raises
        :class:`CheckpointMismatchError`."""
        final = self._step_dir(step)
        sig = _leaf_sig(state)
        if os.path.exists(final):
            with open(os.path.join(final, "manifest.json")) as f:
                have = json.load(f)
            mismatch = []
            if have["step"] != step:
                mismatch.append(f"step: on-disk {have['step']} != {step}")
            if have.get("leaves") != sig:
                mismatch.append("leaf shapes/dtypes differ:\n"
                                + _sig_diff(have.get("leaves", {}), sig))
            if (config is not None and have.get("config") is not None
                    and have["config"] != config):
                mismatch.append(f"config: on-disk {have['config']!r} "
                                f"!= {config!r}")
            if mismatch:
                raise CheckpointMismatchError(
                    f"save: step {step} already exists at {final} with a "
                    f"DIFFERENT state — refusing the silent no-op:\n"
                    + "\n".join(mismatch))
            return                      # identical manifest: idempotent save
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        arrays = {key.replace("/", "__"): np.asarray(leaf)
                  for key, leaf in _flatten_with_paths(state).items()}
        shard_name = "shards_00000.npz"     # the global arrays, one writer
        np.savez(os.path.join(tmp, shard_name), **arrays)
        manifest = {
            "step": step,
            "time": time.time(),
            "process_count": 1,
            "leaves": sig,
            "fingerprint": _sig_fingerprint(sig),
            "checksums": {shard_name:
                          _file_sha256(os.path.join(tmp, shard_name))},
            "config": config,
            "extra": extra or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        os.rename(tmp, final)          # atomic publish
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: max(0, len(steps) - self.keep_last)]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
        for name in os.listdir(self.directory):   # crashed writers' tmp dirs
            if name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)

    # ------------------------------------------------------------ restore --
    def restore(self, step: int, like: Any, *,
                config: Optional[str] = None):
        """Restore into the structure of ``like`` -> (state of numpy
        arrays, extra).  The shard checksums, the config identity and
        the structure fingerprint must all match."""
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        for name, want in (manifest.get("checksums") or {}).items():
            path = os.path.join(d, name)
            if not os.path.exists(path):
                raise CheckpointMismatchError(
                    f"restore: checkpoint step {step} shard {name} is "
                    f"missing (torn write?)")
            got = _file_sha256(path)
            if got != want:
                raise CheckpointMismatchError(
                    f"restore: checkpoint step {step} shard {name} "
                    f"checksum mismatch (sha256 {got[:12]}… != manifest "
                    f"{want[:12]}…) — on-disk corruption")
        if (config is not None and manifest.get("config") is not None
                and manifest["config"] != config):
            raise CheckpointMismatchError(
                f"restore: checkpoint step {step} was saved for config "
                f"{manifest['config']!r}, caller expects {config!r}")
        sig = _leaf_sig(like)
        if manifest.get("fingerprint") is not None:
            missing = set(sig) - set(manifest.get("leaves", {}))
            if missing:
                raise KeyError(f"checkpoint {step} missing leaves: "
                               f"{sorted(missing)[:5]}")
            if _sig_fingerprint(sig) != manifest["fingerprint"]:
                raise CheckpointMismatchError(
                    f"restore: checkpoint step {step} does not fit the "
                    f"target tree (config {manifest.get('config')!r}):\n"
                    + _sig_diff(manifest.get("leaves", {}), sig))
        data: dict[str, np.ndarray] = {}
        for name in sorted(os.listdir(d)):
            if name.startswith("shards_") and name.endswith(".npz"):
                with np.load(os.path.join(d, name)) as z:
                    for k in z.files:
                        data[k.replace("__", "/")] = z[k]
        missing = set(sig) - set(data)
        if missing:
            raise KeyError(f"checkpoint {step} missing leaves: "
                           f"{sorted(missing)[:5]}")
        for key, want in sig.items():
            if list(data[key].shape) != want["shape"]:
                raise ValueError(f"{key}: checkpoint shape "
                                 f"{data[key].shape} != target "
                                 f"{tuple(want['shape'])}")
        return _unflatten_like(like, data), manifest["extra"]

    def restore_latest(self, like: Any, *, config: Optional[str] = None):
        """Restore the newest INTACT checkpoint -> (step, state, extra);
        raises ``FileNotFoundError`` only when none verifies."""
        step = self.latest_intact_step()
        if step is None:
            raise FileNotFoundError(
                f"restore_latest: no intact checkpoint under "
                f"{self.directory}")
        state, extra = self.restore(step, like, config=config)
        return step, state, extra
