"""Pytree checkpointing on msgpack (counterpart of
``repro.ckpt.msgpack_ckpt``): durable atomic writes, incremental
content-hashed snapshots, off-thread serialization, template-free
restore.

The file format is the reference's format v2, so each package reads
the other's files: one ``.msgpack`` map per snapshot holding
``__meta__``, ``__format__`` (2), ``__treedef__`` (the registry name of
the saved tree), ``__base__`` (the file an incremental snapshot chains
to, or nil), ``__hashes__`` (a blake2b hash of every leaf's dtype,
shape and bytes) and ``arrays`` ({leaf path: {dtype, shape, data}}).
Leaf paths are NamedTuple field names, dict keys (sorted, as JAX
flattens a dict) and sequence indices joined by ``/``.  The bytes are
written by :mod:`repro_torch.ckpt.codec`, byte for byte what
``msgpack.packb`` writes, so the port needs no ``msgpack`` package.

Leaves are torch tensors (on any device), numpy arrays or Python and
numpy scalars.  Every save takes owned host copies on the calling
thread (a CUDA tensor is copied to the host, a CPU tensor cloned, so
an engine that later updates its tensors in place cannot change a
snapshot in flight); the writer thread sees numpy arrays only.  A
registered tree type may name boundary dtypes for its leaves
(:func:`register_treedef`): the engines store their threefry key words,
int64 in the port's tensors, as the reference's uint32.

Three mechanisms keep a preemption off the dispatch loop's critical
path, as in the reference:

* **Incremental saves.**  ``save_pytree(path, tree, base=,
  base_hashes=)`` writes only leaves whose hash changed since the base
  snapshot, and loading overlays the chain tip to base.
* **Off-thread serialization.**  :class:`AsyncCheckpointer` hands the
  host copies to one writer thread over a bounded queue; ``wait()`` is
  the durability barrier and re-raises the first writer error.
* **Template-free restore.**  :func:`restore_pytree` rebuilds the saved
  tree (e.g. a ``batched.StepState``) from the manifest and the
  registered reconstructor, as tensors on the caller's device.

Durability: a write goes to a temp file in the same directory, is
flushed and fsync'd, published with ``os.replace``, and the directory
is fsync'd after — a crash mid-write never publishes a truncated file
and leaves the previous snapshot intact.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import os
import queue
import tempfile
import threading
import time
import warnings
from typing import Callable

import numpy as np
import torch

from repro_torch.ckpt import codec
from repro_torch.device import resolve_device
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

FORMAT = 2


# ---------------------------------------------------------------------------
# Leaf paths + the treedef registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Treedef:
    unflatten: Callable
    leaf_dtypes: dict


_TREEDEF_REGISTRY: dict = {}


def register_treedef(name: str, unflatten: Callable,
                     leaf_dtypes: dict | None = None) -> None:
    """Register a reconstructor for template-free restore.

    ``unflatten(leaves, device)`` maps ``{leaf path: numpy array}`` (the
    checkpoint's flat, owned host arrays) to the live tree with its
    tensors on ``device``.  ``leaf_dtypes`` ({leaf path: numpy dtype
    name}) are the dtypes those leaves take in the file where the live
    tree holds them in another (the engines' key words: int64 tensors,
    uint32 on disk); a save converts them exactly, or raises.  Engines
    register their state types at import (``batched.STATE_TREEDEF``,
    ``sharded_batched.STATE_TREEDEF``).
    """
    _TREEDEF_REGISTRY[name] = _Treedef(unflatten, dict(leaf_dtypes or {}))


def _iter_leaves(tree, prefix=()):
    """(path entries, leaf) in the reference's flattening order:
    NamedTuple fields in order, dict keys sorted, sequence indices; a
    None is an empty subtree."""
    if tree is None:
        return
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _iter_leaves(getattr(tree, f), prefix + (f,))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _iter_leaves(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _iter_leaves(v, prefix + (str(i),))
    else:
        yield prefix, tree


_NP_DTYPES: dict = {}


def _numpy_dtype(leaf) -> np.dtype:
    """The numpy dtype a leaf has on the host (no copy)."""
    if torch.is_tensor(leaf):
        d = leaf.dtype
        if d not in _NP_DTYPES:
            _NP_DTYPES[d] = torch.empty(0, dtype=d).numpy().dtype
        return _NP_DTYPES[d]
    return np.asarray(leaf).dtype


def _host_copy(leaf) -> np.ndarray:
    """An owned, contiguous numpy copy of one leaf."""
    if torch.is_tensor(leaf):
        t = leaf.detach()
        t = t.cpu() if t.device.type != "cpu" else t.clone()
        return np.ascontiguousarray(t.numpy())
    return np.array(leaf)


def _to_boundary(key: str, arr: np.ndarray, want) -> np.ndarray:
    """``arr`` in its file dtype ``want``: an exact conversion or a
    ValueError (a key word outside uint32 would wrap silently)."""
    want = np.dtype(want)
    if arr.dtype == want:
        return arr
    if arr.size and (arr.min() < np.iinfo(want).min
                     or arr.max() > np.iinfo(want).max):
        raise ValueError(f"leaf {key!r} holds values outside {want}: "
                         f"refusing a wrapping cast")
    return arr.astype(want)


def _flatten_with_paths(tree, treedef: str | None = None) -> dict:
    """{leaf path: owned host array}, in the file's dtypes."""
    entry = _TREEDEF_REGISTRY.get(treedef)
    boundary = entry.leaf_dtypes if entry is not None else {}
    out = {}
    for path, leaf in _iter_leaves(tree):
        key = "/".join(path)
        arr = _host_copy(leaf)
        if key in boundary:
            arr = _to_boundary(key, arr, boundary[key])
        out[key] = arr
    return out


def _nest(flat: dict, device) -> dict:
    """Default reconstructor: nested dicts split on '/', tensors on
    ``device``."""
    out: dict = {}
    for k, arr in flat.items():
        parts = k.split("/")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = torch.from_numpy(arr).to(device)
    return out


register_treedef("nested_dict", _nest)


# ---------------------------------------------------------------------------
# Durable atomic write + hashing
# ---------------------------------------------------------------------------

def _fsync_dir(d: str) -> None:
    """fsync the directory entry so the rename itself is durable."""
    try:
        dfd = os.open(d, os.O_RDONLY)
    except OSError:                      # platform without dir-open
        return
    try:
        os.fsync(dfd)
    except OSError:
        pass
    finally:
        os.close(dfd)


def _write_atomic(path: str, blob: bytes) -> None:
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())         # data durable BEFORE the rename
        os.replace(tmp, path)            # atomic publish
        _fsync_dir(d)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def leaf_hash(arr: np.ndarray) -> str:
    """Content hash of one leaf (dtype + shape + raw bytes), the
    reference's."""
    h = hashlib.blake2b(digest_size=16)
    h.update(str(arr.dtype).encode())
    h.update(repr(tuple(arr.shape)).encode())
    h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# Save
# ---------------------------------------------------------------------------

def _save_flat(path: str, flat: dict, meta: dict, treedef: str | None,
               base: str | None, base_hashes: dict | None) -> dict:
    """Serialize a flattened {name: array} dict; returns its hashes.

    Every write funnels through here (sync :func:`save_pytree`, the
    :class:`AsyncCheckpointer` writer, :class:`CheckpointManager`): a
    ``ckpt_write`` span (its args add the file's ``bytes`` to the
    reference's) and the ``ckpt.saves`` counter and ``ckpt.save_s``
    histogram of the default metrics registry.
    """
    t0 = time.perf_counter()
    with obs_trace.span("ckpt_write", "checkpoint", path=path,
                        full=base is None) as sp:
        hashes = {k: leaf_hash(v) for k, v in flat.items()}
        if base is not None and base_hashes is not None:
            write = {k: v for k, v in flat.items()
                     if hashes[k] != base_hashes.get(k)}
            base_name = os.path.basename(base)
        else:
            write, base_name = flat, None
        sp.update(leaves_written=len(write), leaves_total=len(flat))
        payload = {
            "__meta__": dict(meta or {}),
            "__format__": FORMAT,
            "__treedef__": treedef,
            "__base__": base_name,
            "__hashes__": hashes,
            "arrays": {
                k: {"dtype": str(v.dtype), "shape": list(v.shape),
                    "data": v.tobytes()}
                for k, v in write.items()
            },
        }
        blob = codec.packb(payload)
        sp.update(bytes=len(blob))
        _write_atomic(path, blob)
    reg = obs_metrics.default_registry()
    reg.counter("ckpt.saves").inc()
    reg.histogram("ckpt.save_s").observe(time.perf_counter() - t0)
    return hashes


def save_pytree(path: str, tree, meta: dict | None = None,
                treedef: str | None = None, base: str | None = None,
                base_hashes: dict | None = None) -> dict:
    """Write one snapshot; returns its per-leaf content hashes.

    A full snapshot by default.  With ``base`` (a prior snapshot in the
    same directory) and ``base_hashes`` (that snapshot's returned
    hashes), only changed leaves are written and the manifest chains to
    the base.  ``treedef`` names a :func:`register_treedef`
    reconstructor, so the file restores through
    :func:`restore_pytree`.
    """
    return _save_flat(path, _flatten_with_paths(tree, treedef),
                      meta or {}, treedef, base, base_hashes)


# ---------------------------------------------------------------------------
# Load
# ---------------------------------------------------------------------------

def _read_payload(path: str) -> dict:
    with open(path, "rb") as f:
        blob = f.read()
    try:
        payload = codec.unpackb(blob)
        if not isinstance(payload, dict) or "arrays" not in payload:
            raise ValueError("missing arrays section")
    except (ValueError, TypeError) as e:
        raise ValueError(f"corrupt checkpoint {path!r}: {e}") from e
    return payload


_MAX_CHAIN = 4096


def _load_arrays(path: str, _depth: int = 0):
    """Resolve a snapshot (following its incremental chain) to a flat
    {name: array} dict of owned, writable copies, and the tip's
    payload."""
    if _depth > _MAX_CHAIN:
        raise ValueError(f"checkpoint chain too deep at {path!r} "
                         f"(> {_MAX_CHAIN}) — cycle?")
    payload = _read_payload(path)
    arrays = {
        k: np.frombuffer(v["data"], dtype=np.dtype(v["dtype"]))
        .reshape(v["shape"]).copy()
        for k, v in payload["arrays"].items()
    }
    base = payload.get("__base__")
    if base is not None:
        base_path = os.path.join(os.path.dirname(os.path.abspath(path)),
                                 base)
        merged, _ = _load_arrays(base_path, _depth + 1)
        merged.update(arrays)            # tip wins
        arrays = merged
    return arrays, payload


@contextlib.contextmanager
def _restore_scope(path: str):
    """One restore's observability: a ``ckpt_restore`` span and the
    ``ckpt.restores`` counter and ``ckpt.restore_s`` histogram (metrics
    only on success)."""
    t0 = time.perf_counter()
    with obs_trace.span("ckpt_restore", "checkpoint", path=path):
        yield
    reg = obs_metrics.default_registry()
    reg.counter("ckpt.restores").inc()
    reg.histogram("ckpt.restore_s").observe(time.perf_counter() - t0)


def _rebuild(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves`` (a tensor leaf gets a tensor on its device, any
    other leaf a numpy array)."""
    if like is None:
        return None
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(getattr(like, f), leaves)
                            for f in like._fields))
    if isinstance(like, dict):
        done = {k: _rebuild(like[k], leaves) for k in sorted(like)}
        return {k: done[k] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, leaves) for v in like)
    arr = next(leaves)
    if torch.is_tensor(like):
        return torch.from_numpy(arr).to(like.device)
    return arr


def load_pytree(path: str, like=None):
    """Returns (tree or flat dict of numpy arrays, meta).  With
    ``like``, restores ``like``'s exact structure, each tensor leaf on
    its template leaf's device.

    A template whose leaves differ in shape or dtype from the file's
    (leaf by leaf, in the file's boundary dtypes: the engines' key
    words are uint32 on disk) is refused with the leaf named, never
    reshaped or cast: resume bit-parity depends on the state landing in
    exactly the slots and representations it left.
    """
    with _restore_scope(path):
        arrays, payload = _load_arrays(path)
        meta = payload.get("__meta__", {})
        if like is None:
            return arrays, meta
        entry = _TREEDEF_REGISTRY.get(payload.get("__treedef__"))
        boundary = entry.leaf_dtypes if entry is not None else {}
        spec = [("/".join(p), leaf) for p, leaf in _iter_leaves(like)]
        missing = {k for k, _ in spec} - set(arrays)
        if missing:
            raise KeyError(
                f"checkpoint missing keys: {sorted(missing)[:5]}...")
        out = []
        for key, leaf in spec:
            arr = arrays[key]
            if tuple(arr.shape) != tuple(np.shape(leaf)):
                raise ValueError(
                    f"checkpoint leaf {key!r} has shape "
                    f"{tuple(arr.shape)} but the template expects "
                    f"{tuple(np.shape(leaf))} — restore against the "
                    f"inputs the state was saved for (file: {path})")
            want = np.dtype(boundary.get(key, _numpy_dtype(leaf)))
            if arr.dtype != want:
                raise ValueError(
                    f"checkpoint leaf {key!r} has dtype {arr.dtype} but "
                    f"the template expects {want} — a silent cast here "
                    f"would break bit-parity invisibly (file: {path})")
            if key in boundary:          # back to the live tree's dtype
                arr = arr.astype(_numpy_dtype(leaf))
            out.append(arr)
        return _rebuild(like, iter(out)), meta


def restore_pytree(path: str, device=None):
    """Template-free restore: (tree, meta) rebuilt from the
    checkpoint's own manifest — leaf names, dtypes, shapes and the
    :func:`register_treedef` name recorded at save time — with its
    tensors on ``device`` (default ``cuda``; ``"cpu"`` on a host
    without a card).  No engine init, no template."""
    dev = resolve_device(device)
    with _restore_scope(path):
        arrays, payload = _load_arrays(path)
        name = payload.get("__treedef__") or "nested_dict"
        if name not in _TREEDEF_REGISTRY:
            raise KeyError(
                f"checkpoint treedef {name!r} is not registered — "
                f"import the module that defines it (known: "
                f"{sorted(_TREEDEF_REGISTRY)})")
        # the reconstructor gets the raw host arrays, so its dtype check
        # sees what the file holds
        return _TREEDEF_REGISTRY[name].unflatten(arrays, dev), payload.get(
            "__meta__", {})


def snapshot_base(path: str) -> str | None:
    """The base filename an incremental snapshot chains to (None for a
    full snapshot), from the manifest."""
    return _read_payload(path).get("__base__")


# ---------------------------------------------------------------------------
# Off-thread serialization
# ---------------------------------------------------------------------------

class AsyncCheckpointer:
    """One writer thread behind a bounded queue.

    ``save()`` takes owned host copies on the caller's thread (the only
    cost the caller pays: the device→host copy and the flatten) and
    enqueues them; the writer hashes, packs, fsyncs and renames.  A full
    queue blocks the caller (at most ``max_pending`` snapshots in
    flight).  ``wait()`` drains the queue and re-raises the first writer
    error; a failed save never vanishes.

    ``chain=`` threads incremental state through the writer: the first
    save of a chain id is a full snapshot, each later one writes only
    changed leaves, chained to the previous file.  ``forget(chain)``
    drops a chain once its files are consumed.
    """

    def __init__(self, max_pending: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=max_pending)
        self._err: BaseException | None = None
        self._chains: dict = {}          # chain id -> (path, hashes)
        self._thread = threading.Thread(
            target=self._loop, name="ckpt-writer", daemon=True)
        self._thread.start()

    # -- caller side -------------------------------------------------------

    def save(self, path: str, tree, meta: dict | None = None,
             treedef: str | None = None, chain: str | None = None) -> None:
        self._raise_pending()
        flat = _flatten_with_paths(tree, treedef)
        self._q.put(("save", path, flat, dict(meta or {}), treedef,
                     chain))

    def wait(self) -> None:
        """Barrier: every enqueued save is durably on disk (or its
        error raised here)."""
        self._q.join()
        self._raise_pending()

    def forget(self, chain: str) -> None:
        self._chains.pop(chain, None)

    def close(self) -> None:
        """Drain the queue (re-raising a writer error) and stop the
        thread."""
        try:
            self.wait()
        finally:
            self._q.put(("stop",))
            self._thread.join()

    def _raise_pending(self) -> None:
        if self._err is not None:
            err, self._err = self._err, None
            raise RuntimeError("async checkpoint save failed") from err

    # -- writer side -------------------------------------------------------

    def _loop(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item[0] == "stop":
                    return
                _, path, flat, meta, treedef, chain = item
                base = base_hashes = None
                if chain is not None and chain in self._chains:
                    base, base_hashes = self._chains[chain]
                hashes = _save_flat(path, flat, meta, treedef, base,
                                    base_hashes)
                if chain is not None:
                    self._chains[chain] = (path, hashes)
            except BaseException as e:  # noqa: BLE001 — surfaced in wait()
                if self._err is None:
                    self._err = e
            finally:
                self._q.task_done()


_DEFAULT_WRITER: AsyncCheckpointer | None = None
_DEFAULT_WRITER_LOCK = threading.Lock()


def save_pytree_async(path: str, tree, meta: dict | None = None,
                      treedef: str | None = None,
                      chain: str | None = None) -> AsyncCheckpointer:
    """Module-level async save through a shared default writer; returns
    the writer so the caller can ``wait()`` on the barrier."""
    global _DEFAULT_WRITER
    with _DEFAULT_WRITER_LOCK:
        if _DEFAULT_WRITER is None:
            _DEFAULT_WRITER = AsyncCheckpointer()
    _DEFAULT_WRITER.save(path, tree, meta=meta, treedef=treedef,
                         chain=chain)
    return _DEFAULT_WRITER


# ---------------------------------------------------------------------------
# Step-numbered checkpoints with retention
# ---------------------------------------------------------------------------

class CheckpointManager:
    """Step-numbered checkpoints with retention (and optional
    incremental chains).

    ``incremental=True`` chains each save to the previous step's
    snapshot, writing a fresh full snapshot every ``full_every`` saves
    so chains stay shallow.  Retention keeps the newest ``keep`` steps
    plus any older snapshot a kept file's chain restores through.
    """

    def __init__(self, directory: str, keep: int = 3,
                 incremental: bool = False, full_every: int = 8,
                 treedef: str | None = None):
        if keep < 1:
            raise ValueError(
                f"keep={keep} must be >= 1 — keep=0 would silently "
                f"disable retention (steps()[:-0] is the empty slice), "
                f"not keep nothing")
        if full_every < 1:
            raise ValueError(f"full_every={full_every} must be >= 1")
        self.dir = directory
        self.keep = keep
        self.incremental = incremental
        self.full_every = full_every
        self.treedef = treedef
        self._prev: tuple | None = None      # (path, hashes)
        self._since_full = 0
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step:08d}.msgpack")

    def steps(self):
        out = []
        for f in os.listdir(self.dir):
            if f.startswith("ckpt_") and f.endswith(".msgpack"):
                try:
                    out.append(int(f[5:-8]))
                except ValueError:
                    warnings.warn(
                        f"skipping unparsable checkpoint filename "
                        f"{f!r} in {self.dir!r}", stacklevel=2)
        return sorted(out)

    def _protected(self, kept_steps) -> set:
        """Filenames any kept snapshot's chain restores through."""
        protect: set = set()
        for step in kept_steps:
            path = self._path(step)
            while True:
                try:
                    base = snapshot_base(path)
                except (OSError, ValueError):
                    break
                if base is None or base in protect:
                    break
                protect.add(base)
                path = os.path.join(self.dir, base)
        return protect

    def save(self, step: int, tree, meta=None) -> str:
        path = self._path(step)
        base = base_hashes = None
        if self.incremental and self._prev is not None \
                and self._since_full < self.full_every:
            base, base_hashes = self._prev
        hashes = save_pytree(path, tree, dict(meta or {}, step=step),
                             treedef=self.treedef, base=base,
                             base_hashes=base_hashes)
        self._since_full = 0 if base is None else self._since_full + 1
        self._prev = (path, hashes)
        steps = self.steps()
        kept = steps[-self.keep:]
        protected = self._protected(kept)
        for old in steps[:-self.keep]:
            if os.path.basename(self._path(old)) not in protected:
                os.unlink(self._path(old))
        return path

    def restore_latest(self, like=None, device=None):
        """(tree, meta) of the newest step, or (None, None): restored
        into ``like`` when given, else template-free on ``device``."""
        steps = self.steps()
        if not steps:
            return None, None
        if like is None:
            return restore_pytree(self._path(steps[-1]), device=device)
        return load_pytree(self._path(steps[-1]), like=like)
