"""Checkpointing of the port's state dicts: atomic, checksummed,
replicated, optionally asynchronous.

  - atomic: write to <dir>/tmp-<step>, fsync, rename to <dir>/step-<step>,
    fsync the directory
  - integrity: per-leaf sha256 recorded in metadata.json and verified on
    restore (an SDC in the checkpoint itself must not restore silently)
  - replication: `save_replicated` writes several directories (in orbit:
    distinct satellites); `restore_latest` takes the newest checkpoint
    that passes verification across all of them
  - async: background threads serialise off the training path, after one
    device-to-host copy made on the caller's thread
  - retention: keep the most recent `keep` checkpoints per directory

The on-disk format is the reference's: one `arrays.npz` whose keys are
the leaf paths with "/" written "__", and metadata.json.  Restored leaves
land on the template's device and dtype.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import zipfile

import numpy as np
import torch

from .tree import tree_map, tree_paths, tree_unflatten


def _fsync_dir(path: str):
    """fsync a directory so its entries are durable (the rename in `save`
    is only atomic-and-durable once the parent directory is synced)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _full(t):
    """A DTensor's full value (gathered); a plain tensor as it is."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def host_copy(state):
    """One copy of every leaf in host memory, made now (a DTensor's full
    value, gathered)."""
    return tree_map(lambda t: _full(t).detach().to("cpu", copy=True), state)


def save(state, directory: str, step: int, keep: int = 3) -> str:
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"tmp-{step}")
    final = os.path.join(directory, f"step-{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    meta = {"step": step, "checksums": {}}
    arrays = {}
    for key, leaf in tree_paths(state).items():
        arr = leaf.detach().cpu().numpy() if torch.is_tensor(leaf) \
            else np.asarray(leaf)
        safe = key.replace("/", "__")
        arrays[safe] = arr
        meta["checksums"][safe] = hashlib.sha256(
            np.ascontiguousarray(arr).tobytes()).hexdigest()
    with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    with open(os.path.join(tmp, "metadata.json"), "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(tmp)
    if os.path.exists(final):
        try:
            shutil.rmtree(final)
        except FileNotFoundError:
            pass   # a concurrent _prune got there first
    os.rename(tmp, final)
    # durability point: a crash before this line may resurface
    # tmp-<step>, never a torn step-<step>
    _fsync_dir(directory)
    _prune(directory, keep)
    return final


def save_replicated(state, directories, step: int, keep: int = 3):
    return [save(state, d, step, keep) for d in directories]


def save_async(state, directory: str, step: int, keep: int = 3):
    """Serialise off the training path.  Returns the Thread (join() to
    wait)."""
    return save_replicated_async(state, [directory], step, keep)[0]


def save_replicated_async(state, directories, step: int, keep: int = 3,
                          copy: bool = True):
    """One serialiser thread per replica directory, sharing a single
    device-to-host copy.  Returns the Threads (join() to wait).
    copy=False: `state` is already a host copy that nobody modifies."""
    if copy:
        state = host_copy(state)
    threads = []
    for d in directories:
        t = threading.Thread(target=save, args=(state, d, step, keep))
        t.start()
        threads.append(t)
    return threads


def _prune(directory: str, keep: int):
    # async savers race each other here: an entry listed by this thread
    # may already be gone, so every removal tolerates it vanishing
    try:
        steps = sorted(d for d in os.listdir(directory)
                       if d.startswith("step-"))
    except FileNotFoundError:
        return
    for d in steps[:-keep]:
        try:
            shutil.rmtree(os.path.join(directory, d))
        except FileNotFoundError:
            pass


def _verify_and_load(path: str):
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        out = {}
        for key in data.files:
            try:
                arr = data[key]
            except zipfile.BadZipFile as e:  # the archive's own CRC
                raise IOError(f"corrupt archive in {path}:{key}: {e}")
            digest = hashlib.sha256(
                np.ascontiguousarray(arr).tobytes()).hexdigest()
            if digest != meta["checksums"][key]:
                raise IOError(f"checksum mismatch in {path}:{key}")
            out[key] = arr
    return meta["step"], out


def restore_into(template, directory: str, step: int | None = None):
    """Restore into the structure, devices and dtypes of `template` (a
    tree of tensors; a DTensor leaf gets its own slice, placed as the
    template's).  Returns (step, state)."""
    steps = sorted(d for d in os.listdir(directory) if d.startswith("step-"))
    if step is not None:
        name = f"step-{step:08d}"
        if name not in steps:
            raise FileNotFoundError(name)
    else:
        name = steps[-1]
    got_step, arrays = _verify_and_load(os.path.join(directory, name))
    leaves = []
    for key, leaf in tree_paths(template).items():
        arr = arrays[key.replace("/", "__")]
        if arr.shape != tuple(leaf.shape):
            raise ValueError(f"{key}: shape {arr.shape} != "
                             f"{tuple(leaf.shape)}")
        full = torch.from_numpy(arr).to(device=leaf.device, dtype=leaf.dtype)
        leaves.append(_place_as(full, leaf))
    return got_step, tree_unflatten(template, leaves)


def _place_as(full, leaf):
    from torch.distributed.tensor import DTensor
    if not isinstance(leaf, DTensor):
        return full
    from repro_torch.distributed.sharding import slice_as
    return slice_as(full, leaf.device_mesh, leaf.placements)


def restore_latest(template, directories):
    """Newest verifiable checkpoint across replica directories."""
    candidates = []
    for d in directories:
        if not os.path.isdir(d):
            continue
        for name in os.listdir(d):
            if name.startswith("step-"):
                candidates.append((int(name[5:]), d))
    for step, d in sorted(candidates, reverse=True):
        try:
            return restore_into(template, d, step)
        except (IOError, OSError, KeyError, ValueError):
            continue   # corrupt replica: fall through to older/other copies
    raise FileNotFoundError("no verifiable checkpoint found")
