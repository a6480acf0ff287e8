"""Chunk-level checkpoint/resume for long pipeline runs.

The port's copy of ``mgl_tpu/pipelines/checkpoint.py`` (the standard
library and NumPy only), unchanged but for its imports.

The reference is stateless request/response (SURVEY.md §5: no
checkpoint/resume exists or is needed in-process).  A pod-scale align+sort
over billions of reads is not: losing a multi-hour run to one preemption
is unacceptable.  This adds the minimal production story:

* work is cut into chunks; each completed chunk's result is written
  atomically (tmp + rename) as an .npz next to a JSON manifest;
* a restarted run loads the manifest, skips completed chunks, and
  recomputes only the remainder;
* results are order-independent on disk and reassembled in chunk order.

Pure host-side bookkeeping — device state is never checkpointed (chunks
are the replay unit, mirroring the reference's request/response grain).
Composes with parallel/elastic.py: hand ``pending_chunks`` to
``run_elastic`` and commit each result through ``save_chunk``.
"""

from __future__ import annotations

import json
import os
import pathlib
import tempfile
from typing import Any, Callable

import numpy as np

MANIFEST = "manifest.json"


def save_chunk_atomic(directory: str | os.PathLike, chunk: int,
                      arrays: dict[str, np.ndarray]) -> None:
    """Atomically write one chunk .npz (tmp + rename) WITHOUT touching the
    manifest — safe for concurrent writers (scale-out workers racing on a
    re-dispatched chunk: last rename wins, both files are complete)."""
    directory = pathlib.Path(directory)
    final = directory / f"chunk_{chunk:06d}.npz"
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, final)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


class CheckpointedRun:
    """Disk-backed chunk ledger for one logical run."""

    def __init__(self, directory: str | os.PathLike, n_chunks: int,
                 tag: str = ""):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.n_chunks = n_chunks
        self.tag = tag
        self._manifest_path = self.dir / MANIFEST
        self._done: set[int] = set()
        if self._manifest_path.exists():
            m = json.loads(self._manifest_path.read_text())
            if m.get("n_chunks") != n_chunks or m.get("tag") != tag:
                raise ValueError(
                    f"checkpoint dir {self.dir} belongs to a different run "
                    f"(tag={m.get('tag')!r}, n_chunks={m.get('n_chunks')})")
            self._done = {int(c) for c in m.get("done", [])
                          if (self.dir / f"chunk_{int(c):06d}.npz").exists()}
        self._write_manifest()

    def _write_manifest(self) -> None:
        tmp = self._manifest_path.with_suffix(".tmp")
        tmp.write_text(json.dumps({
            "tag": self.tag,
            "n_chunks": self.n_chunks,
            "done": sorted(self._done),
        }))
        tmp.replace(self._manifest_path)

    def pending_chunks(self) -> list[int]:
        return [c for c in range(self.n_chunks) if c not in self._done]

    def is_done(self, chunk: int) -> bool:
        return chunk in self._done

    def save_chunk(self, chunk: int, arrays: dict[str, np.ndarray]) -> None:
        """Atomically persist one chunk's result arrays."""
        save_chunk_atomic(self.dir, chunk, arrays)
        self._done.add(chunk)
        self._write_manifest()

    def rescan(self) -> set[int]:
        """Adopt chunk files written by other processes (scale-out workers
        use save_chunk_atomic and report completion through the
        coordinator; the driver rescans to reconcile the ledger — also the
        crash-resume path when the driver died before a manifest write)."""
        for p in self.dir.glob("chunk_*.npz"):
            c = int(p.stem.split("_")[1])
            if c < self.n_chunks:
                self._done.add(c)
        self._write_manifest()
        return set(self._done)

    def load_chunk(self, chunk: int) -> dict[str, np.ndarray]:
        with np.load(self.dir / f"chunk_{chunk:06d}.npz") as z:
            return {k: z[k] for k in z.files}

    def complete(self) -> bool:
        return len(self._done) == self.n_chunks

    def assemble(self, key: str) -> np.ndarray:
        """Concatenate one result array across all chunks, in chunk order."""
        if not self.complete():
            raise RuntimeError(
                f"run incomplete: {self.n_chunks - len(self._done)} chunks pending")
        return np.concatenate(
            [self.load_chunk(c)[key] for c in range(self.n_chunks)])


def run_checkpointed(
    chunks: list[Any],
    work_fn: Callable[[Any], dict[str, np.ndarray]],
    directory: str | os.PathLike,
    tag: str = "",
) -> CheckpointedRun:
    """Drive ``work_fn`` over chunks with resume-on-restart semantics."""
    run = CheckpointedRun(directory, len(chunks), tag=tag)
    for c in run.pending_chunks():
        run.save_chunk(c, work_fn(chunks[c]))
    return run
