"""Crash-durable disk I/O: the ONE place cluster code persists bytes.

Copied from ``dmlc_tpu/cluster/diskio.py`` (the whole module).

Every store write in ``cluster/`` goes temp-file -> fsync -> atomic rename
(-> directory fsync), so a crash at any instant leaves either the old state
or the new state — never a torn half-write that a later read (or a replica
pull) could observe. Rule F1 (tools/lint/rules/persistence.py) forbids bare
``write_bytes``/``open(..., "w")`` persistence in ``cluster/`` outside this
module, so the invariant cannot silently erode.

All helpers route their primitive operations through a ``DiskIo`` object so
the fault-injection harness (``cluster/faults.py``) can script bit flips,
truncations, torn renames, and ENOSPC at the exact syscall seams the
durability story depends on — the real code path is exercised, not a mock.

Content digests are computed WHILE the bytes stream through (sha256), so
integrity metadata costs no extra read pass at any blob size.
"""

from __future__ import annotations

import hashlib
import os
import uuid
from pathlib import Path
from typing import BinaryIO

#: Streaming-copy granularity: bounded memory at any blob size.
COPY_CHUNK = 1024 * 1024


def sha256_hex(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def hash_file(path: str | Path, io: "DiskIo | None" = None) -> str:
    """Streaming sha256 of a file on disk — O(chunk) memory."""
    io = io or DEFAULT_IO
    h = hashlib.sha256()
    with io.open_read(path) as f:
        while chunk := f.read(COPY_CHUNK):
            h.update(chunk)
    return h.hexdigest()


class DiskIo:
    """Primitive filesystem operations behind the atomic helpers.

    Subclass (``faults.FaultyIo``) to inject disk faults; production code
    uses the module-level ``DEFAULT_IO`` instance.
    """

    def open_write(self, path: str | Path) -> BinaryIO:
        return open(path, "wb")  # the atomic-write helper's raw primitive

    def open_read(self, path: str | Path) -> BinaryIO:
        return open(path, "rb")

    def write(self, f: BinaryIO, data: bytes) -> None:
        f.write(data)

    def fsync(self, f: BinaryIO) -> None:
        f.flush()
        os.fsync(f.fileno())

    def rename(self, src: str | Path, dst: str | Path) -> None:
        os.replace(src, dst)

    def fsync_dir(self, path: str | Path) -> None:
        # Directory fsync commits the rename itself; some filesystems
        # (and containers) refuse O_RDONLY dir fds — best-effort there.
        try:
            fd = os.open(path, os.O_RDONLY)
        except OSError:
            return
        try:
            os.fsync(fd)
        except OSError:
            pass
        finally:
            os.close(fd)


DEFAULT_IO = DiskIo()


def _tmp_for(path: Path) -> Path:
    return path.with_name(f".{path.name}.{uuid.uuid4().hex[:8]}.tmp")


def atomic_write(path: str | Path, data: bytes, io: DiskIo | None = None) -> str:
    """Durably write ``data`` at ``path`` (temp -> fsync -> rename -> dir
    fsync). Returns the sha256 hex digest of the INTENDED bytes — if the
    disk corrupts them on the way down, the stored digest won't match and
    scrub/read verification catches it."""
    io = io or DEFAULT_IO
    path = Path(path)
    tmp = _tmp_for(path)
    try:
        with io.open_write(tmp) as f:
            io.write(f, data)
            io.fsync(f)
        io.rename(tmp, path)
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise
    io.fsync_dir(path.parent)
    return sha256_hex(data)


def atomic_copy(src: str | Path, dst: str | Path, io: DiskIo | None = None) -> str:
    """Durable streaming copy (O(chunk) memory): temp -> fsync -> rename.
    Returns the sha256 hex digest of the bytes read from ``src``."""
    io = io or DEFAULT_IO
    dst = Path(dst)
    tmp = _tmp_for(dst)
    h = hashlib.sha256()
    try:
        with io.open_read(src) as fin, io.open_write(tmp) as fout:
            while chunk := fin.read(COPY_CHUNK):
                h.update(chunk)
                io.write(fout, chunk)
            io.fsync(fout)
        io.rename(tmp, dst)
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise
    io.fsync_dir(dst.parent)
    return h.hexdigest()


def atomic_install(tmp: str | Path, dst: str | Path, io: DiskIo | None = None) -> None:
    """Durably install an already-written scratch file: fsync its bytes,
    rename over ``dst``, fsync the directory. The scratch file must have
    been fully written (any writer); this pins it to the platter before the
    rename makes it visible."""
    io = io or DEFAULT_IO
    tmp, dst = Path(tmp), Path(dst)
    with io.open_read(tmp) as f:
        # Re-open read-only is enough for fsync: it flushes the inode's
        # dirty pages regardless of which fd wrote them.
        io.fsync(f)
    io.rename(tmp, dst)
    io.fsync_dir(dst.parent)
