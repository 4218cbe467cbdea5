"""Disk-fault injection for SDFS chaos tests.

Copied from ``dmlc_tpu/cluster/faults.py`` (the whole module).

``FaultyIo`` wraps the durable-write primitives (``cluster/diskio.DiskIo``)
with seeded, scriptable faults at the syscall seams:

- ``bitflip``    — one random bit of a written buffer lands flipped
- ``truncate``   — a write persists only a prefix (torn write / lost tail)
- ``torn_rename``— crash between temp-write and rename: the temp file is
                   fully on disk but the rename never happens
- ``enospc``     — the write raises ``OSError(ENOSPC)``

Faults are armed explicitly (``arm("write", "bitflip")``, FIFO per op) or
probabilistically (``bitflip_rate=...`` etc.) under a seeded RNG, so every
chaos run replays deterministically. Plug one into ``MemberStore(io=...)``
and drive the same ``SimRpcNetwork``/``SimNetwork`` harness the
crash/partition chaos tests already use — disk faults compose with process
faults.

``flip_bit``/``corrupt_stored`` model bit-rot AT REST (silent media decay
after a clean write), the case the anti-entropy scrub exists for.
"""

from __future__ import annotations

import errno
import random
from collections import deque
from pathlib import Path
from typing import BinaryIO, Callable

from dmlc_tpu_torch.cluster.diskio import DiskIo

#: fault kinds by the primitive they apply to
WRITE_FAULTS = ("bitflip", "truncate", "enospc")
RENAME_FAULTS = ("torn_rename",)


class FaultyIo(DiskIo):
    """Seeded fault-injecting DiskIo. Construct with per-op probabilities
    and/or arm one-shot faults; un-armed operations pass through to the
    real filesystem."""

    def __init__(
        self,
        seed: int = 0,
        bitflip_rate: float = 0.0,
        truncate_rate: float = 0.0,
        enospc_rate: float = 0.0,
        torn_rename_rate: float = 0.0,
    ):
        self.rng = random.Random(seed)
        self.rates = {
            "bitflip": bitflip_rate,
            "truncate": truncate_rate,
            "enospc": enospc_rate,
            "torn_rename": torn_rename_rate,
        }
        self._armed: dict[str, deque[str]] = {"write": deque(), "rename": deque()}
        self.injected: list[str] = []  # fault log, for test assertions

    def arm(self, op: str, kind: str) -> "FaultyIo":
        """Queue ``kind`` to fire on the next ``op`` ("write"/"rename")."""
        allowed = WRITE_FAULTS if op == "write" else RENAME_FAULTS
        if kind not in allowed:
            raise ValueError(f"{kind!r} is not a {op} fault {allowed}")
        self._armed[op].append(kind)
        return self

    def _draw(self, op: str, kinds: tuple[str, ...]) -> str | None:
        if self._armed[op]:
            return self._armed[op].popleft()
        for kind in kinds:
            if self.rates[kind] > 0 and self.rng.random() < self.rates[kind]:
                return kind
        return None

    # ---- faulted primitives -------------------------------------------

    def write(self, f: BinaryIO, data: bytes) -> None:
        kind = self._draw("write", WRITE_FAULTS)
        if kind == "enospc":
            self.injected.append("enospc")
            raise OSError(errno.ENOSPC, "no space left on device (injected)")
        if kind == "bitflip" and data:
            buf = bytearray(data)
            bit = self.rng.randrange(len(buf) * 8)
            buf[bit // 8] ^= 1 << (bit % 8)
            data = bytes(buf)
            self.injected.append("bitflip")
        elif kind == "truncate" and data:
            data = data[: self.rng.randrange(len(data))]
            self.injected.append("truncate")
        super().write(f, data)

    def rename(self, src: str | Path, dst: str | Path) -> None:
        kind = self._draw("rename", RENAME_FAULTS)
        if kind == "torn_rename":
            # Crash between temp-write and rename: the temp stays on disk,
            # the destination never appears, and the caller sees the error
            # a real crash would become on restart.
            self.injected.append("torn_rename")
            raise OSError(errno.EIO, "crash before rename (injected)")
        super().rename(src, dst)


class SimCrash(Exception):
    """A simulated process death at a durability seam (dmlc-mc's crash
    injection, docs/MODELCHECK.md). Raised from a ``CrashPointIo`` primitive;
    it unwinds through the store code exactly like a dying process would
    leave the disk — whatever was durably committed before the seam stays,
    everything after never happens — and surfaces to a remote caller as the
    generic RpcError a dead TCP peer becomes (SimRpcNetwork._call_from)."""


class CrashPointIo(DiskIo):
    """DiskIo whose primitives consult a hook before executing.

    The hook is called with the primitive's name (``"open_write"``,
    ``"write"``, ``"fsync"``, ``"rename"``, ``"fsync_dir"``); returning True
    raises ``SimCrash`` at that exact seam. ``ops`` records every primitive
    reached, so a model checker can first count a scenario's seams and then
    enumerate crash-at-op-k schedules deterministically. Read primitives are
    never crash points: a crash between reads is indistinguishable from one
    between events, so only the durability seams multiply schedules."""

    def __init__(self, hook: Callable[[str], bool] | None = None):
        self.hook = hook
        self.ops: list[str] = []
        self.crashed = False

    def _seam(self, op: str) -> None:
        self.ops.append(op)
        if self.hook is not None and self.hook(op):
            self.crashed = True
            raise SimCrash(f"process died at {op} (op #{len(self.ops)})")

    def open_write(self, path: str | Path) -> BinaryIO:
        self._seam("open_write")
        return super().open_write(path)

    def write(self, f: BinaryIO, data: bytes) -> None:
        self._seam("write")
        super().write(f, data)

    def fsync(self, f: BinaryIO) -> None:
        self._seam("fsync")
        super().fsync(f)

    def rename(self, src: str | Path, dst: str | Path) -> None:
        self._seam("rename")
        super().rename(src, dst)

    def fsync_dir(self, path: str | Path) -> None:
        self._seam("fsync_dir")
        super().fsync_dir(path)


# ---------------------------------------------------------------------------
# Bit-rot at rest (post-write media decay) — what scrub exists to catch.
# ---------------------------------------------------------------------------


def flip_bit(path: str | Path, bit: int | None = None, seed: int = 0) -> int:
    """Flip one bit of an existing file in place. Returns the bit index.
    Deliberately bypasses the atomic-write helper: bit-rot does not fsync."""
    path = Path(path)
    buf = bytearray(path.read_bytes())
    if not buf:
        raise ValueError(f"{path} is empty; nothing to rot")
    if bit is None:
        bit = random.Random(seed).randrange(len(buf) * 8)
    buf[bit // 8] ^= 1 << (bit % 8)
    path.write_bytes(bytes(buf))  # dmlc-lint: disable=F1 -- simulating non-durable media decay is the point
    return bit


def corrupt_stored(store, name: str, version: int, seed: int = 0) -> int:
    """Flip one bit in a MemberStore's committed replica of (name, version)
    without touching its sidecar — exactly what silent disk corruption looks
    like to the verification layer."""
    return flip_bit(store.blob_path(name, version), seed=seed)
