"""SDFS: versioned, replicated distributed file store.

Copied from ``dmlc_tpu/cluster/sdfs.py`` (the whole module): the verbs,
their payloads and ``DEFAULT_CHUNK_BYTES`` are the JAX package's, and so
are the store directory's layout (blob names, sidecars, the ``.fence``
file beside the directory, the boot recovery and scratch wipe), so a
member or leader of either package serves the other over TCP and a store
directory passes from one package to the other across a restart.

Capability parity with the reference's L3 (src/services.rs):

- leader-only directory ``filename -> member -> {versions}`` (services.rs:85)
- versioned ``put``/``get``/``get_versions``/``delete``/``ls`` with a
  monotonic per-file version counter (services.rs:95-144,276-281)
- replica placement: hash(filename) + linear probing over active non-replica
  members (services.rs:346-364), replication factor 4 (services.rs:328,359)
- healing loop restoring the replication factor after failures
  (services.rs:186-198,310-405)
- member-side local store under ``storage/`` as ``v{N}.{sanitized-name}``
  (services.rs:34,550-552), recreated at boot (services.rs:504-507)
- ``merge_versions``: newest-first concatenation with ``== Version N ==``
  delimiters (services.rs:555-569)

Redesigned, not translated: bulk bytes move member-to-member over the RPC
fabric as leader-orchestrated third-party copies (the reference's scp shape,
services.rs:264-272, without the fleet-ssh assumption), and every piece is
sans-IO enough to run on the deterministic ``SimRpcNetwork``. On a TPU fleet
this layer stores model weights / executables / dataset shards on host SSDs;
the staging pipeline lifts them host->HBM, and tensors never ride this path.
"""

from __future__ import annotations

import hashlib
import json
import logging
import shutil
import threading
import uuid
from dataclasses import dataclass, field
from pathlib import Path

from dmlc_tpu_torch.cluster import deadline as deadline_lib
from dmlc_tpu_torch.cluster import diskio
from dmlc_tpu_torch.cluster.diskio import DiskIo, atomic_copy, atomic_install, atomic_write
from dmlc_tpu_torch.cluster.rpc import Rpc, RpcError, RpcUnreachable
from dmlc_tpu_torch.utils.tracing import traced_methods, tracer

log = logging.getLogger(__name__)


class IntegrityError(RpcError):
    """Stored or transferred bytes do not match their content digest.

    Message always starts with ``integrity:`` so the verdict survives the
    RPC fabric's error-to-string flattening — ``is_integrity_error`` works
    on both the local exception and its remote-wrapped form."""

    def __init__(self, msg: str):
        super().__init__(msg if msg.startswith("integrity:") else f"integrity: {msg}")


def is_integrity_error(err: Exception | str) -> bool:
    return "integrity:" in str(err)


def sanitize(name: str) -> str:
    """Filesystem-safe form of an SDFS name (the reference replaces '/',
    services.rs:550-552)."""
    return name.replace("/", "_").replace("\\", "_")


def storage_filename(name: str, version: int) -> str:
    """On-disk name: readable sanitized form + a short digest of the RAW
    name, so distinct SDFS names that sanitize identically ('a/b' vs 'a_b')
    never collide on a shared replica."""
    digest = hashlib.sha256(name.encode()).hexdigest()[:10]
    return f"v{version}.{digest}.{sanitize(name)}"


def placement_order(name: str, candidates: list[str]) -> list[str]:
    """Deterministic replica preference: start at hash(name) in the sorted
    candidate ring, then linear probe (services.rs:346-364)."""
    if not candidates:
        return []
    ordered = sorted(candidates)
    start = int.from_bytes(hashlib.sha256(name.encode()).digest()[:8], "big") % len(ordered)
    return ordered[start:] + ordered[:start]


def sidecar_filename(name: str, version: int) -> str:
    """Per-blob metadata sidecar. Leading dot: committed blob names always
    start ``v{N}.``, so a sidecar can never collide with a blob whose SDFS
    name happens to end in ``.meta``."""
    return f".{storage_filename(name, version)}.meta"


class MemberStore:
    """One node's local file store: real files on disk + a version map.

    Staged puts live on DISK (``.staged/``), not in a RAM dict, and reads
    can address byte ranges — so a put/fetch of a multi-GB checkpoint holds
    O(chunk) memory at every hop (the reference streamed via scp from disk,
    services.rs:244-262; round 2's in-RAM staging regressed that property).

    Crash-durable and self-verifying (docs/SDFS.md): every committed blob
    went temp -> fsync -> rename and carries a sidecar (raw name, version,
    sha256, size) written AFTER the blob — the sidecar is the commit point.
    Construction RECOVERS the version map from sidecars instead of wiping
    (blobs without a sidecar, truncated blobs, and stray temps from a crash
    are discarded), so a restarted member still holds its replicas. Reads
    verify the digest; a mismatch quarantines the copy (``.quarantine/``)
    and raises ``IntegrityError`` — a rotted blob is never served and never
    heals onto another member. ``scrub_once`` re-verifies at rest.
    """

    def __init__(self, storage_dir: str | Path, io: DiskIo | None = None, flight=None):
        self.dir = Path(storage_dir)
        self.io = io or diskio.DEFAULT_IO
        # Flight recorder (cluster/flight.py, optional): quarantines are
        # exactly the state transitions postmortems need timestamps for.
        self.flight = flight
        self.dir.mkdir(parents=True, exist_ok=True)
        # Scratch spaces hold only in-flight state a crash abandons; they
        # ARE wiped at boot. Quarantined copies are corrupt by definition —
        # no reason to carry them across an incarnation either.
        self._staged_dir = self._fresh_dir(".staged")
        self._incoming_dir = self._fresh_dir(".incoming")
        self._quarantine_dir = self._fresh_dir(".quarantine")
        self.versions: dict[str, set[int]] = {}
        self.digests: dict[tuple[str, int], str] = {}
        self.staged: dict[str, tuple[Path, str]] = {}  # key -> (path, digest)
        self._lock = threading.RLock()
        self._scrub_cursor = 0
        self._recover()

    def _fresh_dir(self, name: str) -> Path:
        d = self.dir / name
        shutil.rmtree(d, ignore_errors=True)
        # exist_ok: the rmtree is best-effort — a wipe that silently failed
        # must not crash boot; stale files inside are unreferenced.
        d.mkdir(exist_ok=True)
        return d

    def _recover(self) -> None:
        """Rebuild the version map from on-disk sidecars (restart recovery);
        discard anything a crash left uncommitted."""
        keep: set[str] = set()
        for meta in sorted(self.dir.glob(".*.meta")):
            try:
                raw = json.loads(meta.read_text())
                name, version = str(raw["name"]), int(raw["version"])
                digest, size = str(raw["digest"]), int(raw["size"])
            except (OSError, ValueError, KeyError, json.JSONDecodeError):
                meta.unlink(missing_ok=True)  # torn/garbled sidecar
                continue
            blob = self.dir / storage_filename(name, version)
            if meta.name != sidecar_filename(name, version):
                meta.unlink(missing_ok=True)  # renamed/misplaced sidecar
                continue
            if not blob.is_file() or blob.stat().st_size != size:
                # Blob missing or truncated relative to its committed
                # metadata: the pair is unrecoverable here; healing will
                # re-place from an intact replica.
                meta.unlink(missing_ok=True)
                blob.unlink(missing_ok=True)
                continue
            self.versions.setdefault(name, set()).add(version)
            self.digests[(name, version)] = digest
            keep.update((blob.name, meta.name))
        # Everything else in the top-level dir — blobs that never got their
        # sidecar (crash before the commit point), orphaned temps — goes.
        for f in self.dir.iterdir():
            if not f.is_dir() and f.name not in keep:
                f.unlink(missing_ok=True)

    def blob_path(self, name: str, version: int) -> Path:
        return self.dir / storage_filename(name, version)

    def _commit(self, name: str, version: int, digest: str, size: int) -> None:
        """Write the sidecar (the commit point) and index the blob. The blob
        file must already be durably in place."""
        meta = json.dumps(
            {"name": name, "version": version, "digest": digest, "size": size}
        ).encode()
        atomic_write(self.dir / sidecar_filename(name, version), meta, io=self.io)
        with self._lock:
            self.versions.setdefault(name, set()).add(version)
            self.digests[(name, version)] = digest

    # ---- staging (put origin) ------------------------------------------

    def _staged_path(self, key: str) -> Path:
        return self._staged_dir / hashlib.sha256(key.encode()).hexdigest()[:32]

    def stage(self, key: str, data: bytes) -> str:
        """Hold bytes for an in-flight put until replicas pull them.
        Returns the content digest. Atomic: a crash mid-stage leaves no
        half-staged path a replica pull could read."""
        path = self._staged_path(key)
        digest = atomic_write(path, data, io=self.io)
        with self._lock:
            self.staged[key] = (path, digest)
        return digest

    def stage_file(self, key: str, src: str | Path) -> str:
        """Stage an existing file by streaming copy — the whole-blob bytes
        never enter this process's heap. Returns the content digest."""
        path = self._staged_path(key)
        digest = atomic_copy(src, path, io=self.io)
        with self._lock:
            self.staged[key] = (path, digest)
        return digest

    def unstage(self, key: str) -> None:
        with self._lock:
            entry = self.staged.pop(key, None)
        if entry is not None:
            entry[0].unlink(missing_ok=True)

    def _staged_entry(self, key: str) -> tuple[Path, str]:
        with self._lock:
            entry = self.staged.get(key)
        if entry is None:
            raise KeyError(f"nothing staged for {key!r}")
        return entry

    def staged_size(self, key: str) -> int:
        return self._staged_entry(key)[0].stat().st_size

    def staged_digest(self, key: str) -> str:
        return self._staged_entry(key)[1]

    def staged_range(self, key: str, offset: int, length: int) -> bytes:
        path = self._staged_entry(key)[0]
        with open(path, "rb") as f:
            f.seek(offset)
            return f.read(length)

    # ---- stored versions -----------------------------------------------

    def receive(self, name: str, version: int, data: bytes, digest: str | None = None) -> None:
        """Store one whole-blob frame. With ``digest`` given, the bytes are
        verified BEFORE anything touches disk — a corrupt frame never
        becomes a committed replica."""
        actual = diskio.sha256_hex(data)
        if digest is not None and actual != digest:
            raise IntegrityError(
                f"received {name} v{version}: digest {actual[:12]} != expected {digest[:12]}"
            )
        atomic_write(self.blob_path(name, version), data, io=self.io)
        self._commit(name, version, actual, len(data))

    def incoming_path(self) -> Path:
        """A scratch path for chunk-by-chunk assembly; pass the finished
        file to ``adopt_file``. Caller owns cleanup on failure."""
        return self._incoming_dir / uuid.uuid4().hex

    def adopt_file(self, name: str, version: int, path: Path, digest: str | None = None) -> None:
        """Durably install an assembled file as (name, version): verify the
        assembled bytes against ``digest`` (when known), fsync, rename —
        a crash mid-transfer never leaves a half blob visible, and a corrupt
        assembly is rejected before it can be served or re-replicated."""
        path = Path(path)
        actual = diskio.hash_file(path, io=self.io)
        if digest is not None and actual != digest:
            raise IntegrityError(
                f"assembled {name} v{version}: digest {actual[:12]} != expected {digest[:12]}"
            )
        size = path.stat().st_size
        with self._lock:
            atomic_install(path, self.blob_path(name, version), io=self.io)
        self._commit(name, version, actual, size)

    def _checked_path(self, name: str, version: int) -> Path:
        with self._lock:
            if version not in self.versions.get(name, set()):
                raise KeyError(f"{name} v{version} not stored here")
            return self.blob_path(name, version)

    def read(self, name: str, version: int) -> bytes:
        """Whole-blob read, VERIFIED: a digest mismatch quarantines the
        local copy and raises IntegrityError instead of serving rot."""
        path = self._checked_path(name, version)
        data = path.read_bytes()
        expected = self.digests.get((name, version))
        if expected is not None and diskio.sha256_hex(data) != expected:
            self.quarantine(name, version)
            raise IntegrityError(f"stored {name} v{version} failed digest verification")
        return data

    def size(self, name: str, version: int) -> int:
        return self._checked_path(name, version).stat().st_size

    def digest_of(self, name: str, version: int) -> str | None:
        with self._lock:
            return self.digests.get((name, version))

    def read_range(self, name: str, version: int, offset: int, length: int) -> bytes:
        # Range reads are NOT verified per call (that would re-hash the
        # whole blob per chunk); the puller verifies the assembled stream
        # end-to-end against the leader's digest instead.
        path = self._checked_path(name, version)
        with open(path, "rb") as f:
            f.seek(offset)
            return f.read(length)

    # ---- quarantine + scrub --------------------------------------------

    def quarantine(self, name: str, version: int) -> bool:
        """Remove (name, version) from the serving set and park its files
        under ``.quarantine/`` — never served, never a heal source."""
        with self._lock:
            if version not in self.versions.get(name, set()):
                return False
            self.versions[name].discard(version)
            if not self.versions[name]:
                del self.versions[name]
            self.digests.pop((name, version), None)
        tag = uuid.uuid4().hex[:8]
        for fname in (storage_filename(name, version), sidecar_filename(name, version)):
            src = self.dir / fname
            if src.exists():
                src.replace(self._quarantine_dir / f"{tag}.{fname.lstrip('.')}")
        log.warning("quarantined %s v%s (failed digest verification)", name, version)
        if self.flight is not None:
            self.flight.note("quarantine", name=name, version=int(version))
        return True

    def scrub_once(self, max_blobs: int | None = None) -> tuple[int, list[tuple[str, int]]]:
        """Anti-entropy pass: re-hash up to ``max_blobs`` stored blobs
        (round-robin cursor, so successive passes cover the whole store
        incrementally) and quarantine any whose bytes no longer match their
        committed digest. Returns (scanned, corrupt)."""
        with self._lock:
            entries = sorted(
                (n, v) for n, vs in self.versions.items() for v in vs
            )
        if not entries:
            return 0, []
        count = len(entries) if max_blobs is None else min(max_blobs, len(entries))
        start = self._scrub_cursor % len(entries)
        corrupt: list[tuple[str, int]] = []
        for i in range(count):
            name, version = entries[(start + i) % len(entries)]
            expected = self.digests.get((name, version))
            try:
                actual = diskio.hash_file(self.blob_path(name, version), io=self.io)
            except OSError:
                actual = None  # blob vanished underfoot: treat as corrupt
            if expected is not None and actual != expected:
                self.quarantine(name, version)
                corrupt.append((name, version))
        self._scrub_cursor = (start + count) % len(entries)
        return count, corrupt

    def delete(self, name: str) -> None:
        with self._lock:
            for v in self.versions.pop(name, set()):
                self.blob_path(name, v).unlink(missing_ok=True)
                (self.dir / sidecar_filename(name, v)).unlink(missing_ok=True)
                self.digests.pop((name, v), None)

    def listing(self) -> dict[str, list[int]]:
        with self._lock:
            return {n: sorted(vs) for n, vs in self.versions.items()}

    def inventory(self) -> dict[str, dict[str, str]]:
        """Wire-shaped inventory for restart re-announce / reconcile:
        ``{name: {str(version): digest}}``."""
        with self._lock:
            return {
                n: {str(v): self.digests.get((n, v), "") for v in sorted(vs)}
                for n, vs in self.versions.items()
            }


# Bytes per transfer frame. Blobs larger than this move as a sequence of
# range-read RPCs streamed straight to/from disk — no hop ever holds the
# whole blob in memory, and no frame approaches the fabric's MAX_FRAME.
DEFAULT_CHUNK_BYTES = 8 * 1024 * 1024


class SdfsMember:
    """Member-side RPC surface: receive/fetch/replicate-pull/delete/store.

    Bulk bytes move in bounded chunks (``chunk_bytes``): ``fetch_meta`` +
    ``fetch_chunk`` are range reads against the on-disk blob, and
    ``_replicate`` assembles pulled chunks into a scratch file adopted by
    rename — the scp streaming shape (services.rs:244-262) rebuilt on the
    RPC fabric, preserving its O(chunk) memory property.
    """

    def __init__(
        self,
        store: MemberStore,
        rpc: Rpc,
        chunk_bytes: int = DEFAULT_CHUNK_BYTES,
        transfer_timeout_s: float = 300.0,
        gate=None,
    ):
        self.store = store
        self.rpc = rpc
        self.chunk_bytes = chunk_bytes
        # Whole-transfer ceiling for replicate pulls; an inbound deadline on
        # the replicate RPC caps it further (deadlines are inherited).
        self.transfer_timeout_s = float(transfer_timeout_s)
        # Admission gate for the bulk byte-movers (fetch/chunk/replicate):
        # past max_inflight + max_queue concurrent transfers the request is
        # shed with a typed Overloaded instead of piling onto this node's
        # disk/NIC until everything misses its deadline. Control verbs
        # (meta, store, scrub, fence) are never gated — they are how the
        # fleet *observes* an overloaded member.
        self.gate = gate
        # Highest leadership epoch seen on any write (failover.epoch_key
        # order): writes carrying an OLDER term are rejected — a stale
        # claimant on the wrong side of a candidate partition cannot land
        # (or overwrite) blobs here. None until the first fenced write.
        # PERSISTED as a sibling of the store dir (which the boot wipe
        # recreates): a member that restarts after being fenced would
        # otherwise come back legacy-open and accept a stale claimant's
        # writes until the first newer-epoch write arrived (ADVICE r3).
        self._fence_path = store.dir.parent / (store.dir.name + ".fence")
        self._fence: tuple[int, str] | None = self._load_fence()
        self._fence_lock = threading.Lock()

    def _admit(self):
        from contextlib import nullcontext

        return nullcontext() if self.gate is None else self.gate.admit()

    def _load_fence(self) -> tuple[int, str] | None:
        try:
            raw = json.loads(self._fence_path.read_text())
            return int(raw[0]), str(raw[1])
        except Exception:
            return None

    def _save_fence(self) -> None:
        """Atomic durable write, called under ``_fence_lock``. Best-effort:
        a node that cannot persist still fences in memory for this
        incarnation."""
        try:
            atomic_write(self._fence_path, json.dumps(list(self._fence)).encode())
        except OSError:
            log.warning("could not persist epoch fence", exc_info=True)

    def _check_epoch(self, p: dict) -> None:
        from dmlc_tpu_torch.cluster.failover import epoch_key

        epoch = p.get("epoch")
        if epoch is None:
            return  # unfenced caller (standalone leader/tools): legacy-open
        key = epoch_key(epoch)
        with self._fence_lock:
            if self._fence is not None and key < self._fence:
                raise RpcError(
                    f"stale leadership epoch {list(key)} < fenced {list(self._fence)}"
                )
            new = max(self._fence or key, key)
            if new != self._fence:
                self._fence = new
                self._save_fence()

    def _fence_rpc(self, p: dict) -> dict:
        """Fence announcement/probe. Unlike data writes, a STALE term's
        announcement is not an error: the reply always carries this member's
        current fence, so a leader whose epoch counter reset (full-cluster
        restart; fences persist, SdfsLeader.epoch does not) can DISCOVER the
        newer fence and adopt past it instead of bouncing writes forever."""
        from dmlc_tpu_torch.cluster.failover import epoch_key

        epoch = p.get("epoch")
        with self._fence_lock:
            if epoch is not None:
                key = epoch_key(epoch)
                if self._fence is None or key > self._fence:
                    self._fence = key
                    self._save_fence()
            return {"epoch": list(self._fence) if self._fence else None}

    def methods(self) -> dict:
        return traced_methods({
            "sdfs.fence": self._fence_rpc,
            "sdfs.receive": self._receive,
            "sdfs.fetch": self._fetch,
            "sdfs.fetch_meta": self._fetch_meta,
            "sdfs.fetch_chunk": self._fetch_chunk,
            "sdfs.fetch_stage_meta": self._fetch_stage_meta,
            "sdfs.fetch_stage_chunk": self._fetch_stage_chunk,
            "sdfs.replicate": self._replicate,
            "sdfs.delete": self._delete,
            "sdfs.store": self._store,
            "sdfs.scrub": self._scrub,
        })

    def _receive(self, p: dict) -> dict:
        self._check_epoch(p)
        self.store.receive(p["name"], int(p["version"]), p["data"], digest=p.get("digest"))
        return {}

    def _fetch(self, p: dict) -> dict:
        try:
            with self._admit():
                return {"data": self.store.read(p["name"], int(p["version"]))}
        except KeyError as e:
            raise RpcError(str(e))

    def _fetch_meta(self, p: dict) -> dict:
        try:
            return {"size": self.store.size(p["name"], int(p["version"]))}
        except KeyError as e:
            raise RpcError(str(e))

    def _fetch_chunk(self, p: dict) -> dict:
        try:
            with self._admit():
                return {
                    "data": self.store.read_range(
                        p["name"], int(p["version"]), int(p["offset"]), int(p["length"])
                    )
                }
        except KeyError as e:
            raise RpcError(str(e))

    def _fetch_stage_meta(self, p: dict) -> dict:
        try:
            return {"size": self.store.staged_size(p["name"])}
        except KeyError as e:
            raise RpcError(str(e))

    def _fetch_stage_chunk(self, p: dict) -> dict:
        try:
            with self._admit():
                return {
                    "data": self.store.staged_range(
                        p["name"], int(p["offset"]), int(p["length"])
                    )
                }
        except KeyError as e:
            raise RpcError(str(e))

    def _replicate(self, p: dict) -> dict:
        """Third-party copy: pull from ``source`` and store locally. This is
        the scp-orchestration shape (services.rs:264-272) over RPC. Large
        blobs stream chunk-by-chunk into a scratch file; small ones ride one
        frame. The assembled bytes are verified against the leader-supplied
        digest before install — a corrupt source (or wire) can fail this
        pull, but can never seed a corrupt replica here."""
        self._check_epoch(p)
        with self._admit():
            return self._replicate_admitted(p)

    def _replicate_admitted(self, p: dict) -> dict:
        name, version, source = p["name"], int(p["version"]), p["source"]
        digest = p.get("digest")
        if p.get("from_stage"):
            key = p.get("stage_key") or name
            meta, chunk = "sdfs.fetch_stage_meta", "sdfs.fetch_stage_chunk"
            ident: dict = {"name": key}
        else:
            meta, chunk = "sdfs.fetch_meta", "sdfs.fetch_chunk"
            ident = {"name": name, "version": version}
        # One transfer budget covers the whole pull (meta + every chunk):
        # the per-hop Deadline shrinks as chunks land, and the caller's own
        # propagated deadline (if tighter) is inherited underneath it.
        transfer = deadline_lib.Deadline(self.transfer_timeout_s)
        size = int(
            self.rpc.call(source, meta, ident, timeout=30.0, deadline=transfer)["size"]
        )
        if size <= self.chunk_bytes:
            data = self.rpc.call(
                source,
                chunk,
                {**ident, "offset": 0, "length": size},
                timeout=self.transfer_timeout_s,
                deadline=transfer,
            )["data"]
            self.store.receive(name, version, data, digest=digest)
            return {}
        scratch = self.store.incoming_path()
        try:
            # Scratch assembly in .incoming/: never visible as a committed
            # blob — adopt_file verifies, fsyncs, and renames it in.
            with open(scratch, "wb") as f:  # dmlc-lint: disable=F1 -- chunk assembly scratch; adopt_file is the durable commit
                for offset in range(0, size, self.chunk_bytes):
                    part = self.rpc.call(
                        source,
                        chunk,
                        {**ident, "offset": offset,
                         "length": min(self.chunk_bytes, size - offset)},
                        timeout=self.transfer_timeout_s,
                        deadline=transfer,
                    )["data"]
                    f.write(part)
            if scratch.stat().st_size != size:
                raise RpcError(f"assembled {scratch.stat().st_size} bytes, wanted {size}")
            self.store.adopt_file(name, version, scratch, digest=digest)
        except BaseException:
            scratch.unlink(missing_ok=True)
            raise
        return {}

    def _delete(self, p: dict) -> dict:
        self._check_epoch(p)
        self.store.delete(p["name"])
        return {}

    def _store(self, p: dict) -> dict:
        return {"files": self.store.listing(), "inventory": self.store.inventory()}

    def _scrub(self, p: dict) -> dict:
        """Operator/leader-triggered anti-entropy pass over this store."""
        scanned, corrupt = self.store.scrub_once(p.get("max"))
        return {"scanned": scanned, "corrupt": [[n, v] for n, v in corrupt]}


@dataclass
class SdfsLeaderState:
    """The leader's directory: filename -> member address -> versions, plus
    the per-(file, version) content digest every hop verifies against."""

    directory: dict[str, dict[str, set[int]]] = field(default_factory=dict)
    digests: dict[str, dict[int, str]] = field(default_factory=dict)

    def latest_version(self, name: str) -> int:
        vs = [v for m in self.directory.get(name, {}).values() for v in m]
        return max(vs, default=0)

    def replicas_of(self, name: str, version: int) -> list[str]:
        return sorted(
            m for m, vs in self.directory.get(name, {}).items() if version in vs
        )

    def record(self, name: str, version: int, member: str) -> None:
        self.directory.setdefault(name, {}).setdefault(member, set()).add(version)

    def drop_replica(self, name: str, version: int, member: str) -> bool:
        """Quarantine one member's copy at the directory level: it is no
        longer a get target or a heal source for this version."""
        vs = self.directory.get(name, {}).get(member)
        if vs is None or version not in vs:
            return False
        vs.discard(version)
        if not vs:
            self.directory[name].pop(member, None)
        return True

    def locality_of(self, member: str) -> float | None:
        """Fraction of directory filenames with ANY replica on ``member`` —
        the ingest-aware placement locality signal (scheduler/placement.py):
        a member already holding the blobs a predict job reads decodes them
        without an SDFS fetch first. None while the directory is empty so
        the advisor treats locality as unknown rather than zero."""
        if not self.directory:
            return None
        mine = sum(
            1 for ms in self.directory.values() if any(ms.get(member, ()))
        )
        return mine / len(self.directory)

    def digest_of(self, name: str, version: int) -> str | None:
        return self.digests.get(name, {}).get(version)

    def set_digest(self, name: str, version: int, digest: str | None) -> None:
        if digest:
            self.digests.setdefault(name, {})[version] = digest

    def to_wire(self) -> dict:
        return {
            n: {m: sorted(vs) for m, vs in ms.items()} for n, ms in self.directory.items()
        }

    def digests_to_wire(self) -> dict:
        return {
            n: {str(v): d for v, d in vs.items()} for n, vs in self.digests.items()
        }

    @classmethod
    def from_wire(cls, w: dict, digests: dict | None = None) -> "SdfsLeaderState":
        return cls(
            directory={
                n: {m: set(vs) for m, vs in ms.items()} for n, ms in w.items()
            },
            digests={
                n: {int(v): str(d) for v, d in vs.items()}
                for n, vs in (digests or {}).items()
            },
        )


class SdfsLeader:
    """Leader-side SDFS logic + RPC surface.

    ``active_members`` is injected (a callable returning live member RPC
    addresses) so the directory reacts to membership without owning it —
    the reference reads active_ids() the same way (services.rs:315).
    """

    def __init__(
        self,
        rpc: Rpc,
        active_members,
        replication_factor: int = 4,
        is_leading: bool = True,
        fanout: int = 4,
        transfer_timeout_s: float = 300.0,
    ):
        self.rpc = rpc
        self.active_members = active_members
        self.rf = replication_factor
        # Ceiling for one replica copy (the member pulls chunk-by-chunk
        # under this budget, which the RPC frame propagates to it).
        self.transfer_timeout_s = float(transfer_timeout_s)
        # Concurrent replica copies per placement (the reference ran its scp
        # fanout 10-wide, services.rs:367-373); 1 = fully sequential.
        self.fanout = max(1, fanout)
        self.state = SdfsLeaderState()
        self._lock = threading.RLock()
        # Writes are refused unless actively leading (set by StandbyLeader on
        # promotion, like JobScheduler.is_leading): a put acked by a deferring
        # standby would be wholesale-overwritten by its next directory sync —
        # an acked write silently lost. Standalone single-leader use (tests,
        # local tools) passes the default True.
        self.is_leading = is_leading
        # Leadership epoch [counter, claimant] stamped on every member write
        # (and replicated with the directory): members fence out older
        # terms, so a stale claimant's placements bounce instead of landing.
        # Standalone use (tests, tools) keeps the default term.
        self.epoch: list = [1, ""]
        # Highest version handed out per file, including puts still in
        # flight — concurrent puts of one name must get distinct versions
        # even though the directory records them only after replication.
        self._reserved: dict[str, int] = {}
        # Delete tombstones: name -> version watermark at delete time,
        # replicated with the directory. reconcile_from_members skips
        # member-held versions at or below the watermark, so a replica that
        # missed the delete (unreachable, tolerated) cannot resurrect the
        # file through a promotion-time inventory sync; versions stay
        # monotonic past a delete (the reservation keeps the watermark), so
        # re-created files are never shadowed by their own tombstone.
        self._tombstones: dict[str, int] = {}

    def methods(self) -> dict:
        return traced_methods({
            "sdfs.put": self._put,
            "sdfs.put_inline": self._put_inline,
            "sdfs.get": self._get,
            "sdfs.get_versions": self._get_versions,
            "sdfs.delete": self._delete,
            "sdfs.ls": self._ls,
            "sdfs.record": self._record,
            "sdfs.state": self._state_wire,
            "sdfs.announce": self._announce,
            "sdfs.report_corrupt": self._report_corrupt,
        })

    def _require_leading(self) -> None:
        if not self.is_leading:
            raise RpcError("not the active leader")

    def _state_wire(self, p: dict) -> dict:
        """Directory replication payload for standby leaders — without it a
        failover would orphan every stored file and recycle versions. The
        reservation map rides along so concurrent-put protection survives
        failover instead of resetting."""
        with self._lock:
            return {
                "directory": self.state.to_wire(),
                "digests": self.state.digests_to_wire(),
                "reserved": dict(self._reserved),
                "tombstones": dict(self._tombstones),
                "epoch": list(self.epoch),
            }

    def blob_locality(self, member: str) -> float | None:
        """Fraction of the directory this member holds a replica of — fed
        to PlacementAdvisor as the ingest-aware locality signal. None
        (unknown) while the directory is empty."""
        with self._lock:
            return self.state.locality_of(member)

    def adopt_state(self, wire: dict) -> None:
        """Standby sync: mirror the active leader's directory wholesale."""
        with self._lock:
            self.state = SdfsLeaderState.from_wire(
                wire["directory"], wire.get("digests")
            )
            self._reserved = {k: int(v) for k, v in wire.get("reserved", {}).items()}
            self._tombstones = {
                k: int(v) for k, v in wire.get("tombstones", {}).items()
            }

    def _for_each_member(self, what: str, fn) -> list:
        """Run fn(member) across active members CONCURRENTLY (bounded by
        fanout), tolerating per-member failure. Promotion-time passes use
        this: members are most likely to be unreachable exactly then, and a
        serial 2 s timeout per dead member would stall leadership takeover
        O(members x timeout)."""
        from concurrent.futures import ThreadPoolExecutor

        members = self.active_members()
        results = []
        with ThreadPoolExecutor(max_workers=max(self.fanout, 4)) as pool:
            for m, fut in [(m, pool.submit(fn, m)) for m in members]:
                try:
                    results.append((m, fut.result()))
                except (RpcUnreachable, RpcError) as e:
                    log.warning("%s %s failed: %s", what, m, e)
        return results

    def fence_members(self) -> list:
        """Best-effort fence announcement to every reachable member: they
        learn this term before it accepts writes, so a stale claimant's
        subsequent placements are rejected rather than raced.

        Members report their current fence back. If any member holds a
        NEWER term than ours — persisted fences survive a full-cluster
        restart while the epoch counter resets — this term adopts a
        strictly newer one and re-announces, so recovery never depends on
        members forgetting their fences. Returns the final epoch."""
        from dmlc_tpu_torch.cluster.failover import epoch_key

        for _ in range(3):  # adopt + re-announce is bounded, not a loop
            replies = self._for_each_member(
                "fence",
                lambda m: self.rpc.call(
                    m, "sdfs.fence", {"epoch": list(self.epoch)}, timeout=2.0
                ),
            )
            fences = [r.get("epoch") for _, r in replies if r.get("epoch")]
            top = max(fences, key=epoch_key) if fences else None
            if top is None or epoch_key(top) <= epoch_key(self.epoch):
                break
            with self._lock:
                self.epoch = [int(top[0]) + 1, self.epoch[1]]
            log.warning(
                "member fence %s newer than our term; adopted epoch %s",
                top, self.epoch,
            )
        return list(self.epoch)

    def reconcile_from_members(self) -> None:
        """Promotion-time inventory sync: fold every reachable member's
        store listing into the directory and raise version reservations to
        cover what exists ON DISK — versions acked by a previous term that
        this candidate never mirrored (leader died between ack and standby
        sync) can then never be re-handed to a new put as fresh numbers,
        so one version number can never name two different blobs. Must run
        AFTER fence_members(): any stale-term write a member accepts lands
        before its fence, hence before this read of its listing."""
        listings = self._for_each_member(
            "reconcile", lambda m: self.rpc.call(m, "sdfs.store", {}, timeout=2.0)
        )
        for m, reply in listings:
            inventory = reply.get("inventory") or {
                name: {str(v): "" for v in versions}
                for name, versions in reply["files"].items()
            }
            self._fold_inventory(m, inventory)

    def _fold_inventory(
        self, member: str, inventory: dict
    ) -> tuple[list[str], list[tuple[str, int]]]:
        """Fold one member's on-disk inventory (``{name: {str(version):
        digest}}``) into the directory, respecting delete tombstones and
        raising version reservations. Returns ``(dead, corrupt)``: names
        whose every held version sits at or below a delete tombstone (the
        member should drop them — a replica that missed a delete must not
        hold the bytes forever), and versions whose digest disagrees with
        the directory's (a divergent copy: never recorded, and the member
        should quarantine it)."""
        dead: list[str] = []
        corrupt: list[tuple[str, int]] = []
        with self._lock:
            for name, versions in inventory.items():
                # A replica that missed a delete still lists the dead
                # blob; the tombstone watermark keeps it dead.
                dead_below = self._tombstones.get(name, 0)
                live = {int(v): d for v, d in versions.items() if int(v) > dead_below}
                if versions and not live:
                    dead.append(name)
                for v, digest in live.items():
                    known = self.state.digest_of(name, v)
                    if known and digest and digest != known:
                        corrupt.append((name, v))
                        continue
                    self.state.record(name, v, member)
                    self.state.set_digest(name, v, digest)
                top = max(live, default=0)
                if top > self._reserved.get(name, 0):
                    self._reserved[name] = top
        return dead, corrupt

    # ---- RPC methods ---------------------------------------------------

    def _reserve_version(self, name: str) -> int:
        """Hand out the next version for ``name`` under the lock — including
        puts still in flight, so concurrent puts of one name can never share
        a number. THE single home of this invariant (both put paths and the
        failover reservation sync depend on it)."""
        with self._lock:
            self._require_leading()
            version = max(self.state.latest_version(name), self._reserved.get(name, 0)) + 1
            self._reserved[name] = version
            return version

    def _put(self, p: dict) -> dict:
        """Place a new version of ``name`` whose bytes are staged at
        ``origin``. The client computed the content digest while staging;
        it rides placement so every replica verifies what it pulls, and it
        is recorded for every later hop to check. Returns
        {version, replicas, digest}."""
        name, origin, digest = p["name"], p["origin"], p.get("digest")
        version = self._reserve_version(name)
        with self._lock:
            self.state.set_digest(name, version, digest)
        replicas = self._place(
            name, version, source=origin, from_stage=True,
            stage_key=p.get("stage_key", name), digest=digest,
        )
        if not replicas:
            raise RpcError(f"no replicas stored {name!r} v{version}")
        return {"version": version, "replicas": replicas, "digest": digest}

    def _put_inline(self, p: dict) -> dict:
        """Place a new version whose bytes ride IN the request — for
        standalone operator tools (tools/import_weights.py) that have no
        member store to stage in. Same reservation + placement as _put;
        the leader pushes the bytes to each chosen replica directly and
        computes the digest itself."""
        name, data = p["name"], p["data"]
        digest = diskio.sha256_hex(data)
        version = self._reserve_version(name)
        with self._lock:
            self.state.set_digest(name, version, digest)
        replicas = self._place(
            name, version, source=None, from_stage=False, data=data, digest=digest
        )
        if not replicas:
            raise RpcError(f"no replicas stored {name!r} v{version}")
        return {"version": version, "replicas": replicas, "digest": digest}

    def _get(self, p: dict) -> dict:
        """Resolve a (name, version?) to live replica addresses + the
        expected content digest; the client pulls bytes member-to-member
        and verifies them, the leader never relays them."""
        name = p["name"]
        with self._lock:
            version = int(p.get("version") or self.state.latest_version(name))
            if version == 0:
                raise RpcError(f"{name!r} not in SDFS")
            replicas = self.state.replicas_of(name, version)
            digest = self.state.digest_of(name, version)
        live = set(self.active_members())
        replicas = [r for r in replicas if r in live] or replicas
        if not replicas:
            raise RpcError(f"{name!r} v{version} has no replicas")
        return {"version": version, "replicas": replicas, "digest": digest}

    def _get_versions(self, p: dict) -> dict:
        name, n = p["name"], int(p.get("n", 5))
        with self._lock:
            latest = self.state.latest_version(name)
            if latest == 0:
                raise RpcError(f"{name!r} not in SDFS")
            wanted = [v for v in range(latest, max(0, latest - n), -1)]
            out = {v: self.state.replicas_of(name, v) for v in wanted}
            digests = {str(v): self.state.digest_of(name, v) for v in wanted}
        return {
            "versions": {str(v): rs for v, rs in out.items() if rs},
            "digests": digests,
        }

    def _record(self, p: dict) -> dict:
        """Record an out-of-band replica (e.g. `train` broadcast pulls) in
        the directory so ls/delete/healing see those copies too."""
        with self._lock:
            self._require_leading()
            self.state.record(p["name"], int(p["version"]), p["member"])
            self.state.set_digest(p["name"], int(p["version"]), p.get("digest"))
        return {}

    def _announce(self, p: dict) -> dict:
        """Restart re-announce: a member that recovered its store from disk
        pushes its inventory so the directory regains those replicas without
        waiting for a promotion-time reconcile — after a full-fleet restart
        the blobs are served again instead of lost. The reply tells the
        member which names sit wholly below a delete tombstone (drop them)
        and which versions diverge from the recorded digest (quarantine)."""
        self._require_leading()
        dead, corrupt = self._fold_inventory(p["member"], p.get("inventory") or {})
        return {"dead": dead, "corrupt": [[n, v] for n, v in corrupt]}

    def _report_corrupt(self, p: dict) -> dict:
        """A verifying reader (client get, replica pull, member scrub)
        found ``member``'s copy of (name, version) corrupt: drop it from
        the directory so gets and heals stop touching it. heal_once then
        restores rf from the remaining verified replicas."""
        self._require_leading()
        name, version, member = p["name"], int(p["version"]), p["member"]
        with self._lock:
            dropped = self.state.drop_replica(name, version, member)
        if dropped:
            log.warning(
                "dropped corrupt replica %s v%s at %s from directory",
                name, version, member,
            )
        return {"dropped": dropped}

    def _delete(self, p: dict) -> dict:
        name = p["name"]
        with self._lock:
            self._require_leading()
            entry = self.state.directory.pop(name, {})
            members = sorted(entry)
            # Tombstone at the high-water mark (directory AND in-flight
            # reservations): reconcile_from_members must never resurrect
            # any version a replica kept past this delete, and the
            # reservation stays AT the watermark so the next put of this
            # name gets a strictly newer number — one version can then
            # never name both a deleted blob and a re-created one.
            latest = max((v for vs in entry.values() for v in vs), default=0)
            watermark = max(latest, self._reserved.get(name, 0))
            if watermark > 0:
                self._tombstones[name] = watermark
                self._reserved[name] = watermark
            self.state.digests.pop(name, None)
        failed = []
        for m in members:
            try:
                self.rpc.call(
                    m, "sdfs.delete", {"name": name, "epoch": list(self.epoch)},
                    timeout=10.0,
                )
            except (RpcUnreachable, RpcError):
                # Tolerated: stores persist across restarts now, but the
                # tombstone keeps the blob out of the directory and the
                # member's next announce/reconcile tells it to drop the
                # bytes (_fold_inventory's "dead" reply).
                failed.append(m)
        return {"deleted_from": [m for m in members if m not in failed]}

    def _ls(self, p: dict) -> dict:
        with self._lock:
            if name := p.get("name"):
                entry = self.state.directory.get(name, {})
                return {"files": {name: {m: sorted(vs) for m, vs in entry.items()}}}
            return {"files": self.state.to_wire()}

    # ---- placement + healing -------------------------------------------

    def _place(
        self,
        name: str,
        version: int,
        source: str | None,
        from_stage: bool,
        stage_key: str | None = None,
        data: bytes | None = None,
        digest: str | None = None,
    ) -> list[str]:
        """Copy (name, version) onto members chosen by hash + linear probe
        until rf replicas exist: pulled member-to-member from ``source``,
        or pushed directly when the bytes arrived inline (``data``).
        Up to ``fanout`` copies run concurrently (services.rs:367-373 ran
        its scp fanout 10-wide); unreachable candidates are probed past,
        like failed scp targets (services.rs:367-394). ``digest`` rides
        every copy so the receiving member verifies before committing; a
        candidate reporting an integrity failure convicts the SOURCE, whose
        copy is dropped from the directory (never healed from again)."""
        from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait

        with self._lock:
            have = set(self.state.replicas_of(name, version))
        live = self.active_members()
        placed = sorted(have)
        candidates = iter(placement_order(name, [m for m in live if m not in have]))
        source_corrupt = False

        def copy_to(candidate: str) -> bool:
            nonlocal source_corrupt
            try:
                if data is not None:
                    self.rpc.call(
                        candidate,
                        "sdfs.receive",
                        {"name": name, "version": version, "data": data,
                         "digest": digest, "epoch": list(self.epoch)},
                        timeout=self.transfer_timeout_s,
                    )
                else:
                    self.rpc.call(
                        candidate,
                        "sdfs.replicate",
                        {
                            "name": name,
                            "version": version,
                            "source": source,
                            "from_stage": from_stage,
                            "stage_key": stage_key,
                            "digest": digest,
                            "epoch": list(self.epoch),
                        },
                        timeout=self.transfer_timeout_s,
                    )
                return True
            except (RpcUnreachable, RpcError) as e:
                if is_integrity_error(e):
                    source_corrupt = True
                log.warning("replicate %s v%s -> %s failed: %s", name, version, candidate, e)
                return False

        with ThreadPoolExecutor(max_workers=self.fanout) as pool:
            pending: set = set()

            def refill() -> None:
                while len(placed) + len(pending) < self.rf:
                    c = next(candidates, None)
                    if c is None:
                        return
                    pending.add(pool.submit(lambda c=c: (c, copy_to(c))))

            refill()
            while pending:
                done, pending = wait(pending, return_when=FIRST_COMPLETED)
                for fut in done:
                    candidate, ok = fut.result()
                    if ok:
                        with self._lock:
                            self.state.record(name, version, candidate)
                            self.state.set_digest(name, version, digest)
                        placed.append(candidate)
                refill()
        if source_corrupt and source is not None and not from_stage:
            # At least one candidate verified the pulled bytes against the
            # digest and they did not match: the source's copy is rot.
            # Drop it from the directory so it never serves a get or seeds
            # another heal; the caller retries from a different replica.
            with self._lock:
                self.state.drop_replica(name, version, source)
            log.warning(
                "heal source %s had a corrupt copy of %s v%s; dropped from directory",
                source, name, version,
            )
        return placed

    def heal_once(self) -> int:
        """One pass of the re-replication loop (services.rs:186-198): for
        every (file, version) short of rf live replicas, copy from a live
        replica onto new members. A source whose copy fails verification
        (or errors) is skipped and the OTHER live replicas are tried before
        giving up on the file for this pass. Returns number of copies."""
        live = set(self.active_members())
        with self._lock:
            todo = [
                (name, version)
                for name, members in self.state.directory.items()
                for version in {v for vs in members.values() for v in vs}
            ]
        copies = 0
        for name, version in todo:
            with self._lock:
                replicas = self.state.replicas_of(name, version)
                # Prune dead replicas so they don't satisfy the rf check or
                # count as already-placed; if one restarts later it
                # re-announces its recovered inventory and is re-recorded.
                for r in replicas:
                    if r not in live:
                        self.state.directory.get(name, {}).pop(r, None)
            live_replicas = [r for r in replicas if r in live]
            target = min(self.rf, len(live))
            if not live_replicas or len(live_replicas) >= target:
                continue
            before = set(live_replicas)
            digest = self.state.digest_of(name, version)
            for src in live_replicas:
                with self._lock:
                    # An earlier source attempt may have convicted src of
                    # corruption (drop_replica); never heal from it then.
                    if version not in self.state.directory.get(name, {}).get(src, set()):
                        continue
                self._place(name, version, source=src, from_stage=False, digest=digest)
                with self._lock:
                    now = set(self.state.replicas_of(name, version)) & live
                if len(now) >= target:
                    break
            with self._lock:
                after = set(self.state.replicas_of(name, version)) & live
            copies += len(after - before)
        return copies


# ---------------------------------------------------------------------------
# Client-side helpers (the CLI's verbs)
# ---------------------------------------------------------------------------


class SdfsClient:
    """Client verbs against a leader + the member fabric. ``self_addr`` is
    this node's member RPC address (the staging origin for puts). Bulk bytes
    stream disk-to-disk in bounded chunks at every hop.

    ``retry_policy`` (cluster/retrypolicy.py, optional) governs the replica
    fallback walk in ``_pull_to``: the first replica is a free attempt,
    every FURTHER replica is a retry that must pass that member's breaker
    and spend a retry token — a fleet of clients falling back through the
    same drowning replica no longer multiplies its load."""

    def __init__(
        self,
        rpc: Rpc,
        leader_addr: str,
        store: MemberStore,
        self_addr: str,
        chunk_bytes: int = DEFAULT_CHUNK_BYTES,
        timeout_s: float = 60.0,
        transfer_timeout_s: float = 300.0,
        retry_policy=None,
    ):
        self.rpc = rpc
        self.leader_addr = leader_addr
        self.local_store = store
        self.self_addr = self_addr
        self.chunk_bytes = chunk_bytes
        self.timeout_s = float(timeout_s)            # control verbs
        self.transfer_timeout_s = float(transfer_timeout_s)  # bulk pulls
        self.retry_policy = retry_policy

    def put(self, local_path: str | Path, name: str) -> dict:
        # Streaming-copy the file into the stage area — the blob never
        # enters this process's heap, whatever its size. The stage copy
        # also computes the content digest every later hop verifies.
        key = f"{name}#{uuid.uuid4().hex}"
        digest = self.local_store.stage_file(key, local_path)
        return self._put_staged(key, name, digest)

    def put_bytes(self, data: bytes, name: str) -> dict:
        # Unique stage key per put: concurrent puts of the same name from
        # this client must not overwrite each other's staged bytes.
        key = f"{name}#{uuid.uuid4().hex}"
        digest = self.local_store.stage(key, data)
        return self._put_staged(key, name, digest)

    def _put_staged(self, key: str, name: str, digest: str) -> dict:
        try:
            return self.rpc.call(
                self.leader_addr,
                "sdfs.put",
                {"name": name, "origin": self.self_addr, "stage_key": key,
                 "digest": digest},
                # The leader fans the placement out to rf replicas; give the
                # whole put one transfer-class budget.
                timeout=self.transfer_timeout_s,
            )
        finally:
            self.local_store.unstage(key)

    def get(self, name: str, local_path: str | Path, version: int | None = None) -> int:
        info = self.rpc.call(
            self.leader_addr, "sdfs.get", {"name": name, "version": version},
            timeout=self.timeout_s,
        )
        self._pull_to_path(local_path, lambda f: self._pull_to(
            name, info["version"], info["replicas"], f, digest=info.get("digest")
        ))
        return info["version"]

    def get_bytes(self, name: str, version: int | None = None) -> tuple[int, bytes]:
        import io

        info = self.rpc.call(
            self.leader_addr, "sdfs.get", {"name": name, "version": version},
            timeout=self.timeout_s,
        )
        buf = io.BytesIO()
        self._pull_to(
            name, info["version"], info["replicas"], buf, digest=info.get("digest")
        )
        return info["version"], buf.getvalue()

    def get_versions(self, name: str, n: int, local_path: str | Path) -> list[int]:
        """Fetch the last n versions merged newest-first into one file with
        '== Version N ==' delimiters (services.rs:555-569)."""
        reply = self.rpc.call(
            self.leader_addr, "sdfs.get_versions", {"name": name, "n": n},
            timeout=self.timeout_s,
        )
        digests = reply.get("digests", {})
        versions: list[int] = []

        def pull_all(f) -> None:
            for v_str, replicas in sorted(reply["versions"].items(), key=lambda kv: -int(kv[0])):
                v = int(v_str)
                f.write(f"== Version {v} ==\n".encode())
                self._pull_to(name, v, replicas, f, digest=digests.get(v_str))
                versions.append(v)

        self._pull_to_path(local_path, pull_all)
        return versions

    @staticmethod
    def _pull_to_path(local_path: str | Path, pull) -> None:
        """Stream into a sibling temp file and rename over ``local_path``
        only on success — a failed get must never destroy the caller's
        existing copy (which may be its fallback)."""
        local_path = Path(local_path)
        tmp = local_path.with_name(f".{local_path.name}.{uuid.uuid4().hex[:8]}.part")
        try:
            # Client download to the CALLER's path: rename-on-success is the
            # contract here; durability policy for its own files is the
            # caller's business (fsync would be gratuitous for e.g. a CLI
            # fetch into a scratch dir).
            with open(tmp, "wb") as f:  # dmlc-lint: disable=F1 -- caller-owned download path, committed by rename below
                pull(f)
            tmp.replace(local_path)
        except BaseException:
            tmp.unlink(missing_ok=True)
            raise

    def delete(self, name: str) -> dict:
        return self.rpc.call(
            self.leader_addr, "sdfs.delete", {"name": name}, timeout=self.timeout_s
        )

    def ls(self, name: str | None = None) -> dict:
        return self.rpc.call(
            self.leader_addr, "sdfs.ls", {"name": name}, timeout=self.timeout_s
        )["files"]

    def store(self, member_addr: str | None = None) -> dict:
        addr = member_addr or self.self_addr
        return self.rpc.call(addr, "sdfs.store", {}, timeout=self.timeout_s)["files"]

    def scrub(self, member_addr: str | None = None, max_blobs: int | None = None) -> dict:
        """Trigger one anti-entropy scrub pass on a member (default: this
        node). Returns {scanned, corrupt}. A full-store scrub re-hashes
        every blob, so it rides the transfer-class budget."""
        addr = member_addr or self.self_addr
        return self.rpc.call(
            addr, "sdfs.scrub", {"max": max_blobs}, timeout=self.transfer_timeout_s
        )

    def report_corrupt(self, name: str, version: int, member: str) -> None:
        """Tell the leader a replica failed verification (best-effort: a
        leaderless moment must not turn a successful fallback read into an
        error; the scrub loop re-detects it)."""
        try:
            self.rpc.call(
                self.leader_addr,
                "sdfs.report_corrupt",
                {"name": name, "version": version, "member": member},
                timeout=self.timeout_s,
            )
        except (RpcUnreachable, RpcError) as e:
            log.warning("could not report corrupt %s v%s at %s: %s", name, version, member, e)

    def _pull_to(
        self, name: str, version: int, replicas: list[str], f, digest: str | None = None
    ) -> None:
        """Stream one replica's blob into seekable ``f`` in bounded chunks,
        hashing as it lands; on mid-stream failure OR a digest mismatch,
        rewind and retry the next replica. A mismatching replica is
        reported to the leader so healing replaces it — and the corruption
        never reaches the caller."""
        last: Exception | None = None
        start = f.tell()
        for i, r in enumerate(replicas):
            # Retry governance: replica 0 is the free first attempt; every
            # fallback is a retry — breaker-gated and budgeted per replica,
            # so a drowning member is skipped instead of hammered.
            if self.retry_policy is not None:
                allowed = (
                    self.retry_policy.allow(r) if i == 0
                    else self.retry_policy.allow_retry(r)
                )
                if not allowed:
                    last = RpcUnreachable(f"{r}: skipped (breaker open / retry budget dry)")
                    continue
            hasher = hashlib.sha256()
            transfer = deadline_lib.Deadline(self.transfer_timeout_s)
            # One client-side span per replica attempt: the fleet trace
            # shows WHERE the bytes came from (and which fallbacks were
            # tried) as children of whatever request pulled them.
            with tracer.span("sdfs/pull", blob=name, version=int(version), replica=r):
                try:
                    size = int(
                        self.rpc.call(
                            r, "sdfs.fetch_meta", {"name": name, "version": version},
                            timeout=30.0, deadline=transfer,
                        )["size"]
                    )
                    f.seek(start)
                    f.truncate(start)
                    for offset in range(0, size, self.chunk_bytes):
                        part = self.rpc.call(
                            r,
                            "sdfs.fetch_chunk",
                            {
                                "name": name,
                                "version": version,
                                "offset": offset,
                                "length": min(self.chunk_bytes, size - offset),
                            },
                            timeout=self.transfer_timeout_s,
                            deadline=transfer,
                        )["data"]
                        hasher.update(part)
                        f.write(part)
                    if digest is not None and hasher.hexdigest() != digest:
                        raise IntegrityError(
                            f"replica {r} served {name} v{version} with digest "
                            f"{hasher.hexdigest()[:12]} != expected {digest[:12]}"
                        )
                    if self.retry_policy is not None:
                        self.retry_policy.record(r)
                    return
                except (RpcUnreachable, RpcError) as e:
                    if self.retry_policy is not None:
                        self.retry_policy.record(r, e)
                    if is_integrity_error(e):
                        # Either we hashed a mismatch, or the member's own
                        # read verification tripped — in both cases that
                        # copy is rot.
                        self.report_corrupt(name, version, r)
                    last = e
        raise RpcError(f"no live replica served {name!r} v{version}: {last}")
