"""The port's SDFS (cluster/sdfs.py) against the JAX package's.

- The cases of tests/test_sdfs.py, each run once against each package on
  that package's SimRpcNetwork (and, for the chunking and concurrency
  cases, its TCP fabric on localhost).
- Mixed clusters over TcpRpc on localhost: port members under a JAX leader
  and client, JAX members under a port leader, and a fleet of both; each
  returns what an all-JAX cluster returns for the same puts, gets, deletes
  and crash.
- A store directory written by one package's MemberStore reopens in the
  other's with the same inventory, bytes and fence.
- scheduler/dataset.py's SdfsImageSource pulls and caches class images.

Every store lives under ``tmp_path``; every server binds port 0 and is
closed in ``finally``; every socket test runs under ``torch_sockets``'
time limit.
"""

import hashlib
import threading

import numpy as np
import pytest
from torch_sides import JAX, PORT, pkg  # noqa: F401  (fixture)
from torch_sockets import socket_time_limit  # noqa: F401  (autouse fixture)


class Cluster:
    def __init__(self, pkg, tmp_path, n=6, rf=4):
        self.pkg = pkg
        self.net = pkg.rpc.SimRpcNetwork()
        self.live = [f"m{i}" for i in range(n)]
        self.stores = {}
        for addr in self.live:
            store = pkg.sdfs.MemberStore(tmp_path / addr)
            member = pkg.sdfs.SdfsMember(store, self.net.client(addr))
            self.net.serve(addr, member.methods())
            self.stores[addr] = store
        self.leader = pkg.sdfs.SdfsLeader(
            self.net.client("L"), lambda: list(self.live), replication_factor=rf
        )
        self.net.serve("L", self.leader.methods())

    def client(self, addr="m0"):
        return self.pkg.sdfs.SdfsClient(self.net.client(addr), "L", self.stores[addr], addr)

    def crash(self, addr):
        self.live.remove(addr)
        self.net.crash(addr)


@pytest.fixture
def cluster(pkg, tmp_path):
    return Cluster(pkg, tmp_path)


# ---------------------------------------------------------------------------
# tests/test_sdfs.py, against each package
# ---------------------------------------------------------------------------


def test_put_inline_places_rf_replicas(cluster):
    reply = cluster.net.client("tool").call(
        "L", "sdfs.put_inline", {"name": "models/x", "data": b"inline-1"}
    )
    assert reply["version"] == 1 and len(reply["replicas"]) == 4
    for r in reply["replicas"]:
        assert cluster.stores[r].read("models/x", 1) == b"inline-1"
    reply2 = cluster.client().put_bytes(b"staged-2", "models/x")
    assert reply2["version"] == 2
    version, data = cluster.client("m1").get_bytes("models/x", version=1)
    assert (version, data) == (1, b"inline-1")


def test_put_places_rf_replicas(cluster, tmp_path):
    src = tmp_path / "x.bin"
    src.write_bytes(b"payload-1")
    reply = cluster.client().put(src, "data/x")
    assert reply["version"] == 1
    assert len(reply["replicas"]) == 4
    for r in reply["replicas"]:
        assert cluster.stores[r].read("data/x", 1) == b"payload-1"
    for addr, store in cluster.stores.items():
        if addr not in reply["replicas"]:
            assert store.listing() == {}


def test_versioning_and_get(cluster, tmp_path):
    c = cluster.client()
    for i in (1, 2, 3):
        src = tmp_path / "in.txt"
        src.write_bytes(f"content-v{i}".encode())
        assert c.put(src, "f")["version"] == i
    out = tmp_path / "out.txt"
    assert c.get("f", out) == 3
    assert out.read_bytes() == b"content-v3"
    assert c.get("f", out, version=2) == 2
    assert out.read_bytes() == b"content-v2"


def test_get_versions_merge_format(cluster, tmp_path):
    c = cluster.client()
    for i in (1, 2, 3):
        c.put_bytes(f"line{i}\n".encode(), "log")
    out = tmp_path / "merged.txt"
    assert c.get_versions("log", 2, out) == [3, 2]
    assert out.read_text() == "== Version 3 ==\nline3\n== Version 2 ==\nline2\n"


def test_placement_is_deterministic_and_probes_past_crashes(cluster):
    order = cluster.pkg.sdfs.placement_order("some/file", cluster.live)
    assert sorted(order) == sorted(cluster.live)
    assert cluster.pkg.sdfs.placement_order("some/file", cluster.live) == order
    assert order == JAX.sdfs.placement_order("some/file", cluster.live)
    first = order[0]
    cluster.crash(first)
    reply = cluster.client("m0" if first != "m0" else "m1").put_bytes(b"d", "some/file")
    assert len(reply["replicas"]) == 4
    assert first not in reply["replicas"]


def test_healing_restores_replication_factor(cluster):
    c = cluster.client()
    replicas = c.put_bytes(b"heal-me", "h")["replicas"]
    victim = [r for r in replicas if r != "m0"][0]
    cluster.crash(victim)
    copies = cluster.leader.heal_once()
    assert copies >= 1
    now = cluster.leader.state.replicas_of("h", 1)
    assert victim not in now
    assert len(now) == 4
    for r in now:
        assert cluster.stores[r].read("h", 1) == b"heal-me"
    assert cluster.leader.heal_once() == 0


def test_heal_caps_at_cluster_size(pkg, tmp_path):
    cl = Cluster(pkg, tmp_path, n=3, rf=4)
    reply = cl.client().put_bytes(b"d", "f")
    assert sorted(reply["replicas"]) == ["m0", "m1", "m2"]
    assert cl.leader.heal_once() == 0


def test_get_falls_back_to_live_replica(cluster, tmp_path):
    c = cluster.client()
    replicas = c.put_bytes(b"fallback", "f")["replicas"]
    for victim in replicas[:-1]:
        if victim != "m0":
            cluster.crash(victim)
    out = tmp_path / "o"
    assert c.get("f", out) == 1
    assert out.read_bytes() == b"fallback"


def test_delete_removes_everywhere(cluster):
    c = cluster.client()
    replicas = c.put_bytes(b"gone", "f")["replicas"]
    c.delete("f")
    for r in replicas:
        assert cluster.stores[r].listing() == {}
    with pytest.raises(cluster.pkg.rpc.RpcError):
        c.get_bytes("f")
    assert c.ls() == {}


def test_ls_and_store_listings(cluster):
    c = cluster.client()
    c.put_bytes(b"a", "f1")
    c.put_bytes(b"b", "f1")
    c.put_bytes(b"c", "f2")
    ls = c.ls()
    assert set(ls) == {"f1", "f2"}
    assert all(vs == [1, 2] for vs in ls["f1"].values())
    some_replica = next(iter(ls["f2"]))
    assert c.store(some_replica)["f2"] == [1]


def test_put_with_no_members_errors(pkg, tmp_path):
    cl = Cluster(pkg, tmp_path, n=1, rf=4)
    cl.net.crash("m0")
    cl.live.remove("m0")
    store = pkg.sdfs.MemberStore(tmp_path / "client")
    client = pkg.sdfs.SdfsClient(cl.net.client("c"), "L", store, "c")
    cl.net.serve("c", pkg.sdfs.SdfsMember(store, cl.net.client("c")).methods())
    with pytest.raises(pkg.rpc.RpcError):
        client.put_bytes(b"d", "f")


@pytest.mark.parametrize("name,version", [("a/b\\c", 3), ("a/b", 1), ("a_b", 1),
                                          ("models/resnet18", 12), ("data/n01440764", 1)])
def test_storage_filename_sanitizes_without_collisions(pkg, name, version):
    fn = pkg.sdfs.storage_filename(name, version)
    assert fn == JAX.sdfs.storage_filename(name, version)
    assert pkg.sdfs.sidecar_filename(name, version) == JAX.sdfs.sidecar_filename(name, version)
    assert fn.startswith(f"v{version}.") and fn.endswith("." + pkg.sdfs.sanitize(name))
    assert pkg.sdfs.storage_filename("a/b", 1) != pkg.sdfs.storage_filename("a_b", 1)


def test_colliding_names_coexist_on_one_member(pkg, tmp_path):
    store = pkg.sdfs.MemberStore(tmp_path / "s")
    store.receive("a/b", 1, b"slash")
    store.receive("a_b", 1, b"underscore")
    assert store.read("a/b", 1) == b"slash"
    assert store.read("a_b", 1) == b"underscore"
    store.delete("a_b")
    assert store.read("a/b", 1) == b"slash"


def test_boot_recovers_committed_blobs_and_wipes_scratch(pkg, tmp_path):
    store = pkg.sdfs.MemberStore(tmp_path / "s")
    store.receive("f", 1, b"old")
    digest = store.digest_of("f", 1)
    store.stage("leaky", b"staged-bytes")
    store.blob_path("torn", 1).write_bytes(b"half-written")

    fresh = pkg.sdfs.MemberStore(tmp_path / "s")
    assert fresh.listing() == {"f": [1]}
    assert fresh.read("f", 1) == b"old"
    assert fresh.digest_of("f", 1) == digest
    assert not fresh.blob_path("torn", 1).exists()
    with pytest.raises(KeyError):
        fresh.staged_size("leaky")


def test_boot_discards_truncated_blobs(pkg, tmp_path):
    store = pkg.sdfs.MemberStore(tmp_path / "s")
    store.receive("f", 1, b"full-content")
    store.blob_path("f", 1).write_bytes(b"full")
    fresh = pkg.sdfs.MemberStore(tmp_path / "s")
    assert fresh.listing() == {}
    assert not store.blob_path("f", 1).exists()


def tcp_fleet(pkg, tmp_path, n, rf, chunk=None):
    """n members and a leader of ``pkg`` on localhost TCP."""
    rpc = pkg.rpc.TcpRpc()
    servers, stores, addrs = [], {}, []
    kw = {} if chunk is None else {"chunk_bytes": chunk}
    for i in range(n):
        store = pkg.sdfs.MemberStore(tmp_path / f"t{i}")
        srv = pkg.rpc.TcpRpcServer("127.0.0.1", 0,
                                   pkg.sdfs.SdfsMember(store, rpc, **kw).methods())
        servers.append(srv)
        stores[srv.address] = store
        addrs.append(srv.address)
    leader = pkg.sdfs.SdfsLeader(rpc, lambda: list(addrs), replication_factor=rf)
    servers.append(pkg.rpc.TcpRpcServer("127.0.0.1", 0, leader.methods()))
    return rpc, servers, stores, addrs, servers[-1].address


def test_chunked_transfer_never_exceeds_tiny_max_frame(pkg, tmp_path, monkeypatch):
    """With MAX_FRAME shrunk below the blob size, put + replicate + get over
    TCP succeed only if every hop moved bounded chunks."""
    monkeypatch.setattr(pkg.rpc, "MAX_FRAME", 64 * 1024)
    chunk = 16 * 1024
    blob = bytes(range(256)) * 1024  # 256 KiB >> MAX_FRAME
    rpc, servers, stores, addrs, leader = tcp_fleet(pkg, tmp_path, 3, 2, chunk)
    try:
        src = tmp_path / "big.bin"
        src.write_bytes(blob)
        client = pkg.sdfs.SdfsClient(rpc, leader, stores[addrs[0]], addrs[0], chunk_bytes=chunk)
        reply = client.put(src, "big/blob")
        assert len(reply["replicas"]) == 2
        for r in reply["replicas"]:
            assert stores[r].read("big/blob", 1) == blob
        dst = tmp_path / "out.bin"
        assert client.get("big/blob", dst) == 1
        assert dst.read_bytes() == blob
    finally:
        for s in servers:
            s.close()


def test_bulk_put_get_holds_chunk_memory(pkg, tmp_path):
    """A multi-MB blob moves client-disk -> stage -> replicas -> client-disk
    while the Python heap grows by O(chunk), not O(blob)."""
    import tracemalloc

    chunk = 1024 * 1024
    size = 48 * chunk
    cl = Cluster(pkg, tmp_path, n=3, rf=2)
    for addr in cl.live:
        member = pkg.sdfs.SdfsMember(cl.stores[addr], cl.net.client(addr), chunk_bytes=chunk)
        cl.net.serve(addr, member.methods())
    src = tmp_path / "big.bin"
    with open(src, "wb") as f:
        f.seek(size - 1)
        f.write(b"\0")
    client = pkg.sdfs.SdfsClient(cl.net.client("m0"), "L", cl.stores["m0"], "m0",
                                 chunk_bytes=chunk)

    tracemalloc.start()
    base = tracemalloc.get_traced_memory()[0]
    reply = client.put(src, "big/ckpt")
    dst = tmp_path / "back.bin"
    client.get("big/ckpt", dst)
    peak = tracemalloc.get_traced_memory()[1]
    tracemalloc.stop()

    assert len(reply["replicas"]) == 2
    assert dst.stat().st_size == size
    assert peak - base < 12 * chunk, f"peak heap delta {(peak - base) / 1e6:.1f} MB"


def test_concurrent_puts_get_distinct_versions(pkg, tmp_path):
    rpc, servers, stores, addrs, leader = tcp_fleet(pkg, tmp_path, 4, 2)
    try:
        results = {}

        def put_from(idx):
            c = pkg.sdfs.SdfsClient(rpc, leader, stores[addrs[idx]], addrs[idx])
            results[idx] = c.put_bytes(f"payload-{idx}".encode() * 1000, "same/name")

        threads = [threading.Thread(target=put_from, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        v0, v1 = results[0]["version"], results[1]["version"]
        assert {v0, v1} == {1, 2}
        for idx, v in ((0, v0), (1, v1)):
            replica = results[idx]["replicas"][0]
            assert stores[replica].read("same/name", v) == f"payload-{idx}".encode() * 1000
    finally:
        for s in servers:
            s.close()


def test_reconcile_does_not_resurrect_deleted_files(pkg, tmp_path):
    cl = Cluster(pkg, tmp_path, n=4, rf=2)
    c = cl.client()
    replicas = c.put_bytes(b"doomed", "f")["replicas"]
    straggler = replicas[0]
    cl.net.crash(straggler)
    c.delete("f")
    cl.net.restart(cl.net.down.pop())
    assert "f" in cl.stores[straggler].listing()

    cl.leader.reconcile_from_members()
    with pytest.raises(pkg.rpc.RpcError):
        c.get_bytes("f")
    assert "f" not in cl.leader.state.directory

    v_new = c.put_bytes(b"reborn", "f")["version"]
    assert v_new == 2
    cl.leader.reconcile_from_members()
    assert c.get_bytes("f")[1] == b"reborn"
    assert all(
        1 not in vs
        for vs in cl.leader.state.directory.get("f", {}).values()
    ) or cl.leader.state.replicas_of("f", 1) == []


def test_epoch_fence_survives_member_restart(pkg, tmp_path):
    net = pkg.rpc.SimRpcNetwork()
    store = pkg.sdfs.MemberStore(tmp_path / "m0")
    member = pkg.sdfs.SdfsMember(store, net.client("m0"))
    member._receive({"name": "f", "version": 1, "data": b"x", "epoch": [3, "L2"]})
    with pytest.raises(pkg.rpc.RpcError, match="stale leadership epoch"):
        member._receive({"name": "g", "version": 1, "data": b"y", "epoch": [2, "L1"]})

    store2 = pkg.sdfs.MemberStore(tmp_path / "m0")
    member2 = pkg.sdfs.SdfsMember(store2, net.client("m0"))
    assert member2._fence == (3, "L2")
    with pytest.raises(pkg.rpc.RpcError, match="stale leadership epoch"):
        member2._receive({"name": "g", "version": 1, "data": b"y", "epoch": [2, "L1"]})
    member2._receive({"name": "h", "version": 1, "data": b"z", "epoch": [4, "L3"]})
    assert pkg.sdfs.SdfsMember(pkg.sdfs.MemberStore(tmp_path / "m0"),
                               net.client("m0"))._fence == (4, "L3")


def test_full_restart_recovers_past_persisted_fences(pkg, tmp_path):
    cl = Cluster(pkg, tmp_path, n=3, rf=2)
    cl.leader.epoch = [7, "old-leader"]
    cl.leader.fence_members()

    cl2 = Cluster(pkg, tmp_path, n=3, rf=2)
    assert cl2.leader.epoch == [1, ""]
    adopted = cl2.leader.fence_members()
    assert adopted[0] > 7
    c = cl2.client()
    c.put_bytes(b"recovered", "f")
    assert c.get_bytes("f")[1] == b"recovered"


# ---------------------------------------------------------------------------
# Mixed clusters over TCP: the all-JAX answers
# ---------------------------------------------------------------------------

#: (leader, client, members by rank of address): each mixed fleet, and the
#: all-JAX fleet whose answers they must give.
FLEETS = {
    "all_jax": (JAX, JAX, (JAX, JAX, JAX, JAX)),
    "port_members_jax_leader_client": (JAX, JAX, (PORT, PORT, PORT, PORT)),
    "jax_members_port_leader_client": (PORT, PORT, (JAX, JAX, JAX, JAX)),
    "both_members_port_leader_jax_client": (PORT, JAX, (JAX, PORT, PORT, JAX)),
}
#: A chunk far below the large blob, so pulls and copies go chunk by chunk.
FLEET_CHUNK = 64 * 1024


def run_fleet(tmp_path, leader_pkg, client_pkg, member_pkgs) -> list:
    """One scenario on a TCP fleet: puts (inline bytes, a file, a blob of
    several chunks), gets, merged versions, listings, a delete, a member's
    crash and a heal. Returns every answer, with member addresses named by
    their rank among the members' addresses (placement depends only on
    that order)."""
    servers, stores, addrs = [], [], []
    for i, p in enumerate(member_pkgs):
        store = p.sdfs.MemberStore(tmp_path / f"member{i}")
        member = p.sdfs.SdfsMember(store, p.rpc.TcpRpc(), chunk_bytes=FLEET_CHUNK)
        servers.append(p.rpc.TcpRpcServer("127.0.0.1", 0, member.methods()))
        stores.append(store)
        addrs.append(servers[-1].address)
    try:
        rank = {a: f"m{r}" for r, a in enumerate(sorted(addrs))}
        live = list(addrs)
        leader = leader_pkg.sdfs.SdfsLeader(leader_pkg.rpc.TcpRpc(), lambda: list(live),
                                            replication_factor=3)
        servers.append(leader_pkg.rpc.TcpRpcServer("127.0.0.1", 0, leader.methods()))
        laddr = servers[-1].address
        # The client stages in a store of its own, served by its package,
        # outside the members the leader places on.
        cstore = client_pkg.sdfs.MemberStore(tmp_path / "client")
        crpc = client_pkg.rpc.TcpRpc()
        servers.append(client_pkg.rpc.TcpRpcServer(
            "127.0.0.1", 0,
            client_pkg.sdfs.SdfsMember(cstore, crpc, chunk_bytes=FLEET_CHUNK).methods()))
        client = client_pkg.sdfs.SdfsClient(crpc, laddr, cstore, servers[-1].address,
                                            chunk_bytes=FLEET_CHUNK)

        def named(value):
            if isinstance(value, dict):
                return {rank.get(k, k): named(v) for k, v in sorted(value.items())}
            if isinstance(value, list):
                return [named(v) for v in value]
            return rank.get(value, value) if isinstance(value, str) else value

        def put_reply(reply):
            # The copies run concurrently: the replicas, not their order.
            return {"version": reply["version"], "digest": reply["digest"],
                    "replicas": sorted(named(reply["replicas"]))}

        rng = np.random.default_rng(3)
        big = rng.integers(0, 256, 5 * FLEET_CHUNK + 1234, np.uint8).tobytes()
        src = tmp_path / "model.bin"
        src.write_bytes(b"weights-v1" * 300)
        out = [("put", put_reply(client.put_bytes(b"alpha-1", "f/alpha"))),
               ("put", put_reply(client.put_bytes(b"alpha-2", "f/alpha"))),
               ("put", put_reply(client.put(src, "models/m"))),
               ("put", put_reply(client.put_bytes(big, "data/big")))]
        out.append(("get", client.get_bytes("f/alpha")))
        out.append(("get_v1", client.get_bytes("f/alpha", version=1)))
        dst = tmp_path / "big.out"
        out.append(("get_big", client.get("data/big", dst), hashlib.sha256(
            dst.read_bytes()).hexdigest() == hashlib.sha256(big).hexdigest()))
        merged = tmp_path / "merged.txt"
        out.append(("versions", client.get_versions("f/alpha", 2, merged), merged.read_bytes()))
        out.append(("ls", named(client.ls())))
        out.append(("store", [named(client.store(a)) for a in sorted(addrs)]))
        out.append(("digests", [leader.state.digest_of(n, v) for n, v in
                                (("f/alpha", 1), ("f/alpha", 2), ("models/m", 1),
                                 ("data/big", 1))]))
        out.append(("delete", named(client.delete("models/m"))))
        out.append(("ls_after_delete", named(client.ls())))
        # The member of rank 1 crashes; a put and a heal follow.
        victim = sorted(addrs)[1]
        servers[addrs.index(victim)].close()
        live.remove(victim)
        out.append(("put_after_crash", put_reply(client.put_bytes(b"gamma", "f/gamma"))))
        out.append(("heal", leader.heal_once()))
        out.append(("ls_after_heal", named(client.ls())))
        out.append(("get_after_heal", client.get_bytes("data/big")[1] == big,
                    client.get_bytes("f/gamma")))
        out.append(("inventories", [named(stores[addrs.index(a)].inventory())
                                    for a in sorted(addrs) if a != victim]))
        return out
    finally:
        for s in servers:
            s.close()


@pytest.mark.parametrize("fleet", [f for f in FLEETS if f != "all_jax"])
def test_mixed_fleet_gives_the_all_jax_answers(tmp_path, fleet):
    want = run_fleet(tmp_path / "all_jax", *FLEETS["all_jax"])
    got = run_fleet(tmp_path / fleet, *FLEETS[fleet])
    for g, w in zip(got, want):
        assert g == w, f"{fleet}: {g[0]}"
    assert len(got) == len(want)
    # The scenario itself: three replicas, a healed crash, a chunked blob.
    answers = dict((step[0], step[1:]) for step in want)
    assert answers["heal"][0] >= 1 and answers["get_big"][1] is True


# ---------------------------------------------------------------------------
# One store directory, either package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)], ids=["jax_to_port",
                                                                            "port_to_jax"])
def test_store_directory_reopens_across_packages(tmp_path, writer, reader):
    net = writer.rpc.SimRpcNetwork()
    store = writer.sdfs.MemberStore(tmp_path / "m0")
    member = writer.sdfs.SdfsMember(store, net.client("m0"))
    member._receive({"name": "models/resnet18", "version": 1, "data": b"w1" * 999,
                     "epoch": [5, "L"]})
    store.receive("models/resnet18", 2, b"w2" * 777)
    store.receive("a/b", 1, b"slash")
    store.receive("a_b", 1, b"underscore")
    store.stage("in-flight", b"staged")
    store.blob_path("torn", 1).write_bytes(b"no sidecar")
    store.receive("cut", 1, b"cut-short-later")
    store.blob_path("cut", 1).write_bytes(b"cut")
    inventory = writer.sdfs.MemberStore(tmp_path / "m0").inventory()

    other = reader.sdfs.MemberStore(tmp_path / "m0")
    assert other.inventory() == inventory
    assert other.listing() == {"models/resnet18": [1, 2], "a/b": [1], "a_b": [1]}
    assert other.read("models/resnet18", 2) == b"w2" * 777
    assert other.read("a/b", 1) == b"slash"
    assert other.digest_of("a_b", 1) == hashlib.sha256(b"underscore").hexdigest()
    with pytest.raises(KeyError):
        other.staged_size("in-flight")
    assert not other.blob_path("torn", 1).exists()
    reader_member = reader.sdfs.SdfsMember(other, reader.rpc.SimRpcNetwork().client("m0"))
    assert reader_member._fence == (5, "L")
    with pytest.raises(reader.rpc.RpcError, match="stale leadership epoch"):
        reader_member._receive({"name": "g", "version": 1, "data": b"y", "epoch": [4, "L"]})
    # And back: the reader's writes reopen in the writer's package.
    other.receive("back", 1, b"from the reader")
    again = writer.sdfs.MemberStore(tmp_path / "m0")
    assert again.read("back", 1) == b"from the reader"
    assert again.inventory() == reader.sdfs.MemberStore(tmp_path / "m0").inventory()


# ---------------------------------------------------------------------------
# scheduler/dataset.py
# ---------------------------------------------------------------------------


def make_corpus(tmp_path, n):
    from PIL import Image

    data = tmp_path / "seed_corpus"
    rng = np.random.default_rng(5)
    for i in range(n):
        d = data / f"n{i:08d}"
        d.mkdir(parents=True)
        Image.fromarray(rng.integers(0, 256, (32, 32, 3), np.uint8)).save(d / "x.jpg")
    return data


def test_sdfs_image_source_pull_and_cache(pkg, tmp_path):
    data = make_corpus(tmp_path, 4)
    net = pkg.rpc.SimRpcNetwork()
    stores = {}
    for m in ("m0", "m1"):
        stores[m] = pkg.sdfs.MemberStore(tmp_path / m)
        net.serve(m, pkg.sdfs.SdfsMember(stores[m], net.client(m)).methods())
    net.serve("L", pkg.sdfs.SdfsLeader(net.client("L"), lambda: ["m0", "m1"],
                                       replication_factor=2).methods())
    client = pkg.sdfs.SdfsClient(net.client("m0"), "L", stores["m0"], "m0")

    assert pkg.dataset.publish_corpus(client, data) == 4
    assert client.ls(pkg.dataset.sdfs_image_name("n00000002")) != {}
    assert pkg.dataset.sdfs_image_name("n00000002") == JAX.dataset.sdfs_image_name("n00000002")
    source = pkg.dataset.SdfsImageSource(client, tmp_path / "cache")
    paths = source([f"n{i:08d}" for i in range(4)])
    assert all(p.exists() for p in paths)
    assert paths[0].read_bytes() == (data / "n00000000" / "x.jpg").read_bytes()

    calls_before = len(net.calls)
    again = source(["n00000000"])
    assert again[0] == paths[0]
    assert len(net.calls) == calls_before


def test_port_image_source_pulls_from_a_jax_fleet(tmp_path):
    """A port member's SdfsImageSource pulls the images a JAX client
    published into a JAX fleet, over TCP."""
    data = make_corpus(tmp_path, 3)
    rpc, servers, stores, addrs, leader = tcp_fleet(JAX, tmp_path / "fleet", 3, 2)
    try:
        publisher = JAX.sdfs.SdfsClient(rpc, leader, stores[addrs[0]], addrs[0])
        assert JAX.dataset.publish_corpus(publisher, data) == 3
        pstore = PORT.sdfs.MemberStore(tmp_path / "port_member")
        prpc = PORT.rpc.TcpRpc()
        servers.append(PORT.rpc.TcpRpcServer("127.0.0.1", 0,
                                             PORT.sdfs.SdfsMember(pstore, prpc).methods()))
        client = PORT.sdfs.SdfsClient(prpc, leader, pstore, servers[-1].address)
        paths = PORT.dataset.SdfsImageSource(client, tmp_path / "cache")(
            [f"n{i:08d}" for i in (2, 0, 2)])
        assert [p.read_bytes() for p in paths] == [
            (data / f"n{i:08d}" / "x.jpg").read_bytes() for i in (2, 0, 2)]
    finally:
        for s in servers:
            s.close()
