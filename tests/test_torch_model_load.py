"""The weights loop on a port member, over TCP on localhost: weights
published into the SDFS by a client of either package are hot-loaded by
``model.load`` (scheduler/worker.ModelLoader), after which the member's
``job.predict``, served from images it pulls from the same store, answers
what those weights answer. The constant-class weights of
tests/test_weights_loop.py make that answer exact: every image predicts
``TARGET_CLASS``.

Also: ModelLoader's errors carry the JAX package's texts, a refused blob
leaves the served weights as they were, and the ``extra`` table hot-loads
a generation backend.

Every store lives under ``tmp_path``; every server binds port 0 and is
closed in ``finally``; every socket test runs under ``torch_sockets``'
time limit.
"""

import jax
import numpy as np
import pytest
import torch
from test_torch_engine import BATCH  # registers tinynet in both packages
from torch_sides import JAX, PORT
from torch_sockets import socket_time_limit  # noqa: F401  (autouse fixture)

from dmlc_tpu.models import registry as jax_registry
from dmlc_tpu.models import weights as jax_weights
from dmlc_tpu_torch.generate.worker import GenerationBackend
from dmlc_tpu_torch.models import convert
from dmlc_tpu_torch.models import weights
from dmlc_tpu_torch.ops import preprocess as pp
from dmlc_tpu_torch.utils import corpus

TARGET_CLASS = 7
CALL_S = 60.0


def constant_prediction_variables(target: int = TARGET_CLASS):
    """Weights that predict ``target`` for every input: zero everything,
    put a spike in the head bias (tests/test_weights_loop.py)."""
    template = jax_weights.variables_template("tinynet")
    variables = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), template)
    variables["params"]["head"]["bias"][target] = 5.0
    return variables


class Fleet:
    """A leader and two SDFS members of ``leader_pkg``, one port member that
    also serves job.predict (tinynet, no local corpus: its images come
    from the store) and model.load from the same server, and a publishing
    client of ``client_pkg`` with a store of its own."""

    def __init__(self, tmp_path, leader_pkg, client_pkg):
        self.servers = []
        addrs = []
        for i in range(2):
            store = leader_pkg.sdfs.MemberStore(tmp_path / f"m{i}")
            member = leader_pkg.sdfs.SdfsMember(store, leader_pkg.rpc.TcpRpc())
            addrs.append(self.serve(leader_pkg, member.methods()))
        self.store = PORT.sdfs.MemberStore(tmp_path / "serving")
        self.rpc = PORT.rpc.TcpRpc()
        serving_sdfs = PORT.sdfs.SdfsMember(self.store, self.rpc)
        methods = dict(serving_sdfs.methods())
        self.server = PORT.rpc.TcpRpcServer("127.0.0.1", 0, methods)
        self.servers.append(self.server)
        addrs.append(self.server.address)
        leader = leader_pkg.sdfs.SdfsLeader(leader_pkg.rpc.TcpRpc(), lambda: list(addrs),
                                            replication_factor=3)
        self.leader = self.serve(leader_pkg, leader.methods())
        cstore = client_pkg.sdfs.MemberStore(tmp_path / "client")
        crpc = client_pkg.rpc.TcpRpc()
        caddr = self.serve(client_pkg, client_pkg.sdfs.SdfsMember(cstore, crpc).methods())
        self.client = client_pkg.sdfs.SdfsClient(crpc, self.leader, cstore, caddr)
        # The serving member's own view of the store, for its image source.
        own = PORT.sdfs.SdfsClient(self.rpc, self.leader, self.store, self.server.address)
        self.backend = PORT.worker.EngineBackend(
            "tinynet", tmp_path / "no_corpus", batch_size=BATCH, device="cpu",
            dtype=torch.float32,
            image_source=PORT.dataset.SdfsImageSource(own, tmp_path / "data_cache"))
        methods.update(PORT.worker.PredictWorker({"tinynet": self.backend}).methods())
        methods.update(PORT.worker.ModelLoader(self.store, {"tinynet": self.backend}).methods())

    def serve(self, pkg, methods) -> str:
        self.servers.append(pkg.rpc.TcpRpcServer("127.0.0.1", 0, methods))
        return self.servers[-1].address

    def call(self, method, payload):
        return self.rpc.call(self.server.address, method, payload, timeout=CALL_S)

    def close(self):
        for s in self.servers:
            s.close()


@pytest.fixture
def jpegs(tmp_path):
    data_dir, synset_path = corpus.generate(tmp_path / "corpus", n_classes=12,
                                            images_per_class=1, size=48, seed=4)
    return data_dir, [s for s, _ in pp.load_synset_words(synset_path)]


@pytest.mark.parametrize("leader_pkg,client_pkg", [(PORT, PORT), (JAX, JAX), (PORT, JAX)],
                         ids=["port_publisher", "jax_publisher", "jax_publisher_port_leader"])
def test_model_load_over_tcp_serves_the_published_weights(tmp_path, jpegs, leader_pkg,
                                                          client_pkg):
    data_dir, synsets = jpegs
    fleet = Fleet(tmp_path, leader_pkg, client_pkg)
    try:
        assert client_pkg.dataset.publish_corpus(fleet.client, data_dir, synsets) == len(synsets)
        before = fleet.call("job.predict", {"model": "tinynet", "synsets": synsets})
        assert len(before["predictions"]) == len(synsets)
        # Every image came through the store into the member's cache.
        assert sorted(p.stem for p in (tmp_path / "data_cache").glob("*.img")) == sorted(synsets)

        publish = (weights if client_pkg is PORT else jax_weights).publish_weights
        variables = constant_prediction_variables()
        assert publish(fleet.client, "tinynet", variables) == 1
        # rf 3 over 3 members: the serving member holds the blob.
        assert fleet.store.listing()["models/tinynet"] == [1]
        assert fleet.store.read("models/tinynet", 1) == jax_weights.weights_to_bytes(
            "tinynet", variables)
        reply = fleet.call("model.load", {"model": "tinynet", "version": 1})
        assert reply == {"model": "tinynet", "version": 1}
        after = fleet.call("job.predict", {"model": "tinynet", "synsets": synsets})
        assert after["predictions"] == [TARGET_CLASS] * len(synsets)
        assert before["predictions"] != after["predictions"]
    finally:
        fleet.close()


class NoLoad:
    def __call__(self, synsets):
        return [0] * len(synsets)


class Recorder:
    def __init__(self):
        self.loaded = []

    def load_variables(self, variables):
        self.loaded.append(variables)


def loader_errors(pkg, tmp_path) -> list[str]:
    """Every refusal of ``model.load``, as its RpcError text."""
    store = pkg.sdfs.MemberStore(tmp_path / pkg.name)
    good = jax_weights.weights_to_bytes("tinynet", constant_prediction_variables())
    store.receive("models/tinynet", 1, good)
    store.receive("models/tinynet", 2, b"not a blob")
    store.receive("models/tinynet", 3, good[:-40])
    store.receive("models/other", 1, good)
    loader = pkg.worker.ModelLoader(store, {"tinynet": Recorder(), "fake": NoLoad(),
                                            "other": Recorder()})
    load = loader.methods()["model.load"]
    texts = []
    for payload in ({"model": "absent", "version": 1}, {"model": "fake", "version": 1},
                    {"model": "tinynet", "version": 9}, {"model": "tinynet", "version": 2},
                    {"model": "other", "version": 1}):
        with pytest.raises(pkg.rpc.RpcError) as e:
            load(payload)
        texts.append(str(e.value))
    with pytest.raises(Exception) as e:
        load({"model": "tinynet", "version": 3})
    texts.append(type(e.value).__name__)
    assert loader.backends["tinynet"].loaded == []
    assert load({"model": "tinynet", "version": 1}) == {"model": "tinynet", "version": 1}
    assert len(loader.backends["tinynet"].loaded) == 1
    return texts


def test_model_load_errors_are_the_jax_texts(tmp_path):
    got, want = loader_errors(PORT, tmp_path), loader_errors(JAX, tmp_path)
    assert got == want
    assert want[0] == "model 'absent' not served here"
    assert "does not support weight loading" in want[1]
    assert "bad weights blob models/tinynet v2: not a dmlc weights blob" in want[3]
    assert "weights are for 'tinynet', expected 'other'" in want[4]


def test_refused_blob_leaves_the_served_weights(tmp_path):
    store = PORT.sdfs.MemberStore(tmp_path / "s")
    bad = jax_weights.variables_template("tinynet")
    bad = jax.tree_util.tree_map(lambda s: np.ones(s.shape, s.dtype), bad)
    blob = bytearray(jax_weights.weights_to_bytes("tinynet", bad))
    blob[:8] = b"DMLCWTS0"
    store.receive("models/tinynet", 1, bytes(blob))
    backend = PORT.worker.EngineBackend("tinynet", tmp_path, batch_size=BATCH, device="cpu",
                                        dtype=torch.float32)
    loader = PORT.worker.ModelLoader(store, {"tinynet": backend})
    backend.warmup()
    before = {k: v.clone() for k, v in backend.engine.model.state_dict().items()}
    with pytest.raises(PORT.rpc.RpcError, match="bad magic"):
        loader.methods()["model.load"]({"model": "tinynet", "version": 1})
    after = backend.engine.model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)


def test_extra_table_hot_loads_a_generation_backend(tmp_path):
    _, variables = jax_registry.get_model("lm_small").init_params(jax.random.PRNGKey(3))
    variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), variables)
    store = PORT.sdfs.MemberStore(tmp_path / "s")
    store.receive("models/lm_small", 4, jax_weights.weights_to_bytes("lm_small", variables))
    backend = GenerationBackend("lm_small", max_slots=2, page_size=8, num_pages=16,
                                max_prefill=16, device="cpu")
    loader = PORT.worker.ModelLoader(store, {"tinynet": Recorder()},
                                     extra={"lm_small": backend})
    try:
        assert loader.methods()["model.load"]({"model": "lm_small", "version": 4}) == {
            "model": "lm_small", "version": 4}
        want = convert.lm_from_jax(variables)
        got = backend._ensure().engine.model.state_dict()
        assert all(torch.equal(got[k].cpu(), want[k]) for k in want)
    finally:
        backend.stop()
