"""The slice as a whole: a port member serves job.predict, job.decode and
job.generate from a TcpRpcServer on localhost, and clients of both packages
call it over TCP. Predictions on a JPEG corpus (native decode on both sides)
must equal the JAX package's PredictWorker + EngineBackend in process on the
same JPEGs and weights; generated tokens must equal the same port worker's
in process.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_engine import BATCH, SIZE, tiny_variables
from torch_sockets import socket_time_limit  # noqa: F401  (autouse fixture)

from dmlc_tpu import native as jax_native
from dmlc_tpu.cluster.rpc import DecodeError as JaxDecodeError
from dmlc_tpu.cluster.rpc import TcpRpc as JaxTcpRpc
from dmlc_tpu.generate.worker import generate as jax_generate
from dmlc_tpu.models.registry import get_model as jax_get_model
from dmlc_tpu.scheduler.worker import EngineBackend as JaxBackend
from dmlc_tpu.scheduler.worker import PredictWorker as JaxWorker
from dmlc_tpu_torch import native
from dmlc_tpu_torch.cluster.admission import AdmissionGate
from dmlc_tpu_torch.cluster.rpc import TcpRpc, TcpRpcServer
from dmlc_tpu_torch.generate.worker import GenerateWorker, GenerationBackend, generate
from dmlc_tpu_torch.ops import preprocess as tpp
from dmlc_tpu_torch.scheduler.worker import EngineBackend, PredictWorker
from dmlc_tpu_torch.utils import corpus

CALL_S = 60.0


class LocalRpc:
    """The same worker's methods on the caller's thread."""

    def __init__(self, methods):
        self.methods = methods

    def call(self, addr, method, payload, timeout=None):
        return self.methods[method](dict(payload))


@pytest.fixture(scope="module")
def jpeg_corpus(tmp_path_factory):
    if not jax_native.ensure_built():
        pytest.skip("the JAX package's native decoder is not built (g++ or libjpeg missing)")
    root = tmp_path_factory.mktemp("tcp_corpus")
    data_dir, synset_path = corpus.generate(root, n_classes=20, images_per_class=1, size=64,
                                            seed=9)
    return data_dir, [s for s, _ in tpp.load_synset_words(synset_path)]


def test_jax_client_predicts_through_a_port_member(jpeg_corpus, monkeypatch):
    data_dir, synsets = jpeg_corpus
    variables = tiny_variables(6)
    port = EngineBackend("tinynet", data_dir, batch_size=BATCH, variables=variables,
                         dtype=torch.float32, device="cpu")
    port.warmup()
    assert native.available(), "EngineBackend.warmup did not build the native decoder"
    decoded = []
    real = native.decode_resize_batch

    def counted(paths, *args, **kw):
        decoded.append(len(paths))
        return real(paths, *args, **kw)

    monkeypatch.setattr(native, "decode_resize_batch", counted)
    ref = JaxWorker({"tinynet": JaxBackend(
        "tinynet", data_dir, batch_size=BATCH, dtype=jnp.float32,
        variables=jax.tree_util.tree_map(jnp.asarray, variables))})
    member = PredictWorker({"tinynet": port}, gate=AdmissionGate(2, 4, name="predict"))
    server = TcpRpcServer("127.0.0.1", 0, member.methods())
    try:
        rpc = JaxTcpRpc()
        for shard in (synsets, synsets[:5]):  # several batches, then one padded
            req = {"model": "tinynet", "synsets": shard}
            got = rpc.call(server.address, "job.predict", req, timeout=CALL_S)
            assert got == ref.methods()["job.predict"](req)
            assert got == member.methods()["job.predict"](req)
            assert len(got["predictions"]) == len(shard)
        blobs = [tpp.class_image_path(data_dir, s).read_bytes() for s in synsets[:6]]
        req = {"blobs": blobs, "size": SIZE}
        got = rpc.call(server.address, "job.decode", req, timeout=CALL_S)
        assert got == ref.methods()["job.decode"](req) and got["n"] == 6
        with pytest.raises(JaxDecodeError, match="indices \\[1\\]"):
            rpc.call(server.address, "job.decode", {"blobs": [blobs[0], b"junk"], "size": SIZE},
                     timeout=CALL_S)
    finally:
        server.close()
    assert sum(decoded) >= 2 * len(synsets) + 5 + 6  # every JPEG went through native
    assert member.gate.summary()["admitted"] >= 5 and member.gate.summary()["sheds"] == 0


BACKEND_KW = dict(max_slots=4, page_size=8, num_pages=128, max_prefill=16, max_waiting=64)
# Every poll over TCP is a connection on an ephemeral port: polling slowly
# keeps this test from crowding the ports other tests bind.
POLL_S = 0.02


def test_generate_over_tcp_is_token_identical(tmp_path):
    _, variables = jax_get_model("lm_small").init_params(jax.random.PRNGKey(0),
                                                         dtype=jnp.float32)
    backend = GenerationBackend("lm_small", device="cpu", **BACKEND_KW)
    backend.warmup()
    backend.load_variables(jax.tree_util.tree_map(np.asarray, variables))
    worker = GenerateWorker({"lm_small": backend})
    vocab = jax_get_model("lm_small").num_outputs
    rng = np.random.default_rng(31)
    reqs = [(rng.integers(0, vocab, size=int(rng.integers(2, 15))).tolist(),
             int(rng.integers(1, 10))) for _ in range(6)]
    server = TcpRpcServer("127.0.0.1", 0, worker.methods())
    results, errors = {}, {}

    def run(key, i):
        prompt, n = reqs[i]
        try:
            if key == "port_tcp":
                results[key, i] = generate(TcpRpc(), server.address, "lm_small", prompt,
                                           max_new_tokens=n, poll_interval_s=POLL_S)
            elif key == "jax_tcp":
                results[key, i] = jax_generate(JaxTcpRpc(), server.address, "lm_small", prompt,
                                               max_new_tokens=n, poll_interval_s=POLL_S)
            else:
                results[key, i] = generate(LocalRpc(worker.methods()), "member", "lm_small",
                                           prompt, max_new_tokens=n, poll_interval_s=POLL_S)
        except Exception as e:  # collected and asserted below
            errors[key, i] = e

    try:
        threads = [threading.Thread(target=run, args=(key, i))
                   for key in ("port_tcp", "jax_tcp", "local") for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=CALL_S)
        assert not any(t.is_alive() for t in threads)
    finally:
        server.close()
        backend.stop()
    assert not errors, errors
    for i, (_, n) in enumerate(reqs):
        assert len(results["local", i]) == n
        assert results["port_tcp", i] == results["jax_tcp", i] == results["local", i], i
