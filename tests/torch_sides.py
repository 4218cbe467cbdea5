"""The cluster and scheduler modules of both packages side by side, for tests that run
one case against each (``pkg`` fixture: ``jax`` and ``port``).

``bind_sides`` serves test modules kept as their reference in the JAX
package's tests is: the module imports the JAX package's names as the
reference does, and an autouse fixture rebinds each of them, for the length
of one case, to the object of the same name in the package under test.
"""

from types import SimpleNamespace

import pytest

import dmlc_tpu.cli as jax_cli
import dmlc_tpu.cluster.admission as jax_admission
import dmlc_tpu.cluster.critpath as jax_critpath
import dmlc_tpu.cluster.decodetier as jax_decodetier
import dmlc_tpu.cluster.devicemon as jax_devicemon
import dmlc_tpu.cluster.diskio as jax_diskio
import dmlc_tpu.cluster.failover as jax_failover
import dmlc_tpu.cluster.faults as jax_faults
import dmlc_tpu.cluster.flight as jax_flight
import dmlc_tpu.cluster.localcluster as jax_localcluster
import dmlc_tpu.cluster.observe as jax_observe
import dmlc_tpu.cluster.profile as jax_profile
import dmlc_tpu.cluster.retrypolicy as jax_retrypolicy
import dmlc_tpu.cluster.rpc as jax_rpc
import dmlc_tpu.cluster.scrapetree as jax_scrapetree
import dmlc_tpu.cluster.sdfs as jax_sdfs
import dmlc_tpu.cluster.sentinel as jax_sentinel
import dmlc_tpu.cluster.tenant as jax_tenant
import dmlc_tpu.cluster.tracectx as jax_tracectx
import dmlc_tpu.cluster.transport as jax_transport
import dmlc_tpu.generate.slots as jax_slots
import dmlc_tpu.generate.worker as jax_genworker
import dmlc_tpu.loadgen as jax_loadgen
import dmlc_tpu.ops.device_resize as jax_device_resize
import dmlc_tpu.ops.preprocess as jax_preprocess
import dmlc_tpu.scheduler.autoscaler as jax_autoscaler
import dmlc_tpu.scheduler.dataset as jax_dataset
import dmlc_tpu.scheduler.genrouter as jax_genrouter
import dmlc_tpu.scheduler.jobs as jax_jobs
import dmlc_tpu.scheduler.placement as jax_placement
import dmlc_tpu.scheduler.worker as jax_worker
import dmlc_tpu.utils.config as jax_config
import dmlc_tpu.utils.metrics as jax_metrics
import dmlc_tpu.utils.tracing as jax_tracing
import dmlc_tpu_torch.cli as port_cli
import dmlc_tpu_torch.cluster.admission as port_admission
import dmlc_tpu_torch.cluster.critpath as port_critpath
import dmlc_tpu_torch.cluster.decodetier as port_decodetier
import dmlc_tpu_torch.cluster.devicemon as port_devicemon
import dmlc_tpu_torch.cluster.diskio as port_diskio
import dmlc_tpu_torch.cluster.failover as port_failover
import dmlc_tpu_torch.cluster.faults as port_faults
import dmlc_tpu_torch.cluster.flight as port_flight
import dmlc_tpu_torch.cluster.localcluster as port_localcluster
import dmlc_tpu_torch.cluster.observe as port_observe
import dmlc_tpu_torch.cluster.profile as port_profile
import dmlc_tpu_torch.cluster.retrypolicy as port_retrypolicy
import dmlc_tpu_torch.cluster.rpc as port_rpc
import dmlc_tpu_torch.cluster.scrapetree as port_scrapetree
import dmlc_tpu_torch.cluster.sdfs as port_sdfs
import dmlc_tpu_torch.cluster.sentinel as port_sentinel
import dmlc_tpu_torch.cluster.tenant as port_tenant
import dmlc_tpu_torch.cluster.tracectx as port_tracectx
import dmlc_tpu_torch.cluster.transport as port_transport
import dmlc_tpu_torch.generate.slots as port_slots
import dmlc_tpu_torch.generate.worker as port_genworker
import dmlc_tpu_torch.loadgen as port_loadgen
import dmlc_tpu_torch.ops.device_resize as port_device_resize
import dmlc_tpu_torch.ops.preprocess as port_preprocess
import dmlc_tpu_torch.scheduler.autoscaler as port_autoscaler
import dmlc_tpu_torch.scheduler.dataset as port_dataset
import dmlc_tpu_torch.scheduler.genrouter as port_genrouter
import dmlc_tpu_torch.scheduler.jobs as port_jobs
import dmlc_tpu_torch.scheduler.placement as port_placement
import dmlc_tpu_torch.scheduler.worker as port_worker
import dmlc_tpu_torch.utils.config as port_config
import dmlc_tpu_torch.utils.metrics as port_metrics
import dmlc_tpu_torch.utils.tracing as port_tracing

SIDES = {
    "jax": SimpleNamespace(name="jax", diskio=jax_diskio, faults=jax_faults, flight=jax_flight,
                           rpc=jax_rpc, sdfs=jax_sdfs, transport=jax_transport,
                           dataset=jax_dataset, worker=jax_worker, config=jax_config,
                           tenant=jax_tenant, metrics=jax_metrics, jobs=jax_jobs,
                           failover=jax_failover, profile=jax_profile,
                           critpath=jax_critpath, sentinel=jax_sentinel,
                           observe=jax_observe, scrapetree=jax_scrapetree,
                           devicemon=jax_devicemon, tracing=jax_tracing,
                           tracectx=jax_tracectx, localcluster=jax_localcluster,
                           cli=jax_cli, admission=jax_admission, decodetier=jax_decodetier,
                           retrypolicy=jax_retrypolicy, slots=jax_slots,
                           genworker=jax_genworker, loadgen=jax_loadgen,
                           device_resize=jax_device_resize, preprocess=jax_preprocess,
                           autoscaler=jax_autoscaler, genrouter=jax_genrouter,
                           placement=jax_placement),
    "port": SimpleNamespace(name="port", diskio=port_diskio, faults=port_faults,
                            flight=port_flight, rpc=port_rpc, sdfs=port_sdfs,
                            transport=port_transport, dataset=port_dataset, worker=port_worker,
                            config=port_config, tenant=port_tenant, metrics=port_metrics,
                            jobs=port_jobs, failover=port_failover, profile=port_profile,
                            critpath=port_critpath, sentinel=port_sentinel,
                            observe=port_observe, scrapetree=port_scrapetree,
                            devicemon=port_devicemon, tracing=port_tracing,
                            tracectx=port_tracectx, localcluster=port_localcluster,
                            cli=port_cli, admission=port_admission, decodetier=port_decodetier,
                            retrypolicy=port_retrypolicy, slots=port_slots,
                            genworker=port_genworker, loadgen=port_loadgen,
                            device_resize=port_device_resize, preprocess=port_preprocess,
                            autoscaler=port_autoscaler, genrouter=port_genrouter,
                            placement=port_placement),
}
JAX, PORT = SIDES["jax"], SIDES["port"]


@pytest.fixture(params=sorted(SIDES))
def pkg(request):
    """One package's modules; each case runs once against each."""
    return SIDES[request.param]


def bind_sides(namespace: dict, names: dict[str, str]):
    """An autouse fixture, parametrised by ``pkg``, that binds each name of
    ``names`` (name -> the ``SIDES`` attribute of the module that holds it,
    or None for a name that is itself such a module) in ``namespace`` (a
    test module's globals) to that object of the package under test, for
    the length of each case. Assign it to a name of the test module."""

    @pytest.fixture(autouse=True)
    def sided(pkg, monkeypatch):
        for name, module in names.items():
            value = getattr(pkg, name) if module is None else getattr(getattr(pkg, module), name)
            monkeypatch.setitem(namespace, name, value)
        return pkg

    return sided
