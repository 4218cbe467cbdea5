"""The cluster and scheduler modules of both packages side by side, for tests that run
one case against each (``pkg`` fixture: ``jax`` and ``port``)."""

from types import SimpleNamespace

import pytest

import dmlc_tpu.cluster.diskio as jax_diskio
import dmlc_tpu.cluster.failover as jax_failover
import dmlc_tpu.cluster.faults as jax_faults
import dmlc_tpu.cluster.flight as jax_flight
import dmlc_tpu.cluster.rpc as jax_rpc
import dmlc_tpu.cluster.sdfs as jax_sdfs
import dmlc_tpu.cluster.tenant as jax_tenant
import dmlc_tpu.cluster.transport as jax_transport
import dmlc_tpu.scheduler.dataset as jax_dataset
import dmlc_tpu.scheduler.jobs as jax_jobs
import dmlc_tpu.scheduler.worker as jax_worker
import dmlc_tpu.utils.config as jax_config
import dmlc_tpu.utils.metrics as jax_metrics
import dmlc_tpu_torch.cluster.diskio as port_diskio
import dmlc_tpu_torch.cluster.failover as port_failover
import dmlc_tpu_torch.cluster.faults as port_faults
import dmlc_tpu_torch.cluster.flight as port_flight
import dmlc_tpu_torch.cluster.rpc as port_rpc
import dmlc_tpu_torch.cluster.sdfs as port_sdfs
import dmlc_tpu_torch.cluster.tenant as port_tenant
import dmlc_tpu_torch.cluster.transport as port_transport
import dmlc_tpu_torch.scheduler.dataset as port_dataset
import dmlc_tpu_torch.scheduler.jobs as port_jobs
import dmlc_tpu_torch.scheduler.worker as port_worker
import dmlc_tpu_torch.utils.config as port_config
import dmlc_tpu_torch.utils.metrics as port_metrics

SIDES = {
    "jax": SimpleNamespace(name="jax", diskio=jax_diskio, faults=jax_faults, flight=jax_flight,
                           rpc=jax_rpc, sdfs=jax_sdfs, transport=jax_transport,
                           dataset=jax_dataset, worker=jax_worker, config=jax_config,
                           tenant=jax_tenant, metrics=jax_metrics, jobs=jax_jobs,
                           failover=jax_failover),
    "port": SimpleNamespace(name="port", diskio=port_diskio, faults=port_faults,
                            flight=port_flight, rpc=port_rpc, sdfs=port_sdfs,
                            transport=port_transport, dataset=port_dataset, worker=port_worker,
                            config=port_config, tenant=port_tenant, metrics=port_metrics,
                            jobs=port_jobs, failover=port_failover),
}
JAX, PORT = SIDES["jax"], SIDES["port"]


@pytest.fixture(params=sorted(SIDES))
def pkg(request):
    """One package's modules; each case runs once against each."""
    return SIDES[request.param]
