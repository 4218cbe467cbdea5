"""Leader failover: the total order over leadership epochs.

Copied from ``dmlc_tpu/cluster/failover.py``, ``epoch_key`` only: the SDFS
members fence writes by it (cluster/sdfs.py). ``LeaderTracker`` and
``StandbyLeader`` stand on the leader's job scheduler
(``dmlc_tpu/scheduler/jobs.py``), which this package does not have yet;
they come with it.
"""

from __future__ import annotations


def epoch_key(epoch) -> tuple[int, str]:
    """Total order over leadership epochs. An epoch is [counter, claimant]:
    counters order successive terms; the claimant address breaks the tie
    when two partitioned candidates claim the same counter — deterministic,
    so every member and every candidate agrees on which term is newer."""
    return int(epoch[0]), str(epoch[1])
