"""Dataset distribution through SDFS: corpus shards staged member-to-member.

Copied from ``dmlc_tpu/scheduler/dataset.py`` (the whole module), over
this package's ``ops/preprocess.py``.

BASELINE.json's distributed config is "AlexNet ImageNet-1k distributed
inference, 4-node SDFS shard", and the north star stages batches "from the
SDFS get path straight into HBM". The reference sidesteps this by requiring
the full fixture corpus pre-installed on every VM (src/services.rs:485-490);
here the corpus is *published once* into the replicated store and members
pull exactly the class images their shards need, caching them on local disk:

- ``publish_corpus`` — one SDFS file per class image (``data/<synset>``),
  placed rf-ways by the leader like any other file.
- ``SdfsImageSource`` — member-side resolver: local cache hit, else a
  replica pull through the ordinary SDFS ``get`` path, then disk cache. An
  EngineBackend wired with one serves shards on a node with NO local
  corpus; the decode/stream pipeline lifts the cached files host->HBM.
"""

from __future__ import annotations

import logging
import threading
from pathlib import Path

from dmlc_tpu_torch.ops import preprocess as pp

log = logging.getLogger(__name__)


def sdfs_image_name(synset: str) -> str:
    return f"data/{synset}"


def publish_corpus(sdfs_client, data_dir: str | Path, synsets=None) -> int:
    """Put each class's fixture image into SDFS (the reference serves the
    first image per class dir, services.rs:485-490). Returns #published.
    ``synsets`` limits/orders the classes; default = every subdirectory."""
    data_dir = Path(data_dir)
    if synsets is None:
        synsets = sorted(d.name for d in data_dir.iterdir() if d.is_dir())
    n = 0
    for synset in synsets:
        path = pp.class_image_path(data_dir, synset)
        sdfs_client.put_bytes(path.read_bytes(), sdfs_image_name(synset))
        n += 1
    log.info("published %d class images into SDFS", n)
    return n


class SdfsImageSource:
    """Resolve synset ids to LOCAL image paths, pulling misses from SDFS.

    Drop-in for the data_dir lookup in EngineBackend: callable mapping a
    synset list to paths. Pulled bytes are cached under ``cache_dir`` so
    each class image crosses the network once per node, not once per shard.
    """

    def __init__(self, sdfs_client, cache_dir: str | Path):
        self.sdfs = sdfs_client
        self.cache_dir = Path(cache_dir)
        self.cache_dir.mkdir(parents=True, exist_ok=True)
        self._lock = threading.Lock()

    def path_for(self, synset: str) -> Path:
        local = self.cache_dir / f"{synset}.img"
        if local.exists():
            return local
        with self._lock:
            if local.exists():  # raced another shard for the same class
                return local
            # dmlc-lint: disable=L1 -- cache-fill lock: the pull IS the critical section (one network fetch per class image; racing shards for the same class must wait for the bytes, not re-pull)
            _, data = self.sdfs.get_bytes(sdfs_image_name(synset))
            tmp = local.with_suffix(".tmp")
            tmp.write_bytes(data)
            tmp.rename(local)  # atomic: readers never see torn bytes
        return local

    def __call__(self, synsets) -> list[Path]:
        return [self.path_for(s) for s in synsets]
