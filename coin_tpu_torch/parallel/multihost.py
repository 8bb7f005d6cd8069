"""Host-side traffic between processes (counterpart of
coin_tpu/parallel/multihost.py:20-84).

The reference's cross-process traffic (detectron2's comm.gather and
all_gather) maps to:
- the gradient sum and the batch-wide counts of a step: the reductions of
  ``parallel/mesh_utils``, on the step's tensors;
- the collector's union and the evaluator's gathers: pickled objects
  gathered over the default process group, here.
Without a process group every function is a no-op for one process.
"""

from __future__ import annotations

import logging
import pickle
from typing import Any, List

import torch.distributed as dist

logger = logging.getLogger(__name__)


def process_count() -> int:
    """The world size of the default process group; 1 without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def process_index() -> int:
    """This process's rank in the default process group; 0 without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def is_main_process() -> bool:
    return process_index() == 0


def all_gather_objects(obj: Any) -> List[Any]:
    """Gather an arbitrary picklable object from every process (the
    collector-union and metric-gather path), in rank order."""
    world = process_count()
    if world == 1:
        return [obj]
    # the gather pads every payload to the largest and materialises
    # world x max_payload on every host: warn before a collector union
    # silently eats tens of GB
    size = len(pickle.dumps(obj))
    gb = size * world / 2 ** 30
    if gb > 4.0:
        logger.warning(
            "all_gather_objects: ~%.1f GB gathered per host (payload "
            "%.1f MB x %d processes) — consider sharding the store merge",
            gb, size / 2 ** 20, world)
    out: List[Any] = [None] * world
    dist.all_gather_object(out, obj)
    return out


def merge_result_stores(store, chunk_bytes: int = 512 << 20):
    """Union each process's ResultStore shard into ``store`` on every
    process (replaces the collector's all_gather, gdino_collector.py:72-75).

    Stores beyond ``chunk_bytes`` of pickle are exchanged in image-id
    chunks: the padded gather materialises world x max_payload per host,
    and a BDD100K-scale store (70k images x 128 boxes) is hundreds of MB
    per rank; chunking bounds peak host memory instead of letting one
    gather eat world x store at once."""
    if process_count() == 1:
        return store
    payload_size = len(pickle.dumps(store))
    # every process must take the same branch and chunk count
    n_chunks = max(1, -(-payload_size // chunk_bytes))
    n_chunks = max(all_gather_objects(n_chunks))
    if n_chunks == 1:
        for other in all_gather_objects(store):
            store.merge(other)
        return store
    ids = sorted(store.image_ids())
    for ci in range(n_chunks):
        sub = type(store)(store.num_classes)
        sub._data = {i: store._data[i] for i in ids[ci::n_chunks]}
        for other in all_gather_objects(sub):
            store.merge(other)
    return store
