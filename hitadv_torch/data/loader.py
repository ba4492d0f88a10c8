"""Threaded prefetching batch loader: the input pipeline (port of
`hitadv_tpu/data/loader.py`).

Replaces the reference's ``torch.utils.data.DataLoader(num_workers=10)``
(`eval.py:90`): a pool of reader threads parses samples while the card
computes, bounded queues hold ready batches, and the batches come out in
order. Threads, not forked workers: a forked worker would copy the global
``np.random`` state and each dataset's ``RandomState``, so that
`modelnet.fps_numpy`'s random start and ShapeNetPart's resample would
repeat across workers. The txt datasets can parse through the native
parser of `hitadv_torch/runtime`.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from hitadv_torch.parallel.mesh import put_batch


def batch_iterator(dataset, batch_size: int, shuffle: bool = False,
                   drop_last: bool = False,
                   rng: Optional[np.random.RandomState] = None,
                   num_workers: int = 0,
                   prefetch: int = 4
                   ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield ``(points [B, N, C], labels [B])`` batches.

    ``dataset`` implements ``__len__``/``__getitem__ -> (points, label)``.
    ``num_workers > 0`` enables threaded sample loading with a bounded
    prefetch queue (IO/parse overlap; numpy releases the GIL in loadtxt's
    C core and the native parser entirely).
    """
    n = len(dataset)
    order = np.arange(n)
    if shuffle:
        (rng or np.random).shuffle(order)

    batches = [order[i:i + batch_size]
               for i in range(0, n, batch_size)]
    if drop_last and batches and len(batches[-1]) < batch_size:
        batches.pop()

    def assemble(idx_batch) -> Tuple[np.ndarray, np.ndarray]:
        samples = [dataset[int(i)] for i in idx_batch]
        pts = np.stack([s[0] for s in samples])
        labels = np.asarray([s[1] for s in samples], np.int32)
        return pts, labels

    if num_workers <= 0:
        for idx_batch in batches:
            yield assemble(idx_batch)
        return

    # batch i comes from worker i % num_workers, through that worker's
    # bounded queue: the consumer takes them in order; a worker's error
    # is put in its queue and raised here
    stop = threading.Event()
    chunks = [batches[i::num_workers] for i in range(num_workers)]
    out_queues = [queue.Queue(maxsize=prefetch) for _ in range(num_workers)]

    def chunk_worker(wid):
        try:
            for idx_batch in chunks[wid]:
                if stop.is_set():
                    return
                out_queues[wid].put(assemble(idx_batch))
        except Exception as e:
            out_queues[wid].put(e)

    for wid in range(num_workers):
        threading.Thread(target=chunk_worker, args=(wid,),
                         daemon=True).start()

    try:
        for i in range(len(batches)):
            item = out_queues[i % num_workers].get()
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()


def device_put_batches(batches: Iterable, device="cuda", group=None):
    """Copy each ``(points, labels)`` batch to ``device`` as it is yielded
    (f32 points, int64 labels).

    With a process ``group`` (`parallel.mesh`), each batch is placed for
    `shard_attack` by `put_batch`: on one host every rank iterates its own
    loader and takes rank 0's batch (a broadcast), so that the ranks
    attack one global batch even where a threaded loader's draws depend
    on thread timing (`ROADMAP.md` §3); across hosts the loader's batch
    is this host's shard, and every rank of the host takes its first
    rank's."""
    for pts, labels in batches:
        pts = torch.as_tensor(pts, dtype=torch.float32).to(device)
        labels = torch.as_tensor(labels).to(device).long()
        if group is not None:
            pts, labels = put_batch(pts, group), put_batch(labels, group)
        yield pts, labels
