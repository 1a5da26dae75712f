"""Dataset loading: an id-format directory -> triples, attributes, stores.

The port's copy of ``load_triples``, ``load_attr_triples`` and
``load_dataset`` of the JAX package's loader/base.py, the reference's loader
pipeline
(core/loader/base_loader.hpp + posix_loader.hpp) on one host. Inputs:

- ``id_triples.npy``: one packed [M, 3] array (the fast path), or
  ``id_triples_*.npy`` chunks;
- ``id_*.nt`` text files of "s\\tp\\to" rows (the reference's format);
- ``attr_*.nt`` text files of "s\\ta\\ttype\\tvalue" rows (attributes).

``build_partition`` (store/gstore.py) builds the partition from them;
``load_dataset`` does both for every worker. An ``hdfs://`` directory is
staged locally first by loader/hdfs.py. Presharding
(``preshard_dataset``, ``load_host_partitions``) waits for the distributed
engine (ROADMAP §A, "``parallel/``, the distributed engine").
"""

from __future__ import annotations

import glob
import os

import numpy as np

from wukong_tpu_torch.store.gstore import build_partition
from wukong_tpu_torch.utils.logger import log_info
from wukong_tpu_torch.utils.timer import StopWatch


def load_triples(dataset_dir: str) -> np.ndarray:
    """All id triples of a dataset directory as an int64 [M, 3] array."""
    npy = os.path.join(dataset_dir, "id_triples.npy")
    if os.path.exists(npy):
        return np.load(npy)
    chunks = sorted(glob.glob(os.path.join(dataset_dir, "id_triples_*.npy")))
    if chunks:
        maps = [np.load(c, mmap_mode="r") for c in chunks]
        out = np.empty((sum(len(m) for m in maps), 3), dtype=np.int64)
        at = 0
        for m in maps:
            out[at:at + len(m)] = m
            at += len(m)
        return out
    files = sorted(glob.glob(os.path.join(dataset_dir, "id_*.nt")))
    if not files:
        raise FileNotFoundError(f"no id_triples.npy or id_*.nt in {dataset_dir}")
    from wukong_tpu_torch.native import parse_id_triples

    parts = []
    for path in files:
        arr = parse_id_triples(path)  # native mmap parser, loadtxt fallback
        if arr.size:
            parts.append(arr.reshape(-1, 3))
    return np.concatenate(parts) if parts else np.empty((0, 3), dtype=np.int64)


def load_attr_triples(dataset_dir: str):
    """The attributes of a dataset directory as the column tuple
    (subjects, attribute ids, value-type tags, values) that
    ``build_partition`` takes; values are float64 when any row's tag is a
    floating type (2, 3), else int64."""
    s, a, t, v = [], [], [], []
    for path in sorted(glob.glob(os.path.join(dataset_dir, "attr_*.nt"))):
        with open(path) as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) != 4:
                    continue
                tag = int(parts[2])
                s.append(int(parts[0]))
                a.append(int(parts[1]))
                t.append(tag)
                v.append(float(parts[3]) if tag in (2, 3) else int(parts[3]))
    vdtype = np.float64 if any(x in (2, 3) for x in t) else np.int64
    return (np.asarray(s, dtype=np.int64), np.asarray(a, dtype=np.int64),
            np.asarray(t, dtype=np.int64), np.asarray(v, dtype=vdtype))


def load_dataset(dataset_dir: str, num_workers: int,
                 versatile: bool = True) -> list:
    """Full bulk-load path: files -> [GStore per worker]."""
    sw = StopWatch()
    triples = load_triples(dataset_dir)
    attrs = load_attr_triples(dataset_dir)
    t_read = sw.restart()
    stores = [build_partition(triples, i, num_workers, attrs, versatile)
              for i in range(num_workers)]
    t_build = sw.restart()
    log_info(f"loaded {len(triples):,} triples: read {t_read / 1e6:.1f}s, "
             f"build {t_build / 1e6:.1f}s "
             f"({sum(s.memory_bytes() for s in stores) / 2**20:.1f} MiB)")
    return stores
