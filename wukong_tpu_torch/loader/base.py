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
staged locally first by loader/hdfs.py. For a cluster the reference's
RDMA shuffle (read_partial_exchange, base_loader.hpp:165-219) moves
offline: ``preshard_dataset`` re-buckets a dataset into one file per host,
and ``load_host_partitions`` builds a host's shard range from its file
alone.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from wukong_tpu_torch.store.gstore import build_partition, check_vid_range
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


def preshard_dataset(src_dir: str, out_dir: str, num_hosts: int,
                     shards_per_host: int) -> dict:
    """Re-bucket an id dataset into per-host files: host h's file holds every
    triple whose subject OR object owner falls in h's shard range (the
    both-sides placement, base_loader.hpp:172-173), so each host builds its
    partitions from its own file. The string tables and the attribute files
    are copied whole (attributes are placed by subject when built)."""
    import json
    import shutil

    from wukong_tpu_torch.utils.mathutil import hash_mod

    os.makedirs(out_dir, exist_ok=True)
    triples = load_triples(src_dir)
    total = num_hosts * shards_per_host
    s_host = hash_mod(triples[:, 0], total) // shards_per_host
    o_host = hash_mod(triples[:, 2], total) // shards_per_host
    sizes = {}
    for h in range(num_hosts):
        rows = triples[(s_host == h) | (o_host == h)]
        np.save(os.path.join(out_dir, f"host{h:03d}_triples.npy"), rows)
        sizes[h] = int(len(rows))
    for aux in ("str_index", "str_attr_index", "str_normal",
                "str_normal_virtual"):
        src = os.path.join(src_dir, aux)
        if os.path.exists(src):
            shutil.copyfile(src, os.path.join(out_dir, aux))
    for apath in sorted(glob.glob(os.path.join(src_dir, "attr_*.nt"))):
        shutil.copyfile(apath, os.path.join(out_dir, os.path.basename(apath)))
    meta = {"num_hosts": num_hosts, "shards_per_host": shards_per_host,
            "rows_per_host": sizes}
    with open(os.path.join(out_dir, "preshard.json"), "w") as f:
        json.dump(meta, f)
    return meta


def load_host_partitions(presharded_dir: str, host_id: int,
                         versatile: bool = True) -> list:
    """One host's bulk load from a ``preshard_dataset`` directory: its own
    triple file plus the shared attribute files, built into its shard range.
    The stores carry global shard ids (sid)."""
    import json

    with open(os.path.join(presharded_dir, "preshard.json")) as f:
        meta = json.load(f)
    sph = meta["shards_per_host"]
    total = meta["num_hosts"] * sph
    rows = np.load(os.path.join(presharded_dir,
                                f"host{host_id:03d}_triples.npy"))
    attrs = load_attr_triples(presharded_dir)
    check_vid_range(rows)
    return [build_partition(rows, host_id * sph + k, total, attrs, versatile,
                            check_ids=False)
            for k in range(sph)]


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
