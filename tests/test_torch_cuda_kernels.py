"""Kernel tests that need a CUDA card: marked ``cuda``, they skip without
one. Run them on the card with

    python3 -m pytest -m cuda tests/test_torch_cuda_kernels.py
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

import chip_smoke
from wukong_tpu_torch.join import kernels as JK

pytestmark = pytest.mark.cuda


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_threads_probe_a_freshly_staged_keys_index():
    """Two threads probe one keys table as soon as it is staged with its
    dense index (the tiled kernel's path: C = 2^23, no glob); every mask
    equals the plain version's, round after round."""
    dev = _card()
    rng = np.random.default_rng(5)
    C, live = 1 << 23, 1 << 20
    for _round in range(4):
        keys, offsets, edges, depth = chip_smoke._lp_csr(
            rng, 100_000, 8, 1 << 22, 1 << 22)
        dk = JK.to_device_i32(keys, dev)
        index = JK.keys_index(keys, dk)
        assert index is not None  # the keys are dense enough for one
        table = (dk, JK.to_device_i32(offsets, dev),
                 JK.to_device_i32(edges, dev))
        inputs = []
        for _t in range(2):
            kx = rng.integers(0, len(keys), C)
            pick = offsets[kx] + (rng.random(C) * (offsets[kx + 1]
                                                   - offsets[kx])).astype(int)
            cand = np.where(rng.random(C) < 0.5, edges[pick],
                            rng.integers(0, 1 << 22, C))
            valid = np.zeros(C, dtype=bool)
            valid[:live] = True
            inputs.append((torch.from_numpy(valid).to(dev),
                           JK.to_device_i32(cand, dev),
                           JK.to_device_i32(keys[kx], dev)))
        got = [None, None]

        def probe(t):
            valid, cand, anchors = inputs[t]
            got[t] = JK.level_probe(valid, cand, None,
                                    [table + (anchors, depth, index)])

        threads = [threading.Thread(target=probe, args=(t,))
                   for t in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        for t, (valid, cand, anchors) in enumerate(inputs):
            want = JK.level_probe_plain(valid, cand, None,
                                        [table + (anchors, depth)])
            assert torch.equal(got[t], want)


def test_expand_rows_matches_its_plain_version():
    """expand_rows on every case of chip_smoke.expand_rows_cases (one
    launch up to a tile of rows, three past it; a strided table view kept
    strided on the card) equals expand_rows_plain on the CPU copy, three
    runs each."""
    dev = _card()
    errs = {"expand_rows": 0}
    chip_smoke.expand_rows_checks(errs)
    assert errs["expand_rows"] == 0
    assert chip_smoke.on_card(chip_smoke.expand_rows_cases()[8][1],
                              dev).stride() == (3000, 2)
