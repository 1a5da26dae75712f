"""The port's thread->core binder (wukong_tpu_torch/runtime/bind.py) against
the JAX package's on the same inputs: cpulist parsing, a core.bind file's
tid->core map, the default round-robin, and ``bind_thread`` doing nothing
while binding is off; the engine pool's threads and the console's --bind
reach it."""

import os

import pytest

from wukong_tpu.runtime import bind as jbind
from wukong_tpu_torch.runtime import bind


@pytest.mark.parametrize("text", ["0-3,8,10-11", "5", "", "0-0", " 2,4-6\n",
                                  "7,1-2"])
def test_parse_cpulist_equals_jax(text):
    assert bind._parse_cpulist(text) == jbind._parse_cpulist(text)


def _binders(topo):
    """Both binders over the same topology (nodes of core lists)."""
    out = []
    for mod in (bind, jbind):
        b = mod.CoreBinder()
        b.cpu_topo = [list(n) for n in topo]
        b.default_bindings = [c for n in topo for c in n]
        out.append(b)
    return out


@pytest.mark.parametrize("topo", [[[0, 1, 2, 3]], [[0, 1], [2, 3]],
                                  [[0, 2, 4], [1, 3, 5], [6, 7]]])
def test_core_bind_file_maps_like_jax(tmp_path, topo):
    path = tmp_path / "core.bind"
    path.write_text("# engines on node 0 first\n0 1 2\n\n3 4\n5 6 7 8\n")
    port, jax_ = _binders(topo)
    assert port.load_core_binding(str(path))
    assert jax_.load_core_binding(str(path))
    assert port.core_bindings == jax_.core_bindings
    assert port.enabled and jax_.enabled
    for tid in range(12):
        assert port.core_of(tid) == jax_.core_of(tid)


def test_missing_file_leaves_binding_off(tmp_path):
    port, jax_ = _binders([[0, 1]])
    missing = str(tmp_path / "nope.bind")
    assert port.load_core_binding(missing) is False
    assert jax_.load_core_binding(missing) is False
    assert not port.enabled and not port.core_bindings


def test_bind_thread_is_a_no_op_while_binding_is_off(monkeypatch):
    b = bind.CoreBinder()
    assert not b.enabled
    calls = []
    monkeypatch.setattr(b, "bind_to_core", lambda core: calls.append(core))
    assert b.bind_thread(0) is False and b.bind_thread(3) is False
    assert calls == []


def test_bind_thread_pins_by_the_map_when_on(monkeypatch):
    b, _j = _binders([[4, 5], [6, 7]])
    b.core_bindings = {0: 6}
    b.enabled = True
    calls = []
    monkeypatch.setattr(b, "bind_to_core",
                        lambda core: calls.append(core) or True)
    assert b.bind_thread(0) and b.bind_thread(1)
    assert calls == [6, 5]  # the file's map, then the default round-robin


def test_topology_covers_the_usable_cores():
    b, jb = bind.CoreBinder(), jbind.CoreBinder()
    assert b.cpu_topo == jb.cpu_topo
    assert b.default_bindings == jb.default_bindings
    if hasattr(os, "sched_getaffinity"):
        assert set(b.default_bindings) <= set(os.sched_getaffinity(0))


def test_pool_threads_and_console_reach_the_binder(monkeypatch, tmp_path):
    from wukong_tpu_torch.runtime import console
    from wukong_tpu_torch.runtime.scheduler import EnginePool

    seen = []

    class Spy:
        def bind_thread(self, tid):
            seen.append(tid)
            return False

        def load_core_binding(self, fname):
            seen.append(fname)
            return True

    monkeypatch.setattr(bind, "get_binder", lambda: Spy())
    pool = EnginePool(num_engines=2, make_engine=lambda tid: object())
    pool.start()
    try:
        for _ in range(200):
            if len(seen) >= 2:
                break
            import time

            time.sleep(0.01)
    finally:
        pool.stop()
    assert sorted(seen) == [0, 1]
    cfg = tmp_path / "config"
    cfg.write_text("global_num_engines 1\n")
    with pytest.raises(SystemExit):  # argparse: the dataset is missing
        console.main([str(cfg), "-b", str(tmp_path / "core.bind")])
    seen.clear()
    monkeypatch.setattr(console, "load_config", lambda path: None)

    class Stop(Exception):
        pass

    def stop(_d):
        raise Stop

    monkeypatch.setattr("wukong_tpu_torch.loader.hdfs.resolve_dataset_dir",
                        stop)
    with pytest.raises(Stop):
        console.main([str(cfg), str(tmp_path), "-b", "core.bind"])
    assert seen == ["core.bind"]
