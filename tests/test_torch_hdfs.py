"""The port's HDFS dataset source (wukong_tpu_torch/loader/hdfs.py) against
the JAX package's, through a fake ``hdfs`` CLI on PATH that serves files out
of a local directory (tests/test_hdfs_loader.py's fake client): with no
client both refuse with the same error; the staging directory, the warm
cache, the skipped subdirectory and the empty-remote refusal match; the
``hdfs.read`` fault site is retried through; and the port's console boots
from an ``hdfs://`` dataset and answers the JAX console's rows."""

import os
import re
import stat

import numpy as np
import pytest

from wukong_tpu.loader import hdfs as jh
from wukong_tpu.utils.errors import WukongError as JError
from wukong_tpu_torch.loader import hdfs as ph
from wukong_tpu_torch.loader.base import load_triples
from wukong_tpu_torch.runtime import faults
from wukong_tpu_torch.utils.errors import ErrorCode, WukongError

from test_hdfs_loader import FAKE_HDFS


@pytest.fixture
def fake_hdfs(tmp_path, monkeypatch):
    """The fake CLI and a remote root, with both packages' probe caches
    reset."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    exe = bindir / "hdfs"
    exe.write_text(FAKE_HDFS)
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    root = tmp_path / "remote"
    (root / "data").mkdir(parents=True)
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")
    monkeypatch.setenv("FAKE_HDFS_ROOT", str(root))
    monkeypatch.delenv("WUKONG_HDFS_CMD", raising=False)
    old = dict(ph._state), dict(jh._state)
    for st in (ph._state, jh._state):
        st.update(cmd=None, probed=False)
    yield root / "data"
    ph._state.update(old[0])
    jh._state.update(old[1])


def _write_remote(d, triples):
    np.save(str(d / "id_triples.npy"), np.asarray(triples, dtype=np.int64))
    (d / "str_index").write_text("<p1>\t131073\n")
    (d / "ignored.log").write_text("not a dataset file\n")


def test_refused_with_the_jax_error_when_no_client(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("WUKONG_HDFS_CMD", raising=False)
    old = dict(ph._state), dict(jh._state)
    for st in (ph._state, jh._state):
        st.update(cmd=None, probed=False)
    try:
        assert not ph.hdfs_available() and not jh.hdfs_available()
        with pytest.raises(WukongError) as got:
            ph.list_dir("hdfs://fake/data")
        with pytest.raises(JError) as want:
            jh.list_dir("hdfs://fake/data")
        assert got.value.code == ErrorCode.FILE_NOT_FOUND
        assert str(got.value) == str(want.value)
    finally:
        ph._state.update(old[0])
        jh._state.update(old[1])


def test_fetch_stages_as_jax_does(fake_hdfs, tmp_path):
    tri = [[200000, 131073, 200001], [200001, 131073, 200002]]
    _write_remote(fake_hdfs, tri)
    sub = fake_hdfs / "preshard"  # a directory is never fetched
    sub.mkdir()
    (sub / "junk").write_text("nested\n")
    staged = ph.fetch_dataset("hdfs://fake/data", str(tmp_path / "port"))
    jstaged = jh.fetch_dataset("hdfs://fake/data", str(tmp_path / "jax"))
    assert sorted(os.listdir(staged)) == sorted(os.listdir(jstaged)) == [
        "id_triples.npy", "str_index"]
    for f in os.listdir(staged):
        assert (open(os.path.join(staged, f), "rb").read()
                == open(os.path.join(jstaged, f), "rb").read())
    assert load_triples(staged).tolist() == tri
    # warm cache: a changed remote file is not fetched again
    np.save(str(fake_hdfs / "id_triples.npy"), np.zeros((1, 3), np.int64))
    ph.fetch_dataset("hdfs://fake/data", str(tmp_path / "port"))
    assert load_triples(staged).tolist() == tri


def _private_staging(monkeypatch, tmp_path):
    """A staging root of this test's own: the default one is keyed by the
    hdfs:// path alone, so another test's warm files would be reused."""
    import tempfile

    (tmp_path / "tmp").mkdir()
    monkeypatch.setenv("TMPDIR", str(tmp_path / "tmp"))
    monkeypatch.setattr(tempfile, "tempdir", None)


def test_resolve_and_the_staging_key(fake_hdfs, monkeypatch, tmp_path):
    _private_staging(monkeypatch, tmp_path)
    assert ph.resolve_dataset_dir("/local/path") == "/local/path"
    assert ph.is_hdfs_path("hdfs://x") and not ph.is_hdfs_path("/x")
    _write_remote(fake_hdfs, [[200000, 131073, 200001]])
    staged = ph.resolve_dataset_dir("hdfs://fake/data")
    # the same per-user root and path hash as the JAX loader's
    assert staged == jh.resolve_dataset_dir("hdfs://fake/data")
    (fake_hdfs.parent / "data_b").mkdir()
    _write_remote(fake_hdfs.parent / "data_b", [[200007, 131073, 200008]])
    staged_b = ph.resolve_dataset_dir("hdfs://fake/data_b")
    assert staged_b != staged
    assert load_triples(staged_b).tolist() == [[200007, 131073, 200008]]


def test_empty_remote_refused(fake_hdfs, tmp_path):
    (fake_hdfs / "readme.log").write_text("nothing useful\n")
    with pytest.raises(WukongError, match="holds no dataset files"):
        ph.fetch_dataset("hdfs://fake/data", str(tmp_path / "s"))


def test_read_fault_is_retried(fake_hdfs, tmp_path):
    _write_remote(fake_hdfs, [[200000, 131073, 200001]])
    faults.install(faults.parse_plan("seed=0;hdfs.read:transient,count=2"))
    try:
        staged = ph.fetch_dataset("hdfs://fake/data", str(tmp_path / "s"))
    finally:
        faults.install(None)
    assert load_triples(staged).tolist() == [[200000, 131073, 200001]]
    faults.install(faults.parse_plan("seed=0;hdfs.read:transient"))
    try:
        with pytest.raises(WukongError) as e:
            ph.list_dir("hdfs://fake/data")
    finally:
        faults.install(None)
    assert e.value.code == ErrorCode.FILE_NOT_FOUND


ROWS = re.compile(r"\(last\) result rows: (\d+)")


def test_console_boots_from_hdfs(fake_hdfs, tmp_path, capfd, monkeypatch):
    """console.main over an hdfs:// dataset (--device cpu) answers the
    JAX console's rows over the same staged directory."""
    import chip_smoke
    from wukong_tpu.config import Global as JGlobal
    from wukong_tpu.runtime import console as jconsole
    from wukong_tpu_torch.config import Global
    from wukong_tpu_torch.loader.lubm import write_dataset
    from wukong_tpu_torch.runtime import console

    for G in (Global, JGlobal):
        for name in list(vars(G)):
            monkeypatch.setattr(G, name, getattr(G, name))
    _private_staging(monkeypatch, tmp_path)
    local = tmp_path / "lubm1"
    write_dataset(str(local), 1, seed=0)
    for name in os.listdir(local):
        (fake_hdfs / name).write_bytes((local / name).read_bytes())
    cfg = tmp_path / "config"
    cfg.write_text("global_enable_planner false\n")
    q = tmp_path / "q5"
    q.write_text(chip_smoke.QUERIES["lubm_q5"])
    cmd = f"sparql -f {q} -N"
    assert console.main([str(cfg), "hdfs://fake/data", "--device", "cpu",
                         "-c", cmd]) == 0
    got = ROWS.findall(capfd.readouterr().err)
    assert jconsole.main([str(cfg), "hdfs://fake/data", "-c", cmd]) == 0
    want = ROWS.findall(capfd.readouterr().err)
    assert got == want and len(got) == 1 and int(got[0]) > 0
