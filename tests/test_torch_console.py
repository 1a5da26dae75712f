"""The port's console against the JAX package's, on a LUBM-1 directory that
the port's ``write_dataset`` writes: ``help``, ``config``, ``logger``,
``sparql -f/-b/-v/-N/-d``, ``sparql-emu``, ``load-stat``/``store-stat``,
``load -d [-c]``, ``gsck``, ``checkpoint`` and ``recover`` (with the JAX
console's log lines and rows), an unknown verb, and
``main([... "--device", "cpu", "-c", ...])``, which reads
the config file and the directory as the JAX ``main`` does and answers the
JAX console's rows (device="cpu": every kernel's plain version). With no
``--device`` it runs on the card, so here it raises."""

import re

import pytest

import chip_smoke
from wukong_tpu.config import Global as JGlobal
from wukong_tpu.runtime import console as jconsole
from wukong_tpu_torch.config import Global
from wukong_tpu_torch.loader.lubm import write_dataset
from wukong_tpu_torch.runtime import console

ROWS = re.compile(r"\(last\) result rows: (\d+), avg latency: ([\d,]+) usec "
                  r"\((\d+) runs\)")


@pytest.fixture(autouse=True)
def _restore_globals(monkeypatch):
    """main() loads a config file into the process-wide Global of each
    package: every knob comes back after each test."""
    for G in (Global, JGlobal):
        for name in list(vars(G)):
            monkeypatch.setattr(G, name, getattr(G, name))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("console")
    d = root / "id_lubm_1"
    write_dataset(str(d), 1, seed=0)
    cfg = root / "config"
    cfg.write_text("global_num_engines 2\nglobal_enable_planner true\n"
                   "global_mt_threshold 4\n")
    for name, text in chip_smoke.QUERIES.items():
        (root / name).write_text(text)
    for name, text in chip_smoke.TEMPLATES.items():
        (root / f"tmpl_{name}").write_text(text)
    (root / "batch").write_text(
        "# the seven basic shapes\n"
        + "".join(f"sparql -f {root / n} -n 2\n" for n in chip_smoke.QUERIES))
    (root / "mix").write_text(
        f"{len(chip_smoke.TEMPLATES)} 1\n"
        + "".join(f"tmpl_{n} 1\n" for n in chip_smoke.TEMPLATES)
        + "lubm_q6 1\n")
    return root, d, cfg


def _rows_logged(err: str) -> list:
    return [int(m.group(1)) for m in ROWS.finditer(err)]


def test_main_answers_the_jax_consoles_rows(dataset, capfd):
    root, d, cfg = dataset
    cmd = f"sparql -b {root / 'batch'}"
    assert console.main([str(cfg), str(d), "--device", "cpu", "-c", cmd]) == 0
    got = capfd.readouterr().err
    assert "unknown config item ignored: global_mt_threshold" in got
    assert got.count("Run the command: sparql -f") == 7
    assert jconsole.main([str(cfg), str(d), "-c", cmd]) == 0
    want = capfd.readouterr().err
    assert _rows_logged(got) == _rows_logged(want) and len(_rows_logged(got)) == 7
    assert all(int(m.group(3)) == 2 for m in ROWS.finditer(got))


def test_main_runs_on_the_card_by_default(dataset):
    _root, d, cfg = dataset
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        console.main([str(cfg), str(d), "-c", "help"])


@pytest.fixture(scope="module")
def con(dataset):
    _root, d, cfg = dataset
    from wukong_tpu_torch.loader.base import load_attr_triples, load_triples
    from wukong_tpu_torch.runtime.proxy import Proxy
    from wukong_tpu_torch.store.gstore import build_partition
    from wukong_tpu_torch.store.string_server import StringServer

    g = build_partition(load_triples(str(d)), 0, 1,
                        attr_triples=load_attr_triples(str(d)))
    return console.Console(Proxy(g, StringServer(str(d)), device="cpu"),
                           stats_path=str(d / "statfile"))


def test_help_quit_and_unknown_verbs(con, capfd):
    assert con.run_command("help") is True
    out = capfd.readouterr().out
    for verb in ("sparql -f", "sparql -b", "sparql-emu", "config", "logger",
                 "load-stat", "store-stat", "load -d", "gsck", "checkpoint",
                 "recover", "migrate"):
        assert verb in out
    # every verb of the JAX console is ported: a verb neither console has
    assert con.run_command("frobnicate") is True
    assert "unknown command: frobnicate (try 'help')" in \
        capfd.readouterr().err
    assert con.run_command("") is True and con.run_command("quit") is False
    assert con.run_command('sparql -f "unterminated') is True
    assert "bad command" in capfd.readouterr().err


def test_config_verbs(con, capfd, tmp_path):
    con.run_command("config -s global_query_deadline_ms=250")
    assert Global.query_deadline_ms == 250
    with pytest.raises(ValueError, match="immutable"):  # as the JAX verb
        con.run_command("config -s num_engines 9")
    con.run_command("config -v")
    assert "global_query_deadline_ms\t250" in capfd.readouterr().out
    path = tmp_path / "c"
    path.write_text("global_plan_cache_size 17\n")
    con.run_command(f"config -l {path}")
    assert Global.plan_cache_size == 17
    con.run_command("config -x")
    assert "usage: config" in capfd.readouterr().err


def test_sparql_verbs(con, dataset, capfd):
    root, _d, _cfg = dataset
    q5 = root / "lubm_q5"
    con.run_command(f"sparql -f {q5} -n 3 -v 2")
    err = capfd.readouterr().err
    [rows] = _rows_logged(err)
    assert rows > 2 and "  1: <http://www.Department0.University0.edu/" in err
    for dev in ("cpu", "gpu"):
        con.run_command(f"sparql -f {q5} -N -d {dev}")
        assert _rows_logged(capfd.readouterr().err) == [rows]
    con.run_command(f"sparql -f {q5} -d dist")
    assert "no distributed engine: start with --dist" in \
        capfd.readouterr().err
    con.run_command(f"sparql -f {q5} -b {root / 'batch'}")
    assert "exclusive" in capfd.readouterr().err
    con.run_command(f"sparql -f {root / 'missing'}")
    assert "cannot read file" in capfd.readouterr().err
    con.run_command("sparql -f")  # argparse error: the REPL survives
    con.run_command("logger 5")
    con.run_command(f"sparql -f {q5}")
    assert _rows_logged(capfd.readouterr().err) == []
    con.run_command("logger 2")


def test_stat_verbs(con, capfd, tmp_path):
    con.run_command("store-stat")
    assert "no planner statistics" in capfd.readouterr().err
    from wukong_tpu_torch.loader.base import load_triples
    from wukong_tpu_torch.planner.optimizer import Planner
    from wukong_tpu_torch.planner.stats import Stats

    con.proxy.planner = Planner(Stats.generate(load_triples(
        con.proxy.str_server.dir)))
    path = tmp_path / "st"
    con.run_command(f"store-stat -f {path}")
    con.proxy.planner = None
    con.run_command(f"load-stat -f {path}")
    assert con.proxy.planner is not None
    assert con.proxy.gpu.stats is con.proxy.planner.stats
    assert "statistics loaded" in capfd.readouterr().err


def test_sparql_emu_verb(con, dataset, capfd):
    root, _d, _cfg = dataset
    con.run_command(f"sparql-emu -f {root / 'mix'} -d 0.4 -w 0.1 -b 16 -p 4")
    rep = con.last_emu
    assert rep["errors"] == 0 and rep["thpt_qps"] > 0
    assert [rep["class_mode"][c] for c in range(4)] == ["device-batch"] * 4
    assert "latency CDF" in capfd.readouterr().err


def _worlds(base):
    """(port console, JAX console) over one partition of the same triples,
    without a planner."""
    from wukong_tpu.engine.cpu import CPUEngine as JCPU
    from wukong_tpu.loader.lubm import VirtualLubmStrings
    from wukong_tpu.runtime.proxy import Proxy as JProxy
    from wukong_tpu.store.gstore import build_partition as jbuild
    from wukong_tpu_torch.loader.lubm import VirtualLubmStrings as PStrings
    from wukong_tpu_torch.runtime.proxy import Proxy
    from wukong_tpu_torch.store.gstore import build_partition

    jg = jbuild(base, 0, 1)
    return (console.Console(Proxy(build_partition(base, 0, 1),
                                  PStrings(1, seed=0), device="cpu")),
            jconsole.Console(JProxy(jg, VirtualLubmStrings(1, seed=0),
                                    JCPU(jg, VirtualLubmStrings(1, seed=0)))))


def test_load_gsck_checkpoint_recover_verbs(dataset, capfd, tmp_path):
    """Both consoles over the same 90% of LUBM-1: `load -d` of the other
    10% gives the JAX console's rows and log line, `-c` again adds nothing,
    gsck passes, and after `checkpoint`, one more load and a restart from
    the base, `recover` restores the JAX console's rows and replay count."""
    import numpy as np

    from wukong_tpu.store import wal as jwal
    from wukong_tpu_torch.loader.lubm import generate_lubm
    from wukong_tpu_torch.store import wal

    root, _d, _cfg = dataset
    triples, _ = generate_lubm(1, seed=0)
    keep = np.random.default_rng(4).random(len(triples)) < 0.9
    base, delta = triples[keep], triples[~keep]
    half = len(delta) // 2
    dirs = [chip_smoke.write_ids(str(tmp_path / n), part) for n, part in
            (("d0", delta[:half]), ("d1", delta[half:]))]
    q5 = f"sparql -f {root / 'lubm_q5'} -N"
    logs = {}
    for side, G in (("port", Global), ("jax", JGlobal)):
        G.wal_dir = str(tmp_path / side / "wal")
        G.checkpoint_dir = str(tmp_path / side / "ckpt")
    try:
        pc, jc = _worlds(base)
        for c, side in ((pc, "port"), (jc, "jax")):
            for cmd in (f"load -d {dirs[0]}", q5, f"load -d {dirs[0]} -c",
                        "gsck", "gsck -i", "checkpoint", f"load -d {dirs[1]}",
                        q5, "recover -d 1"):
                c.run_command(cmd)
            logs[side] = capfd.readouterr().err
        wal.reset_wal()
        jwal.reset_wal()
        pc, jc = _worlds(base)  # a restart from the base
        for c, side in ((pc, "port"), (jc, "jax")):
            c.run_command("recover")
            c.run_command(q5)
            logs[side + " recovered"] = capfd.readouterr().err
    finally:
        wal.reset_wal()
        jwal.reset_wal()
    for side in ("port", "jax"):
        text = logs[side]
        assert re.findall(r"dynamic load: ([\d,]+) new", text)[1] == "0"
        assert text.count("gsck: PASS") == 2
        assert "checkpoint written: " in text
    got = [re.findall(r"dynamic load: ([\d,]+) new", logs[s])
           for s in ("port", "jax")]
    assert got[0] == got[1] and got[0][0] != "0"
    assert _rows_logged(logs["port"]) == _rows_logged(logs["jax"])
    # recover -d without --dist: the drill refuses as the JAX one does
    for side in ("port", "jax"):
        assert "kill-and-recover drill needs the distributed engine" \
            in logs[side]
    recovered = [re.search(r"recovered: checkpoint=\S+ replayed=(.*) epoch",
                           logs[s + " recovered"]).group(1)
                 for s in ("port", "jax")]
    assert recovered[0] == recovered[1] == (
        "{'insert': 1, 'epoch': 0, 'vector': 0}")
    assert (_rows_logged(logs["port recovered"])
            == _rows_logged(logs["jax recovered"])
            == _rows_logged(logs["port"])[-1:])
