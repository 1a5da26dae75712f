"""Interactive console / CLI (reference: core/console.hpp:99-108, 893-992).

The port's copy of the JAX package's runtime/console.py:

    python -m wukong_tpu_torch.runtime.console <config> <dataset_dir> \\
        [-c "<command>"] [--device cuda|cpu] [--dist [-w N]]

Verbs: help, quit, config, logger, sparql (``-t <tenant>`` serves as a
tenant), sparql-emu, load (``load -d <dir> [-c]``: online inserts), gsck,
load-stat, store-stat, checkpoint, recover, and the reports of the
observability plane: trace (the flight recorder), explain and analyze
(EXPLAIN / EXPLAIN ANALYZE), slo (tenant SLOs and the overload bus),
admission (the admission plane), history (the metrics time-series ring),
events (the event journal), cache (the serving plane and the reuse
observatory) and device (the device-cost observatory). One-shot mode with
-c, else a REPL. The dataset may be an ``hdfs://`` directory, staged
locally first. The engines run on the card unless ``--device cpu`` is
given; ``--bind`` binds the engine threads to cores. ``--dist``
partitions the dataset into ``-w`` shards (default ``num_workers``, or 8
when it is 1) on one device and serves them through the distributed engine
(``sparql ... -d dist``, ``analyze ... -d dist``); there ``migrate``
drives the shard-migration actuator (runtime/migration.py) and ``recover
-d <shard>`` runs the kill-and-heal drill (``Emulator.run_drill``).
"""

from __future__ import annotations

import argparse
import json
import os
import shlex

from wukong_tpu_torch.config import Global, load_config, reload_config
from wukong_tpu_torch.utils.errors import WukongError
from wukong_tpu_torch.utils.logger import log_error, log_info, set_log_level

HELP = """\
help                         print help info
quit                         quit from the console
config <-v | -l <file> | -s <string>>   show/load/set config
logger <level>               set log level (0..7)
sparql -f <file> [-m <f>] [-n <n>] [-p <plan>] [-N] [-v <n>] [-d cpu|gpu]
       [-t <tenant>]         run a single SPARQL query (as a tenant)
sparql -b <file>             run a batch of `sparql` commands from a file
sparql-emu -f <mix_config> [-d <sec>] [-w <sec>] [-b <batch>] [-p <inflight>]
                             run the open-loop throughput emulator
load -d <dir> [-c]           dynamic (incremental) load; -c drops duplicates
gsck [-i] [-n]               check store integrity
load-stat [-f <file>]        load optimizer statistics
store-stat [-f <file>]       store optimizer statistics
trace [-q <qid|id>] [-n <k>] [-o <file>]
                             flight recorder: list recent traces, print one
                             query's span tree by qid/trace id, or export
                             Chrome trace JSON (open in ui.perfetto.dev)
explain <-f <file> | -q <text>> [-p <plan>] [-j]
                             EXPLAIN: planned patterns + per-step
                             cost/cardinality estimates (no execution)
analyze <-f <file> | -q <text>> [-d cpu|gpu] [-j]
                             EXPLAIN ANALYZE: execute under a forced trace,
                             join estimated vs actual per-step rows / wall
                             time + the latency decomposition
top [-k <n>] [-j]            hot shards / templates / lanes (like top(1);
                             also served at GET /top on the metrics port)
slo [-k <n>] [-j]            per-tenant SLO compliance / error budgets /
                             burn rates + the overload signal bus
admission [-k <n>] [-j]      admission control plane: overload level,
                             per-tenant quotas/weights, decision counts
history [-k <n>] [-w <sec>] [-j]
                             metrics trend windows from the time-series
                             ring: counter rates, histogram percentiles,
                             gauges
events [-k <n>] [-s <shard>] [-K <kind>] [-j]
                             cluster event journal: breaker trips, SLO
                             burns, admission sheds, trace dumps
cache [-k <n>] [-j]          serving plane + observatory: real result-
                             cache hit rate/bytes/views, shadow hit rate,
                             template popularity + cacheability verdicts,
                             invalidation trend
device [-k <n>] [-j]         device-cost observatory: dispatches, padding
                             efficiency, variants, residency, demotions
plan [-j] [-n]               observe-only placement advisor: run one
                             sweep and print its decision + shard
                             lineage (-n skips the fresh sweep; also
                             GET /plan)
migrate [-j] | migrate -abort | migrate -s
                             live shard migration: sweep the advisor and
                             execute its MigrationPlan (clone/catch-up/
                             cutover/retire; migration_enable must be
                             on). -abort rolls the in-flight migration
                             back to the donor; -s prints actuator status
metrics [-j]                 dump the metrics registry (Prometheus text, -j JSON)
checkpoint                   write one atomic checkpoint to checkpoint_dir;
                             truncates covered WAL
recover [-d <shard>]         restore newest checkpoint + replay the WAL tail;
                             -d runs the kill-and-recover drill against one
                             shard instead (requires --dist)
"""


class Console:
    def __init__(self, proxy, stats_path: str | None = None):
        self.proxy = proxy
        self.stats_path = stats_path
        self._in_batch = False
        self.last_emu: dict | None = None  # the last sparql-emu report

    def run_command(self, line: str) -> bool:
        """Execute one command; returns False to quit."""
        try:
            args = shlex.split(line)
        except ValueError as e:
            log_error(f"bad command: {e}")
            return True
        if not args:
            return True
        cmd, rest = args[0], args[1:]
        try:
            if cmd in ("quit", "q", "exit"):
                return False
            if cmd == "help":
                print(HELP)
            elif cmd == "config":
                self._config(rest)
            elif cmd == "logger":
                set_log_level(int(rest[0]))
            elif cmd == "sparql":
                self._sparql(rest)
            elif cmd == "sparql-emu":
                self._emu(rest)
            elif cmd == "load":
                ap = argparse.ArgumentParser(prog="load")
                ap.add_argument("-d", required=True)
                ap.add_argument("-c", action="store_true")
                ns = ap.parse_args(rest)
                self.proxy.dynamic_load_data(ns.d, ns.c)
            elif cmd == "gsck":
                index = "-i" in rest or not rest
                normal = "-n" in rest or not rest
                self.proxy.gstore_check(index, normal)
            elif cmd == "load-stat":
                self._stat(rest, load=True)
            elif cmd == "store-stat":
                self._stat(rest, load=False)
            elif cmd == "trace":
                self._trace(rest)
            elif cmd in ("explain", "analyze"):
                self._explain(rest, analyze=cmd == "analyze")
            elif cmd == "top":
                self._top(rest)
            elif cmd == "slo":
                self._report(rest, "slo")
            elif cmd == "admission":
                self._report(rest, "admission")
            elif cmd == "history":
                self._history(rest)
            elif cmd == "events":
                self._events(rest)
            elif cmd == "cache":
                self._cache(rest)
            elif cmd == "device":
                self._device(rest)
            elif cmd == "plan":
                self._plan_verb(rest)
            elif cmd == "migrate":
                self._migrate(rest)
            elif cmd == "metrics":
                self._metrics(rest)
            elif cmd == "checkpoint":
                log_info(f"checkpoint written: {self.proxy.checkpoint()}")
            elif cmd == "recover":
                self._recover(rest)
            else:
                log_error(f"unknown command: {cmd} (try 'help')")
        except WukongError as e:
            log_error(str(e))
        except SystemExit:
            pass  # argparse error inside a command
        return True

    # ------------------------------------------------------------------
    def _config(self, rest) -> None:
        if not rest or rest[0] == "-v":
            print(Global.dump())
        elif rest[0] == "-l":
            load_config(rest[1])
            self._apply_observatory_knobs()
        elif rest[0] == "-s":
            reload_config(" ".join(rest[1:]).replace("=", " "))
            self._apply_observatory_knobs()
        else:
            log_error("usage: config <-v | -l <file> | -s <key value>>")

    def _apply_observatory_knobs(self) -> None:
        """The observatory knobs are runtime-mutable both ways: the
        sampler/advisor/actuator threads check their knob every tick (on
        to off), but a flip from off to on after boot needs the idempotent
        starters re-invoked — without this, `config -s enable_tsdb true`
        (or `migration_enable true`) would never act until a restart. Over
        the distributed engine's sharded store the migration actuator is
        tried first, then the observe-only advisor (one sweeper)."""
        from wukong_tpu_torch.obs.placement import maybe_start_advisor
        from wukong_tpu_torch.obs.tsdb import maybe_start_tsdb
        from wukong_tpu_torch.runtime.migration import maybe_start_migration

        maybe_start_tsdb()
        dist = getattr(self.proxy, "dist", None)
        sstore = dist.sstore if dist is not None else None
        if maybe_start_migration(sstore, owner=self.proxy) is None:
            maybe_start_advisor(sstore)

    def _sparql(self, rest) -> None:
        ap = argparse.ArgumentParser(prog="sparql")
        ap.add_argument("-f", default=None)
        ap.add_argument("-b", default=None,
                        help="batch file: one `sparql ...` command per line "
                             "(console.hpp:151, exclusive with -f)")
        ap.add_argument("-m", type=int, default=1)
        ap.add_argument("-n", type=int, default=1)
        ap.add_argument("-p", default=None)
        ap.add_argument("-N", action="store_true", help="non-blind (ship results)")
        ap.add_argument("-v", type=int, default=0, help="print first N rows")
        ap.add_argument("-d", default=None, choices=["cpu", "gpu", "dist"])
        ap.add_argument("-t", default="default",
                        help="tenant identity (SLO accounting, admission)")
        ns = ap.parse_args(rest)
        if (ns.f is None) == (ns.b is None):
            log_error("single mode (-f) and batch mode (-b) are exclusive "
                      "— pass exactly one")
            return
        if ns.b is not None:
            if self._in_batch:
                log_error("nested batch files are not allowed")
                return
            try:
                with open(ns.b) as f:
                    lines = f.read().splitlines()
            except OSError as e:
                log_error(f"cannot read batch file: {e}")
                return
            log_info("Batch-mode start ...")
            self._in_batch = True
            try:
                for line in lines:
                    line = line.strip()
                    if not line or line.startswith("#"):
                        continue
                    log_info(f"Run the command: {line}")
                    self.run_command(line)
            finally:
                self._in_batch = False
            return
        try:
            with open(ns.f) as f:
                text = f.read()
            plan = None
            if ns.p:
                with open(ns.p) as f:
                    plan = f.read()
        except OSError as e:  # a mistyped path must not kill the REPL
            log_error(f"cannot read file: {e}")
            return
        blind = None if not (ns.N or ns.v) else False
        self.proxy.run_single_query(text, repeats=ns.n, plan_text=plan,
                                    mt_factor=ns.m, device=ns.d, blind=blind,
                                    print_results=ns.v, tenant=ns.t)

    def _emu(self, rest) -> None:
        from wukong_tpu_torch.runtime.emulator import Emulator, load_mix_config

        ap = argparse.ArgumentParser(prog="sparql-emu")
        ap.add_argument("-f", required=True)
        ap.add_argument("-d", type=float, default=5.0)
        ap.add_argument("-w", type=float, default=1.0)
        ap.add_argument("-b", type=int, default=None)
        ap.add_argument("-p", type=int, default=None,
                        help="in-flight cap across the engine pool")
        ns = ap.parse_args(rest)
        mix = load_mix_config(ns.f, self.proxy.str_server)
        self.last_emu = Emulator(self.proxy).run(
            mix, duration_s=ns.d, warmup_s=ns.w, batch=ns.b, parallel=ns.p)

    def _stat(self, rest, load: bool) -> None:
        """load-stat / store-stat: persist optimizer statistics
        (console.hpp:977-980 -> stats.hpp:585-640)."""
        from wukong_tpu_torch.planner.stats import Stats

        path = rest[rest.index("-f") + 1] if "-f" in rest else self.stats_path
        if path is None:
            log_error("no statfile path (use -f <file>)")
            return
        if load:
            from wukong_tpu_torch.planner.optimizer import Planner

            self.proxy.planner = Planner(Stats.load(path))
            if self.proxy.gpu is not None:
                self.proxy.gpu.stats = self.proxy.planner.stats
            log_info(f"statistics loaded from {path}")
        else:
            if self.proxy.planner is None:
                log_error("no planner statistics to store")
                return
            self.proxy.planner.stats.save(path)
            log_info(f"statistics stored to {path}")

    # ------------------------------------------------------------------
    def _trace(self, rest) -> None:
        """Flight-recorder verbs (the console prints directly)."""
        from wukong_tpu_torch.obs import get_recorder, write_chrome_trace

        ap = argparse.ArgumentParser(prog="trace")
        ap.add_argument("-q", default=None,
                        help="fetch one trace by qid or trace id")
        ap.add_argument("-n", type=int, default=16,
                        help="how many recent traces to list/export")
        ap.add_argument("-o", default=None,
                        help="export Chrome trace JSON to this path")
        ns = ap.parse_args(rest)
        rec = get_recorder()
        if ns.o is not None:
            traces = ([rec.find(ns.q)] if ns.q is not None
                      else rec.last(ns.n))
            traces = [t for t in traces if t is not None]
            if not traces:
                log_error("no traces recorded (enable_tracing on?)")
                return
            print(f"wrote {len(traces)} trace(s) to "
                  f"{write_chrome_trace(ns.o, traces)}")
            return
        if ns.q is not None:
            tr = rec.find(ns.q)
            if tr is None:
                log_error(f"no trace for {ns.q!r} in the flight recorder")
                return
            print(f"trace {tr.trace_id} qid={tr.qid} kind={tr.kind} "
                  f"tenant={tr.tenant} status={tr.status} "
                  f"dur={tr.dur_us:,}us")
            if tr.text:
                print(f"  query: {' '.join(tr.text.split())[:120]}")
            for sp in tr.spans:
                pad = "  " * (sp.depth + 1)
                attrs = " ".join(f"{k}={v}" for k, v in sp.attrs.items())
                print(f"{pad}{sp.name} {sp.dur_us:,}us"
                      + (f" [{attrs}]" if attrs else ""))
                for (_t, name, a) in sp.events:
                    ev = " ".join(f"{k}={v}" for k, v in a.items())
                    print(f"{pad}  ! {name}" + (f" [{ev}]" if ev else ""))
            return
        traces = rec.last(ns.n)
        if not traces:
            log_error("flight recorder is empty (enable_tracing on?)")
            return
        for tr in traces:
            print(f"{tr.trace_id}  qid={tr.qid:<6} {tr.kind:<7} "
                  f"{tr.status:<16} {tr.dur_us:>10,}us "
                  f"{len(tr.spans):>3} spans")
        if rec.dumps:
            print(f"({len(rec.dumps)} auto-dumped: "
                  + ", ".join(f"{r}:{t.trace_id}"
                              for r, t in list(rec.dumps)[-8:]) + ")")

    def _explain(self, rest, analyze: bool) -> None:
        """explain / analyze over Proxy.explain_query (obs/profile.py)."""
        prog = "analyze" if analyze else "explain"
        ap = argparse.ArgumentParser(prog=prog)
        ap.add_argument("-f", default=None, help="query file")
        ap.add_argument("-q", default=None, help="inline query text")
        ap.add_argument("-d", default=None, choices=["cpu", "gpu", "dist"])
        ap.add_argument("-p", default=None, help="user plan file (EXPLAIN)")
        ap.add_argument("-j", action="store_true",
                        help="print the structured JSON report")
        ns = ap.parse_args(rest)
        if (ns.f is None) == (ns.q is None):
            log_error(f"usage: {prog} <-f <file> | -q <text>>")
            return
        try:
            if ns.f:
                with open(ns.f) as f:
                    text = f.read()
            else:
                text = ns.q
            plan = None
            if ns.p:
                with open(ns.p) as f:
                    plan = f.read()
        except OSError as e:  # a mistyped path must not kill the REPL
            log_error(f"cannot read file: {e}")
            return
        report = self.proxy.explain_query(text, analyze=analyze,
                                          device=ns.d, plan_text=plan)
        if ns.j:
            print(json.dumps({k: v for k, v in report.items()
                              if k != "rendered"},
                             indent=1, sort_keys=True, default=str))
        else:
            print(report["rendered"])

    @staticmethod
    def _print_report(json_out: bool, text: str, js: dict) -> None:
        """The shared (text, JSON) epilogue of every report verb."""
        if json_out:
            print(json.dumps(js, indent=1, sort_keys=True, default=str))
        else:
            print(text, end="")

    def _report(self, rest, verb: str) -> None:
        """slo: per-tenant compliance / error budgets / burn rates + the
        overload signal bus; admission: the admission control plane."""
        from wukong_tpu_torch.obs.slo import render_slo
        from wukong_tpu_torch.runtime.admission import render_admission

        ap = argparse.ArgumentParser(prog=verb)
        ap.add_argument("-k", type=int, default=None,
                        help="tenant rows shown (default: the top_k knob)")
        ap.add_argument("-j", action="store_true", help="JSON output")
        ns = ap.parse_args(rest)
        render = render_slo if verb == "slo" else render_admission
        self._print_report(ns.j, *render(ns.k))

    def _top(self, rest) -> None:
        """top: hot shards / templates / lanes (the /top endpoint's body)."""
        from wukong_tpu_torch.obs.profile import render_top

        ap = argparse.ArgumentParser(prog="top")
        ap.add_argument("-k", type=int, default=None,
                        help="rows per section (default: the top_k knob)")
        ap.add_argument("-j", action="store_true", help="JSON output")
        ns = ap.parse_args(rest)
        self._print_report(ns.j, *render_top(ns.k))

    def _plan_verb(self, rest) -> None:
        """plan: one observe-only placement-advisor sweep, its decision
        and the shard lineage (the /plan body)."""
        from wukong_tpu_torch.obs.placement import render_plan

        ap = argparse.ArgumentParser(prog="plan")
        ap.add_argument("-j", action="store_true", help="JSON output")
        ap.add_argument("-n", action="store_true",
                        help="no fresh sweep: print the last plan only")
        ns = ap.parse_args(rest)
        self._print_report(ns.j, *render_plan(advise=not ns.n))

    @staticmethod
    def _metrics(rest) -> None:
        """metrics: the registry as Prometheus text (-j: the JSON
        snapshot)."""
        from wukong_tpu_torch.obs import get_registry

        if "-j" in rest:
            print(json.dumps(get_registry().snapshot(), indent=1,
                             sort_keys=True))
        else:
            print(get_registry().render_prometheus(), end="")

    def _device(self, rest) -> None:
        """device: the device-cost observatory (dispatches, padding
        efficiency, variants, residency, template demotions)."""
        from wukong_tpu_torch.obs.device import render_device

        ap = argparse.ArgumentParser(prog="device")
        ap.add_argument("-k", type=int, default=None,
                        help="dispatch rows shown (default: the top_k knob)")
        ap.add_argument("-j", action="store_true", help="JSON output")
        ns = ap.parse_args(rest)
        self._print_report(ns.j, *render_device(ns.k))

    def _history(self, rest) -> None:
        """history: metrics trend windows from the time-series ring."""
        from wukong_tpu_torch.obs.tsdb import render_history

        ap = argparse.ArgumentParser(prog="history")
        ap.add_argument("-k", type=int, default=None,
                        help="rows per section (default: the top_k knob)")
        ap.add_argument("-w", type=float, default=None,
                        help="trend window seconds (default: retention)")
        ap.add_argument("-j", action="store_true", help="JSON output")
        ns = ap.parse_args(rest)
        self._print_report(ns.j, *render_history(ns.k, ns.w))

    def _cache(self, rest) -> None:
        """cache: the serving plane + the reuse observatory."""
        from wukong_tpu_torch.obs.reuse import render_cache

        ap = argparse.ArgumentParser(prog="cache")
        ap.add_argument("-k", type=int, default=None,
                        help="template rows shown (default: the top_k knob)")
        ap.add_argument("-j", action="store_true", help="JSON output")
        ns = ap.parse_args(rest)
        self._print_report(ns.j, *render_cache(ns.k))

    def _events(self, rest) -> None:
        """events: the cluster event journal."""
        from wukong_tpu_torch.obs.events import render_events

        ap = argparse.ArgumentParser(prog="events")
        ap.add_argument("-k", type=int, default=None,
                        help="events shown (default: 4x the top_k knob)")
        ap.add_argument("-s", type=int, default=None, metavar="shard",
                        help="only events correlated to this shard")
        ap.add_argument("-K", default=None, metavar="kind",
                        help="only events of this kind")
        ap.add_argument("-j", action="store_true", help="JSON output")
        ns = ap.parse_args(rest)
        self._print_report(ns.j, *render_events(ns.k, shard=ns.s,
                                                kind=ns.K))

    def _migrate(self, rest) -> None:
        """migrate: one actuator round — sweep the advisor, execute the
        MigrationPlan it emits (migration_enable must be on). -abort
        rolls the in-flight migration back; -s prints status only."""
        from wukong_tpu_torch.obs.placement import get_advisor
        from wukong_tpu_torch.runtime.migration import get_migrator

        ap = argparse.ArgumentParser(prog="migrate", prefix_chars="-")
        ap.add_argument("-abort", dest="abort", action="store_true",
                        help="abort the in-flight migration")
        ap.add_argument("-s", dest="status", action="store_true",
                        help="actuator status only (no sweep)")
        ap.add_argument("-j", action="store_true", help="JSON output")
        ns = ap.parse_args(rest)
        mig = get_migrator()
        dist = getattr(self.proxy, "dist", None)
        if dist is not None:
            mig.attach(sstore=dist.sstore, owner=self.proxy)
            get_advisor().attach_store(dist.sstore)
        if ns.abort:
            job = mig.abort(cause="operator")
            log_info(f"migration {job.plan.plan_id} aborted"
                     if job is not None else "no migration in flight")
            return
        if ns.status:
            if ns.j:
                print(json.dumps(mig.status(), indent=1, sort_keys=True,
                                 default=str))
            else:
                log_info(f"migration actuator: {mig.status()}")
            return
        plan = get_advisor().advise_once()
        if plan is None:
            log_info("no MigrationPlan to execute (advisor: "
                     f"{get_advisor().status()['decision']})")
            return
        job = mig.run_plan(plan)
        if ns.j:
            print(json.dumps(job.to_dict(), indent=1, sort_keys=True,
                             default=str))
        else:
            log_info(f"migration {job.plan.plan_id} {job.phase}: shard "
                     f"{job.plan.donor_shard} -> host "
                     f"{job.plan.recipient_host} "
                     f"({job.bytes_moved:,} bytes)")

    def _recover(self, rest) -> None:
        """recover: boot-style checkpoint+WAL restore. recover -d <shard>:
        the kill-and-recover drill — force that primary down, prove
        failover keeps results complete, heal, verify."""
        ap = argparse.ArgumentParser(prog="recover")
        ap.add_argument("-d", "--drill", type=int, default=None,
                        metavar="shard")
        ns = ap.parse_args(rest)
        if ns.drill is None:
            stats = self.proxy.recover()
            log_info(f"recovered: checkpoint={stats['checkpoint']} "
                     f"replayed={stats['replayed']} epoch={stats['epoch']}")
            return
        from wukong_tpu_torch.runtime.emulator import Emulator

        report = Emulator(self.proxy).run_drill(shard=ns.drill)
        log_info(f"drill report: {report}")

    # ------------------------------------------------------------------
    def repl(self) -> None:
        log_info("wukong console — 'help' for commands")
        while True:
            try:
                line = input("wukong> ")
            except (EOFError, KeyboardInterrupt):
                break
            if not self.run_command(line):
                break


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="wukong on PyTorch/CUDA: RDF store + SPARQL engine")
    ap.add_argument("config", help="config file path")
    ap.add_argument("dataset",
                    help="dataset directory (id-format; hdfs:// is staged)")
    ap.add_argument("-c", "--command", default=None,
                    help="one-shot command, then exit")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the GPU engine's kernels run (cpu: their "
                         "plain PyTorch versions)")
    ap.add_argument("-b", "--bind", default=None, metavar="core.bind",
                    help="enable thread->core binding from a core.bind file "
                         "(reference: wukong -b, bind.hpp)")
    ap.add_argument("-w", "--workers", type=int, default=None,
                    help="graph partitions (default: num_workers, or 8 "
                         "shard slots with --dist)")
    ap.add_argument("--dist", action="store_true",
                    help="partition into -w shards on the device and serve "
                         "them through the distributed engine")
    args = ap.parse_args(argv)
    load_config(args.config)
    if args.workers is not None:
        Global.num_workers = args.workers
    if args.bind is not None:
        # after load_config: the binding sanity check reads Global.num_engines
        from wukong_tpu_torch.runtime.bind import get_binder

        get_binder().load_core_binding(args.bind)

    from wukong_tpu_torch.loader.base import load_attr_triples, load_triples
    from wukong_tpu_torch.loader.hdfs import resolve_dataset_dir
    from wukong_tpu_torch.runtime.proxy import Proxy
    from wukong_tpu_torch.store.gstore import build_partition
    from wukong_tpu_torch.store.string_server import StringServer

    args.dataset = resolve_dataset_dir(args.dataset)  # hdfs:// -> staged dir
    ss = StringServer(args.dataset)
    # one read of the triple files serves the partition and the statistics
    triples = load_triples(args.dataset)
    attrs = load_attr_triples(args.dataset)
    g = build_partition(triples, 0, 1, attr_triples=attrs)
    dist = None
    if args.dist:
        from wukong_tpu_torch.parallel.dist_engine import DistEngine
        from wukong_tpu_torch.parallel.mesh import make_mesh
        from wukong_tpu_torch.store.gstore import build_all_partitions

        n = args.workers or (Global.num_workers
                             if Global.num_workers > 1 else 8)
        dist = DistEngine(build_all_partitions(triples, n, attrs), ss,
                          make_mesh(n, device=args.device))
    # raises here without a card
    proxy = Proxy(g, ss, device=args.device, dist_engine=dist)
    if args.device == "cuda":
        # build every kernel library the build cache lacks before the first
        # query (the JAX console's persistent XLA cache set-up)
        from wukong_tpu_torch.utils.compilecache import setup_persistent_cache

        setup_persistent_cache()
    statfile = os.path.join(args.dataset, "statfile")
    if Global.enable_planner:
        from wukong_tpu_torch.planner.optimizer import make_planner

        proxy.planner = make_planner(
            None if os.path.exists(statfile + ".npz") else triples, statfile)
        if proxy.gpu is not None:
            proxy.gpu.stats = proxy.planner.stats  # capacity estimation
    del triples

    console = Console(proxy, stats_path=statfile)
    if args.command is not None:
        console.run_command(args.command)
    else:
        console.repl()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
