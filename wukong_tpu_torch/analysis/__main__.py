"""CLI: ``python -m wukong_tpu_torch.analysis [--json] [--gate NAME ...] [ROOT]``.

Runs every registered gate (or the selected subset) over the package tree
(``wukong_tpu_torch/`` by default) and exits 1 when any violation is found,
2 on an unknown gate name; ``tests/test_torch_analysis.py`` runs the same
command. ``--list`` prints the gate registry; ``--json`` emits a
machine-readable report.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv: list[str] | None = None) -> int:
    from wukong_tpu_torch.analysis.framework import plugin_names, run_analysis

    ap = argparse.ArgumentParser(
        prog="python -m wukong_tpu_torch.analysis",
        description="wukong-analyze: run the project's static-analysis "
                    "gates")
    ap.add_argument("root", nargs="?", default=None,
                    help="package root to analyze (default: the installed "
                         "wukong_tpu_torch tree)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable JSON report on stdout")
    ap.add_argument("--gate", action="append", default=None,
                    metavar="NAME", help="run only this gate (repeatable)")
    ap.add_argument("--list", action="store_true",
                    help="list registered gates and exit")
    args = ap.parse_args(argv)

    if args.list:
        for name in plugin_names():
            print(name)
        return 0
    try:
        bad = run_analysis(args.root, plugins=args.gate)
    except KeyError as e:
        print(e.args[0], file=sys.stderr)
        return 2
    if args.as_json:
        print(json.dumps({
            "gates": args.gate or plugin_names(),
            "count": len(bad),
            "violations": [v.to_dict() for v in bad],
        }, indent=1, sort_keys=True))
    else:
        for v in bad:
            print(v)
        print(f"wukong-analyze: {len(bad)} violation(s)" if bad
              else "wukong-analyze: clean")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
