"""strom-lint for the port: the static-analysis CLI (counterpart of
nvme_strom_tpu/tools/strom_lint.py).

One entry point, one exit-code contract (the strom-scrub convention):

- ``0`` clean (zero unwaived violations),
- ``1`` violations (each printed ``file:line: [check] message``),
- ``2`` the lint run itself failed (an unparseable header or kernel
  source, a malformed manifest, an unknown check).

Usage::

    python -m nvme_strom_tpu_torch.tools.strom_lint          # every check
    ... --check abi,locks       # a subset
    ... --json                  # machine-readable report
    ... --dump-graph            # print the lock acquisition graph
    ... --manifest my.conf --header my.h --kernels DIR --root DIR f.py ...

Positional paths (optional) replace the package file set, which is how
the linter's own tests point it at seeded-defect fixtures; ``--kernels``
names the directory of ``.cu`` sources (default
``nvme_strom_tpu_torch/csrc``).  The checks and the waiver grammar are
in nvme_strom_tpu_torch/analysis.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from nvme_strom_tpu_torch.analysis.driver import ALL_CHECKS, run_checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="strom-lint",
        description="ctypes-ABI conformance, lock-discipline analysis "
                    "and drift checks for nvme_strom_tpu_torch")
    ap.add_argument("paths", nargs="*", type=Path,
                    help="python files to analyze (default: the whole "
                         "nvme_strom_tpu_torch package)")
    ap.add_argument("--check", default=",".join(ALL_CHECKS),
                    help="comma-separated subset of: "
                         + ", ".join(ALL_CHECKS))
    ap.add_argument("--root", type=Path, default=None,
                    help="repo root (default: the installed checkout)")
    ap.add_argument("--header", type=Path, default=None,
                    help="C ABI header (default: csrc/strom_io.h)")
    ap.add_argument("--kernels", type=Path, default=None,
                    help="directory of the kernel library's .cu sources "
                         "(default: nvme_strom_tpu_torch/csrc)")
    ap.add_argument("--manifest", type=Path, default=None,
                    help="lock-order manifest (default: "
                         "analysis/lock_order.conf)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit the full report as JSON on stdout")
    ap.add_argument("--dump-graph", action="store_true",
                    help="print every lock acquisition edge observed")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="also print waived findings")
    args = ap.parse_args(argv)

    checks = [c.strip() for c in args.check.split(",") if c.strip()]
    try:
        rep = run_checks(
            checks=checks,
            root=args.root.resolve() if args.root else None,
            header=args.header.resolve() if args.header else None,
            manifest_path=(args.manifest.resolve()
                           if args.manifest else None),
            # resolve(): checkers report paths relative to root, and a
            # cwd-relative fixture path would fail that relative_to()
            py_files=(sorted(p.resolve() for p in args.paths)
                      if args.paths else None),
            kernel_sources=(sorted(args.kernels.resolve().glob("*.cu"))
                            if args.kernels else None))
    except Exception as e:  # malformed manifest, bad --check, crash
        print(f"strom-lint: error: {e}", file=sys.stderr)
        return 2

    if args.as_json:
        print(json.dumps(rep.as_dict(), indent=2))
        return rep.exit_code

    for v in rep.violations:
        if v.waived and not args.verbose:
            continue
        print(v.format())
    if args.dump_graph:
        for e in rep.edges:
            print(f"edge {e.held} -> {e.acquired}  "
                  f"[{e.file}:{e.line}; {e.how}]")
    n_act, n_wav = len(rep.active), len(rep.waived)
    print(f"strom-lint: {', '.join(rep.checks_run)}: "
          f"{n_act} violation(s), {n_wav} waived", file=sys.stderr)
    return rep.exit_code


if __name__ == "__main__":
    sys.exit(main())
