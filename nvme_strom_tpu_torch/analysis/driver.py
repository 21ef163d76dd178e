"""strom-lint: every checker under ONE exit-code contract
(counterpart of nvme_strom_tpu/analysis/driver.py).

Exit codes follow the strom-scrub convention:

- ``0`` — clean: zero unwaived violations (waived findings and the
  checker inventory still print with ``-v``);
- ``1`` — violations found (each reported ``file:line: [check] msg``);
- ``2`` — the lint run itself failed (unparseable header or kernel
  source, malformed manifest, crash) — never conflated with "dirty
  tree", so CI can tell "fix your code" from "fix the linter".

One run covers the port's two ctypes surfaces, its locks, its knobs and
its counters.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence


@dataclass
class Violation:
    check: str
    file: str
    line: int
    message: str
    #: waiver-matching key (see analysis/manifest.py); defaults to the
    #: message itself
    key: Optional[str] = None
    waived: bool = False
    waive_reason: Optional[str] = None

    def format(self) -> str:
        tag = " (waived: %s)" % self.waive_reason if self.waived else ""
        return f"{self.file}:{self.line}: [{self.check}] {self.message}{tag}"

    def as_dict(self) -> dict:
        return {"check": self.check, "file": self.file, "line": self.line,
                "message": self.message, "key": self.key,
                "waived": self.waived, "waive_reason": self.waive_reason}


@dataclass
class Report:
    violations: List[Violation] = field(default_factory=list)
    checks_run: List[str] = field(default_factory=list)
    #: lock acquisition edges (check 'locks' only) for --dump-graph
    edges: List[object] = field(default_factory=list)

    @property
    def active(self) -> List[Violation]:
        return [v for v in self.violations if not v.waived]

    @property
    def waived(self) -> List[Violation]:
        return [v for v in self.violations if v.waived]

    @property
    def exit_code(self) -> int:
        return 1 if self.active else 0

    def as_dict(self) -> dict:
        return {"checks_run": self.checks_run,
                "violations": [v.as_dict() for v in self.violations],
                "n_active": len(self.active),
                "n_waived": len(self.waived),
                "exit_code": self.exit_code}


#: the package the passes scan, under the repository root
PACKAGE = "nvme_strom_tpu_torch"


def _repo_root() -> Path:
    return Path(__file__).resolve().parents[2]


def default_header(root: Path) -> Path:
    return root / "csrc" / "strom_io.h"


def default_kernel_sources(root: Path) -> List[Path]:
    """The kernel library's translation units, as the build compiles
    them (one ``nvcc -c`` a ``.cu``)."""
    return sorted((root / PACKAGE / "csrc").glob("*.cu"))


def default_manifest() -> Path:
    return Path(__file__).resolve().parent / "lock_order.conf"


def package_py_files(root: Path) -> List[Path]:
    pkg = root / PACKAGE
    return sorted(p for p in pkg.rglob("*.py")
                  if "__pycache__" not in p.parts)


#: the lock pass scans every module of the package: a lock added to a
#: new module is picked up without a list to update
def run_checks(checks: Optional[Sequence[str]] = None,
               root: Optional[Path] = None,
               header: Optional[Path] = None,
               manifest_path: Optional[Path] = None,
               py_files: Optional[List[Path]] = None,
               kernel_sources: Optional[List[Path]] = None) -> Report:
    """Run the selected checkers (default: all).  Raises on *linter*
    failure (malformed manifest/header parse handled as violations where
    that is the documented contract; unexpected exceptions propagate to
    the CLI which maps them to exit 2)."""
    from nvme_strom_tpu_torch.analysis import abi as abi_mod
    from nvme_strom_tpu_torch.analysis import counters as counters_mod
    from nvme_strom_tpu_torch.analysis import knobs as knobs_mod
    from nvme_strom_tpu_torch.analysis import locks as locks_mod
    from nvme_strom_tpu_torch.analysis.manifest import parse_manifest

    root = root or _repo_root()
    header = header or default_header(root)
    manifest_path = manifest_path or default_manifest()
    files = py_files if py_files is not None else package_py_files(root)
    cus = (kernel_sources if kernel_sources is not None
           else default_kernel_sources(root))
    selected = list(checks) if checks else list(ALL_CHECKS)
    unknown = [c for c in selected if c not in ALL_CHECKS]
    if unknown:
        raise ValueError(f"unknown checks {unknown}; "
                         f"available: {sorted(ALL_CHECKS)}")

    man = parse_manifest(manifest_path)
    rep = Report(checks_run=selected)
    if "abi" in selected:
        vs = abi_mod.check_abi(header, files, root, cus)
        rep.violations += _apply_waivers(man, "abi", vs)
    if "knobs" in selected:
        rep.violations += _apply_waivers(
            man, "knobs", knobs_mod.check_knob_docs(root))
    if "counters" in selected:
        rep.violations += _apply_waivers(
            man, "counters", counters_mod.check_counter_drift())
    if "locks" in selected:
        vs, edges = locks_mod.check_locks(files, root, man)
        rep.violations += vs
        rep.edges = edges
    # a waiver that matched nothing is stale and hides future
    # regressions — but only a FULL run (every check over the whole
    # package, not a fixture-file subset) can judge that fairly
    if py_files is None and set(selected) == set(ALL_CHECKS):
        for w in man.unused_waivers():
            rep.violations.append(Violation(
                "manifest", man.path, w.line,
                f"unused waiver ({w.check} {w.pattern!r}) — it matches "
                f"nothing; remove it or fix its pattern",
                key=f"unused:{w.pattern}"))
    return rep


def _apply_waivers(man, check: str, vs: List[Violation]) -> List[Violation]:
    for v in vs:
        w = man.waive(check, v.key or v.message)
        if w is not None:
            v.waived = True
            v.waive_reason = w.reason
    return vs


ALL_CHECKS: Dict[str, str] = {
    "abi": "ctypes-ABI conformance against csrc/strom_io.h and the "
           "kernel sources' extern \"C\" entry points",
    "locks": "lock-order manifest + blocking-under-lock discipline",
    "knobs": "STROM_* knob documentation drift (README env table)",
    "counters": "StromStats counter drift vs strom_stat render/json/prom",
}
