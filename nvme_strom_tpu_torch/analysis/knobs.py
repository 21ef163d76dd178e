"""STROM_* knob-documentation drift check (counterpart of
nvme_strom_tpu/analysis/knobs.py).

Every ``STROM_*`` environment variable the port (``nvme_strom_tpu_torch``)
or the C engine it compiles (``csrc/strom_io.cc``) reads must appear in
README.md's environment-variable table; the README may document a whole
family with a glob row (``STROM_FAULT_READ_*``)."""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List, Set, Tuple

from nvme_strom_tpu_torch.analysis.driver import PACKAGE, Violation

CHECK = "knobs"

#: a Python-side env READ of a STROM knob through os.environ /
#: os.getenv / the _env_int / _env_float helpers — the name may sit on
#: the next line (black-wrapped calls), so \s* spans newlines
#: (the knob literal is spliced in so the scanner cannot match its own
#: pattern source when it sweeps this module)
_K = "STROM" + "_[A-Z0-9_]+"
_PY_READ = re.compile(
    r'(?:environ(?:\.get)?\s*[\[\(]|_env_int\(|_env_float\(|'
    r'getenv\()\s*["\'](' + _K + ')')

#: the C engine's reads through getenv / the env_* helpers
_C_READ = re.compile(r'(?:getenv|env_[a-z0-9_]+)\s*\(\s*"(' + _K + ')"')


def knobs_read_by_the_code(root: Path) -> Dict[str, Tuple[str, int]]:
    """knob -> (repo-relative file, line) of one site reading it."""
    knobs: Dict[str, Tuple[str, int]] = {}
    for py in sorted((root / PACKAGE).rglob("*.py")):
        if "__pycache__" in py.parts:
            continue
        text = py.read_text()
        for m in _PY_READ.finditer(text):
            knobs.setdefault(
                m.group(1),
                (str(py.relative_to(root)),
                 text[:m.start()].count("\n") + 1))
    cc = root / "csrc" / "strom_io.cc"
    if cc.exists():
        text = cc.read_text()
        for m in _C_READ.finditer(text):
            knobs.setdefault(
                m.group(1),
                (str(cc.relative_to(root)),
                 text[:m.start()].count("\n") + 1))
    return knobs


def knobs_documented_in_readme(root: Path) -> Tuple[Set[str], Set[str]]:
    text = (root / "README.md").read_text()
    tokens = set(re.findall(r"STROM_[A-Z0-9_]+\*?", text))
    exact = {t for t in tokens if not t.endswith("*")}
    prefixes = {t[:-1] for t in tokens if t.endswith("*")}
    return exact, prefixes


def check_knob_docs(root: Path) -> List[Violation]:
    knobs = knobs_read_by_the_code(root)
    if not knobs:
        return [Violation(CHECK, PACKAGE, 1,
                          "the knob scan found no knobs at all — the "
                          "regex rotted", key="scan-empty")]
    exact, prefixes = knobs_documented_in_readme(root)
    out: List[Violation] = []
    for k in sorted(knobs):
        if k in exact or any(k.startswith(p) for p in prefixes):
            continue
        file, line = knobs[k]
        out.append(Violation(
            CHECK, file, line,
            f"{k} is read by the code but absent from README.md's "
            f"env-var table — add a row (or a family glob row like "
            f"STROM_FAULT_READ_*)", key=k))
    return out
