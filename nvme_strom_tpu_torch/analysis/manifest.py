"""Lock-order manifest + waiver grammar (counterpart of
nvme_strom_tpu/analysis/manifest.py).

The manifest is the *declared* locking discipline of the port's
concurrent I/O core.  ``analysis/locks.py`` enforces it statically; the
runtime witness (``utils/lockwitness.py``) records real acquisition
edges in the port's chaos-class tests.

Format (line-based; ``#`` comments)::

    order <group> > <group> > ...     # allowed acquisition direction
    group <name> <glob> [<glob> ...]  # lock-id patterns forming a group
    blocking-allow <glob>             # callee never treated as blocking
    waiver <check> <key-glob> reason "<why this is safe>"

Lock ids are ``<module>.<Class>.<attr>`` (``sched.QoSScheduler._lock``)
or ``<module>.<global>`` (``engine._lib_lock``) — exactly the names the
witness-wrapped constructors (``make_lock("...")``) declare in code.

``order`` chains read left-to-right: a lock in an earlier group may be
held while acquiring a lock in a later group, never the reverse.  Locks
in the same group are unordered relative to each other (identity-level
self-deadlock is still checked).  A lock matching no group is *unranked*
— only self-deadlock and blocking checks apply to it.

Waiver keys (what ``<key-glob>`` matches):

- ``order``:    ``<held-id>-><acquired-id>``
- ``blocking``: ``<held-id>:<callee>``
- ``abi`` / ``knobs`` / ``counters``: the violation's own key string.

Every waiver MUST carry a reason string — a waiver is a reviewed
decision, not a mute button — and unused waivers are themselves reported
(a waiver that matches nothing is stale and hides future regressions).
"""

from __future__ import annotations

import fnmatch
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple


class ManifestError(ValueError):
    """The manifest itself is malformed — always fatal to the lint run."""


@dataclass
class Waiver:
    check: str
    pattern: str
    reason: str
    line: int
    used: bool = False


@dataclass
class LockManifest:
    path: str
    #: group name -> list of lock-id globs
    groups: Dict[str, List[str]] = field(default_factory=dict)
    #: chains of group names, each an allowed acquisition direction
    orders: List[List[str]] = field(default_factory=list)
    #: callee globs exempt from blocking-op detection everywhere
    blocking_allow: List[str] = field(default_factory=list)
    waivers: List[Waiver] = field(default_factory=list)
    #: lazy caches: direct successor adjacency from the declared
    #: chains, and its transitive closure (cross-chain orders compose:
    #: 'kv > engine' + 'engine > arena' implies kv > arena)
    _adj: Optional[Dict[str, set]] = field(default=None, repr=False)
    _after: Optional[Dict[str, set]] = field(default=None, repr=False)

    # ------------------------------------------------------------------
    def group_of(self, lock_id: str) -> Optional[str]:
        for name, globs in self.groups.items():
            if any(fnmatch.fnmatchcase(lock_id, g) for g in globs):
                return name
        return None

    def _closure(self) -> Dict[str, set]:
        """``after[g]`` = every group orderable strictly after ``g``,
        across ALL declared chains transitively — a per-chain check
        would let cross-chain inversions through ('kv > engine' +
        'sched > engine > arena' orders kv before arena, and an
        arena-held-acquiring-kv edge must still be flagged)."""
        if self._after is None:
            adj: Dict[str, set] = {}
            for chain in self.orders:
                for a, b in zip(chain, chain[1:]):
                    adj.setdefault(a, set()).add(b)
            after = {g: set(s) for g, s in adj.items()}
            changed = True
            while changed:
                changed = False
                for g, s in after.items():
                    grown = set().union(s, *(after.get(h, ())
                                             for h in s))
                    if grown != s:
                        after[g] = grown
                        changed = True
            self._adj, self._after = adj, after
        return self._after

    def _order_path(self, src: str, dst: str) -> List[str]:
        """One witnessing declared path src ->* dst for the report."""
        self._closure()
        frontier: List[List[str]] = [[src]]
        seen = {src}
        while frontier:
            path = frontier.pop(0)
            if path[-1] == dst:
                return path
            for nxt in sorted((self._adj or {}).get(path[-1], ())):
                if nxt not in seen:
                    seen.add(nxt)
                    frontier.append(path + [nxt])
        return [src, dst]

    def order_violations(self, held_id: str,
                         acquired_id: str) -> Optional[str]:
        """None if the edge held->acquired conforms; otherwise a short
        description of the violated (possibly cross-chain) order."""
        gh, ga = self.group_of(held_id), self.group_of(acquired_id)
        if gh is None or ga is None or gh == ga:
            return None
        after = self._closure()
        if gh in after.get(ga, ()):      # declared acquired-before-held
            path = self._order_path(ga, gh)
            return (f"declared order is "
                    f"{' > '.join(path)} but {held_id} "
                    f"({gh}) is held while acquiring "
                    f"{acquired_id} ({ga})")
        return None

    def is_blocking_allowed(self, callee: str) -> bool:
        return any(fnmatch.fnmatchcase(callee, g)
                   for g in self.blocking_allow)

    def waive(self, check: str, key: str) -> Optional[Waiver]:
        """First waiver matching (check, key), marked used."""
        for w in self.waivers:
            if w.check == check and fnmatch.fnmatchcase(key, w.pattern):
                w.used = True
                return w
        return None

    def unused_waivers(self) -> List[Waiver]:
        return [w for w in self.waivers if not w.used]


_WAIVER_RE = re.compile(
    r'^waiver\s+(\S+)\s+(\S+)\s+reason\s+"([^"]+)"\s*$')


def parse_manifest(path: Path) -> LockManifest:
    man = LockManifest(path=str(path))
    for lineno, raw in enumerate(path.read_text().splitlines(), 1):
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        where = f"{path}:{lineno}"
        if line.startswith("group "):
            parts = line.split()
            if len(parts) < 3:
                raise ManifestError(f"{where}: group needs a name and "
                                    f"at least one glob: {raw!r}")
            man.groups.setdefault(parts[1], []).extend(parts[2:])
        elif line.startswith("order "):
            chain = [g.strip() for g in line[len("order "):].split(">")]
            if len(chain) < 2 or not all(chain):
                raise ManifestError(f"{where}: order needs at least two "
                                    f"'>'-separated groups: {raw!r}")
            man.orders.append(chain)
        elif line.startswith("blocking-allow "):
            parts = line.split()
            if len(parts) != 2:
                raise ManifestError(f"{where}: blocking-allow takes one "
                                    f"glob: {raw!r}")
            man.blocking_allow.append(parts[1])
        elif line.startswith("waiver "):
            m = _WAIVER_RE.match(line)
            if not m:
                raise ManifestError(
                    f"{where}: waiver grammar is 'waiver <check> "
                    f"<key-glob> reason \"...\"': {raw!r}")
            man.waivers.append(Waiver(check=m.group(1),
                                      pattern=m.group(2),
                                      reason=m.group(3), line=lineno))
        else:
            raise ManifestError(f"{where}: unknown directive: {raw!r}")
    for chain in man.orders:
        for g in chain:
            if g not in man.groups:
                raise ManifestError(
                    f"{path}: order references undeclared group {g!r}")
    # contradictory declarations (A > B somewhere, B >* A elsewhere)
    # would make every edge between the two groups simultaneously legal
    # and a violation — fatal, like any other malformed manifest
    after = man._closure()
    for g, s in after.items():
        if g in s:
            raise ManifestError(
                f"{path}: declared orders are cyclic through group "
                f"{g!r} — no consistent acquisition direction exists")
    return man
