"""Lock-discipline static analyzer (counterpart of
nvme_strom_tpu/analysis/locks.py).

An AST pass over the port's modules that:

1. finds every lock *definition* — ``threading.Lock/RLock/Condition``
   and the witness constructors ``make_lock/make_rlock/make_condition``
   (whose first argument IS the lock's manifest id), dataclass fields
   built by a ``default_factory`` included;
2. builds the intra-module *acquisition graph*: a ``with lockB:`` nested
   (lexically, or through a resolvable same-module/aliased-module call)
   inside ``with lockA:`` is an edge A->B;
3. checks every edge against the declared lock-order manifest
   (analysis/manifest.py) and flags same-lock re-acquisition through a
   non-reentrant lock: a self-deadlock, found before it runs;
4. flags *blocking operations under a lock* — engine waits, memcpy/CRC
   fills, syscalls, ``time.sleep``, a CUDA stream synchronize,
   ``Condition.wait`` while a lock other than the condition's own is
   held.

Deliberate scope: the pass is intra-module plus one level of resolvable
calls (``self.method``, module functions, ``alias.function`` of another
analyzed module).  Cross-object edges it cannot see statically are the
runtime witness's job (utils/lockwitness.py, armed in the port's
chaos-class tests); the two halves enforce the same manifest.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

from nvme_strom_tpu_torch.analysis.driver import Violation
from nvme_strom_tpu_torch.analysis.manifest import LockManifest

CHECK_ORDER = "lock-order"
CHECK_BLOCKING = "lock-blocking"

#: bare callee names that block regardless of receiver
_BLOCKING_NAMES = {
    "sleep", "wait_exact", "wait_timeout", "crc32c", "copy_in",
    "pread", "pwrite", "fsync", "fdatasync",
    "check_call", "check_output", "Popen",
    "strom_wait", "strom_wait_timeout", "strom_submit_read",
    "strom_submit_write", "strom_hostcache_copy", "strom_crc32c",
    "strom_read_buffered", "strom_ring_restart", "strom_tar_index",
    # the kernel library's host-side wait on a CUDA stream
    "strom_stream_synchronize",
}
#: two-segment callee tails that block ("subprocess.run", not dict.get)
_BLOCKING_PAIRS = {
    "subprocess.run", "os.read", "os.write", "os.replace",
    "os.rename", "time.sleep",
}
_WITNESS_CTORS = {"make_lock": "lock", "make_rlock": "rlock",
                  "make_condition": "condition"}
_THREADING_CTORS = {"Lock": "lock", "RLock": "rlock",
                    "Condition": "condition"}


@dataclass
class LockDef:
    id: str
    kind: str                 # lock | rlock | condition
    module: str               # repo-relative path
    line: int
    alias_of: Optional[str] = None   # condition -> its underlying lock id

    @property
    def eff_id(self) -> str:
        """Identity used for deadlock/order edges: a Condition IS its
        underlying lock."""
        return self.alias_of or self.id


@dataclass
class Acq:
    """One acquisition edge held -> acquired."""
    held: str
    acquired: str
    file: str
    line: int
    how: str                  # "nested with" | "via call to <qual>"


@dataclass
class _FuncInfo:
    qual: str                               # "mod:Class.method"
    acquires: Set[str] = field(default_factory=set)   # direct eff_ids
    blocking: List[Tuple[str, int]] = field(default_factory=list)
    calls: List[Tuple[str, int]] = field(default_factory=list)  # resolved


@dataclass
class ModuleLocks:
    path: str                 # repo-relative
    modbase: str              # "sched"
    #: (class or "", attr) -> LockDef
    defs: Dict[Tuple[str, str], LockDef] = field(default_factory=dict)
    funcs: Dict[str, _FuncInfo] = field(default_factory=dict)
    #: local alias -> modbase of another analyzed module
    imports: Dict[str, str] = field(default_factory=dict)
    #: from-imported symbol -> "name:source-modbase"
    from_imports: Dict[str, str] = field(default_factory=dict)
    #: raw events for the second pass: (qual, held eff_id stack snapshot,
    #: node kind, payload, line)
    events: List[tuple] = field(default_factory=list)


def _modbase(rel: str) -> str:
    return Path(rel).stem


# --------------------------------------------------------------------------
# per-module scan
# --------------------------------------------------------------------------

class _LockScanner(ast.NodeVisitor):
    def __init__(self, mod: ModuleLocks):
        self.mod = mod
        self.cls: List[str] = []
        self.fn: List[str] = []
        self.held: List[LockDef] = []

    # -- imports ----------------------------------------------------------
    def visit_Import(self, node: ast.Import) -> None:
        for a in node.names:
            alias = a.asname or a.name.split(".")[0]
            self.mod.imports[alias] = a.name.rsplit(".", 1)[-1]

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if not node.module:
            return
        src = node.module.rsplit(".", 1)[-1]
        for a in node.names:
            # "from pkg.io import hostcache" binds a MODULE alias;
            # "from pkg.io.engine import _load_lib" binds a symbol whose
            # calls must resolve into the source module
            self.mod.from_imports[a.asname or a.name] = f"{a.name}:{src}"

    # -- qualname machinery ----------------------------------------------
    def _qual(self) -> str:
        bits = [b for b in (self.cls[-1] if self.cls else "",
                            ".".join(self.fn)) if b]
        return f"{self.mod.modbase}:{'.'.join(bits) or '<module>'}"

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.cls.append(node.name)
        self.generic_visit(node)
        self.cls.pop()

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self.fn.append(node.name)
        qual = self._qual()
        self.mod.funcs.setdefault(qual, _FuncInfo(qual=qual))
        outer_held = self.held
        self.held = []          # a new frame holds nothing on entry
        self.generic_visit(node)
        self.held = outer_held
        self.fn.pop()

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]

    # -- lock definitions -------------------------------------------------
    def _lock_ctor(self, call: ast.Call) -> Optional[Tuple[str,
                                                           Optional[str],
                                                           Optional[str]]]:
        """(kind, declared_name, cond_arg_src) when ``call`` constructs a
        lock/rlock/condition."""
        fn = call.func
        name = fn.attr if isinstance(fn, ast.Attribute) else (
            fn.id if isinstance(fn, ast.Name) else None)
        if name in _WITNESS_CTORS:
            declared = (call.args[0].value
                        if call.args and isinstance(call.args[0],
                                                    ast.Constant)
                        else None)
            arg = (ast.unparse(call.args[1])
                   if name == "make_condition" and len(call.args) > 1
                   else None)
            return _WITNESS_CTORS[name], declared, arg
        if name in _THREADING_CTORS:
            arg = (ast.unparse(call.args[0])
                   if name == "Condition" and call.args else None)
            return _THREADING_CTORS[name], None, arg
        return None

    def visit_Assign(self, node: ast.Assign) -> None:
        if isinstance(node.value, ast.Call):
            got = self._lock_ctor(node.value)
            if got is not None:
                kind, declared, cond_arg = got
                for tgt in node.targets:
                    key = None
                    if (isinstance(tgt, ast.Attribute)
                            and isinstance(tgt.value, ast.Name)
                            and tgt.value.id == "self" and self.cls):
                        key = (self.cls[-1], tgt.attr)
                    elif isinstance(tgt, ast.Name) and not self.fn:
                        key = ("", tgt.id)
                    if key is None:
                        continue
                    default = (f"{self.mod.modbase}."
                               + (f"{key[0]}.{key[1]}" if key[0]
                                  else key[1]))
                    alias = None
                    if kind == "condition" and cond_arg:
                        alias = self._resolve_lock_src(cond_arg)
                    self.mod.defs[key] = LockDef(
                        id=declared or default, kind=kind,
                        module=self.mod.path, line=node.lineno,
                        alias_of=alias)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        # dataclass-field locks:
        #   _lock: threading.Lock = field(default_factory=lambda:
        #                                 make_lock("..."), ...)
        if (self.cls and not self.fn
                and isinstance(node.target, ast.Name)
                and isinstance(node.value, ast.Call)):
            fn = node.value.func
            fname = fn.attr if isinstance(fn, ast.Attribute) else (
                fn.id if isinstance(fn, ast.Name) else None)
            if fname == "field":
                factory = next(
                    (kw.value for kw in node.value.keywords
                     if kw.arg == "default_factory"), None)
                ctor = None
                if isinstance(factory, ast.Lambda) and \
                        isinstance(factory.body, ast.Call):
                    ctor = self._lock_ctor(factory.body)
                elif factory is not None:
                    # default_factory=threading.Lock
                    name = (factory.attr
                            if isinstance(factory, ast.Attribute)
                            else (factory.id
                                  if isinstance(factory, ast.Name)
                                  else None))
                    if name in _THREADING_CTORS:
                        ctor = (_THREADING_CTORS[name], None, None)
                if ctor is not None:
                    kind, declared, _ = ctor
                    key = (self.cls[-1], node.target.id)
                    default = f"{self.mod.modbase}.{key[0]}.{key[1]}"
                    self.mod.defs[key] = LockDef(
                        id=declared or default, kind=kind,
                        module=self.mod.path, line=node.lineno)
        self.generic_visit(node)

    def _resolve_lock_src(self, src: str) -> Optional[str]:
        """'self._lock' -> the eff id of that lock, if known."""
        src = src.strip()
        if src.startswith("self.") and self.cls:
            d = self.mod.defs.get((self.cls[-1], src[len("self."):]))
        else:
            d = self.mod.defs.get(("", src))
        return d.id if d else None

    # -- acquisition + call/blocking events -------------------------------
    def _resolve_with_expr(self, expr: ast.AST) -> Optional[LockDef]:
        if (isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Name)
                and expr.value.id == "self" and self.cls):
            return self.mod.defs.get((self.cls[-1], expr.attr))
        if isinstance(expr, ast.Name):
            return self.mod.defs.get(("", expr.id))
        return None

    def visit_With(self, node: ast.With) -> None:
        taken: List[LockDef] = []
        for item in node.items:
            d = self._resolve_with_expr(item.context_expr)
            if d is None:
                continue
            if self.fn:
                qual = self._qual()
                info = self.mod.funcs[qual]
                info.acquires.add(d.eff_id)
                held_ids = [h.eff_id for h in self.held]
                self.mod.events.append(
                    (qual, tuple(held_ids), "acquire", d,
                     item.context_expr.lineno))
            self.held.append(d)
            taken.append(d)
        for stmt in node.body:
            self.visit(stmt)
        for _ in taken:
            self.held.pop()

    visit_AsyncWith = visit_With  # type: ignore[assignment]

    def _callee_repr(self, fn: ast.AST) -> Tuple[str, List[str]]:
        """(dotted repr for matching, candidate resolved quals — the
        second pass keeps whichever candidate has a summary)."""
        if isinstance(fn, ast.Name):
            got = self.mod.from_imports.get(fn.id)
            if got is not None:
                name, src = got.split(":", 1)
                # "from pkg.mod import sym" -> mod:sym
                return fn.id, [f"{src}:{name}"]
            return fn.id, [f"{self.mod.modbase}:{fn.id}"]
        if isinstance(fn, ast.Attribute):
            parts: List[str] = [fn.attr]
            cur = fn.value
            while isinstance(cur, ast.Attribute):
                parts.append(cur.attr)
                cur = cur.value
            if isinstance(cur, ast.Name):
                parts.append(cur.id)
            parts.reverse()
            dotted = ".".join(parts)
            quals: List[str] = []
            if parts[0] == "self" and len(parts) == 2 and self.cls:
                quals.append(f"{self.mod.modbase}:{self.cls[-1]}."
                             f"{parts[1]}")
            elif len(parts) == 2:
                if parts[0] in self.mod.imports:
                    quals.append(f"{self.mod.imports[parts[0]]}:"
                                 f"{parts[1]}")
                got = self.mod.from_imports.get(parts[0])
                if got is not None:
                    # "from pkg import mod [as alias]" -> mod:attr
                    name, _src = got.split(":", 1)
                    quals.append(f"{name}:{parts[1]}")
            return dotted, quals
        return "<dynamic>", []

    def visit_Call(self, node: ast.Call) -> None:
        if self.fn:
            qual = self._qual()
            info = self.mod.funcs[qual]
            dotted, callee_quals = self._callee_repr(node.func)
            for cq in callee_quals:
                info.calls.append((cq, node.lineno))
            final = dotted.rsplit(".", 1)[-1]
            pair = ".".join(dotted.split(".")[-2:])
            blocking = (final in _BLOCKING_NAMES
                        or pair in _BLOCKING_PAIRS)
            cond_wait = final in ("wait", "wait_for")
            if blocking or cond_wait:
                recv = (node.func.value if isinstance(node.func,
                                                      ast.Attribute)
                        else None)
                recv_lock = (self._resolve_with_expr(recv)
                             if recv is not None else None)
                info.blocking.append((dotted, node.lineno))
                if self.held:
                    self.mod.events.append(
                        (qual, tuple(h.eff_id for h in self.held),
                         "blocking",
                         (dotted, recv_lock, cond_wait, blocking),
                         node.lineno))
            elif self.held and callee_quals:
                self.mod.events.append(
                    (qual, tuple(h.eff_id for h in self.held),
                     "call", tuple(callee_quals), node.lineno))
        self.generic_visit(node)


def scan_module_locks(path: Path, rel: str) -> ModuleLocks:
    mod = ModuleLocks(path=rel, modbase=_modbase(rel))
    tree = ast.parse(path.read_text(), filename=rel)
    # pass 1 collects lock DEFINITIONS so a method that acquires a lock
    # textually above its __init__ still resolves; pass 2 records events
    _LockScanner(mod).visit(tree)
    mod.funcs = {}
    mod.events = []
    mod.imports = {}
    mod.from_imports = {}
    _LockScanner(mod).visit(tree)
    return mod


# --------------------------------------------------------------------------
# cross-function analysis
# --------------------------------------------------------------------------

def _transitive_acquires(mods: List[ModuleLocks]) -> Dict[str, Set[str]]:
    funcs: Dict[str, _FuncInfo] = {}
    for m in mods:
        funcs.update(m.funcs)
    trans: Dict[str, Set[str]] = {q: set(i.acquires)
                                  for q, i in funcs.items()}
    for _ in range(24):
        changed = False
        for q, info in funcs.items():
            for callee, _ in info.calls:
                extra = trans.get(callee)
                if extra and not extra <= trans[q]:
                    trans[q] |= extra
                    changed = True
        if not changed:
            break
    return trans


def _kind_of(mods: List[ModuleLocks], eff_id: str) -> str:
    for m in mods:
        for d in m.defs.values():
            if d.eff_id == eff_id or d.id == eff_id:
                if d.alias_of is None:
                    return d.kind
    for m in mods:          # alias target definition
        for d in m.defs.values():
            if d.id == eff_id:
                return d.kind
    return "lock"


def check_locks(py_files: List[Path], root: Path,
                manifest: LockManifest) -> Tuple[List[Violation],
                                                 List[Acq]]:
    """Run the discipline pass.  Returns (violations, every acquisition
    edge observed) — the edge list feeds strom_lint's ``--dump-graph``
    and the tests' topology assertions."""
    out: List[Violation] = []
    mods = [scan_module_locks(p, str(p.relative_to(root)))
            for p in py_files]
    trans = _transitive_acquires(mods)
    direct_blocking: Dict[str, List[Tuple[str, int]]] = {}
    for m in mods:
        for q, info in m.funcs.items():
            direct_blocking[q] = info.blocking

    edges: List[Acq] = []

    def _edge(held: str, acq: str, file: str, line: int,
              how: str) -> None:
        edges.append(Acq(held, acq, file, line, how))
        if held == acq:
            if _kind_of(mods, held) != "rlock":
                key = f"{held}->{acq}"
                w = manifest.waive("order", key)
                out.append(Violation(
                    CHECK_ORDER, file, line,
                    f"self-deadlock: {held} re-acquired while already "
                    f"held ({how}) and it is not an RLock",
                    key=key, waived=w is not None,
                    waive_reason=w.reason if w else None))
            return
        why = manifest.order_violations(held, acq)
        if why is not None:
            key = f"{held}->{acq}"
            w = manifest.waive("order", key)
            out.append(Violation(
                CHECK_ORDER, file, line,
                f"lock-order inversion ({how}): {why}",
                key=key, waived=w is not None,
                waive_reason=w.reason if w else None))

    for m in mods:
        for qual, held_ids, kind, payload, line in m.events:
            if kind == "acquire":
                d: LockDef = payload
                for h in held_ids:
                    _edge(h, d.eff_id, m.path, line, "nested with")
            elif kind == "call":
                # first candidate with a summary wins (module-alias vs
                # from-import ambiguity)
                callee = next((c for c in payload
                               if c in trans or c in direct_blocking),
                              None)
                if callee is None:
                    continue
                for acq in sorted(trans.get(callee, ())):
                    for h in held_ids:
                        _edge(h, acq, m.path, line,
                              f"via call to {callee}")
                # depth-1 blocking propagation
                for dotted, bline in direct_blocking.get(callee, []):
                    _report_blocking(out, manifest, m.path, line,
                                     held_ids, dotted,
                                     note=f" (inside {callee}, "
                                          f"line {bline})")
            elif kind == "blocking":
                dotted, recv_lock, cond_wait, hard = payload
                if cond_wait and recv_lock is not None:
                    own = {recv_lock.eff_id, recv_lock.id}
                    others = [h for h in held_ids if h not in own]
                    if others:
                        _report_blocking(
                            out, manifest, m.path, line, tuple(others),
                            dotted,
                            note=" — Condition.wait releases only its "
                                 "own lock; every other held lock "
                                 "blocks for the full wait")
                elif cond_wait and not hard:
                    # .wait()/.wait_for() on something that is not a
                    # known condition: engine/Pending waits block
                    _report_blocking(out, manifest, m.path, line,
                                     held_ids, dotted)
                else:
                    _report_blocking(out, manifest, m.path, line,
                                     held_ids, dotted)

    return out, edges


def _report_blocking(out: List[Violation], manifest: LockManifest,
                     file: str, line: int, held_ids: tuple,
                     dotted: str, note: str = "") -> None:
    if not held_ids:
        return
    if manifest.is_blocking_allowed(dotted):
        return
    inner = held_ids[-1]
    key = f"{inner}:{dotted}"
    w = manifest.waive("blocking", key)
    out.append(Violation(
        CHECK_BLOCKING, file, line,
        f"blocking operation {dotted}() while holding "
        f"{', '.join(held_ids)}{note} — move it outside the lock or "
        f"waive with a reason",
        key=key, waived=w is not None,
        waive_reason=w.reason if w else None))
