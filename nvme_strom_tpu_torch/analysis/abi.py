"""ctypes-ABI conformance checker (counterpart of
nvme_strom_tpu/analysis/abi.py).

The bug class this kills: ctypes caches ONE function object per CDLL
handle, so two modules assigning ``argtypes`` on the same symbol of a
shared handle silently retype each other, depending on import order;
and a signature that drifts from its C definition truncates or shifts
arguments with no error at all.  The port binds two C ABIs, both checked
here (analysis/cabi.py parses them):

- the C engine, ``csrc/strom_io.h`` (``io/engine.py``, ``io/arena.py``,
  ``io/hostcache.py`` over the handle ``_build.engine_library()``);
- the kernel library, whose ``extern "C"`` entry points are *defined* in
  ``nvme_strom_tpu_torch/csrc/*.cu`` with no header
  (``_build.py`` ``_declare`` over ``_build.kernel_library()``).

Two binding idioms are read:

- the plain one, ``lib.strom_x.argtypes = [...]`` and
  ``lib.strom_x.restype = ...``: the assignment is the bind site;
- the signature table: a dict literal whose keys are ``strom_*`` names
  (``sigs = {"strom_x": (restype, [args]), ...}`` or
  ``{"strom_x": [args]}``) bound by one loop, ``for name, (res, args) in
  sigs.items(): fn = getattr(lib, name); fn.restype = res;
  fn.argtypes = args``.  Each dict entry is one bind site, at the line
  of its key; the loop's ``restype`` may be one constant for every
  entry.  Names bound to ctypes types in the enclosing scopes
  (``P, I = ctypes.c_void_p, ctypes.c_int``) resolve.

Checks, per function of either ABI:

- **completeness** — every function has a bind site that assigns BOTH
  ``argtypes`` and an explicit ``restype`` (ctypes' implicit ``c_int`` is
  not a binding: it is right until the C return type widens);
- **type agreement** — arity, pointer depth, scalar width, struct
  identity (``_RingInfo`` vs ``strom_ring_info``), struct field layout,
  fixed-size array shapes;
- **single-bind ownership** — each symbol's ``argtypes`` is assigned at
  exactly one site, ``restype`` in the same module, and a module calls a
  symbol only if it is the owner or imports the owner (it takes the
  owner's declared handle, ``_build.kernel_library()``, instead of a
  second raw one);
- the kernel sources' own agreement: a declaration of an entry point in
  one translation unit held to its definition in another
  (``strom_decode_attention_f16``).

Everything is static (AST over the sources, the parsed header and
kernel sources): the checker needs no built library and no card.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from nvme_strom_tpu_torch.analysis.cabi import (
    CFunc, HeaderABI, HeaderParseError, expected_ctypes, parse_header,
    parse_kernel_sources, struct_name_matches)
from nvme_strom_tpu_torch.analysis.driver import Violation

CHECK = "abi"


@dataclass
class BindSite:
    module: str          # repo-relative path
    qual: str            # enclosing function/class qualname ("<module>")
    symbol: str
    kind: str            # "argtypes" | "restype"
    line: int
    value: Optional[str]  # canonical spelling, None = unparseable


@dataclass
class ModuleScan:
    path: str
    binds: List[BindSite] = field(default_factory=list)
    calls: List[Tuple[str, int]] = field(default_factory=list)
    structs: Dict[str, List[Tuple[str, str]]] = field(default_factory=dict)
    struct_lines: Dict[str, int] = field(default_factory=dict)
    consts: Dict[str, int] = field(default_factory=dict)
    #: repo-relative paths of the modules this one imports (either form)
    imports: Set[str] = field(default_factory=set)


# --------------------------------------------------------------------------
# python-side normalization
# --------------------------------------------------------------------------

def _const_int(node: ast.AST, consts: Dict[str, int]) -> Optional[int]:
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return node.value
    if isinstance(node, ast.Name):
        return consts.get(node.id)
    return None


def _norm_ctype_expr(node: ast.AST, consts: Dict[str, int],
                     aliases: Optional[Dict[str, str]] = None
                     ) -> Optional[str]:
    """Canonical spelling of a ctypes type expression:
    ``c_uint64`` / ``c_char_p`` / ``None`` / ``POINTER(x)`` /
    ``ARRAY(x,n)`` / ``PYSTRUCT(ClassName)`` (resolved against the
    header later).  ``aliases`` maps local names to spellings
    (``P = ctypes.c_void_p``).  None = not understood (reported, never
    skipped)."""
    if isinstance(node, ast.Constant) and node.value is None:
        return "None"
    if isinstance(node, ast.Attribute):
        # ctypes.c_uint64 (whatever the ctypes module is called locally)
        if node.attr.startswith("c_"):
            return node.attr
        return None
    if isinstance(node, ast.Name):
        if aliases and node.id in aliases:
            return aliases[node.id]
        if node.id.startswith("c_"):
            return node.id
        return f"PYSTRUCT({node.id})"
    if isinstance(node, ast.Call):
        fn = node.func
        fname = fn.attr if isinstance(fn, ast.Attribute) else (
            fn.id if isinstance(fn, ast.Name) else None)
        if fname == "POINTER" and len(node.args) == 1:
            inner = _norm_ctype_expr(node.args[0], consts, aliases)
            return None if inner is None else f"POINTER({inner})"
        return None
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
        inner = _norm_ctype_expr(node.left, consts, aliases)
        n = _const_int(node.right, consts)
        if inner is None or n is None:
            return None
        return f"ARRAY({inner},{n})"
    return None


def _resolve_pystructs(spelling: str,
                       abi: HeaderABI) -> Tuple[str, Optional[str]]:
    """Replace ``PYSTRUCT(X)`` with ``STRUCT(<c name>)`` by matching the
    Python Structure class name against the header's structs.  Returns
    (resolved spelling, error or None)."""
    err: Optional[str] = None

    def _sub(m: re.Match) -> str:
        nonlocal err
        py = m.group(1)
        for c_name in abi.structs:
            if struct_name_matches(py, c_name):
                return f"STRUCT({c_name})"
        err = (f"Python struct class {py!r} matches no struct in "
               f"{abi.path}")
        return f"STRUCT(?{py})"

    return re.sub(r"PYSTRUCT\((\w+)\)", _sub, spelling), err


def _is_ctype_spelling(s: Optional[str]) -> bool:
    return s is not None and s.startswith(("c_", "POINTER(", "ARRAY("))


# --------------------------------------------------------------------------
# module scanning
# --------------------------------------------------------------------------

def _module_paths(dotted: str) -> List[str]:
    """Repo-relative candidates for a dotted module name."""
    base = dotted.replace(".", "/")
    return [f"{base}.py", f"{base}/__init__.py"]


class _Scanner(ast.NodeVisitor):
    def __init__(self, scan: ModuleScan):
        self.scan = scan
        self.stack: List[str] = []
        #: alias scopes, innermost last: name -> ctypes spelling
        self.aliases: List[Dict[str, str]] = [{}]
        #: signature tables by scope: name -> the dict literal
        self.tables: List[Dict[str, ast.Dict]] = [{}]

    # qualname tracking -----------------------------------------------------
    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.stack.append(node.name)
        bases = [ast.unparse(b) for b in node.bases]
        if any(b.split(".")[-1] == "Structure" for b in bases):
            self._capture_struct(node)
        self.generic_visit(node)
        self.stack.pop()

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self.stack.append(node.name)
        self.aliases.append({})
        self.tables.append({})
        self.generic_visit(node)
        self.tables.pop()
        self.aliases.pop()
        self.stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]

    def _qual(self) -> str:
        return ".".join(self.stack) or "<module>"

    def _alias_map(self) -> Dict[str, str]:
        out: Dict[str, str] = {}
        for scope in self.aliases:
            out.update(scope)
        return out

    def _norm(self, node: ast.AST) -> Optional[str]:
        return _norm_ctype_expr(node, self.scan.consts, self._alias_map())

    # imports (call-site ownership) ------------------------------------------
    def visit_Import(self, node: ast.Import) -> None:
        for a in node.names:
            self.scan.imports.update(_module_paths(a.name))

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module and not node.level:
            self.scan.imports.update(_module_paths(node.module))
            for a in node.names:     # "from pkg import module"
                self.scan.imports.update(
                    _module_paths(f"{node.module}.{a.name}"))

    # module-level int constants (array dims like _MAX_RAID_MEMBERS) --------
    def _capture_const(self, node: ast.Assign) -> None:
        if (len(node.targets) == 1 and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, int)):
            self.scan.consts[node.targets[0].id] = node.value.value

    # names bound to ctypes types ("P, I = ctypes.c_void_p, ctypes.c_int") --
    def _capture_aliases(self, node: ast.Assign) -> None:
        for tgt in node.targets:
            pairs: List[Tuple[ast.AST, ast.AST]] = []
            if isinstance(tgt, ast.Name):
                pairs = [(tgt, node.value)]
            elif (isinstance(tgt, ast.Tuple)
                  and isinstance(node.value, ast.Tuple)
                  and len(tgt.elts) == len(node.value.elts)):
                pairs = list(zip(tgt.elts, node.value.elts))
            for t, v in pairs:
                if not isinstance(t, ast.Name):
                    continue
                spelling = self._norm(v)
                if _is_ctype_spelling(spelling):
                    self.aliases[-1][t.id] = spelling
            if (isinstance(tgt, ast.Name) and isinstance(node.value, ast.Dict)
                    and node.value.keys
                    and all(isinstance(k, ast.Constant)
                            and isinstance(k.value, str)
                            and k.value.startswith("strom_")
                            for k in node.value.keys)):
                self.tables[-1][tgt.id] = node.value

    # ctypes.Structure subclasses ------------------------------------------
    def _capture_struct(self, node: ast.ClassDef) -> None:
        fields: List[Tuple[str, str]] = []
        for stmt in node.body:
            if not (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)
                    and stmt.targets[0].id == "_fields_"):
                continue
            val = stmt.value
            if isinstance(val, ast.List):
                for elt in val.elts:
                    got = self._field_pair(elt)
                    if got is None:
                        fields.append(("?", "?"))
                    else:
                        fields.append(got)
            elif isinstance(val, ast.ListComp):
                # the _StatsBlk idiom:
                #   [(n, ctypes.c_uint64) for n in ("a", "b", ...)]
                fields.extend(self._expand_comp(val))
            else:
                fields.append(("?", "?"))
        self.scan.structs[node.name] = fields
        self.scan.struct_lines[node.name] = node.lineno

    def _field_pair(self, elt: ast.AST) -> Optional[Tuple[str, str]]:
        if not (isinstance(elt, ast.Tuple) and len(elt.elts) == 2
                and isinstance(elt.elts[0], ast.Constant)):
            return None
        name = elt.elts[0].value
        spelling = self._norm(elt.elts[1])
        return (str(name), spelling if spelling is not None else "?")

    def _expand_comp(self, comp: ast.ListComp) -> List[Tuple[str, str]]:
        out: List[Tuple[str, str]] = []
        if len(comp.generators) != 1:
            return [("?", "?")]
        gen = comp.generators[0]
        src = gen.iter
        if not (isinstance(src, (ast.Tuple, ast.List))
                and isinstance(comp.elt, ast.Tuple)
                and len(comp.elt.elts) == 2):
            return [("?", "?")]
        spelling = self._norm(comp.elt.elts[1])
        for name_node in src.elts:
            if isinstance(name_node, ast.Constant):
                out.append((str(name_node.value),
                            spelling if spelling is not None else "?"))
        return out

    # binding assignments + raw-handle calls --------------------------------
    def visit_Assign(self, node: ast.Assign) -> None:
        if not self.stack:
            self._capture_const(node)
        self._capture_aliases(node)
        for tgt in node.targets:
            if (isinstance(tgt, ast.Attribute)
                    and tgt.attr in ("argtypes", "restype")
                    and isinstance(tgt.value, ast.Attribute)
                    and tgt.value.attr.startswith("strom_")):
                symbol = tgt.value.attr
                if tgt.attr == "argtypes":
                    value = self._norm_argtypes(node.value)
                else:
                    value = self._norm(node.value)
                self.scan.binds.append(BindSite(
                    module=self.scan.path, qual=self._qual(),
                    symbol=symbol, kind=tgt.attr, line=node.lineno,
                    value=value))
        self.generic_visit(node)

    def _norm_argtypes(self, node: ast.AST) -> Optional[str]:
        if not isinstance(node, (ast.List, ast.Tuple)):
            return None
        parts = []
        for elt in node.elts:
            s = self._norm(elt)
            if s is None:
                return None
            parts.append(s)
        return "[" + ",".join(parts) + "]"

    # the signature-table idiom ---------------------------------------------
    def visit_For(self, node: ast.For) -> None:
        it = node.iter
        table = None
        if (isinstance(it, ast.Call) and isinstance(it.func, ast.Attribute)
                and it.func.attr == "items" and not it.args
                and isinstance(it.func.value, ast.Name)):
            name = it.func.value.id
            for scope in reversed(self.tables):
                if name in scope:
                    table = scope[name]
                    break
        if table is not None:
            self._bind_table(node, table)
        self.generic_visit(node)

    def _bind_table(self, loop: ast.For, table: ast.Dict) -> None:
        """One bind site per table entry, for each of ``argtypes`` and
        ``restype`` the loop's body assigns."""
        tgt = loop.target
        if not (isinstance(tgt, ast.Tuple) and len(tgt.elts) == 2):
            return
        value_names: Dict[str, Optional[int]] = {}   # name -> tuple index
        if isinstance(tgt.elts[1], ast.Name):
            value_names[tgt.elts[1].id] = None
        elif isinstance(tgt.elts[1], ast.Tuple):
            for i, e in enumerate(tgt.elts[1].elts):
                if isinstance(e, ast.Name):
                    value_names[e.id] = i
        for stmt in ast.walk(loop):
            if not isinstance(stmt, ast.Assign):
                continue
            for t in stmt.targets:
                if not (isinstance(t, ast.Attribute)
                        and t.attr in ("argtypes", "restype")):
                    continue
                for key, val in zip(table.keys, table.values):
                    expr: Optional[ast.AST] = stmt.value
                    if (isinstance(stmt.value, ast.Name)
                            and stmt.value.id in value_names):
                        idx = value_names[stmt.value.id]
                        if idx is None:
                            expr = val
                        elif (isinstance(val, ast.Tuple)
                              and len(val.elts) > idx):
                            expr = val.elts[idx]
                        else:
                            expr = None
                    if expr is None:
                        value = None
                    elif t.attr == "argtypes":
                        value = self._norm_argtypes(expr)
                    else:
                        value = self._norm(expr)
                    self.scan.binds.append(BindSite(
                        module=self.scan.path, qual=self._qual(),
                        symbol=key.value, kind=t.attr, line=key.lineno,
                        value=value))

    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        if isinstance(fn, ast.Attribute) and fn.attr.startswith("strom_"):
            self.scan.calls.append((fn.attr, node.lineno))
        self.generic_visit(node)


def scan_module(path: Path, rel: str) -> ModuleScan:
    scan = ModuleScan(path=rel)
    tree = ast.parse(path.read_text(), filename=rel)
    _Scanner(scan).visit(tree)
    return scan


# --------------------------------------------------------------------------
# the check
# --------------------------------------------------------------------------

def check_abi(header_path: Path, py_files: List[Path], root: Path,
              kernel_sources: Sequence[Path] = ()) -> List[Violation]:
    """Run the full conformance pass; returns violations.  A header or
    kernel source the parser cannot read RAISES (exit 2, 'fix the
    linter') instead of returning a violation: a violation is exit 1
    ('fix your code') and waivable, and a broad 'waiver abi *' must never
    be able to green-light a run with zero ABI coverage."""
    out: List[Violation] = []
    abi = parse_header(str(header_path))
    kabi = parse_kernel_sources(list(kernel_sources))
    #: every function either ABI defines, with the file that holds it
    funcs: Dict[str, Tuple[CFunc, str]] = {
        n: (f, str(header_path)) for n, f in abi.funcs.items()}
    for n, f in kabi.funcs.items():
        if n in funcs:
            raise HeaderParseError(
                f"{f.file}:{f.line}: {n} is both a {header_path.name} "
                f"function and a kernel entry point — the checker cannot "
                f"tell which library a binding targets")
        funcs[n] = (f, f.file)
    for file, line, msg in kabi.problems:
        out.append(Violation(CHECK, _rel(file, root), line, msg))
    where_declared = (header_path.name if not kabi.funcs
                      else f"{header_path.name} or the kernel sources")

    scans = [scan_module(p, str(p.relative_to(root))) for p in py_files]

    # ownership map: symbol -> argtypes bind sites
    arg_sites: Dict[str, List[BindSite]] = {}
    res_sites: Dict[str, List[BindSite]] = {}
    for scan in scans:
        for b in scan.binds:
            (arg_sites if b.kind == "argtypes" else
             res_sites).setdefault(b.symbol, []).append(b)

    # unknown symbols (typo'd binds or calls)
    for sites in (arg_sites, res_sites):
        for sym, bs in sites.items():
            if sym not in funcs:
                for b in bs:
                    out.append(Violation(
                        CHECK, b.module, b.line,
                        f"{sym}: bound but not declared in "
                        f"{where_declared} — typo or dead binding"))
    for scan in scans:
        for sym, line in scan.calls:
            if sym not in funcs:
                out.append(Violation(
                    CHECK, scan.path, line,
                    f"{sym}(): called but not declared in "
                    f"{where_declared}"))

    # completeness + single-bind ownership + agreement, per C function
    for name, (func, src) in sorted(funcs.items()):
        asites = arg_sites.get(name, [])
        rsites = res_sites.get(name, [])
        if not asites:
            what = ("declared in the header" if src == str(header_path)
                    else "an entry point of the kernel sources")
            out.append(Violation(
                CHECK, _rel(src, root), func.line,
                f"{name}: {what} but argtypes are bound nowhere in the "
                f"package — every ABI symbol needs one owning bind site",
                key=f"unbound:{name}"))
            continue
        if len(asites) > 1:
            where = ", ".join(f"{b.module}:{b.line}" for b in asites)
            for b in asites[1:]:
                out.append(Violation(
                    CHECK, b.module, b.line,
                    f"{name}: argtypes bound at {len(asites)} sites "
                    f"({where}) — exactly one owning site allowed (a "
                    f"second site retypes the shared handle)"))
        owner = asites[0]
        if not rsites:
            out.append(Violation(
                CHECK, owner.module, owner.line,
                f"{name}: argtypes bound but restype never set — "
                f"ctypes' implicit c_int default is not a binding "
                f"(bind restype explicitly, None for void)"))
        elif len(rsites) > 1:
            where = ", ".join(f"{b.module}:{b.line}" for b in rsites)
            for b in rsites[1:]:
                out.append(Violation(
                    CHECK, b.module, b.line,
                    f"{name}: restype bound at {len(rsites)} sites "
                    f"({where}) — exactly one owning site allowed"))
        if rsites and rsites[0].module != owner.module:
            out.append(Violation(
                CHECK, rsites[0].module, rsites[0].line,
                f"{name}: restype bound in {rsites[0].module} but "
                f"argtypes in {owner.module} — one site must own the "
                f"whole signature"))

        # agreement: argtypes
        want = [expected_ctypes(p.ctype)[0] for p in func.params]
        origin = ("header" if src == str(header_path)
                  else f"definition at {_rel(src, root)}:{func.line}")
        got_s = owner.value
        if got_s is None:
            out.append(Violation(
                CHECK, owner.module, owner.line,
                f"{name}: argtypes expression not statically "
                f"understood — use plain ctypes type lists"))
        else:
            resolved, err = _resolve_pystructs(got_s, abi)
            if err:
                out.append(Violation(CHECK, owner.module, owner.line,
                                     f"{name}: {err}"))
            got = resolved[1:-1].split(",") if resolved != "[]" else []
            got = _rejoin_nested(got)
            if len(got) != len(func.params):
                out.append(Violation(
                    CHECK, owner.module, owner.line,
                    f"{name}: argtypes has {len(got)} entries, "
                    f"{origin} declares {len(func.params)} parameters"))
            else:
                for i, (g, w, p) in enumerate(zip(got, want, func.params)):
                    if not _types_agree(g, w):
                        out.append(Violation(
                            CHECK, owner.module, owner.line,
                            f"{name}: argtypes[{i}] ({p.name}) is {g}, "
                            f"{origin} wants {w} ({p.ctype})"))
        # agreement: restype
        if rsites:
            rs = rsites[0]
            wantr = expected_ctypes(func.ret)[0]
            if rs.value is None:
                out.append(Violation(
                    CHECK, rs.module, rs.line,
                    f"{name}: restype expression not statically "
                    f"understood"))
            else:
                resolved, err = _resolve_pystructs(rs.value, abi)
                if err:
                    out.append(Violation(CHECK, rs.module, rs.line,
                                         f"{name}: {err}"))
                elif not _types_agree(resolved, wantr):
                    out.append(Violation(
                        CHECK, rs.module, rs.line,
                        f"{name}: restype is {resolved}, {origin} wants "
                        f"{wantr} ({func.ret})"))

        # ownership of call sites: the owner, or a module that imports it
        for scan in scans:
            if scan.path == owner.module or owner.module in scan.imports:
                continue
            for sym, line in scan.calls:
                if sym == name:
                    out.append(Violation(
                        CHECK, scan.path, line,
                        f"{name}(): called outside its owning module "
                        f"{owner.module} — delegate through the owner's "
                        f"Python wrapper instead of a second raw handle"))

    # struct layout agreement (every Python Structure that names a
    # header struct must match its field list exactly)
    for scan in scans:
        for py_name, fields in scan.structs.items():
            c_name = next((c for c in abi.structs
                           if struct_name_matches(py_name, c)), None)
            if c_name is None:
                continue
            st = abi.structs[c_name]
            line = scan.struct_lines.get(py_name, 1)
            if len(fields) != len(st.fields):
                out.append(Violation(
                    CHECK, scan.path, line,
                    f"{py_name}: {len(fields)} fields, C struct "
                    f"{c_name} has {len(st.fields)}"))
                continue
            for (fn_py, ft_py), fc in zip(fields, st.fields):
                wantf = expected_ctypes(fc.ctype)[0]
                if fn_py != fc.name:
                    out.append(Violation(
                        CHECK, scan.path, line,
                        f"{py_name}: field {fn_py!r} where C struct "
                        f"{c_name} has {fc.name!r} — order/name drift"))
                elif ft_py != "?" and not _types_agree(ft_py, wantf):
                    out.append(Violation(
                        CHECK, scan.path, line,
                        f"{py_name}.{fn_py}: {ft_py}, C struct wants "
                        f"{wantf}"))
    return out


def _rel(path: str, root: Path) -> str:
    """``path`` relative to ``root`` when it lies under it."""
    try:
        return str(Path(path).resolve().relative_to(root.resolve()))
    except ValueError:
        return str(path)


def _rejoin_nested(parts: List[str]) -> List[str]:
    """Undo the naive comma split inside POINTER(ARRAY(x,n)) etc."""
    out: List[str] = []
    depth = 0
    buf = ""
    for p in parts:
        buf = f"{buf},{p}" if buf else p
        depth = buf.count("(") - buf.count(")")
        if depth == 0:
            out.append(buf)
            buf = ""
    if buf:
        out.append(buf)
    return out


def _types_agree(got: str, want: str) -> bool:
    if got == want:
        return True
    # a POINTER(STRUCT(x)) may legitimately be passed where the C side
    # wants a raw pointer the Python side never dereferences — but not
    # the reverse; and c_char_p/c_void_p are NOT interchangeable (NUL
    # semantics differ).
    if want == "c_void_p" and got.startswith("POINTER("):
        return True
    # size_t == uint64 on every platform this engine builds for (LP64);
    # so are unsigned long and long long's widths
    aliases = {"c_size_t": "c_uint64", "c_ulong": "c_uint64",
               "c_ulonglong": "c_uint64", "c_long": "c_int64",
               "c_longlong": "c_int64", "c_uint": "c_uint32",
               "c_int": "c_int32"}
    return aliases.get(got, got) == aliases.get(want, want)
