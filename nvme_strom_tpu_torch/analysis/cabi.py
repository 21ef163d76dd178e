"""Parser for the two C ABIs the port binds with ctypes (counterpart of
nvme_strom_tpu/analysis/cabi.py).

- ``csrc/strom_io.h``: the ``strom_*`` prototypes and structs of the C
  engine, the contract between the engine and every ctypes consumer, as
  in the reference (:func:`parse_header`).
- ``nvme_strom_tpu_torch/csrc/*.cu``: the ``extern "C"`` entry points of
  the port's hand-written CUDA kernels, which no header declares: their
  *definitions* are the ground truth (:func:`parse_kernel_sources`).

This is not a C compiler: it understands exactly the subset the sources
use (``extern "C"`` prototypes and definitions, single or in ``extern "C"
{ ... }`` blocks; ``typedef struct { ... } name;`` blocks; ``#define`` of
integer constants and of an entry point's name; ``#ifdef`` / ``#ifndef``
/ ``#else`` / ``#endif``; ``#include`` of another ``.cu``; fixed-size
array fields and parameters) and *fails loudly* on anything it cannot
parse, so a source edit the parser does not understand breaks the lint
run instead of silently shrinking its coverage.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

#: scalar C type token -> canonical name (also the ctypes suffix:
#: canonical "uint64" corresponds to ctypes.c_uint64)
_SCALARS = {
    "int": "int",
    "unsigned": "uint",
    "unsigned int": "uint",
    "char": "char",
    "int8_t": "int8", "uint8_t": "uint8",
    "int16_t": "int16", "uint16_t": "uint16",
    "int32_t": "int32", "uint32_t": "uint32",
    "int64_t": "int64", "uint64_t": "uint64",
    "size_t": "size_t",
    "void": "void",
    "float": "float",
    "double": "double",
    "bool": "bool",
    "long": "long",
    "unsigned long": "ulong",
    "long long": "longlong",
    "unsigned long long": "ulonglong",
}


class HeaderParseError(ValueError):
    """The header contains a construct this parser does not understand —
    extend the parser, never skip the declaration."""


@dataclass(frozen=True)
class CType:
    """Canonicalized C type: a scalar or struct base, pointer depth, and
    array dimensions (outermost first; arrays in parameter position decay
    to one extra pointer level)."""
    base: str                       # canonical scalar or "struct:<name>"
    ptr: int = 0                    # pointer depth
    dims: Tuple[int, ...] = ()      # array dims, outermost first

    def __str__(self) -> str:
        s = self.base + "*" * self.ptr
        for d in self.dims:
            s += f"[{d}]"
        return s


@dataclass
class CParam:
    name: str
    ctype: CType


@dataclass
class CFunc:
    name: str
    ret: CType
    params: List[CParam]
    line: int
    #: the source that declares (header) or defines (kernel source) it;
    #: "" for a header function (the header's own path)
    file: str = ""


@dataclass
class CStruct:
    name: str
    fields: List[CParam] = field(default_factory=list)
    line: int = 0


@dataclass
class HeaderABI:
    """Everything the conformance checker needs from one header."""
    path: str
    funcs: Dict[str, CFunc] = field(default_factory=dict)
    structs: Dict[str, CStruct] = field(default_factory=dict)
    macros: Dict[str, int] = field(default_factory=dict)


def _strip_comments(text: str) -> str:
    # replace comments with spaces, preserving newlines for line numbers
    def _blank(m: re.Match) -> str:
        return re.sub(r"[^\n]", " ", m.group(0))
    text = re.sub(r"/\*.*?\*/", _blank, text, flags=re.S)
    return re.sub(r"//[^\n]*", _blank, text)


def _parse_decl(tokens: str, macros: Dict[str, int],
                where: str) -> Tuple[CType, str]:
    """``tokens`` is one declarator ("const strom_rd_ext *exts",
    "uint64_t out_read[STROM_LAT_BUCKETS]", "void", ...).  Returns
    (CType, name); name is "" for abstract declarators."""
    t = tokens.strip()
    dims: List[int] = []
    for m in reversed(list(re.finditer(r"\[\s*([A-Za-z_0-9]+)\s*\]", t))):
        tok = m.group(1)
        if tok.isdigit():
            dims.insert(0, int(tok))
        elif tok in macros:
            dims.insert(0, macros[tok])
        else:
            raise HeaderParseError(
                f"{where}: unknown array dimension {tok!r} in {tokens!r}")
        t = t[:m.start()] + t[m.end():]
    ptr = t.count("*")
    t = t.replace("*", " ")
    words = [w for w in t.split() if w not in ("const", "struct")]
    if not words:
        raise HeaderParseError(f"{where}: empty declarator in {tokens!r}")
    # longest scalar match first ("unsigned long long", "unsigned int")
    name = ""
    for n in (3, 2, 1):
        if len(words) >= n and " ".join(words[:n]) in _SCALARS:
            base, rest = _SCALARS[" ".join(words[:n])], words[n:]
            break
    else:
        base, rest = f"struct:{words[0]}", words[1:]
    if len(rest) > 1:
        raise HeaderParseError(f"{where}: cannot parse declarator {tokens!r}")
    if rest:
        name = rest[0]
    return CType(base, ptr, tuple(dims)), name


def parse_header(path: str) -> HeaderABI:
    """Parse ``path`` into a :class:`HeaderABI`.  Every ``strom_``
    prototype and every ``typedef struct`` is captured; a declaration the
    parser cannot handle raises :class:`HeaderParseError`."""
    raw = open(path).read()
    text = _strip_comments(raw)
    abi = HeaderABI(path=path)

    for m in re.finditer(r"^\s*#\s*define\s+([A-Z_0-9]+)\s+"
                         r"(0x[0-9a-fA-F]+|\d+)u?\s*$",
                         text, re.M):
        abi.macros[m.group(1)] = int(m.group(2), 0)

    # opaque handles: "typedef struct X X;" — treated as void* targets
    opaque = set(re.findall(
        r"typedef\s+struct\s+(\w+)\s+\1\s*;", text))

    for m in re.finditer(
            r"typedef\s+struct\s+(\w+)?\s*\{(.*?)\}\s*(\w+)\s*;",
            text, re.S):
        name = m.group(3)
        line = text[:m.start()].count("\n") + 1
        st = CStruct(name=name, line=line)
        body = m.group(2)
        for decl in body.split(";"):
            decl = decl.strip()
            if not decl:
                continue
            ctype, fname = _parse_decl(decl, abi.macros,
                                       f"{path}:struct {name}")
            if not fname:
                raise HeaderParseError(
                    f"{path}: unnamed field in struct {name}: {decl!r}")
            st.fields.append(CParam(fname, ctype))
        abi.structs[name] = st

    # prototypes: "<ret> strom_xxx(<params>);" possibly spanning lines.
    # The return type may itself be a pointer ("void *strom_arena_create").
    for m in re.finditer(
            r"^[ \t]*([A-Za-z_][A-Za-z_0-9 ]*?[ \t*]+)"
            r"(strom_\w+)\s*\(([^;{]*)\)\s*;",
            text, re.M | re.S):
        ret_tok, name, params_tok = m.groups()
        line = text[:m.start()].count("\n") + 1
        where = f"{path}:{line}"
        ret, _ = _parse_decl(ret_tok, abi.macros, where)
        params: List[CParam] = []
        params_tok = params_tok.strip()
        if params_tok and params_tok != "void":
            for p in params_tok.split(","):
                ctype, pname = _parse_decl(p, abi.macros, where)
                # array parameters decay to pointers
                if ctype.dims:
                    ctype = CType(ctype.base, ctype.ptr + 1,
                                  ctype.dims[1:])
                params.append(CParam(pname, ctype))
        if ret.base.startswith("struct:") and \
                ret.base[len("struct:"):] in opaque:
            ret = CType("void", max(ret.ptr, 1), ret.dims)
        fixed: List[CParam] = []
        for p in params:
            if p.ctype.base.startswith("struct:") and \
                    p.ctype.base[len("struct:"):] in opaque:
                p = CParam(p.name, CType("void", max(p.ctype.ptr, 1),
                                         p.ctype.dims))
            fixed.append(p)
        abi.funcs[name] = CFunc(name=name, ret=ret, params=fixed, line=line)

    if not abi.funcs:
        raise HeaderParseError(f"{path}: no strom_* prototypes found — "
                               "the parser or the header rotted")
    # the loud-failure backstop the module contract promises: any
    # strom_* name followed by '(' that the prototype regex did NOT
    # capture is a declaration shape we cannot parse (e.g. the return
    # type on its own line) — fail the run instead of silently
    # exempting that function from every conformance check
    for m in re.finditer(r"\b(strom_\w+)\s*\(", text):
        name = m.group(1)
        if name not in abi.funcs:
            line = text[:m.start()].count("\n") + 1
            raise HeaderParseError(
                f"{path}:{line}: {name!r} looks like a prototype the "
                f"parser could not capture (return type on its own "
                f"line?) — extend the parser, never skip the "
                f"declaration")
    return abi


# --------------------------------------------------------------------------
# the kernel library's entry points (nvme_strom_tpu_torch/csrc/*.cu)
# --------------------------------------------------------------------------

@dataclass
class KernelABI:
    """The ``extern "C"`` entry points the kernel sources define, across
    every translation unit (each ``.cu`` is one: the build runs one
    ``nvcc -c`` a source), and what disagrees among them."""
    sources: List[str] = field(default_factory=list)
    funcs: Dict[str, CFunc] = field(default_factory=dict)
    #: (file, line, message): a declaration that disagrees with the
    #: definition, a declaration defined nowhere, a second definition
    problems: List[Tuple[str, int, str]] = field(default_factory=list)


@dataclass
class _Line:
    text: str
    file: str            # the source this line comes from
    line: int
    unknown: bool        # under a condition the parser cannot decide


_DIRECTIVE = re.compile(r"^\s*#\s*(\w+)\s*(.*?)\s*$")
_IDENT = re.compile(r"^[A-Za-z_]\w*$")


def _preprocess(path, defines: Dict[str, str], depth: int = 0
                ) -> List[_Line]:
    """The lines of one translation unit that the compiler sees, with
    ``#include "x.cu"`` expanded, ``#ifdef`` / ``#ifndef`` / ``#else`` /
    ``#endif`` decided and object-like macros naming an identifier
    substituted.  ``#include`` of a header (``.cuh``, ``.h``) is not
    expanded: a header that holds an ``extern "C"`` raises.  A condition
    the parser cannot decide (``#if expr``) keeps both branches, marked
    ``unknown``."""
    from pathlib import Path
    path = Path(path)
    if depth > 8:
        raise HeaderParseError(f"{path}: #include nesting too deep")
    text = _strip_comments(path.read_text())
    out: List[_Line] = []
    #: one frame an open #if: (state, taken): state True / False / None
    stack: List[List[Optional[bool]]] = []

    def live() -> Optional[bool]:
        if any(f[0] is False for f in stack):
            return False
        return None if any(f[0] is None for f in stack) else True

    for lineno, raw in enumerate(text.split("\n"), 1):
        where = f"{path}:{lineno}"
        m = _DIRECTIVE.match(raw)
        if m is None:
            state = live()
            if state is not False:
                line = raw
                for name, val in defines.items():
                    if _IDENT.match(val) and name in line:
                        line = re.sub(rf"\b{name}\b", val, line)
                out.append(_Line(line, str(path), lineno, state is None))
            continue
        word, rest = m.group(1), m.group(2)
        if word in ("ifdef", "ifndef"):
            known = rest.split()[0] in defines if rest else False
            st = (known if word == "ifdef" else not known) \
                and live() is not False
            stack.append([st, st])
        elif word == "if":
            stack.append([None, None])
        elif word in ("elif", "else"):
            if not stack:
                raise HeaderParseError(f"{where}: #{word} without #if")
            f = stack[-1]
            if word == "elif" or f[1] is None:
                f[0] = None
            else:
                f[0] = not f[1]
                f[1] = True
        elif word == "endif":
            if not stack:
                raise HeaderParseError(f"{where}: #endif without #if")
            stack.pop()
        elif live() is False:
            continue
        elif word == "define":
            parts = rest.split(None, 1)
            if not parts:
                raise HeaderParseError(f"{where}: empty #define")
            name = parts[0]
            if "(" not in name:           # function-like macros: ignored
                defines[name] = parts[1].strip() if len(parts) > 1 else ""
        elif word == "undef":
            defines.pop(rest.strip(), None)
        elif word == "include":
            inc = re.match(r'"([^"]+)"', rest)
            if inc is None:
                continue                  # a system header
            target = path.parent / inc.group(1)
            if not target.exists():
                raise HeaderParseError(f"{where}: #include {rest} not found")
            if target.suffix == ".cu":
                out.extend(_preprocess(target, defines, depth + 1))
            elif re.search(r'extern\s+"C"',
                           _strip_comments(target.read_text())):
                raise HeaderParseError(
                    f"{where}: {target.name} holds an extern \"C\" "
                    f"declaration — the parser reads entry points from "
                    f".cu sources only; extend it")
        # #pragma, #error, #line ...: nothing for the ABI
    if stack:
        raise HeaderParseError(f"{path}: unterminated #if")
    return out


def _skip_literal(text: str, i: int) -> int:
    """Index past the string or char literal that starts at ``i``."""
    q = text[i]
    i += 1
    while i < len(text) and text[i] != q:
        i += 2 if text[i] == "\\" else 1
    return i + 1


def _match_brace(text: str, i: int) -> int:
    """Index past the ``}`` that closes the ``{`` at ``i``."""
    depth = 0
    while i < len(text):
        c = text[i]
        if c in "\"'":
            i = _skip_literal(text, i)
            continue
        if c == "{":
            depth += 1
        elif c == "}":
            depth -= 1
            if depth == 0:
                return i + 1
        i += 1
    raise HeaderParseError("unbalanced braces")


def _head_until(text: str, i: int) -> Tuple[str, int, str]:
    """From ``i``, the text up to the first ``{`` or ``;`` outside
    parentheses: (head, index of that character, the character)."""
    depth = 0
    j = i
    while j < len(text):
        c = text[j]
        if c == "(":
            depth += 1
        elif c == ")":
            depth -= 1
        elif depth == 0 and c in "{;":
            return text[i:j], j, c
        j += 1
    raise HeaderParseError("an extern \"C\" item runs to the end of the file")


_PROTO = re.compile(r"^(.*?[\s*&])([A-Za-z_]\w*)\s*\((.*)\)\s*$", re.S)


def _parse_proto(head: str, where: str) -> CFunc:
    m = _PROTO.match(head.strip())
    if m is None:
        raise HeaderParseError(
            f"{where}: cannot parse the entry point {head.strip()!r} — "
            f"extend the parser, never skip the declaration")
    ret_tok, name, params_tok = m.groups()
    ret, _ = _parse_decl(ret_tok, {}, where)
    params: List[CParam] = []
    params_tok = params_tok.strip()
    if params_tok and params_tok != "void":
        for ptok in params_tok.split(","):
            ctype, pname = _parse_decl(ptok, {}, where)
            if ctype.dims:
                ctype = CType(ctype.base, ctype.ptr + 1, ctype.dims[1:])
            params.append(CParam(pname, ctype))
    return CFunc(name=name, ret=ret, params=params, line=0)


def _unit_entry_points(tu) -> List[Tuple[CFunc, bool]]:
    """(function, is_definition) for every ``extern "C"`` item of one
    translation unit, each with the file and line it comes from."""
    lines = _preprocess(tu, {})
    text = "\n".join(ln.text for ln in lines)
    starts = [0]
    for ln in lines:
        starts.append(starts[-1] + len(ln.text) + 1)

    def origin(off: int) -> _Line:
        lo, hi = 0, len(lines) - 1
        while lo < hi:                      # last start <= off
            mid = (lo + hi + 1) // 2
            if starts[mid] <= off:
                lo = mid
            else:
                hi = mid - 1
        return lines[lo]

    found: List[Tuple[CFunc, bool]] = []

    def item(i: int, end: int) -> int:
        """Parse the item at ``i`` (not past ``end``); index after it."""
        head, j, c = _head_until(text, i)
        if j > end:
            raise HeaderParseError(f"{tu}: an extern \"C\" block item "
                                   f"runs past the block")
        src = origin(i + len(head) - len(head.lstrip()))
        where = f"{src.file}:{src.line}"
        if src.unknown:
            raise HeaderParseError(
                f"{where}: an entry point under a condition the parser "
                f"cannot decide (#if expr) — extend the parser")
        fn = _parse_proto(head, where)
        fn.line, fn.file = src.line, src.file
        found.append((fn, c == "{"))
        return _match_brace(text, j) if c == "{" else j + 1

    for m in re.finditer(r'\bextern\s+"C"\s*', text):
        i = m.end()
        if text.startswith("{", i):
            end = _match_brace(text, i) - 1
            k = i + 1
            while True:
                while k < end and text[k].isspace():
                    k += 1
                if k >= end:
                    break
                k = item(k, end)
        else:
            item(i, len(text))
    return found


def parse_kernel_sources(paths) -> KernelABI:
    """The entry points that the ``.cu`` sources ``paths`` define (each
    source one translation unit, as the build compiles them).  An entry
    point defined by a macro-named definition is read under each unit's
    own macros: ``decode_attention.cu`` defines ``strom_decode_attention``
    and, included by ``decode_attention_f16.cu`` with
    ``STROM_ATTN_F16_TU``, ``strom_decode_attention_f16``.  A declaration
    is held to the definition of its name; a construct the parser cannot
    read raises :class:`HeaderParseError`."""
    kabi = KernelABI(sources=[str(p) for p in paths])
    decls: List[Tuple[CFunc, str]] = []
    for tu in paths:
        for fn, is_def in _unit_entry_points(tu):
            if not fn.name.startswith("strom_"):
                raise HeaderParseError(
                    f"{fn.file}:{fn.line}: extern \"C\" {fn.name} is not a "
                    f"strom_* entry point (an unresolved macro name?)")
            if not is_def:
                decls.append((fn, str(tu)))
                continue
            prev = kabi.funcs.get(fn.name)
            if prev is not None:
                kabi.problems.append((
                    fn.file, fn.line,
                    f"{fn.name}: defined in two translation units "
                    f"({prev.file}:{prev.line} and here, in {tu}) — the "
                    f"link keeps one"))
                continue
            kabi.funcs[fn.name] = fn
    for fn, tu in decls:
        d = kabi.funcs.get(fn.name)
        if d is None:
            kabi.problems.append((
                fn.file, fn.line,
                f"{fn.name}: declared in {tu} but defined in no kernel "
                f"source — the library would not load"))
        elif ([p.ctype for p in fn.params] != [p.ctype for p in d.params]
              or fn.ret != d.ret):
            kabi.problems.append((
                fn.file, fn.line,
                f"{fn.name}: this declaration "
                f"({fn.ret} ({', '.join(str(p.ctype) for p in fn.params)}))"
                f" disagrees with its definition at {d.file}:{d.line} "
                f"({d.ret} ({', '.join(str(p.ctype) for p in d.params)}))"
                f" — extern \"C\" carries no types, so the linker cannot "
                f"catch it"))
    if not kabi.funcs and paths:
        raise HeaderParseError("no extern \"C\" entry point found in the "
                               "kernel sources — the parser rotted")
    return kabi


# --------------------------------------------------------------------------
# expected-ctypes mapping
# --------------------------------------------------------------------------

def _snake(name: str) -> str:
    """_RingInfo -> ring_info (how Python Structure class names are
    matched against header struct names)."""
    name = name.lstrip("_")
    return re.sub(r"(?<!^)(?=[A-Z])", "_", name).lower()


def struct_name_matches(py_class: str, c_struct: str) -> bool:
    """Does Python Structure class ``py_class`` plausibly model C struct
    ``c_struct``?  ``_RingInfo`` matches ``strom_ring_info``."""
    s = _snake(py_class)
    return c_struct in (s, f"strom_{s}")


def expected_ctypes(ctype: CType) -> List[str]:
    """Acceptable canonical ctypes spellings for one C parameter/return
    type (see analysis/abi.py for the canonical spelling grammar)."""
    base, ptr = ctype.base, ctype.ptr
    if ctype.dims:
        # only reachable for struct fields; parameters decayed already
        inner = expected_ctypes(CType(base, ptr))[0]
        for d in reversed(ctype.dims):
            inner = f"ARRAY({inner},{d})"
        return [inner]
    if ptr == 0:
        if base == "void":
            return ["None"]
        if base.startswith("struct:"):
            return [f"STRUCT({base[len('struct:'):]})"]
        return [f"c_{base}"]
    if base == "void":
        inner = "c_void_p"
        for _ in range(ptr - 1):
            inner = f"POINTER({inner})"
        return [inner]
    if base == "char" and ptr == 1:
        return ["c_char_p"]
    if base.startswith("struct:"):
        sname = base[len("struct:"):]
        out = [f"POINTER(STRUCT({sname}))" + ""]
        if ptr > 1:
            out = [f"POINTER({out[0]})"]
        return out
    inner = f"c_{base}"
    for _ in range(ptr):
        inner = f"POINTER({inner})"
    return [inner]
