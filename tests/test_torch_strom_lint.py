"""The port's strom-lint and lock-order witness
(nvme_strom_tpu_torch/analysis, utils/lockwitness.py,
tools/strom_lint.py), held against layers 1-3 of tests/test_strom_lint.py:

1. the seeded-defect fixtures (tests/lint_fixtures/) through both
   packages' checkers give the same violations, by check, file and line;
   the manifest grammar cases; the CLI's exit codes;
2. the shipped port tree lints clean (exit 0) with a non-empty
   acquisition graph; every entry point of the kernel sources (single
   ``extern "C"`` definitions, ``extern "C" { ... }`` blocks, the
   macro-named ``_f16`` entry points) is parsed and agrees with
   ``_build._declare``; a planted drift in a copy of a ``.cu`` source or
   of ``csrc/strom_io.h`` fails with a file and line;
3. the nine witness cases: each scripted sequence gives the same edges,
   cycles and exceptions in both witnesses.

Layer 4, the sanitizer matrix, builds the shared C engine and stays the
reference's.  Nothing here builds a library or writes under ``csrc/``.
"""

import io
import json
import re
import shutil
import threading
import time
from contextlib import redirect_stdout
from pathlib import Path

import pytest

from nvme_strom_tpu.analysis import abi as jax_abi
from nvme_strom_tpu.analysis import locks as jax_locks
from nvme_strom_tpu.analysis import manifest as jax_manifest
from nvme_strom_tpu.utils import lockwitness as jax_lw
from nvme_strom_tpu_torch.analysis import run_checks
from nvme_strom_tpu_torch.analysis.abi import check_abi
from nvme_strom_tpu_torch.analysis.cabi import (HeaderParseError,
                                                parse_header,
                                                parse_kernel_sources)
from nvme_strom_tpu_torch.analysis.driver import (default_header,
                                                  default_kernel_sources,
                                                  default_manifest,
                                                  package_py_files)
from nvme_strom_tpu_torch.analysis.knobs import check_knob_docs
from nvme_strom_tpu_torch.analysis.locks import check_locks
from nvme_strom_tpu_torch.analysis.manifest import (ManifestError,
                                                    parse_manifest)
from nvme_strom_tpu_torch.tools.strom_lint import main as lint_main
from nvme_strom_tpu_torch.utils import lockwitness as port_lw

REPO = Path(__file__).resolve().parents[1]
FIX = Path(__file__).resolve().parent / "lint_fixtures"
KSRC = REPO / "nvme_strom_tpu_torch" / "csrc"
BUILD_PY = "nvme_strom_tpu_torch/_build.py"


def _where(violations):
    """(check, file name, line) of every violation, waived or not."""
    return sorted((v.check, Path(v.file).name, v.line) for v in violations)


def _active(violations, check=None):
    return [v for v in violations
            if (check is None or v.check == check) and not v.waived]


def _one(violations, needle):
    got = [v for v in violations if needle in v.message]
    assert got, (f"no violation mentioning {needle!r}; have:\n  "
                 + "\n  ".join(v.format() for v in violations))
    assert got[0].line > 0
    return got[0]


def _sig_line(path, symbol):
    """The line of ``"symbol":`` in a signature table."""
    for i, ln in enumerate((REPO / path).read_text().splitlines(), 1):
        if f'"{symbol}":' in ln:
            return i
    raise AssertionError(f"{symbol} not in {path}")


# --------------------------------------------------------------------------
# 1a. seeded ABI defects, both packages
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def abi_reports():
    args = (FIX / "abi_bad.h", [FIX / "abi_bad.py"], FIX)
    return check_abi(*args), jax_abi.check_abi(*args)


def test_abi_fixture_same_violations_as_jax(abi_reports):
    port, jax = abi_reports
    assert _where(port) == _where(jax)
    assert len(port) >= 7


@pytest.mark.parametrize("needle,names", [
    ("argtypes[2] (offset) is c_uint32", ("strom_fx_read", "c_uint64")),
    ("restype never set", ("strom_fx_read",)),
    ("argtypes bound at 2 sites", ("strom_fx_crc",)),
    ("argtypes has 1 entries", ("strom_fx_create",)),
    ("strom_fx_destroy: declared in the header", ()),
    ("strom_fx_never_bound: declared in the header", ()),
    ("order/name drift", ("_FxInfo",)),
], ids=["type", "restype", "double_bind", "arity", "unbound_called",
        "unbound", "struct_drift"])
def test_abi_fixture_defect(abi_reports, needle, names):
    v = _one(abi_reports[0], needle)
    for n in names:
        assert n in v.message


def test_abi_cli_exits_1_with_file_and_line(capsys):
    rc = lint_main(["--check", "abi", "--root", str(FIX),
                    "--header", str(FIX / "abi_bad.h"),
                    "--manifest", str(FIX / "lockorder_fixture.conf"),
                    str(FIX / "abi_bad.py")])
    assert rc == 1
    out = capsys.readouterr().out
    assert re.search(r"abi_bad\.py:\d+: \[abi\]", out), out


# --------------------------------------------------------------------------
# 1b. seeded lock defects, both packages
# --------------------------------------------------------------------------

_LOCK_FILES = [FIX / "locks_inversion.py", FIX / "locks_blocking.py"]


@pytest.fixture(scope="module")
def lock_reports():
    conf = FIX / "lockorder_fixture.conf"
    return (check_locks(_LOCK_FILES, FIX, parse_manifest(conf)),
            jax_locks.check_locks(_LOCK_FILES, FIX,
                                  jax_manifest.parse_manifest(conf)))


def test_lock_fixture_same_violations_and_edges_as_jax(lock_reports):
    (pv, pe), (jv, je) = lock_reports
    assert sorted((v.check, v.file, v.line, v.key) for v in pv) == \
        sorted((v.check, v.file, v.line, v.key) for v in jv)
    assert sorted((e.held, e.acquired, e.line) for e in pe) == \
        sorted((e.held, e.acquired, e.line) for e in je)


@pytest.mark.parametrize("needle,names", [
    ("nested with", ("Duo._b", "Duo._a")),
    ("via call to", ("_take_alpha",)),
    ("self-deadlock", ("Duo._b", "not an RLock")),
], ids=["direct", "via_call", "self_deadlock"])
def test_lock_fixture_order_defect(lock_reports, needle, names):
    v = _one(_active(lock_reports[0][0], "lock-order"), needle)
    assert v.file.endswith("locks_inversion.py")
    for n in names:
        assert n in v.message


def test_lock_fixture_exactly_three_order_defects(lock_reports):
    vs, edges = lock_reports[0]
    assert len(_active(vs, "lock-order")) == 3
    assert any(e.held.endswith("Duo._a") and e.acquired.endswith("Duo._b")
               for e in edges)


@pytest.mark.parametrize("needle", ["time.sleep", "crc32c", "pending.wait",
                                    "os.fsync",
                                    "Condition.wait releases only"])
def test_lock_fixture_blocking_shape(lock_reports, needle):
    v = _one(_active(lock_reports[0][0], "lock-blocking"), needle)
    assert v.file.endswith("locks_blocking.py")


def test_lock_fixture_correct_patterns_not_flagged(lock_reports):
    bad = {v.line for v in _active(lock_reports[0][0], "lock-blocking")}
    src = (FIX / "locks_blocking.py").read_text().splitlines()
    for marker in ("correct: NOT a violation", "time.sleep(0.01)"):
        assert next(i + 1 for i, ln in enumerate(src)
                    if marker in ln) not in bad


def test_lock_cli_exits_1():
    assert lint_main(["--check", "locks", "--root", str(FIX),
                      "--manifest", str(FIX / "lockorder_fixture.conf"),
                      *map(str, _LOCK_FILES)]) == 1


# --------------------------------------------------------------------------
# 1c. manifest grammar, both packages
# --------------------------------------------------------------------------

@pytest.mark.parametrize("text", [
    "group only_a_name\n",
    "waiver blocking x:y\n",                      # no reason string
    "order ghost > phantom\n",                    # undeclared groups
    "definitely not a directive\n",
    "group a fx.A\ngroup b fx.B\norder a > b\norder b > a\n",   # cyclic
    "blocking-allow a b\n",
], ids=["group", "waiver", "order", "directive", "cyclic", "allow"])
def test_manifest_rejects_bad_grammar_like_jax(tmp_path, text):
    p = tmp_path / "bad.conf"
    p.write_text(text)
    with pytest.raises(ManifestError):
        parse_manifest(p)
    with pytest.raises(jax_manifest.ManifestError):
        jax_manifest.parse_manifest(p)


def test_manifest_orders_compose_transitively(tmp_path):
    p = tmp_path / "m.conf"
    p.write_text("group a fx.A\ngroup b fx.B\ngroup c fx.C\n"
                 "order a > b\norder b > c\n")
    man, ref = parse_manifest(p), jax_manifest.parse_manifest(p)
    for held, acq in (("fx.C", "fx.A"), ("fx.A", "fx.C"), ("fx.C", "fx.B")):
        assert man.order_violations(held, acq) == \
            ref.order_violations(held, acq)
    assert "a > b > c" in man.order_violations("fx.C", "fx.A")
    assert man.order_violations("fx.A", "fx.C") is None


def test_malformed_manifest_and_unknown_check_exit_2(tmp_path):
    p = tmp_path / "bad.conf"
    p.write_text("definitely not a directive\n")
    assert lint_main(["--check", "locks", "--manifest", str(p)]) == 2
    assert lint_main(["--check", "nonsense"]) == 2


def test_unused_waiver_reported_on_a_full_run(tmp_path):
    p = tmp_path / "m.conf"
    p.write_text(default_manifest().read_text()
                 + '\nwaiver blocking never.Matches:anything '
                   'reason "stale"\n')
    rep = run_checks(manifest_path=p)
    assert [v.message for v in rep.active
            if "unused waiver" in v.message]
    assert rep.exit_code == 1


@pytest.fixture(scope="module")
def port_report():
    """One full run over the shipped port tree."""
    return run_checks()


def test_every_shipped_waiver_has_a_reason_and_is_used(port_report):
    man = parse_manifest(default_manifest())
    assert man.waivers and all(w.reason.strip() for w in man.waivers)
    assert not [v for v in port_report.violations if v.check == "manifest"]
    # a full run reports an unused waiver, so each matched a finding
    assert len(port_report.waived) >= len(man.waivers)


# --------------------------------------------------------------------------
# 2. the shipped port tree
# --------------------------------------------------------------------------

def test_port_tree_lints_clean(port_report):
    rep = port_report
    assert rep.active == [], "\n  ".join(v.format() for v in rep.active)
    assert set(rep.checks_run) == {"abi", "locks", "knobs", "counters"}
    assert rep.exit_code == 0


def test_port_acquisition_graph(port_report):
    got = {(e.held, e.acquired) for e in port_report.edges}
    assert ("kv_offload.PrefixStore._drain_mu",
            "kv_offload.PrefixStore._lock") in got
    assert ("arena.CudaRegistration._lock", "_build._lock") in got


def test_cli_exit_0_and_json_report_shape():
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = lint_main(["--json"])
    doc = json.loads(buf.getvalue())
    assert rc == 0 == doc["exit_code"] and doc["n_active"] == 0
    assert doc["n_waived"] >= 4
    assert set(doc["checks_run"]) == {"abi", "locks", "knobs", "counters"}


def test_every_port_lock_goes_through_the_witness():
    """No plain threading lock is built anywhere in the port: every lock
    has a manifest id the witness and the lock pass share."""
    for py in package_py_files(REPO):
        if py.name == "lockwitness.py" or "analysis" in py.parts:
            continue        # the witness itself; the passes that read it
        text = py.read_text()
        assert not re.search(r"threading\.(Lock|RLock|Condition)\(|"
                             r"default_factory=threading\.", text), py


def test_header_abi_parsed_in_full():
    abi = parse_header(str(default_header(REPO)))
    assert len(abi.funcs) >= 40
    for must in ("strom_engine_create_rings", "strom_submit_readv_ring",
                 "strom_hostcache_copy", "strom_crc32c", "strom_tar_index"):
        assert must in abi.funcs


#: every entry point of the kernel sources, by the form it is defined in
KERNEL_ENTRY_POINTS = {
    "single": ("strom_flash_fwd", "strom_flash_route", "strom_flash_bwd_dq",
               "strom_flash_bwd_dkv", "strom_quant_gemv", "strom_dequant"),
    "block": ("strom_h2d_copy", "strom_h2d_copy_probe",
              "strom_host_register", "strom_host_unregister",
              "strom_host_device_pointer", "strom_cuda_error_string",
              "strom_ici_ring_capacity", "strom_stream_synchronize",
              "strom_enable_peer_access", "strom_ici_ring",
              "strom_ipc_alloc", "strom_ipc_open", "strom_ipc_close",
              "strom_ipc_free"),
    "macro": ("strom_decode_attention", "strom_decode_attention_f16",
              "strom_paged_attention", "strom_paged_attention_f16"),
}


def test_kernel_entry_points_parsed_in_every_form():
    kabi = parse_kernel_sources(default_kernel_sources(REPO))
    want = {n for names in KERNEL_ENTRY_POINTS.values() for n in names}
    assert set(kabi.funcs) == want
    assert kabi.problems == []
    f16 = kabi.funcs["strom_paged_attention_f16"]
    assert Path(f16.file).name == "paged_attention.cu"
    assert len(f16.params) == len(kabi.funcs["strom_paged_attention"].params)


def test_kernel_entry_points_agree_with_declare(port_report):
    """Each entry point is bound once, in ``_build._declare``, with its
    definition's arity and types."""
    kernel = {n for names in KERNEL_ENTRY_POINTS.values() for n in names}
    assert not [v for v in port_report.violations
                if any(n in v.message for n in kernel)]
    from nvme_strom_tpu_torch.analysis.abi import scan_module
    binds = {b.symbol for b in scan_module(REPO / BUILD_PY, BUILD_PY).binds
             if b.kind == "argtypes"}
    assert kernel <= binds


def _copy_sources(tmp_path):
    d = tmp_path / "csrc"
    d.mkdir()
    for p in KSRC.iterdir():
        if p.suffix in (".cu", ".cuh"):
            shutil.copy(p, d / p.name)
    return d


#: (file, text, replacement, symbols whose bind site must fail)
KERNEL_DRIFTS = {
    "dropped_single": ("flash_attention_bwd.cu",
                       "int skv, int d, int dtype,\n"
                       "                                  int causal,",
                       "int skv, int d, int dtype,\n"
                       "                                 ",
                       ("strom_flash_bwd_dq",)),
    "retyped_block": ("h2d_copy.cu",
                      "int strom_h2d_copy(const void* src, void* dst, "
                      "uint64_t n,",
                      "int strom_h2d_copy(const void* src, void* dst, "
                      "uint32_t n,",
                      ("strom_h2d_copy",)),
    "retyped_pointer": ("ici_ring.cu", "int* blocks, unsigned* chunk)",
                        "int* blocks, int* chunk)",
                        ("strom_ici_ring_capacity",)),
    "dropped_macro": ("paged_attention.cu",
                      "int max_blocks, int d, int width,\n"
                      "                                 int rows_per_chunk,",
                      "int max_blocks, int d,\n"
                      "                                 int rows_per_chunk,",
                      ("strom_paged_attention",
                       "strom_paged_attention_f16")),
}


@pytest.mark.parametrize("case", sorted(KERNEL_DRIFTS))
def test_planted_kernel_drift_fails_with_file_and_line(tmp_path, case):
    name, old, new, symbols = KERNEL_DRIFTS[case]
    d = _copy_sources(tmp_path)
    src = (d / name).read_text()
    assert src.count(old) == 1, (name, old)
    (d / name).write_text(src.replace(old, new))
    vs = check_abi(default_header(REPO), [REPO / BUILD_PY], REPO,
                   sorted(d.glob("*.cu")))
    for sym in symbols:
        got = [v for v in vs if v.message.startswith(f"{sym}:")
               and v.file == BUILD_PY]
        assert got, "\n".join(v.format() for v in vs)
        assert got[0].line == _sig_line(BUILD_PY, sym)
        assert name in got[0].message
    if case == "dropped_macro":
        # the f16 prototype in paged_attention.cu no longer matches the
        # definition its own unit makes
        assert any("disagrees with its definition" in v.message
                   and v.file.endswith("paged_attention.cu") for v in vs)


def test_planted_header_drift_fails_with_file_and_line(tmp_path):
    h = tmp_path / "strom_io.h"
    text = default_header(REPO).read_text()
    old = "uint32_t strom_crc32c(const void *data, uint64_t len, uint32_t crc);"
    assert text.count(old) == 1
    h.write_text(text.replace(old, "uint32_t strom_crc32c(const void *data,"
                                   " uint64_t len);"))
    vs = check_abi(h, [REPO / "nvme_strom_tpu_torch/io/engine.py"], REPO,
                   default_kernel_sources(REPO))
    v = _one(vs, "strom_crc32c: argtypes has 3 entries")
    assert (v.file, v.line) == ("nvme_strom_tpu_torch/io/engine.py",
                                _sig_line("nvme_strom_tpu_torch/io/engine.py",
                                          "strom_crc32c"))


@pytest.mark.parametrize("case", ["unresolved_macro", "undecidable_if",
                                  "header_prototype"])
def test_unparseable_entry_point_is_exit_2(tmp_path, case):
    d = _copy_sources(tmp_path)
    args = ["--check", "abi", "--kernels", str(d)]
    if case == "unresolved_macro":
        (d / "extra.cu").write_text(
            'extern "C" int STROM_NOT_DEFINED(int a) { return a; }\n')
    elif case == "undecidable_if":
        (d / "extra.cu").write_text(
            '#if FOO > 1\nextern "C" int strom_x(int a) { return a; }\n'
            '#endif\n')
    else:
        h = tmp_path / "h.h"
        h.write_text("int strom_ok(int a);\nuint64_t\nstrom_orphan(int a);\n")
        args += ["--header", str(h)]
    with pytest.raises(HeaderParseError):
        if case == "header_prototype":
            parse_header(args[-1])
        else:
            parse_kernel_sources(sorted(d.glob("*.cu")))
    assert lint_main(args) == 2


def test_knob_read_but_undocumented_is_reported(tmp_path):
    pkg = tmp_path / "nvme_strom_tpu_torch"
    pkg.mkdir()
    (pkg / "m.py").write_text('import os\nos.environ.get("STROM_DOCUMENTED")'
                              '\nos.environ.get("STROM_MISSING_KNOB")\n')
    (tmp_path / "README.md").write_text("| `STROM_DOCUMENTED` | x |\n")
    vs = check_knob_docs(tmp_path)
    assert [(v.key, v.line) for v in vs] == [("STROM_MISSING_KNOB", 3)]


# --------------------------------------------------------------------------
# 3. the witness: nine cases, both packages
# --------------------------------------------------------------------------

@pytest.fixture
def witnesses():
    """Both witness modules, their arming restored after the test."""
    saved = [(m, m._armed_override) for m in (jax_lw, port_lw)]
    try:
        yield {"jax": jax_lw, "port": port_lw}
    finally:
        for m, prev in saved:
            m.witness().reset()
            m._armed_override = prev


def _violations(w):
    return [[v["kind"], list(v["edge"])] for v in w.violations]


def _w_edges_and_cycle(lw, tmp_path):
    w = lw.arm()
    a, b = lw.make_lock("fx.A"), lw.make_lock("fx.B")
    with a:
        with b:
            pass
    out = {"first": w.snapshot_edges(), "clean": _violations(w)}
    with b:
        with a:
            pass
    out["inverted"] = _violations(w)
    out["after"] = w.snapshot_edges()
    with a:
        with b:
            pass
    out["no_cascade"] = _violations(w)
    return out


def _w_strict(lw, tmp_path, monkeypatch):
    monkeypatch.setenv("STROM_LOCK_WITNESS", "strict")
    w = lw.arm()
    a, b = lw.make_lock("fx.SA"), lw.make_lock("fx.SB")
    with a:
        with b:
            pass
    try:
        with b:
            with a:
                pass
        raised = None
    except lw.LockOrderError:
        raised = "LockOrderError"
    return {"raised": raised, "violations": _violations(w)}


def _w_self_deadlock(lw, tmp_path):
    w = lw.arm()
    a = lw.make_lock("fx.SD")
    with a:
        try:
            a.acquire()
            raised = None
        except lw.LockOrderError:
            raised = "LockOrderError"
    return {"raised": raised, "violations": _violations(w)}


def _w_rlock_reentry(lw, tmp_path):
    w = lw.arm()
    r = lw.make_rlock("fx.R")
    with r:
        with r:
            pass
    return {"edges": w.snapshot_edges(), "violations": _violations(w)}


def _waiter_run(cv, depth):
    hits = []

    def waiter():
        with cv:
            if depth == 2:
                with cv:
                    cv.wait(timeout=5)
            else:
                cv.wait(timeout=5)
            hits.append(True)

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    with cv:
        cv.notify()
    t.join(timeout=5)
    return hits


def _w_condition_wait(lw, tmp_path):
    w = lw.arm()
    mu = lw.make_lock("fx.CVmu")
    hits = _waiter_run(lw.make_condition("fx.CV", mu), 1)
    return {"hits": hits, "violations": _violations(w)}


def _w_condition_over_rlock(lw, tmp_path):
    w = lw.arm()
    hits = _waiter_run(lw.make_condition("fx.CVr"), 2)
    return {"hits": hits, "violations": _violations(w)}


def _w_rlock_locked_probe(lw, tmp_path):
    w = lw.arm()
    r = lw.make_rlock("fx.RLP")
    seen = [r.locked()]
    with r:
        seen.append(r.locked())
    seen.append(r.locked())
    held, release = threading.Event(), threading.Event()

    def holder():
        with r:
            held.set()
            release.wait(5)

    t = threading.Thread(target=holder)
    t.start()
    held.wait(5)
    seen.append(r.locked())             # held by another thread
    release.set()
    t.join(5)
    return {"locked": seen, "violations": _violations(w)}


def _w_disarmed_plain(lw, tmp_path):
    lw.disarm()
    return {"plain": isinstance(lw.make_lock("fx.P"),
                                type(threading.Lock()))}


def _w_cycle_dump(lw, tmp_path, monkeypatch):
    d = tmp_path / type(lw).__name__ / lw.__name__
    d.mkdir(parents=True)
    monkeypatch.setenv("STROM_FLIGHT_DIR", str(d))
    monkeypatch.setenv("STROM_FLIGHT_MIN_S", "0")
    w = lw.arm()
    a, b = lw.make_lock("fx.DA"), lw.make_lock("fx.DB")
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    dumps = sorted(d.glob("strom_flight_*lock_order_cycle*"))
    doc = json.loads(dumps[0].read_text()) if dumps else {}
    return {"dumps": len(dumps), "violations": _violations(w),
            "edge": doc.get("extra", {}).get("violation", {}).get("edge"),
            "edges": doc.get("extra", {}).get("edges")}


WITNESS_CASES = {
    "edges_and_cycle": _w_edges_and_cycle,
    "strict_raises": _w_strict,
    "self_deadlock_raises": _w_self_deadlock,
    "rlock_reentry_clean": _w_rlock_reentry,
    "condition_wait": _w_condition_wait,
    "condition_over_rlock": _w_condition_over_rlock,
    "rlock_locked_probe": _w_rlock_locked_probe,
    "disarmed_plain": _w_disarmed_plain,
    "cycle_dumps_flight_record": _w_cycle_dump,
}


@pytest.mark.parametrize("case", list(WITNESS_CASES))
def test_witness_case_matches_jax(witnesses, tmp_path, monkeypatch, case):
    fn = WITNESS_CASES[case]
    needs_env = fn in (_w_strict, _w_cycle_dump)
    got = {}
    for name, lw in witnesses.items():
        lw.witness().reset()
        got[name] = (fn(lw, tmp_path, monkeypatch) if needs_env
                     else fn(lw, tmp_path))
        lw.witness().reset()
        monkeypatch.delenv("STROM_LOCK_WITNESS", raising=False)
    assert got["port"] == got["jax"]
    expect = {
        "edges_and_cycle": lambda g: g["inverted"] == g["no_cascade"]
        == [["cycle", ["fx.B", "fx.A"]]] and g["after"] == g["first"]
        == {"fx.A": ["fx.B"]},
        "strict_raises": lambda g: g["raised"] == "LockOrderError",
        "self_deadlock_raises": lambda g: g["raised"] == "LockOrderError",
        "rlock_reentry_clean": lambda g: g == {"edges": {},
                                               "violations": []},
        "condition_wait": lambda g: g["hits"] == [True]
        and not g["violations"],
        "condition_over_rlock": lambda g: g["hits"] == [True]
        and not g["violations"],
        "rlock_locked_probe": lambda g: g["locked"] == [False, True, False,
                                                        True],
        "disarmed_plain": lambda g: g["plain"] is True,
        "cycle_dumps_flight_record": lambda g: g["dumps"] == 1
        and g["edge"] == ["fx.DB", "fx.DA"],
    }[case]
    assert expect(got["port"]), got["port"]
