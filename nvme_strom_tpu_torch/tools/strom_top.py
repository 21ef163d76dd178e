"""strom_top — a live console view of a process's attribution and
goodput, polled from its debug server (obs/debugsrv.py, started by
``STROM_DEBUG_PORT`` in the serving or training process):

    STROM_DEBUG_PORT=9178 STROM_ATTRIB=1 python -m nvme_strom_tpu_torch.serve &
    python -m nvme_strom_tpu_torch.tools.strom_top --port 9178
    python -m nvme_strom_tpu_torch.tools.strom_top --port 9178 --once

The top half is each QoS class's critical-path attribution (``/attrib``:
wall p50 / p99 and each component's share of the wall); the bottom half
the waste ledger and each ring's time in state (``/ledger``) and the
ring breakers, the cold start's and the drain's phase (``/health``).
It keeps no state, so it can attach and detach at any time.
Counterpart of nvme_strom_tpu/tools/strom_top.py: the same frame from
the same documents.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.error
import urllib.request

from nvme_strom_tpu_torch.utils.stats import human_bytes as _human

#: component render order and column labels (obs/attrib.py COMPONENTS,
#: then what no span covered)
_COMPONENTS = (
    ("sched_queue", "sched"),
    ("hostcache", "cache"),
    ("nvme_read", "nvme"),
    ("retry_backoff", "retry"),
    ("hedge", "hedge"),
    ("degraded", "degr"),
    ("bridge", "bridge"),
    ("ici_scatter", "ici"),
    ("unattributed", "other"),
)


def fetch(host: str, port: int, route: str, timeout: float = 2.0):
    url = f"http://{host}:{port}{route}"
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read().decode())


def render_frame(attrib: dict, ledger: dict, health: dict) -> str:
    """One frame from the three route documents (no I/O)."""
    lines = ["strom-top — critical-path attribution (per QoS class, µs)"]
    if not attrib.get("enabled", True):
        lines.append("  attribution off — set STROM_ATTRIB=1 in the "
                     "serving process")
    else:
        classes = attrib.get("classes", {})
        if not classes:
            lines.append(f"  no retired requests yet "
                         f"(requests={attrib.get('requests', 0)})")
        else:
            hdr = f"  {'class':<10}{'n':>6}{'wall p50':>10}{'p99':>10}  "
            lines.append(hdr + "".join(f"{lbl:>9}"
                                       for _c, lbl in _COMPONENTS))
        for kl in sorted(classes):
            blk = classes[kl]
            comps = blk.get("components", {})
            lines.append(
                f"  {kl:<10}{blk['n']:>6}"
                f"{blk['wall_p50_us']:>10}{blk['wall_p99_us']:>10}  "
                + "".join(
                    f"{100.0 * comps.get(c, {}).get('share', 0.0):>8.1f}%"
                    for c, _l in _COMPONENTS))
        dropped = attrib.get("spans_dropped", 0)
        if dropped:
            lines.append(f"  ATTRIBUTION INCOMPLETE — {dropped} spans "
                         "dropped at the collector bound")
    lines.append("")
    lines.append("ledger — goodput vs waste")
    lines.append(f"  delivered {_human(ledger.get('delivered_bytes', 0)):>12}"
                 f"   goodput {_human(ledger.get('goodput_bytes', 0)):>12}"
                 f"   fraction {ledger.get('goodput_fraction', 1.0):.4f}")
    waste = ledger.get("waste", {})
    wrow = "   ".join(f"{k}={_human(v)}" for k, v in sorted(waste.items())
                      if v)
    lines.append(f"  waste     {_human(ledger.get('waste_bytes', 0)):>12}"
                 + (f"   ({wrow})" if wrow else ""))
    rs = ledger.get("ring_state_s")
    if rs:
        n = max((len(v) for v in rs.values()), default=0)
        for r in range(n):
            total = sum(rs[s][r] for s in rs if r < len(rs[s]))
            parts = []
            for state in ("busy", "idle", "stalled", "restarting"):
                vals = rs.get(state)
                if vals and r < len(vals) and total > 0:
                    parts.append(f"{state} {100.0 * vals[r] / total:.0f}%")
            lines.append(f"  ring {r}: " + "  ".join(parts))
    states = health.get("ring_health") or []
    if states:
        lines.append(f"  breakers: {' '.join(states)}"
                     + ("   DEGRADED (buffered brown-out)"
                        if health.get("degraded") else ""))
    phase = health.get("boot_phase")
    if phase and phase != "steady":
        lines.append(f"  boot: {phase} (cold start in progress — "
                     "serve-while-restoring)")
    drain = health.get("drain_phase")
    if drain and drain != "serving":
        lines.append(f"  drain: {drain} (rolling replacement — "
                     "warm handoff in progress)")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="strom_top",
        description="live per-class attribution and ledger view of a "
                    "STROM_DEBUG_PORT debug server")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, required=True,
                    help="the process's STROM_DEBUG_PORT")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="seconds between frames")
    ap.add_argument("--once", action="store_true",
                    help="print one frame and exit")
    args = ap.parse_args(argv)

    def frame() -> str:
        return render_frame(fetch(args.host, args.port, "/attrib"),
                            fetch(args.host, args.port, "/ledger"),
                            fetch(args.host, args.port, "/health"))

    try:
        if args.once:
            print(frame())
            return 0
        while True:
            out = frame()
            sys.stdout.write("\x1b[2J\x1b[H" + out + "\n")
            sys.stdout.flush()
            time.sleep(max(0.1, args.interval))
    except (urllib.error.URLError, OSError) as e:
        print(f"strom_top: cannot reach http://{args.host}:{args.port}: "
              f"{e}", file=sys.stderr)
        return 2
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
