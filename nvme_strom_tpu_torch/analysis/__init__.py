"""strom-lint for the port: static analysis of its concurrent I/O core
and its two ctypes surfaces (counterpart of nvme_strom_tpu/analysis).

- :mod:`~nvme_strom_tpu_torch.analysis.cabi` — parser for the C ABI the
  port binds: the ``strom_*`` prototypes and structs of
  ``csrc/strom_io.h`` (the engine), and the ``extern "C"`` entry-point
  definitions of ``nvme_strom_tpu_torch/csrc/*.cu`` (the kernel library,
  which no header declares).
- :mod:`~nvme_strom_tpu_torch.analysis.abi` — ctypes-ABI conformance:
  every binding's ``argtypes``/``restype`` checked for completeness, type
  agreement and single-bind ownership against both ABIs.
- :mod:`~nvme_strom_tpu_torch.analysis.locks` — lock-discipline AST pass:
  the acquisition graph, the lock-order manifest, blocking operations
  under a lock.
- :mod:`~nvme_strom_tpu_torch.analysis.manifest` — the declared lock
  order and waiver grammar (``lock_order.conf``).
- :mod:`~nvme_strom_tpu_torch.analysis.knobs` — ``STROM_*`` knobs read by
  the port or the C engine against the README's table.
- :mod:`~nvme_strom_tpu_torch.analysis.counters` — ``StromStats``
  counters against ``tools/strom_stat.py``'s render, ``--json`` and
  ``--prom``.
- :mod:`~nvme_strom_tpu_torch.analysis.driver` — every checker under one
  exit-code contract (``python -m nvme_strom_tpu_torch.tools.strom_lint``;
  0 clean, 1 violations, 2 runtime error).

The runtime half, the lock-order witness armed in the port's chaos-class
tests, is :mod:`nvme_strom_tpu_torch.utils.lockwitness`.
"""

from nvme_strom_tpu_torch.analysis.driver import (   # noqa: F401
    Violation, Report, run_checks, ALL_CHECKS)
