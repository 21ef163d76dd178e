"""Operator tools of the port, each run as
``python -m nvme_strom_tpu_torch.tools.<name>`` (counterparts of
nvme_strom_tpu/tools/):

* ``strom_stat``: the counters an engine exports to
  ``$STROM_STATS_EXPORT``, as a table, JSON or OpenMetrics;
* ``strom_top``: a live console view of a process's debug server;
* ``strom_scrub``: the offline CRC32C scrub of checkpoints, shards and
  KV stores, and the sweep of crashed-save debris;
* ``ssd2gpu_test``: the chunked NVMe → card read test, with its
  same-minute ceilings (``--ceilings``);
* ``transfer_diag``, ``stream_probe``, ``kernel_probe``,
  ``profile_report``: probes of the host→device boundary, the stream,
  the flash kernels and a train step's device time;
* ``convert_llama``: HF Llama safetensors → the port's layout.

Entry points run on ``cuda:0`` unless given ``--device cpu``.
"""
