"""Direct SQL on the device (counterpart of nvme_strom_tpu/sql/): Parquet
footers and pages read by the port's own code, payload streamed NVMe →
staging → device through ``DeviceStream`` and ``h2d_copy``, values
decoded there, then GROUP BY, top-k, the star join, the device cache,
multi-file and multi-process scans and the SQL text front end on torch
tensors.  No pyarrow."""

from nvme_strom_tpu_torch.sql.parquet import EngineFile, ParquetScanner
from nvme_strom_tpu_torch.sql.groupby import (groupby_aggregate, sql_groupby,
                                              sql_groupby_str,
                                              sql_scalar_agg, top_k_groups)
from nvme_strom_tpu_torch.sql.join import lookup_unique, star_join_groupby
from nvme_strom_tpu_torch.sql.topk import sql_topk
from nvme_strom_tpu_torch.sql.parser import (SQLSyntaxError, parse_select,
                                             sql_query)
from nvme_strom_tpu_torch.sql.multi import (multi_groupby, multi_scalar_agg,
                                            multi_topk, open_dataset)
from nvme_strom_tpu_torch.sql.dist import dist_groupby, dist_scalar_agg
from nvme_strom_tpu_torch.sql.cache import DeviceTable
from nvme_strom_tpu_torch.sql.scan_plan import (ScanPlan, iter_scan_columns,
                                                plan_scan, pushdown_enabled,
                                                sql_workers)

__all__ = ["EngineFile", "ParquetScanner", "groupby_aggregate",
           "sql_groupby", "sql_groupby_str", "sql_scalar_agg",
           "top_k_groups", "lookup_unique", "star_join_groupby",
           "sql_topk", "SQLSyntaxError", "parse_select", "sql_query",
           "multi_groupby", "multi_scalar_agg", "multi_topk",
           "open_dataset", "dist_groupby", "dist_scalar_agg", "DeviceTable",
           "ScanPlan", "iter_scan_columns", "plan_scan",
           "pushdown_enabled", "sql_workers"]
