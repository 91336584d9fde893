from hpc_suffix_array_tpu_torch.viz.charts import (
    generate_performance_charts, generate_phase_breakdown_chart,
    generate_comparative_charts)
from hpc_suffix_array_tpu_torch.viz.report import (
    generate_statistics_report, generate_multi_backend_report)

__all__ = [
    "generate_performance_charts",
    "generate_phase_breakdown_chart",
    "generate_comparative_charts",
    "generate_statistics_report",
    "generate_multi_backend_report",
]
