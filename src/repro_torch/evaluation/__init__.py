"""Methodology comparison against the exhaustive optimum (paper Table II)."""
from repro_torch.evaluation.compare import (check_report, compare_methods,
                                            format_report)

__all__ = ["check_report", "compare_methods", "format_report"]
