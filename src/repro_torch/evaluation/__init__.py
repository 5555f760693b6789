"""Methodology comparison against the exhaustive optimum (paper Table II),
and the per-(device, method) matrix over hardware profiles."""
from repro_torch.evaluation.compare import (check_matrix, check_report,
                                            compare_methods,
                                            compare_methods_matrix,
                                            evals_to_optimum, format_matrix,
                                            format_report)

__all__ = ["check_report", "compare_methods", "format_report",
           "compare_methods_matrix", "check_matrix", "format_matrix",
           "evals_to_optimum"]
