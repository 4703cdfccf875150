"""Host-side IO: flock-protected results aggregation (native-backed)."""

from flowstate.io.aggregate import (
    RESULTS_HEADER,
    append_results,
    append_row_locked,
)

__all__ = ["append_results", "append_row_locked", "RESULTS_HEADER"]
