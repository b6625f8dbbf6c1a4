"""``host_ms_per_call.frame``: the median over the window of the
benchmark's span around each entry call, ended before the synchronise:
the host's time to issue one call (not profiled)."""

import statistics


def read(rec):
    issue = rec.get("host_issue_s")
    return statistics.median(issue) * 1e3 if issue else None
