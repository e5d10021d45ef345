"""Host milliseconds a request spends in `Searcher.prepare_queries` (the
queries' encode and upload), the mean of a benchmark-side span around
the call over every request of the measured window (host clock)."""


def read(r):
    spans = r["prepare_s"]
    return 1e3 * sum(spans) / len(spans) if spans else None
