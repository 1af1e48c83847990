"""Host ms from the call of the serving step until it returns, before the
copy to host memory waits for the card; the mean over the traced window."""


def read(rec):
    d = rec.get("dispatch_s")
    return 1e3 * sum(d) / len(d) if d else None
