"""Load generator: the 95th percentile of how late each arrival (a request
sent, a paced frame handed out) ran behind its due time."""

from portbench.stats import percentile


def read(rec, metric):
    lag = rec.out.gen_lag
    return percentile(lag, 95) * 1e3 if lag else None
