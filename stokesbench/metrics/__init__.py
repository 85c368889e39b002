"""One reader a metric: `metrics/<name>.py` defines `read(record)`, which
returns the metric's value from a run's `harness.Record`, or None where the
run holds nothing to read (the harness then leaves the metric out)."""
