"""One reader a metric: `<metric>.py` holds `read(ctx)`, which returns the
metric's value from a run's context (harness.Context), or None where the run
gives it nothing to read; the run then leaves the metric out of its line."""
