"""One reader a metric, ``<metric name>.py`` with ``read(run)``: the
metric's value from the run's record, or None when the run gave it
nothing to read (the metric is then left out of the result line)."""
