"""One reader per metric, ``<metric name>.py`` with ``read(record)``:
the value, or None where the record holds nothing to read."""
