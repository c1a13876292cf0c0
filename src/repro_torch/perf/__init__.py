"""Performance accounting of the port: the dry run's roofline terms
(``roofline``; counterpart of ``repro/perf``)."""
