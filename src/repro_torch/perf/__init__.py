"""Performance accounting of the port: the dry run's roofline terms
(``roofline``) and the opcode inventory of the kernels' SASS
(``sass_analysis``); counterpart of ``repro/perf``."""
