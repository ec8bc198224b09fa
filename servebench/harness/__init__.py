"""The serving benchmark's harness: everything a run needs that is not the
program under test.  The program is ``repro_torch`` (``src/``); the
harness takes from it the serving path it drives, its counters and its
kernel names, and nothing else.  Traffic, weights, the metric arithmetic,
the counting of operations and bytes, the reading of traces and the
comparison that decides ``correct`` live here, beside the plain reference
(``servebench/reference``)."""
