"""``python -m analytics_zoo_tpu_torch.obs`` — the zoo-metrics CLI.

This (not ``-m analytics_zoo_tpu_torch.obs.export``) is the
module-execution form: running export.py itself under ``-m`` would
execute its module body twice (the runpy ``__main__`` copy plus the copy
the package ``__init__`` imports), doubling import-time side effects like
the ``ZOO_TRACE_PERFETTO`` atexit writer.
"""

from .export import main

if __name__ == "__main__":
    raise SystemExit(main())
