"""Command-line entry points (``python -m audiotokenization_tpu_torch.cli.<name>``,
or the installed ``audiotok-torch-<name>`` scripts)."""
from __future__ import annotations

import functools


def command(main):
    """``main(argv=None)`` of a CLI whose result its Python callers read:
    ``main([...])`` returns it. Run as a command (no argv: a console script,
    which exits with ``sys.exit(main())``), it returns None, so the exit
    status is 0 as the JAX package's CLIs give, and a failure raises."""

    @functools.wraps(main)
    def run(argv=None):
        out = main(argv)
        return None if argv is None else out

    return run
