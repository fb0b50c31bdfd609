"""The one stdout channel for ``src/repro_torch`` CLI drivers.

``repro_torch.launch.*`` report through ``emit`` / ``emit_json`` (JSON
result envelopes on stdout) and ``warn`` (diagnostics on stderr), so
library code never prints.
"""

from __future__ import annotations

import json
import sys
from typing import Any, Optional, TextIO


def emit(*parts: Any, sep: str = " ", end: str = "\n",
         stream: Optional[TextIO] = None, flush: bool = True) -> None:
    """Write one line of CLI output (the sanctioned ``print``)."""
    out = stream if stream is not None else sys.stdout
    out.write(sep.join(str(p) for p in parts) + end)
    if flush:
        out.flush()


def emit_json(obj: Any, *, indent: Optional[int] = 2,
              stream: Optional[TextIO] = None, **kwargs: Any) -> None:
    """Write a JSON document to stdout (CLI result envelopes)."""
    kwargs.setdefault("default", str)
    emit(json.dumps(obj, indent=indent, **kwargs), stream=stream)


def warn(*parts: Any) -> None:
    """Diagnostics go to stderr, never mixed into a JSON stdout."""
    emit("warning:", *parts, stream=sys.stderr)
