"""Atomic artifact writes: write to ``path + ".tmp"``, fsync, then
``os.replace``, so a trace, a frames sidecar or a report either exists
complete or not at all (a killed run never leaves a truncated file for a
reader to reject).  The port's copy of the JAX package's
``utils/artifacts.py``."""

from __future__ import annotations

import json
import os

__all__ = ["write_bytes_atomic", "write_text_atomic", "write_json_atomic"]


def write_bytes_atomic(path: str, data: bytes) -> None:
    """Write ``data`` to ``path`` atomically (tmp + os.replace)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def write_text_atomic(path: str, text: str) -> None:
    write_bytes_atomic(path, text.encode("utf-8"))


def write_json_atomic(path: str, obj, *, indent: int | None = 1,
                      **json_kwargs) -> None:
    """json.dump, atomically (indent 1 by default)."""
    write_text_atomic(path, json.dumps(obj, indent=indent, **json_kwargs))
