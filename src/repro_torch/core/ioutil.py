"""Small filesystem helpers shared by every on-disk cache in the repo."""
from __future__ import annotations

import os
import pathlib
import threading

__all__ = ["atomic_write_text"]


def atomic_write_text(path, text: str) -> None:
    """Write ``text`` to ``path`` atomically (tmp + rename).

    The tmp name is unique per (process, thread): a shared ``<name>.tmp``
    would let two writers of the same path interleave write/replace and
    race a partially-written file into place (or crash on the other's
    already-renamed tmp).  Concurrent writers each replace atomically,
    so readers always see one writer's complete content (last wins).
    """
    p = pathlib.Path(path)
    tmp = p.with_name(f"{p.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        tmp.write_text(text)
        tmp.replace(p)
    finally:
        tmp.unlink(missing_ok=True)
