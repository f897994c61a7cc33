"""Process-wide liveness heartbeat.

One file, touched from every loop that can block on the device (the
renderer's chunk loop), watched by an external watchdog: a hung device
call freezes the loop and the file's mtime goes stale.  Off until a path is
set.
"""

from __future__ import annotations

import os
from typing import Optional

_path: Optional[str] = None


def set_path(path: Optional[str]):
    global _path
    _path = path


def beat():
    if not _path:
        return
    try:
        os.utime(_path)
    except OSError:
        try:
            open(_path, "w").close()
        except OSError:
            pass
