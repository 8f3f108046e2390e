"""Builds the package's C++ host libraries from their sources.

Each library is compiled with the system g++ into `build/native/` at the
checkout root (listed in .gitignore), under a file name keyed on a hash of
its sources and flags.  A binary therefore always matches the sources beside
it: an edited or copied tree compiles afresh instead of loading a stale
library.  Builds are atomic (compile to a temporary file, then rename), so
concurrent processes that race on a first build are safe.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile

BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "build", "native")


def build(name: str, source: str, deps: tuple[str, ...] = (),
          flags: tuple[str, ...] = (), out_dir: str = BUILD_DIR) -> str:
    """Compile `source` (which may #include `deps`) into
    out_dir/lib<name>-<hash>.so unless that file exists; returns its path.
    Raises CalledProcessError or OSError when the compiler fails or is
    missing."""
    h = hashlib.sha256()
    for part in flags:
        h.update(part.encode() + b"\0")
    for path in (source, *deps):
        with open(path, "rb") as f:
            h.update(f.read())
    so = os.path.join(out_dir, f"lib{name}-{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(out_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f"lib{name}-", suffix=".tmp",
                               dir=out_dir)
    os.close(fd)
    try:
        subprocess.run(["g++", *flags, "-shared", "-fPIC", "-o", tmp, source],
                       check=True)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so
