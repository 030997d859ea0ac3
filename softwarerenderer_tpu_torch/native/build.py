"""Build the native library: g++ -O3 -shared -fPIC srt_native.cpp, into
the package's git-ignored _build/ directory."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "srt_native.cpp")
LIBRARY = os.path.join(os.path.dirname(_DIR), "_build", "libsrt_native.so")


def build(force: bool = False) -> bool:
    """Compile the library if needed; returns True when it exists."""
    if not force and os.path.exists(LIBRARY) \
            and os.path.getmtime(LIBRARY) >= os.path.getmtime(SOURCE):
        return True
    gxx = shutil.which("g++") or shutil.which("clang++")
    if gxx is None:
        return False
    # A name of this process's own, so that processes building at once
    # never write one file; the rename into place is atomic.
    tmp = f"{LIBRARY}.{os.getpid()}.tmp"
    cmd = [gxx, "-O3", "-std=c++17", "-shared", "-fPIC", "-o", tmp, SOURCE]
    try:
        os.makedirs(os.path.dirname(LIBRARY), exist_ok=True)
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, LIBRARY)
        return True
    except (subprocess.SubprocessError, OSError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return False


if __name__ == "__main__":
    ok = build(force="--force" in sys.argv)
    print(LIBRARY if ok else "build failed")
    sys.exit(0 if ok else 1)
