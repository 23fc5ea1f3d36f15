"""Build the repository's native host graph engine for the port.

The engine's source is ``csrc/gs_native.cpp`` (the same source the JAX
package builds).  The port compiles it with ``g++`` into a library of its
own, named by a hash of the source and the flags:

    g++ -O3 -march=native -shared -fPIC -std=c++17 -pthread
        -o build/graphsage_torch/libgs_native-<hash>.so csrc/gs_native.cpp

so it never writes inside the JAX package.  The hash also covers the host's
CPU model, which ``-march=native`` compiles for, so a build directory copied
to another machine is rebuilt there.  A current build is reused; a failed
build raises (there is no fallback to the numpy sampler, whose random
stream differs).  ``python -m graphsage_torch.native.build`` builds it.
"""

from __future__ import annotations

import hashlib
import os
import platform
import subprocess
from pathlib import Path

_REPO = Path(__file__).resolve().parent.parent.parent
SOURCE = _REPO / "csrc" / "gs_native.cpp"
BUILD_DIR = _REPO / "build" / "graphsage_torch"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             "-pthread")


def _host_cpu() -> str:
    """The CPU model name (what -march=native compiles for)."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    digest.update(_host_cpu().encode())
    return BUILD_DIR / f"libgs_native-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the engine unless a current build exists; return the .so."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: concurrent builds never see a
    # half-written library
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"native engine build failed (g++ rc="
                           f"{proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


if __name__ == "__main__":
    print(build())
