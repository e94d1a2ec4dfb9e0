"""Native libraries of the port, built from their source at first use.

Each library is compiled from one source file into ``build/tpusfm_torch/``
(gitignored) under a name keyed by the hash of the source and the flags,
and reused while that file exists. The compiler writes to a temporary file
that is renamed into place, so concurrent builders (test workers) never
load a partial library.
"""
from __future__ import annotations

import hashlib
import os
import pathlib
import subprocess
import tempfile

BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "tpusfm_torch"


def build_library(src: pathlib.Path, compiler: str, flags: tuple, name: str) -> pathlib.Path:
    """``compiler *flags -o <lib> src`` into BUILD_DIR/<name>_<key>.so; the
    compiler's output goes beside it (.log). Raises if the compiler fails."""
    key = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{name}_{key}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        done = subprocess.run([compiler, *flags, "-o", tmp, str(src)], check=True,
                              capture_output=True, text=True)
        out.with_suffix(".log").write_text(done.stdout + done.stderr)
        os.replace(tmp, out)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"{compiler} failed building {src}:\n{e.stderr}") from e
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out
