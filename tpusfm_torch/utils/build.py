"""Native libraries of the port, built from their source at first use.

Each library is compiled from one source file into ``build/tpusfm_torch/``
(gitignored) under a name keyed by the hash of the source and the flags,
and reused while that file exists. The compiler writes to a temporary file
and its log to another, each renamed into place (``os.replace``), so
processes that build at once (test workers, the ranks of a process group)
never load a partial library or read a partial log; the last rename wins
with identical content.
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
    fd, tmp_log = tempfile.mkstemp(suffix=".log", dir=BUILD_DIR)
    os.close(fd)
    try:
        done = subprocess.run([compiler, *flags, "-o", tmp, str(src)], check=True,
                              capture_output=True, text=True)
        pathlib.Path(tmp_log).write_text(done.stdout + done.stderr)
        os.replace(tmp_log, out.with_suffix(".log"))
        os.replace(tmp, out)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"{compiler} failed building {src}:\n{e.stderr}") from e
    finally:
        for t in (tmp, tmp_log):
            if os.path.exists(t):
                os.remove(t)
    return out
