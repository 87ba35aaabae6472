"""Unified CLI: ``python -m barcoder_tpu <command> ...``.

Commands map 1:1 to the reference's scripts:
  targets   ↔ targets.py        (guide→genome mapping)
  design    ↔ design_guides.py  (genome-wide guide design)
  count     ↔ heuristicount.py  (barcode counting in reads)
  mismatch  ↔ mismatch.py       (mismatch-efficacy model)
  distill   ↔ distillreads.py   (read sort/compress preprocessing)
  gui       ↔ extensible_GUI.py (interactive launcher; terminal UI)
"""

from __future__ import annotations

import os
import sys


def _shield_stdout() -> None:
    """XLA's Gloo CPU-collective backend prints ``[Gloo] Rank ...`` banners
    straight to fd 1 from C++ (unbuffered, unscopable from Python), which
    can interleave mid-line with the CLI's machine-readable stdout on the
    CPU stand-in — observed as split banner fragments corrupting TSV lines
    under load. Re-point fd 1 at stderr so every native write lands there,
    and hand Python a private dup of the ORIGINAL stdout: the data contract
    (clean TSV/JSON on the process's stdout) is preserved exactly. GPU
    meshes use NCCL and never print these banners, but the shield is
    harmless there too.

    Idempotent: a second main() call in the same process (library/test use)
    re-enters here because multihost.initialize() short-circuits True once
    initialized — re-shielding would dup the ALREADY-redirected fd 1 (now
    stderr) and silently send all machine-readable output to stderr."""
    global _STDOUT_SHIELDED
    if _STDOUT_SHIELDED:
        return
    sys.stdout.flush()
    real = os.dup(1)
    os.dup2(2, 1)  # native fd-1 writers (Gloo) now reach stderr
    sys.stdout = os.fdopen(real, "w", buffering=1)
    _STDOUT_SHIELDED = True


_STDOUT_SHIELDED = False


def _join_cluster() -> None:
    """Multi-host runs set BARCODER_TPU_COORDINATOR / _NUM_PROCESSES /
    _PROCESS_ID (one CLI process per host); joining must happen before the
    first jax.devices() touch so every mesh spans the global device set
    (parallel.multihost). No-op when the env is absent."""
    if os.environ.get("BARCODER_TPU_COORDINATOR") or os.environ.get(
        "BARCODER_TPU_NUM_PROCESSES"
    ):
        from ..parallel import multihost

        if multihost.initialize():
            _shield_stdout()


def main(argv=None) -> int:
    _join_cluster()
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "targets":
        from .targets import main as run

        return run(rest)
    if cmd == "design":
        from .design import main as run

        return run(rest)
    if cmd == "count":
        from .count import main as run

        return run(rest)
    if cmd == "mismatch":
        from .mismatch import main as run

        return run(rest)
    if cmd == "distill":
        from .distill import main as run

        return run(rest)
    if cmd == "gui":
        from .gui import main as run

        return run(rest)
    print(f"unknown command: {cmd}\n", file=sys.stderr)
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
