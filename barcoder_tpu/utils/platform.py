"""The one place that decides which platform the engines run on.

Every platform-dependent choice — whether phase 1 runs the compiled kernel,
whether the persistent compile cache is on — is derived from
``device_platform()``. It knows two platforms: ``gpu`` (an
NVIDIA card through JAX's CUDA plugin) and ``cpu`` (tests, and machines
without a card). Any other platform is an error, not a silent fallback.
"""

from __future__ import annotations

import os

PLATFORMS = ("gpu", "cpu")

# genome positions per phase-1 tile, the same on every platform: the GPU
# kernel's programs are 128 columns wide whatever the tile, and end-to-end
# scan times on the H100 did not move with P in {2048, ..., 16384}
# (PERF.md); CPU meshes in the tests want small tiles
TILE_P = 2048


def device_platform(devices=None) -> str:
    """Platform of ``devices`` (default: ``jax.devices()``): ``"gpu"`` or
    ``"cpu"``. Raises RuntimeError on any other platform."""
    if devices is None:
        import jax

        devices = jax.devices()
    platform = list(devices)[0].platform
    if platform not in PLATFORMS:
        raise RuntimeError(
            f"unsupported JAX platform {platform!r}; barcoder_tpu runs on "
            f"{' or '.join(PLATFORMS)}"
        )
    return platform


def phase1_kernel_enabled(platform: str) -> bool:
    """Whether phase 1 runs the compiled kernel (ops.pallas_scan
    .scan_block_hits): always on the GPU, never on the CPU (there the
    plain-XLA phase 1 runs; tests reach the kernel through interpret
    mode). ``BARCODER_TPU_PHASE1=xla`` selects the plain-XLA phase 1 on the
    GPU too — the comparison the kernel is measured against."""
    choice = os.environ.get("BARCODER_TPU_PHASE1", "kernel")
    if choice not in ("kernel", "xla"):
        raise ValueError(
            f"BARCODER_TPU_PHASE1={choice!r}; choose 'kernel' or 'xla'"
        )
    return platform == "gpu" and choice == "kernel"
