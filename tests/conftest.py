"""Test configuration: run everything on CPU with 8 fake devices so
mesh/sharding logic is exercised without accelerator hardware
(SURVEY.md §4). On a machine with a card, ``JAX_PLATFORMS=cuda pytest -m
gpu`` runs the card-only tests (marked ``gpu``; they skip on the CPU)."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("BARCODER_TPU_BACKEND", "jax")

# keep on-disk scan/site artifacts out of the user cache; per-session tmp
import tempfile  # noqa: E402

_ART_DIR = tempfile.mkdtemp(prefix="barcoder_tpu_test_artifacts_")
os.environ["BARCODER_TPU_ARTIFACTS"] = _ART_DIR

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
