"""Process environment of a run, set before torch is imported."""

import os
from pathlib import Path

# every compiler and kernel cache lives at a fixed path inside the
# checkout, so that only a checkout's first run builds; the port's own
# CUDA libraries go to cross_patient_speech_decoding_tpu_torch/_build/
CACHE_DIRS = {
    "TORCH_EXTENSIONS_DIR": "torch_extensions",
    "TRITON_CACHE_DIR": "triton",
    "CUDA_CACHE_PATH": "nv",
}
# a run stays in one process with few host threads: its load is steadier
THREADS = "4"


def set_cache_env(root: Path) -> None:
    cache = Path(root) / "portbench" / ".cache"
    for var, sub in CACHE_DIRS.items():
        path = cache / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = THREADS
    # a library that could load JAX by itself is kept from it
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
