"""Every build and kernel cache of a run at a fixed path inside the
checkout, set before torch is imported: the port's nvcc output stays in
build/torch_kernels/ (kernels/build.py fixes it there), Triton's cache and
the CUDA driver's JIT cache go to build/triton_cache/ and
build/cuda_cache/. Nothing is written to /dev/shm or a fixed /tmp path."""

import os

FORBIDDEN_TOP = ("jax", "jaxlib", "flax", "dab_radio_tpu")


def pin_caches(root: str):
    build = os.path.join(root, "build")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton_cache")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(build, "cuda_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")


def forbidden_modules(modules) -> list:
    """Names of loaded modules whose top-level name, compared whole, is
    JAX's or the JAX package's (dab_radio_tpu_torch is not dab_radio_tpu)."""
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN_TOP)
