"""The persistent kernel build cache, set up at the console's boot.

The port's counterpart of the JAX package's utils/compilecache.py. The JAX
package points XLA at a persistent on-disk compilation cache so a restarted
process reloads its compiled programs instead of recompiling them. The port
compiles no XLA: its persistent cache is the ``nvcc`` build cache of
engine/cuda_lib.py, one shared library a kernel source in
``wukong_tpu_torch/build/``, keyed by a hash of the source and the flags, so
a restart reuses every library whose source is unchanged.
:func:`setup_persistent_cache` builds whatever is missing before the first
query; ``cuda_lib.build_all`` charges its outcome to the device
observatory's ``wukong_device_compile_cache_total{site="boot"}`` counter:
``hit`` when every library was present, ``miss`` when ``nvcc`` ran. A
failed build raises.
"""

from __future__ import annotations

from wukong_tpu_torch.engine import cuda_lib
from wukong_tpu_torch.utils.logger import log_info


def setup_persistent_cache() -> str:
    """Build every kernel library that the build cache lacks (in parallel,
    one ``nvcc`` a source) and return the cache directory. Only the card's
    entry points call it: the CPU has no ``nvcc`` and runs every kernel's
    plain version."""
    seconds = cuda_lib.build_all()
    log_info(f"kernel build cache: {cuda_lib.BUILD} "
             f"({cuda_lib.last_build_outcome}, {seconds:.1f} s)")
    return str(cuda_lib.BUILD)
