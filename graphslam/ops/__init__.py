"""Hand-written GPU kernels for the hot ops, and the rule that picks them.

Each kernel keeps its plain jnp reference beside it; tests compare the two
with the kernel run through the Pallas interpreter. Callers choose a kernel
with `on_gpu`, never by reading the default backend's name.
"""

from __future__ import annotations

import jax


def on_gpu(kernel_fn, xla_fn, *args):
    """`kernel_fn(*args)` where the computation is compiled for a CUDA
    device, `xla_fn(*args)` for any other platform.

    The choice is made when the computation is lowered, for the devices its
    arrays are placed on, so a CPU-placed computation in a process that also
    sees a GPU gets the XLA path. Only the chosen branch is lowered."""
    return jax.lax.platform_dependent(*args, cuda=kernel_fn, default=xla_fn)
