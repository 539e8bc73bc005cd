"""hyteg_tpu: matrix-free finite elements + geometric multigrid in JAX.

Package-wide numerical policy: on the GPU, XLA's DEFAULT matmul precision
may run f32 ``dot``/``einsum`` operands through the tensor cores in TF32,
which keeps about three decimal digits.  For an FE solver stack this is
not a benign speed knob — CG step sizes computed from rounded dot
products turn a multigrid coarse solve into an error *amplifier*.  A
numerics framework must default to f32-accurate matmuls; the hot stencil
paths are elementwise code and do not pay for this.  Set
HYTEG_TPU_FAST_MATMUL=1 before import to opt out for ML-style workloads
layered on top.
"""

import logging
import os

import jax

if not os.environ.get("HYTEG_TPU_FAST_MATMUL"):
    jax.config.update("jax_default_matmul_precision", "highest")
    logging.getLogger(__name__).info(
        "hyteg_tpu: set jax_default_matmul_precision='highest' "
        "(solver dot products must not round to bf16; opt out with "
        "HYTEG_TPU_FAST_MATMUL=1)")
