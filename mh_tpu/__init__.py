"""mh_tpu — a Metropolis-Hastings scene-layout inference engine on JAX.

A from-scratch JAX/XLA framework with the capabilities of the CUDA
reference ``j-timothy-balint/Metropolis-Hastings-GPGPU`` (parallel MH
optimization of 2-D furniture/scene layouts, Merrell-style interior-design
cost terms), re-designed for batched accelerator execution:

- Scene + chain state are static-shaped, masked PyTrees (reference data
  model: ``Kernel.cu:43-149``).
- The objective is a pure vectorized log-score: all seven cost terms as
  masked tensor expressions fused by XLA (reference: ``Kernel.cu:191-550``).
- Proposals / accept / chain loop are functional ``lax.scan`` programs with
  counter-based threefry RNG (reference: cuRAND states, ``Kernel.cu:152-160``).
- Chain parallelism is ``vmap`` over a chains axis sharded across a
  ``jax.sharding.Mesh`` (reference: one CUDA block per chain,
  ``Kernel.cu:754``), with collectives for adaptation / tempering / SMC.
"""

from mh_tpu.config import CostMode, SamplerConfig, REF_PI, REF_BETA
from mh_tpu.models.scene import (
    RectSet,
    Scene,
    SceneSpec,
    rects_from_vertices,
    demo_scene,
)
from mh_tpu.ops.costs import CostBreakdown, cost_terms, total_cost
from mh_tpu.sampler.mh import (
    MHState,
    compile_chains,
    mh_init,
    mh_step,
    run_chain,
    run_chains,
)
from mh_tpu.api import LayoutResult, suggest_layouts
from mh_tpu.models.pi import estimate_pi

__version__ = "0.1.0"

__all__ = [
    "CostMode",
    "SamplerConfig",
    "REF_PI",
    "REF_BETA",
    "RectSet",
    "Scene",
    "SceneSpec",
    "rects_from_vertices",
    "demo_scene",
    "CostBreakdown",
    "cost_terms",
    "total_cost",
    "MHState",
    "compile_chains",
    "mh_init",
    "mh_step",
    "run_chain",
    "run_chains",
    "LayoutResult",
    "suggest_layouts",
    "estimate_pi",
]
