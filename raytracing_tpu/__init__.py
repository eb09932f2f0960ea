"""raytracing_tpu — a differentiable ray tracer in JAX/Pallas for GPUs.

Built from scratch to reproduce (and extend) the capabilities of the Rust/AVX2
CPU ray tracer KristinnVikarJ/raytracing (mounted read-only at /root/reference;
see SURVEY.md for the structural analysis). Nothing here is a port: the 8-wide
`__m256` SIMD kernels of the reference (`src/simd_accel.rs`) become vectorized
XLA ops and a Pallas walk kernel over SoA arrays, the recursive `trace_ray`
(`src/main.rs:88-311`) becomes an iterative wavefront over statically-shaped
ray levels, and rayon scanline parallelism (`src/main.rs:317-319`) becomes
`shard_map` over a device mesh.

Public surface:
  config      — RenderConfig / SceneConfig (the reference's missing CLI/config)
  geometry    — OBJ loading, SoA meshes, scene construction
  accel       — host-side acceleration-structure builds (packets, BVH)
  ops         — intersection / sampling / color math (pure JAX)
  kernels     — the Pallas (Triton) walk kernel for the intersection hot
                loop, and wavefront ray binning
  models      — integrators: Whitted (reference-parity), path tracer, inverse
  parallel    — device-mesh sharding of the ray batch, gradient collectives
  utils       — PNG output, profiling, logging
"""

from raytracing_tpu.config import RenderConfig
from raytracing_tpu.geometry.mesh import Mesh, Scene
from raytracing_tpu.geometry.scene import build_default_scene
from raytracing_tpu.models.whitted import render as render_whitted

__version__ = "0.1.0"

__all__ = [
    "RenderConfig",
    "Mesh",
    "Scene",
    "build_default_scene",
    "render_whitted",
]
