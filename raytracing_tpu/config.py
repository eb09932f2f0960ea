"""Configuration system.

The reference has no config at all — compile-time consts (`main.rs:29-36`), a
hardcoded scene (`main.rs:406-448`) and a `// TODO: Use clap for CLI params`
(`main.rs:382`). Here every knob is an explicit, hashable dataclass so configs
can be passed as static arguments through `jax.jit`.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


def _u8(r: int, g: int, b: int) -> Tuple[float, float, float]:
    return (r / 255.0, g / 255.0, b / 255.0)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render parameters.

    Defaults mirror the reference's compile-time constants
    (`/root/reference/src/main.rs:29-36`) and shading constants:
    800x800, SCALE=1, 4 stratified samples (2x2), REFLECT_DEPTH=4,
    DIFFUSE_DEPTH=2, DIFFUSE_SCATT=10, sky #87ceeb, gamma 2.2,
    normal offset 1e-5.
    """

    width: int = 800
    height: int = 800
    scale: float = 1.0
    # Stratified supersampling (`main.rs:321-365`). Any positive count:
    # sample s sits at a cell center of the gx x gy stratification grid
    # (ops/sampling.stratified_grid — 4 reproduces the reference's fixed
    # 2x2 pattern; non-square counts stratify on a rectangular grid).
    samples_per_pixel: int = 4
    reflect_depth: int = 4
    diffuse_depth: int = 2
    diffuse_scatter: int = 10
    sky_color: Tuple[float, float, float] = _u8(0x87, 0xCE, 0xEB)
    gamma: float = 2.2
    # Hit points are pushed off the surface along the face normal to avoid
    # self-intersection (`main.rs:121-124`).
    normal_offset: float = 1e-5
    # Möller–Trumbore epsilon for determinant / t acceptance.
    eps: float = 1e-8
    # Primary rays per wavefront chunk. Each chunk expands by a factor of
    # (1 + diffuse_scatter) at the secondary levels, so the live ray count
    # is chunk_size * 11 at the widest level; 64Ki keeps that well inside
    # device memory while keeping the frame at 40 chunk programs.
    chunk_size: int = 65536
    # Intersection backend: "auto" (the Pallas walk on a GPU, the XLA
    # cluster scan elsewhere — tracer.resolve_backend), "bruteforce"
    # (oracle), "cluster" (two-level packet hierarchy, pure XLA), "pallas"
    # (the walk kernel, kernels/traverse.py; compiles for a CUDA GPU).
    backend: str = "auto"
    # Run the pallas backend's kernel in the Pallas interpreter. Only for
    # tests and debugging on a host without a GPU; it is orders of
    # magnitude slower.
    interpret: bool = False
    # Whether shading normals are the precomputed face normals carried on the
    # mesh (reference behaviour, `objects.rs:206-220`) or recomputed
    # differentiably from vertices ("geometric") so gradients flow to verts.
    normals: str = "stored"
    # Re-sort secondary (bounce) rays by (origin cell, direction cone)
    # before tracing so walk blocks stay coherent (pallas backend only).
    # Order-invisible semantically; a pure performance knob.
    bin_secondary: bool = True
    # Also re-bin PURE-REFLECT levels (depth > diffuse_depth, where no
    # diffuse fan is spawned): a mirror bounce of the hemispherical GI fan
    # scatters directions across the sphere, so unbinned reflect blocks
    # mix cones and their frustums balloon to full-scene scans. Bit-exact
    # either way (the permutation is undone before radiance accumulation;
    # no RNG is drawn at pure-reflect levels).
    bin_reflect_levels: bool = True
    # Additionally re-sort each level's SHADOW rays by hit position: GI
    # hit points scatter across the scene, so the level's bounce-sorted
    # order leaves shadow blocks with ballooned frustums. Pays one extra
    # payload sort + unsort per level (pallas backend only). "auto" =
    # re-bin only when the frame has NO coarse gi_accel; True/False force
    # it either way.
    bin_shadow: object = "auto"
    # Cluster size of the AUTO-BUILT coarse second accel for the
    # incoherent bounce (depth>1) levels — see whitted.render. Results are
    # exact either way (same triangles; only the walk partition changes).
    # 0 disables the auto build; it is also skipped when the primary accel
    # is already at least this coarse, or when an explicit gi_accel is
    # passed. Pallas backend only. Off by default: the walk's clusters
    # above 32 triangles measured slower, not faster (PERF.md).
    gi_cluster_size: int = 0
    # Visibility samples per spherical area light per shading point (only
    # used when the scene carries lights; see models/whitted.
    # area_light_term). More samples -> smoother penumbras.
    light_samples: int = 4

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)

    @property
    def spp_grid(self):
        """Stratification grid (gx, gy), gx * gy == samples_per_pixel —
        any positive spp is valid (rectangular grid for non-squares)."""
        from raytracing_tpu.ops.sampling import stratified_grid

        return stratified_grid(self.samples_per_pixel)


# Reference scene materials (`main.rs:426-447`): Material::new(albedo,
# reflectivity, roughness); albedo is stored pre-divided by pi
# (`objects.rs:184-190`) — we keep the same convention in Mesh.materials.
TEAPOT1_MATERIAL = (1.0, 0.9, 0.1)
TEAPOT2_MATERIAL = (1.0, 0.025, 0.975)
GROUND_MATERIAL = (1.0, 0.0, 1.0)

TEAPOT1_COLOR = _u8(0x50, 0xC8, 0x78)
TEAPOT2_COLOR = _u8(0xFF, 0x00, 0x00)
GROUND_COLOR = _u8(128, 128, 128)
