"""Multi-host distribution: jax.distributed wiring + global-mesh render.

The reference is a single process with a thread pool (SURVEY.md §2.8); the
scale-out path here is:

  1. `initialize()` — wire `jax.distributed` from explicit args, our env
     vars (RTPU_COORDINATOR / RTPU_NUM_PROCESSES / RTPU_PROCESS_ID), or
     the cluster auto-detection JAX performs when no args are given.
  2. one global 1-D mesh over every device of every host ("rays" axis) —
     rays are independent, so a 1-D data-parallel axis is the whole
     story: geometry replicates, the forward pass needs zero cross-host
     traffic, and the only collectives are `pmean` loss/grad reductions
     (NVLink within a host, the network across hosts) in the train step.
  3. `render_distributed` — every process generates ONLY its addressable
     ray shards (camera rays are index arithmetic, so no host holds the
     full frame), renders them, and `save_local_shards` writes per-host
     image tiles gather-free; `assemble_shards` stitches them offline.

The 2-process CPU smoke test (tests/test_distributed_smoke.py) runs this
file end-to-end under `xla_force_host_platform_device_count`, the same
way __graft_entry__.dryrun_multichip validates single-process
multi-device sharding.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh as DeviceMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from raytracing_tpu.accel.packets import ClusterAccel
from raytracing_tpu.config import RenderConfig
from raytracing_tpu.geometry.mesh import Scene
from raytracing_tpu.parallel.shard import RAY_AXIS, render_sharded


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids=None,
) -> bool:
    """Initialize jax.distributed for multi-host runs.

    Resolution order per argument: explicit parameter, then the
    RTPU_COORDINATOR / RTPU_NUM_PROCESSES / RTPU_PROCESS_ID environment
    variables. With num_processes <= 1 (or nothing set) this is a no-op
    returning False — single-process runs never pay for a coordinator.
    On a cluster JAX can detect, all three may be omitted but
    RTPU_NUM_PROCESSES set to 'auto' to use JAX's auto-detection.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "RTPU_COORDINATOR")
    if num_processes is None:
        num_processes = os.environ.get("RTPU_NUM_PROCESSES")
    if num_processes is None:
        return False
    if num_processes == "auto":
        jax.distributed.initialize()
        return True
    num_processes = int(num_processes)
    if num_processes <= 1:
        return False
    if process_id is None:
        process_id = int(os.environ["RTPU_PROCESS_ID"])
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=int(process_id),
        local_device_ids=local_device_ids,
    )
    return True


def global_ray_mesh() -> DeviceMesh:
    """1-D mesh over every device of every process (hosts x chips
    flattened — a ray batch has no reason to distinguish the two axes)."""
    return DeviceMesh(np.asarray(jax.devices()), (RAY_AXIS,))


def render_distributed(
    scene: Scene,
    config: RenderConfig,
    accel: Optional[ClusterAccel] = None,
    key: Optional[jax.Array] = None,
    mesh: Optional[DeviceMesh] = None,
    gi_accel: Optional[ClusterAccel] = None,
) -> jax.Array:
    """Full-frame render over the global mesh.

    Each process generates only the camera rays of its addressable
    shards (`make_array_from_callback` + on-host index arithmetic — no
    host ever materializes the whole frame's rays), then the sharded
    render runs with replicated geometry and zero collectives. Returns
    the [spp*h*w(padded), 3] GLOBAL sharded radiance array in ray order;
    write per-host outputs gather-free with `save_local_shards` and
    reassemble the frame offline with `assemble_shards`.
    """
    from raytracing_tpu.models.camera import camera_rays_for_ids
    from raytracing_tpu.models.whitted import render_rays

    if key is None:
        key = jax.random.PRNGKey(0)
    mesh = mesh or global_ray_mesh()
    n_dev = mesh.devices.size
    spp, h, w = config.samples_per_pixel, config.height, config.width
    r = spp * h * w
    per = -(-r // n_dev)
    rp = per * n_dev
    sharding = NamedSharding(mesh, P(RAY_AXIS))

    def cb(index):
        sl = index[0]
        ids = np.arange(sl.start, sl.stop, dtype=np.int64)
        ids = np.minimum(ids, r - 1)  # pad rays repeat the last id
        o_l, d_l = camera_rays_for_ids(jnp.asarray(ids), config)
        return np.concatenate(
            [np.asarray(o_l), np.asarray(d_l)], axis=1
        ).astype(np.float32)

    rays = jax.make_array_from_callback((rp, 6), sharding, cb)
    lights = getattr(scene, "lights", None)

    def local(mesh_g, accel_g, gi_accel_g, lights_g, sun, rays_l, key_):
        key_l = jax.random.fold_in(key_, jax.lax.axis_index(RAY_AXIS))
        return render_rays(mesh_g, accel_g, sun, rays_l[:, 0:3],
                           rays_l[:, 3:6], key_l, config,
                           lights=lights_g, gi_accel=gi_accel_g)

    fn = jax.jit(jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(), P(RAY_AXIS), P()),
        out_specs=P(RAY_AXIS),
        check_vma=False,
    ))
    return fn(scene.mesh, accel, gi_accel, lights, scene.sun, rays, key)


def save_local_shards(rgb: jax.Array, out_dir: str, tag: str = "shard"
                      ) -> list:
    """Write this process's addressable shards of a global ray-order
    radiance array to `{out_dir}/{tag}_d{device_id}.npy` — the gather-free
    per-host image output path. Returns the written file names."""
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for s in rgb.addressable_shards:
        path = os.path.join(out_dir, f"{tag}_d{s.device.id}.npy")
        start = s.index[0].start or 0
        np.save(path, {"start": int(start),
                       "data": np.asarray(s.data)},
                allow_pickle=True)
        written.append(path)
    return written


def assemble_shards(out_dir: str, config: RenderConfig, tag: str = "shard"
                    ) -> np.ndarray:
    """Offline stitch of every process's saved shards -> [h, w, 3] image
    (spp-averaged). Run after all hosts have written."""
    spp, h, w = config.samples_per_pixel, config.height, config.width
    r = spp * h * w
    buf = np.zeros((r, 3), np.float32)
    import glob

    for path in glob.glob(os.path.join(out_dir, f"{tag}_d*.npy")):
        rec = np.load(path, allow_pickle=True).item()
        start, data = rec["start"], rec["data"]
        stop = min(start + data.shape[0], r)
        buf[start:stop] = data[:stop - start]
    return buf.reshape(spp, h, w, 3).mean(axis=0)
