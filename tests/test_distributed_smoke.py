"""2-process multi-host smoke test: jax.distributed over the CPU backend
(2 processes x 4 virtual devices = one 8-device global mesh), the same
code path a multi-host GPU cluster takes (SURVEY.md §2.8 distributed
backend row).

Renders a small frame with `render_distributed` (each process generates
only its addressable ray shards), writes gather-free per-host shard
files, and stitches them with `assemble_shards`.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_render(tmp_path):
    worker = os.path.join(os.path.dirname(__file__), "helpers",
                          "dist_worker.py")
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(i), str(port), str(tmp_path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=560)
        outs.append(out.decode())
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-3000:]}"
        assert "WROTE 4" in out, out[-2000:]

    from raytracing_tpu.config import RenderConfig
    from raytracing_tpu.parallel.distributed import assemble_shards

    cfg = RenderConfig(width=16, height=16, samples_per_pixel=1,
                       backend="cluster", diffuse_scatter=2)
    img = assemble_shards(str(tmp_path), cfg)
    assert img.shape == (16, 16, 3)
    assert np.isfinite(img).all()
    sky = (np.array([0x87, 0xCE, 0xEB]) / 255.0) ** (1 / 2.2)
    np.testing.assert_allclose(img[0, 0], sky, atol=1e-3)
    # geometry occupies the frame center
    assert np.abs(img[10] - sky).max() > 0.05
