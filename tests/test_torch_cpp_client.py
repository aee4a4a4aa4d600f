"""C++ frontend: the native thin client (native/client/) against a live
cluster of the PyTorch port — the C++-API-parity row (the reference's
cpp/src/ray/api.cc driver surface; here tasks execute in the cluster's
Python workers, with bytes in / bytes out across the language boundary
like the reference's XLANG buffer convention).

The port's copy of ``tests/test_cpp_client.py``: the same three cases,
with the client built by ``native/build.py`` into the package's
``_build/`` (the reference runs ``make`` in its source tree), plus the
client's wire version against the port's, the port's client against
both packages' servers, and the C++ driver's named call of greedy
``gpt.generate`` against the JAX package's tokens. Every cluster wait and
subprocess has a deadline.
"""

import dataclasses
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ray_memory_management_tpu_torch as rmt
from ray_memory_management_tpu.models import gpt as jgpt
from ray_memory_management_tpu_torch.models import gpt as tgpt
from ray_memory_management_tpu_torch.models.convert import params_from_jax
from ray_memory_management_tpu_torch.native import build
from ray_memory_management_tpu_torch.utils import runtime_smoke
from _port_fixtures import one_intra_op_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO_LINES = ("CONNECTED", "GET roundtrip=ok", "DUPGET ok",
              "NAMED registered=yes", "WAIT ready=1 not_ready=0",
              "DEMO OK")


@pytest.fixture(scope="module")
def rmt_demo_binary():
    """The C++ client and demo, built by ``native/build.py`` (cached by
    digest; a compile failure raises with g++'s stderr)."""
    return build.program_path("rmt_demo")


def _run_demo(binary, host, port, *extra, timeout=240):
    return subprocess.run([binary, host, str(port), *extra],
                          capture_output=True, text=True, timeout=timeout)


class TestCppClient:
    def test_demo_end_to_end(self, rmt_demo_binary):
        """Connect (mutual HMAC auth + version-checked ping), round-trip
        an object, invoke a cluster-registered function, wait, fetch."""
        from ray_memory_management_tpu_torch.client.server import (
            ClusterServer, register_named_function, unregister_named_function)

        def cpp_transform(a: bytes, b: bytes) -> bytes:
            return (a + b).upper()

        rmt.init(num_cpus=2)
        server = None
        try:
            register_named_function("cpp_transform", cpp_transform)
            server = ClusterServer()
            host, port = server.address
            rc = _run_demo(rmt_demo_binary, host, port)
            assert rc.returncode == 0, (rc.stdout, rc.stderr)
            out = rc.stdout
            for line in DEMO_LINES:
                assert line in out
            assert "RESULT ABCDEF" in out
        finally:
            unregister_named_function("cpp_transform")
            if server is not None:
                server.close()
            rmt.shutdown()

    def test_bad_authkey_rejected(self, rmt_demo_binary):
        """A wrong authkey must fail the HMAC handshake, not hang or
        half-connect."""
        from ray_memory_management_tpu_torch.client.server import (
            ClusterServer)

        rmt.init(num_cpus=2)
        server = None
        try:
            server = ClusterServer()
            host, port = server.address
            rc = _run_demo(rmt_demo_binary, host, port, "wrong-key",
                           timeout=120)
            assert rc.returncode != 0
            assert "DEMO FAILED" in rc.stderr
            # the failed handshake must not kill the accept loop: a
            # well-keyed client connects fine afterwards
            from ray_memory_management_tpu_torch.client.client import (
                ClientBackend)

            backend = ClientBackend(host, port)
            backend.close()
        finally:
            if server is not None:
                server.close()
            rmt.shutdown()

    def test_get_bytes_rejects_rich_values(self):
        """The raw-bytes boundary is typed: fetching a non-bytes value
        through get_bytes raises a clear error instead of handing the
        frontend an undecodable pickle."""
        from multiprocessing.connection import Client

        from ray_memory_management_tpu_torch import serialization as ser
        from ray_memory_management_tpu_torch.client.server import (
            ClusterServer)
        from ray_memory_management_tpu_torch.config import (
            WIRE_PROTOCOL_VERSION)

        rmt.init(num_cpus=2)
        server = None
        try:
            server = ClusterServer()
            host, port = server.address
            oid = rmt.put({"rich": "value"})
            conn = Client((host, port), family="AF_INET",
                          authkey=b"rmt-client")
            # versioned handshake first: unversioned verbs are refused
            conn.send({"type": "ping", "proto": WIRE_PROTOCOL_VERSION,
                       "req_id": 0})
            assert conn.recv()["error"] is None
            conn.send({"type": "get_bytes", "oids": [oid.binary()],
                       "req_id": 1, "timeout": 30})
            reply = conn.recv()
            assert reply["error"] is not None
            assert "non-bytes" in str(ser.loads(reply["error"]))
            conn.close()
        finally:
            if server is not None:
                server.close()
            rmt.shutdown()


def test_client_pings_the_ports_wire_version():
    """The C++ client's versioned ping carries the port's
    ``WIRE_PROTOCOL_VERSION`` (the reference's copy still says 1)."""
    from ray_memory_management_tpu_torch.config import WIRE_PROTOCOL_VERSION

    src = os.path.join(os.path.dirname(build.__file__), "client",
                       "rmt_client.cpp")
    with open(src) as f:
        literals = re.findall(r'ping\["proto"\]\s*=\s*PvInt\((\d+)\)',
                              f.read())
    assert literals == [str(WIRE_PROTOCOL_VERSION)]


# one cluster of either package, the demo against its ClusterServer, the
# demo's stdout and stderr passed through, its exit code as ours
_SERVE_DEMO = """
import importlib, subprocess, sys
pkg = importlib.import_module(sys.argv[1])
server_mod = importlib.import_module(sys.argv[1] + ".client.server")


def cpp_transform(a, b):
    return (a + b).upper()


pkg.init(num_cpus=2)
server = None
try:
    server_mod.register_named_function("cpp_transform", cpp_transform)
    server = server_mod.ClusterServer()
    host, port = server.address
    r = subprocess.run([sys.argv[2], host, str(port)], capture_output=True,
                       text=True, timeout=120)
    sys.stdout.write(r.stdout)
    sys.stderr.write(r.stderr)
finally:
    if server is not None:
        server.close()
    pkg.shutdown()
sys.exit(r.returncode)
"""


def test_demo_lines_equal_against_both_packages(rmt_demo_binary):
    """Wire parity: the port's demo prints the same lines against the
    JAX package's ``ClusterServer`` as against the port's, each cluster
    in its own process with the same ``cpp_transform``. Both servers
    speak v2, so this holds the port's client and server to the
    reference's server."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join(
               p for p in (REPO, os.environ.get("PYTHONPATH")) if p)}

    def serve(pkg):
        return subprocess.run(
            [sys.executable, "-c", _SERVE_DEMO, pkg, rmt_demo_binary],
            capture_output=True, text=True, timeout=300, cwd=REPO, env=env)

    with ThreadPoolExecutor(2) as pool:
        port, ref = pool.map(serve, ["ray_memory_management_tpu_torch",
                                     "ray_memory_management_tpu"])
    for r in (port, ref):
        assert r.returncode == 0, (r.stdout, r.stderr[-3000:])
    assert "RESULT ABCDEF" in port.stdout
    assert port.stdout.splitlines() == ref.stdout.splitlines()


def test_demo_drives_greedy_generate_like_jax(rmt_demo_binary):
    """The slice's path on the CPU: the C++ driver calls a named function
    that greedily generates with ``runtime_smoke.generate_text`` (the
    body of ``cpp_generate``, here on the test preset with the JAX
    package's weights on the CPU), and its RESULT line is the JAX
    package's ``generate`` of the same prompt, token for token."""
    from ray_memory_management_tpu_torch.client.server import (
        ClusterServer, register_named_function, unregister_named_function)

    jcfg = dataclasses.replace(jgpt.PRESETS["test"], dtype=jnp.float32)
    tcfg = dataclasses.replace(tgpt.PRESETS["test"], dtype=torch.float32)
    jparams = jgpt.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    prompt = b"abcdef"  # the demo's cpp_transform("abc", "def")
    steps = runtime_smoke.CPP_NEW_TOKENS
    want = np.asarray(jgpt.generate(jparams, jcfg,
                                    jnp.asarray([list(prompt)]),
                                    steps=steps))[0, len(prompt):]

    def cpp_transform(a: bytes, b: bytes) -> bytes:
        return runtime_smoke.generate_text(tparams, tcfg, a + b, steps)

    rmt.init(num_cpus=2)
    server = None
    try:
        register_named_function("cpp_transform", cpp_transform)
        server = ClusterServer()
        rc = _run_demo(rmt_demo_binary, *server.address)
        assert rc.returncode == 0, (rc.stdout, rc.stderr)
        for line in DEMO_LINES:
            assert line in rc.stdout
        assert f"RESULT {','.join(map(str, want))}\n" in rc.stdout
    finally:
        unregister_named_function("cpp_transform")
        if server is not None:
            server.close()
        rmt.shutdown()


def test_cpp_generate_raises_without_a_card():
    """``cpp_generate`` runs gpt2-small on the card and never on the CPU
    in its place."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runtime_smoke.cpp_generate(b"abc", b"def")
